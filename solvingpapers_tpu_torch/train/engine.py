"""The training engine (port of the single-device path of
`solvingpapers_tpu/train/engine.py`).

`Trainer` runs the reference's loop on one device: the objective (the
LM loss, or a family's own, `train.objectives`), the train step (loss,
backward through the flash kernels under `use_flash`, global-norm clip,
optimizer update, then the model's new non-trainable state, such as
DeepSeek-V3's routing biases), evaluation, the log/eval/checkpoint
cadence with resume, and the step-time, tokens/s and MFU metrics. The
first step is fenced and kept out of the timing, as are eval and
checkpoint saves.

Each step's dropout seed is `TrainState.step_seed()`, a pure function of
the state's generator seed and the step — the reference's
``fold_in(state.rng, state.step)`` — so a resumed run and a recomputed
(remat) block draw the same masks.

`scan_steps = K > 1` runs the reference's training windows: K ordinary
steps back to back (the same batches, step seeds and optimizer state as
stepping one at a time), the host logging, evaluating and checkpointing
only at window ends, so every cadence must be a multiple of K; a resume
off a window boundary and the ragged tail step singly. (The reference
scans a window on the device to spare K - 1 dispatches. A CUDA graph
would be the port's form, but the dropout seed is a kernel argument, so
a replay would redraw one step's masks; the port runs the steps
eagerly.)

Gradient accumulation (``optimizer.accum_steps = k``) lives in the
optimizer, as the reference's ``optax.MultiSteps`` does: a step is one
micro-step — one batch, one forward and backward, one step seed, one
log-able row, and DeepSeek-V3's routing biases installed — and every
k-th step emits the update. `steps`, the cadences and the logged lr
(the schedule at the step count, as the reference logs it) count
micro-steps. The two compose without a rule between them: a
`scan_steps` window is K micro-steps, and an update falls wherever a
k-th micro-step does, inside a window or at its end.

`fit(..., callbacks=[(every, fn)])` calls ``fn(state, step)`` at every
multiple of `every` (after eval, outside the timed window), as the
reference's hooks for sampling during training.

Not ported, and refused when set (they need a mesh, several cards or
the reference's XLA observatories): `mesh`, `context_parallel`,
`pipeline_parallel`, `xla_obs`, `mesh_obs`, `trace_path`, `status_port`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Iterator

import torch

from solvingpapers_tpu_torch import ops
from solvingpapers_tpu_torch.checkpoint import CheckpointManager
from solvingpapers_tpu_torch.device import resolve_device
from solvingpapers_tpu_torch.metrics import ConsoleWriter, MetricsWriter
from solvingpapers_tpu_torch.metrics.mfu import chip_peak_flops
from solvingpapers_tpu_torch.train.optim import OptimizerConfig, make_optimizer
from solvingpapers_tpu_torch.train.state import TrainState

# loss_fn(model, batch, dropout_seed) -> (loss, aux dict of scalar tensors,
# the model's new non-trainable state {buffer name: tensor} or None)
LossFn = Callable[..., tuple[torch.Tensor, dict, dict | None]]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 1000
    batch_size: int = 32
    log_every: int = 50
    eval_every: int = 500
    eval_batches: int = 20
    ckpt_every: int = 0  # 0 = disabled
    checkpoint_dir: str | None = None
    keep_n: int = 3
    seed: int = 0
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    tokens_per_step: int | None = None  # enables tokens/sec + MFU metrics
    flops_per_token: float | None = None
    # the reference's mesh, parallelism and observability options; not
    # ported — a Trainer refuses a config that sets one
    mesh: dict | None = None
    context_parallel: bool = False
    pipeline_parallel: bool = False
    scan_steps: int = 1
    xla_obs: bool = False
    mesh_obs: bool = False
    trace_path: str | None = None
    status_port: int | None = None

    def unported(self) -> list[str]:
        """The set options this port does not run."""
        set_ = {
            "mesh": self.mesh is not None,
            "context_parallel": self.context_parallel,
            "pipeline_parallel": self.pipeline_parallel,
            "xla_obs": self.xla_obs,
            "mesh_obs": self.mesh_obs,
            "trace_path": self.trace_path is not None,
            "status_port": self.status_port is not None,
        }
        return [name for name, on in set_.items() if on]


def lm_loss_fn(model, batch, dropout_seed=None):
    """Default LM objective: next-token CE of batch['x'] -> batch['y'],
    the model's dropout (GPT's) drawn from `dropout_seed`."""
    logits, _ = model(batch["x"], dropout_seed=dropout_seed)
    loss = ops.cross_entropy(logits, batch["y"])  # auto-chunks at scale
    return loss, {"perplexity": torch.exp(loss)}, None


class Trainer:
    """``Trainer(model, config, loss_fn=lm_loss_fn, device=None)``: trains
    `model`, which must live on `device` (default ``cuda``; raises when
    there is none — see `device.resolve_device`)."""

    def __init__(self, model, config: TrainConfig, loss_fn: LossFn = lm_loss_fn,
                 device: str | torch.device | None = None):
        unported = config.unported()
        if unported:
            raise NotImplementedError(
                f"TrainConfig sets {unported}, which the port does not run "
                "(single device only: train the dense twin, "
                "configs.registry.dense_twin)")
        self.device = resolve_device(device)
        devices = {p.device for p in model.parameters()}
        if devices != {self.device}:
            raise ValueError(f"the model lives on {sorted(map(str, devices))}, "
                             f"the trainer on {self.device}")
        self.model = model
        self.config = config
        self.loss_fn = loss_fn

    # ------------------------------------------------------------ state

    def init_state(self) -> TrainState:
        """Fresh parameters from the reference's initializers (the model
        family's `init_params`, `models.init_params_for`), a fresh
        optimizer, step 0; the generator is seeded from `config.seed` and
        draws the parameters."""
        from solvingpapers_tpu_torch.models import init_params_for

        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.config.seed)
        init_params = init_params_for(self.model.cfg)
        self.model.load_state_dict(init_params(self.model.cfg, generator))
        optimizer, _ = make_optimizer(self.config.optimizer,
                                      self.model.parameters())
        return TrainState(step=0, model=self.model, optimizer=optimizer,
                          generator=generator)

    def _on_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    # ------------------------------------------------------------ steps

    def train_step(self, state: TrainState, batch: dict) -> dict:
        """One update; returns the step's metrics as device tensors (and
        the lr as a float) without waiting for the device."""
        model = state.model
        model.train()
        loss, aux, new_state = self.loss_fn(model, self._on_device(batch),
                                            state.step_seed())
        state.optimizer.zero_grad()
        loss.backward()
        grad_norm, lr = state.optimizer.step(state.step)
        if new_state:
            # after the backward, which may recompute (remat) blocks that
            # must read the state the forward read
            with torch.no_grad():
                for name, value in new_state.items():
                    model.get_buffer(name).copy_(value)
        state.step += 1
        return {"train_loss": loss.detach(), "grad_norm": grad_norm, "lr": lr,
                **{f"train_{k}": v.detach() for k, v in aux.items()}}

    @torch.no_grad()
    def evaluate(self, state: TrainState, eval_iter: Iterator[dict]) -> dict:
        """Mean of each eval metric over up to `eval_batches` batches."""
        model = state.model
        model.eval()
        acc: dict[str, float] = {}
        n = 0
        for i, batch in enumerate(eval_iter):
            if i >= self.config.eval_batches:
                break
            loss, aux, _ = self.loss_fn(model, self._on_device(batch), None)
            for k, v in {"val_loss": loss,
                         **{f"val_{k}": v for k, v in aux.items()}}.items():
                acc[k] = acc.get(k, 0.0) + float(v)
            n += 1
        model.train()
        return {k: v / max(n, 1) for k, v in acc.items()}

    # ------------------------------------------------------------ fit

    def fit(self, batch_iter: Iterator[dict],
            eval_iter_fn: Callable[[], Iterator[dict]] | None = None,
            writer: MetricsWriter | None = None,
            state: TrainState | None = None,
            callbacks: list[tuple[int, Callable]] | None = None) -> TrainState:
        """Train to `config.steps`, logging every `log_every` steps (and
        the last), evaluating every `eval_every`, calling each of
        `callbacks` ``[(every, fn(state, step))]`` every `every` steps,
        checkpointing every `ckpt_every` into `checkpoint_dir` and
        resuming from its newest checkpoint at the start; in windows of
        `scan_steps` steps (see the module's docstring). The first step,
        or window, is fenced out of the timing, and so are eval and the
        callbacks; their exceptions propagate."""
        cfg = self.config
        callbacks = list(callbacks or [])
        scan_k = max(cfg.scan_steps, 1)
        if scan_k > 1:
            cadences = [("log_every", cfg.log_every),
                        ("eval_every", cfg.eval_every),
                        ("ckpt_every", cfg.ckpt_every)]
            cadences += [(f"callbacks[{i}].every", every)
                         for i, (every, _) in enumerate(callbacks)]
            for nm, ev in cadences:
                if ev > 0 and ev % scan_k:
                    raise ValueError(
                        f"{nm}={ev} must be a multiple of scan_steps="
                        f"{scan_k}: the host only sees window boundaries")
        writer = writer or ConsoleWriter()
        if state is None:
            state = self.init_state()
        ckpt = None
        if cfg.checkpoint_dir and cfg.ckpt_every > 0:
            ckpt = CheckpointManager(cfg.checkpoint_dir, cfg.keep_n,
                                     cfg.ckpt_every)
            restored = ckpt.restore_latest(map_location=self.device)
            if restored is not None:
                state.load_state_dict(restored[0])
        start_step = state.step
        peak = chip_peak_flops(self.device) if cfg.flops_per_token else math.nan
        t_prev = time.perf_counter()
        last_log_step = start_step
        step = start_step
        while step < cfg.steps:
            # whole windows on window-aligned steps; single steps to
            # re-align after a resume and through the ragged tail, so
            # window ends stay multiples of scan_k
            kk = 1 if step % scan_k or step + scan_k > cfg.steps else scan_k
            end = step + kk
            for _ in range(kk):
                metrics = self.train_step(state, next(batch_iter))
            if step == start_step:
                # fence the first step or window (allocator warm-up,
                # kernel builds) out of the timed window, which starts here
                float(metrics["train_loss"])
                t_prev = time.perf_counter()
                last_log_step = end

            if cfg.eval_every > 0 and eval_iter_fn and end % cfg.eval_every == 0:
                float(metrics["train_loss"])  # train time is not eval time
                t_eval = time.perf_counter()
                writer.write(end, self.evaluate(state, eval_iter_fn()))
                t_prev += time.perf_counter() - t_eval

            due = [fn for every, fn in callbacks if every > 0 and end % every == 0]
            if due:
                float(metrics["train_loss"])  # train time is not callback time
                t_cb = time.perf_counter()
                for fn in due:
                    fn(state, end)
                t_prev += time.perf_counter() - t_cb

            if end % max(cfg.log_every, 1) == 0 or end == cfg.steps:
                row = {k: float(v) for k, v in metrics.items()}  # waits
                if step != start_step:
                    now = time.perf_counter()
                    dt = (now - t_prev) / max(end - last_log_step, 1)
                    t_prev, last_log_step = now, end
                    row["step_time_s"] = dt
                    if cfg.tokens_per_step:
                        row["tokens_per_sec"] = cfg.tokens_per_step / dt
                        row["tokens"] = end * cfg.tokens_per_step
                        if math.isfinite(peak):
                            row["mfu"] = (row["tokens_per_sec"]
                                          * cfg.flops_per_token / peak)
                writer.write(end, row)

            if ckpt is not None and end % ckpt.save_every == 0:
                float(metrics["train_loss"])
                t_save = time.perf_counter()
                ckpt.maybe_save(end, state.state_dict())
                t_prev += time.perf_counter() - t_save
            step = end
        if ckpt is not None:
            ckpt.maybe_save(state.step, state.state_dict(), force=True)
        return state
