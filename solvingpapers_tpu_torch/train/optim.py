"""Optimizer construction (port of `solvingpapers_tpu/train/optim.py`).

The reference builds an optax chain — ``clip_by_global_norm`` then
AdamW, Adam or SGD under a warmup-cosine schedule. The port keeps
optax's semantics where torch's own helpers differ:

* the global-norm clip scales the gradients by ``max / norm`` only when
  ``norm >= max`` (``torch.nn.utils.clip_grad_norm_`` always scales, by
  ``max / (norm + 1e-6)``, so it is not used);
* AdamW decays every parameter, norms and embeddings included, by
  ``lr * weight_decay`` — the update `torch.optim.AdamW` makes;
* the learning rate of an update is the schedule at the step count
  BEFORE it (step 0's warmup lr is exactly 0);
* the schedules are optax's formulas (`warmup_cosine`).

Gradient accumulation (``accum_steps = k > 1``) is the reference's
``optax.MultiSteps`` around that chain: every call folds its gradients
into a running mean (Welford's ``acc + (g - acc) / (n + 1)``), and only
every k-th call runs the chain — clip, then the optimizer — on the
mean; the other calls leave the parameters as they are. The schedule
and AdamW's count advance once per emitted update, not per call. A
partial window's mean waits in the state (and its checkpoints) for the
calls that complete it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | sgd | adam
    max_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 0
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    accum_steps: int = 1


def _cosine_decay(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule."""
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine(max_lr: float, warmup_steps: int, total_steps: int,
                  min_lr_ratio: float = 0.1) -> Schedule:
    """Linear warmup from 0 then cosine decay to min_lr_ratio·max_lr:
    optax's ``warmup_cosine_decay_schedule`` (or, without warmup,
    ``cosine_decay_schedule``), as the reference builds them."""
    if warmup_steps <= 0:
        return _cosine_decay(max_lr, max(total_steps, 1), min_lr_ratio)
    end_value = max_lr * min_lr_ratio
    alpha = 0.0 if max_lr == 0.0 else end_value / max_lr
    decay = _cosine_decay(max_lr,
                          max(total_steps, warmup_steps + 1) - warmup_steps,
                          alpha)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            # optax.linear_schedule(0 -> max_lr): (init - end) * frac + end
            frac = 1 - max(count, 0) / warmup_steps
            return -max_lr * frac + max_lr
        return decay(count - warmup_steps)

    return schedule


class Optimizer:
    """The reference's optax chain over a model's parameters: read each
    parameter's ``.grad``, clip by global norm, then update with the lr
    the schedule gives at the count before the update; with
    ``accum_steps > 1`` under ``optax.MultiSteps`` (see the module's
    docstring)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: OptimizerConfig, schedule: Schedule):
        self.params = list(params)
        self.grad_clip = cfg.grad_clip
        self.schedule = schedule
        if cfg.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {cfg.accum_steps}")
        self.accum_steps = cfg.accum_steps
        # MultiSteps' state: calls folded into the running mean, updates
        # emitted (the schedule's count), the mean itself
        self.mini_step = 0
        self.updates = 0
        self.acc = None
        if cfg.name == "adamw":
            self.torch_opt = torch.optim.AdamW(
                self.params, lr=0.0, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
                weight_decay=cfg.weight_decay)
        elif cfg.name == "adam":
            self.torch_opt = torch.optim.Adam(
                self.params, lr=0.0, betas=(cfg.b1, cfg.b2), eps=cfg.eps)
        elif cfg.name == "sgd":
            self.torch_opt = torch.optim.SGD(self.params, lr=0.0)
        else:
            raise ValueError(f"unknown optimizer {cfg.name!r}")

    def zero_grad(self) -> None:
        self.torch_opt.zero_grad(set_to_none=True)

    def step(self, count: int) -> tuple[torch.Tensor, float]:
        """One call at step `count`; returns (the global norm of this
        call's UNCLIPPED gradients as a float32 tensor, the lr the
        reference logs: the schedule at `count`). Without accumulation
        that lr is the update's; with it the update, when this call
        emits one, takes the schedule at the count of updates emitted
        before it. Nothing here waits for the device."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.nn.utils.get_total_norm(grads)
        logged = float(self.schedule(count))
        if self.accum_steps > 1:
            if not self._accumulate():
                return norm, logged
            lr = float(self.schedule(self.updates))
            grads = [p.grad for p in self.params]
            self._clip(grads, torch.nn.utils.get_total_norm(grads))
        else:
            lr = logged
            self._clip(grads, norm)
        for group in self.torch_opt.param_groups:
            group["lr"] = lr
        self.torch_opt.step()
        if self.accum_steps > 1:
            self.updates += 1
            for a in self.acc:
                a.zero_()
        return norm, logged

    def _clip(self, grads, norm) -> None:
        if self.grad_clip > 0:
            # optax: where(norm < max, g, g / norm * max)
            scale = torch.where(norm < self.grad_clip, 1.0,
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)

    def _accumulate(self) -> bool:
        """Fold this call's gradients (a missing one counts as zeros, as
        JAX's are) into the running mean; on the k-th call put the mean
        in every ``.grad`` and return True."""
        if self.acc is None:
            self.acc = [torch.zeros_like(p) for p in self.params]
        # a float32 tensor divisor: a Python one is multiplied in as its
        # reciprocal on CUDA, where optax divides
        n = torch.tensor(self.mini_step + 1, dtype=torch.float32,
                         device=self.acc[0].device)
        for p, a in zip(self.params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(a)
            a.add_((g - a) / n)
        self.mini_step = (self.mini_step + 1) % self.accum_steps
        if self.mini_step:
            return False
        for p, a in zip(self.params, self.acc):
            if p.grad is None:
                p.grad = a.clone()
            else:
                p.grad.copy_(a)
        return True

    def state_dict(self) -> dict:
        state = self.torch_opt.state_dict()
        if self.accum_steps > 1:
            state["accum"] = {"mini_step": self.mini_step,
                              "updates": self.updates, "acc": self.acc}
        return state

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        accum = state.pop("accum", None)
        if (accum is None) != (self.accum_steps == 1):
            raise ValueError("the checkpoint's optimizer state was saved with "
                             "another accum_steps setting")
        self.torch_opt.load_state_dict(state)
        if accum is not None:
            self.mini_step = int(accum["mini_step"])
            self.updates = int(accum["updates"])
            self.acc = (None if accum["acc"] is None else
                        [a.to(p.device) for p, a in zip(self.params,
                                                        accum["acc"])])


def make_optimizer(cfg: OptimizerConfig, params: Iterable[torch.nn.Parameter]
                   ) -> tuple[Optimizer, Schedule]:
    """(optimizer over `params`, its schedule) for `cfg`."""
    schedule = warmup_cosine(cfg.max_lr, cfg.warmup_steps, cfg.total_steps,
                             cfg.min_lr_ratio)
    return Optimizer(params, cfg, schedule), schedule
