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

Gradient accumulation (the reference's ``optax.MultiSteps``) is not
ported: ``accum_steps > 1`` raises.
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
    the schedule gives at the count before the update."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: OptimizerConfig, schedule: Schedule):
        self.params = list(params)
        self.grad_clip = cfg.grad_clip
        self.schedule = schedule
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
        """One update at step `count`; returns (the global norm of the
        UNCLIPPED gradients as a float32 tensor, the lr used). Nothing
        here waits for the device."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.nn.utils.get_total_norm(grads)
        if self.grad_clip > 0:
            # optax: where(norm < max, g, g / norm * max)
            scale = torch.where(norm < self.grad_clip, 1.0,
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        lr = float(self.schedule(count))
        for group in self.torch_opt.param_groups:
            group["lr"] = lr
        self.torch_opt.step()
        return norm, lr

    def state_dict(self) -> dict:
        return self.torch_opt.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.torch_opt.load_state_dict(state)


def make_optimizer(cfg: OptimizerConfig, params: Iterable[torch.nn.Parameter]
                   ) -> tuple[Optimizer, Schedule]:
    """(optimizer over `params`, its schedule) for `cfg`."""
    if cfg.accum_steps > 1:
        raise NotImplementedError(
            "gradient accumulation (accum_steps > 1) is not ported yet "
            "(ROADMAP A2, the training queue)")
    schedule = warmup_cosine(cfg.max_lr, cfg.warmup_steps, cfg.total_steps,
                             cfg.min_lr_ratio)
    return Optimizer(params, cfg, schedule), schedule
