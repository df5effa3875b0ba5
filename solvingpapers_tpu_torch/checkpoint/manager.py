"""Checkpoint manager (port of `solvingpapers_tpu/checkpoint/manager.py`).

Periodic and final saves of the full training state (model, optimizer,
step, generator) with `keep_n` retention and restore-latest at start,
plus a params-only export. Each checkpoint is one `torch.save` file,
``step_<N>.pt``, written to a temporary name and renamed into place, so
a crash mid-write never leaves a truncated checkpoint where
`restore_latest` would find it. Saves block (the reference's Orbax
saves can run in a background thread; not ported).
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, save_every: int = 1000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_n = keep_n
        self.save_every = save_every

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := _NAME.match(name)))

    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save `state` (a picklable tree of tensors, e.g.
        `TrainState.state_dict()`) at `step` when the cadence says so or
        `force`; a step already saved is not written again. Keeps the
        newest `keep_n`."""
        if not force and (self.save_every <= 0 or step % self.save_every):
            return False
        if step in self.all_steps():
            return False
        _atomic_save(state, self._path(step))
        if self.keep_n > 0:
            for old in self.all_steps()[:-self.keep_n]:
                os.remove(self._path(old))
        return True

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, map_location=None) -> tuple[Any, int] | None:
        """(state, step) of the newest checkpoint, or None when there is
        none."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True), step


def restore_for_inference(model: torch.nn.Module, directory: str) -> int | None:
    """Load the newest checkpoint's model state in `directory` — the
    parameters and the buffers (DeepSeek-V3's routing biases) — onto
    `model`, built for sampling or evaluation; a model that stores its
    weights in the compute dtype gets each float32 master weight rounded
    once, as a forward would round it. Returns the checkpoint's step, or
    None when there is none (a missing directory included). The
    reference's `cli._restore_for_inference`."""
    if not os.path.isdir(directory):
        return None
    restored = CheckpointManager(directory, save_every=0).restore_latest(
        map_location=next(model.parameters()).device)
    if restored is None:
        return None
    state, step = restored
    model.load_state_dict(state["model"])
    return step


def export_params(path: str, params: dict[str, torch.Tensor]) -> None:
    """Params-only export: a model's state dict, written atomically."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    _atomic_save(dict(params), path)


def load_params(path: str, map_location=None) -> dict[str, torch.Tensor]:
    return torch.load(path, map_location=map_location, weights_only=True)
