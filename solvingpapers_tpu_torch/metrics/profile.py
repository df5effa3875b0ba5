"""The profiler window of `Trainer` and `ServeEngine` (`profile_dir`,
`profile_steps`): a `torch.profiler.profile` open over steps [start,
stop), written as a Chrome trace when it closes (the port of the
reference's `jax.profiler.start_trace` / `stop_trace` window; open the
file in Perfetto or chrome://tracing).

`ProfileWindow.tick(step)` keeps the reference's order: it closes a
window whose stop has come BEFORE it checks the start, so a window that
fits inside one host step never opens and closes empty in the same call.
It records CPU activity, and CUDA activity on the card.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_NULL_SCOPE = contextlib.nullcontext()


class ProfileWindow:
    """One profiler window over steps [`steps[0]`, `steps[1]`); its trace
    goes to ``<directory>/<stem>.<pid>.<ns>.pt.trace.json`` (`path`, once
    written). The window opens at most once."""

    def __init__(self, directory: str, steps: tuple[int, int],
                 device: torch.device, stem: str):
        self.directory = directory
        self.start, self.stop_at = steps
        self.device = device
        self.stem = stem
        self.path: str | None = None
        self.done = False
        self._prof = None

    @property
    def is_open(self) -> bool:
        return self._prof is not None

    def tick(self, step: int) -> None:
        """Close the window at `stop_at`, then open it at `start`."""
        if self._prof is not None and step >= self.stop_at:
            self.close()
        if self._prof is None and not self.done and step >= self.start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()

    def close(self) -> None:
        """Stop an open window and write its trace (idempotent)."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        self.done = True
        prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(
            self.directory,
            f"{self.stem}.{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(self.path)


def scope(window: ProfileWindow | None, name: str):
    """`torch.profiler.record_function(name)` when a profiler window is
    configured (the label shows in its trace), a shared no-op context
    otherwise."""
    if window is None:
        return _NULL_SCOPE
    return torch.profiler.record_function(name)
