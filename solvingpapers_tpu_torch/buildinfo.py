"""Process identity for the bench provenance stamp: versions, git sha,
device (port of `solvingpapers_tpu/buildinfo.py`).

The serving bench (`serve/bench.py`) stamps every result with these
facts, so an entry stays identifiable after a rebase: which build, which
torch and CUDA, which card. The reference reports `jax` and `jaxlib`;
the port reports `torch` and `cuda` (the CUDA version torch was built
for, None on a CPU build), and `device_kind` is the card's name from
`torch.cuda.get_device_name`, or "cpu" without a card.

`build_info()` is cached after the first call and never raises: a
missing git binary, a tarball install, or a CPU-only torch degrade to
None or "cpu" fields. The reference's pid, start time, device count and
uptime serve its /statusz, which the port does not have.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

__all__ = ["build_info", "git_sha"]


@functools.lru_cache(maxsize=1)
def git_sha() -> str | None:
    """The repo HEAD this process is running from, or None when the
    package runs outside a git checkout (wheel/tarball installs)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    sha = out.stdout.strip()
    return sha or None


@functools.lru_cache(maxsize=1)
def build_info() -> dict:
    """git sha, python, torch and CUDA versions, platform ("cuda" or
    "cpu") and device kind (the card's name, or "cpu")."""
    import torch

    info: dict = {
        "git_sha": git_sha(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    try:
        on_card = torch.cuda.is_available()
        info["platform"] = "cuda" if on_card else "cpu"
        info["device_kind"] = torch.cuda.get_device_name(0) if on_card else "cpu"
    except Exception:  # noqa: BLE001 — a broken CUDA install must not raise here
        info["platform"] = None
        info["device_kind"] = None
    return info
