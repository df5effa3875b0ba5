"""Builds the port's CUDA kernels from the sources in this checkout.

Each library is one `.cu` file under `csrc/` with a plain C interface,
compiled by `nvcc` for sm_90a into a shared object that `ctypes` loads
(no PyTorch headers, so a build takes seconds, not minutes). Builds
happen at first use — or all at once, in parallel, through `build_all` —
into `kernels/build/` (listed in `.gitignore`). A library's file name
carries a hash of its source and flags, so an edited source is never
served by a stale build.

Nothing here runs at import time: the CPU test box has no `nvcc`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# library name -> its single source file under csrc/
LIBRARIES = {
    "flash_fwd": "flash_fwd.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the log
]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the port's kernels are built from source on the machine with "
            "the card"
        )
    return nvcc


def library_path(name: str) -> Path:
    """Where library `name` lives once built (source- and flag-hashed)."""
    src = CSRC / LIBRARIES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Build every library in `names` (default: all) that is not built
    yet, one `nvcc` process per source, all started together. Returns
    {name: {"path", "seconds", "log"}}; raises RuntimeError naming the
    library and the compiler's output when a build fails."""
    names = list(LIBRARIES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, dict] = {}
    running = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": path, "seconds": 0.0, "log": "(cached)"}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / LIBRARIES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, path, time.perf_counter())
    errors = []
    for name, (proc, tmp, path, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": path, "seconds": seconds, "log": log}
    if errors:
        raise RuntimeError("kernel build failed: " + "\n".join(errors))
    return out


def ensure_built(name: str) -> Path:
    """Path of library `name`, building it first if needed."""
    return build_all([name])[name]["path"]
