"""Builds the port's CUDA kernels from the sources in this checkout.

Each library is one `.cu` file under `csrc/` with a plain C interface,
compiled by `nvcc` for sm_90a into a shared object that `ctypes` loads
(no PyTorch headers, so a build takes seconds, not minutes). Builds
happen at first use — or all at once, in parallel, through `build_all` —
into `kernels/build/` (listed in `.gitignore`). A library's file name
carries a hash of its source, of every header under `csrc/` and of the
flags, so an edited source or shared header (`philox.cuh`) is never
served by a stale build.

Builds and loads are serialized by `lock`, and launch counts go through
`count`: the serving fleet (serve/fleet.py) launches kernels from several
engine-loop threads of one process, whose first launches may race. A
loaded library is read without the lock (it is published only once its
entry points are typed). The launchers' `static bool configured` flags
(csrc/flash_fwd.cu, csrc/flash_bwd.cu) may be read and set by two
threads at once. That race is harmless: a thread that reads the flag
unset sets the kernel's attributes itself before its launch (setting the
same value twice is allowed), and the flag is set only after a
`cudaFuncSetAttribute` that returned.

Nothing here runs at import time: the CPU test box has no `nvcc`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# library name -> its single source file under csrc/
LIBRARIES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd": "flash_bwd.cu",
    "dropout_mask": "dropout_mask.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the log
]


# held across a build and a library's first load: threads of one process
# share a pid, so without it two first launches would write one temporary
# file and load half-written libraries
lock = threading.RLock()
_count_lock = threading.Lock()


def count(fn) -> None:
    """Add one to a kernel wrapper's ``launches``. A bare ``+=`` reads and
    writes the attribute in two steps, so two threads launching at once
    could lose a launch; the lock makes the count exact."""
    with _count_lock:
        fn.launches += 1


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
    """Where library `name` lives once built (hashed over its source,
    every header a source may include, and the flags)."""
    digest = hashlib.sha256((CSRC / LIBRARIES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Build every library in `names` (default: all) that is not built
    yet, one `nvcc` process per source, all started together. Returns
    {name: {"path", "seconds", "log"}}; raises RuntimeError naming the
    library and the compiler's output when a build fails."""
    names = list(LIBRARIES) if names is None else list(names)
    with lock:
        return _build(names)


def _build(names) -> dict[str, dict]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, dict] = {}
    running = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": path, "seconds": 0.0, "log": "(cached)"}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
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
