"""The kernels' build, load and launch counts under two threads, as the
serving fleet (`serve/fleet.py`) runs them: one engine loop a replica,
in one process.

* `build.ensure_built` from two threads runs the compiler once, and each
  build writes its own temporary file (threads share a pid);
* a wrapper's first-use load (`flash_attention._library`) happens once;
* `build.count` loses no launch when many threads count at once.

No compiler runs here: a stand-in `nvcc` writes the library file.
"""

import ctypes
import importlib
import os
import sys
import threading
import time
import types

from solvingpapers_tpu_torch.kernels import build

flash = importlib.import_module("solvingpapers_tpu_torch.kernels.flash_attention")

FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(0.2)
open(out, "w").write("built")
"""


def test_concurrent_first_builds_compile_once(tmp_path, monkeypatch):
    csrc, log = tmp_path / "csrc", tmp_path / "nvcc.log"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a source")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "LIBRARIES", {"fake": "fake.cu"})
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    start = threading.Barrier(2)
    paths = []

    def first_use():
        start.wait()
        paths.append(build.ensure_built("fake"))

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    outputs = log.read_text().split()
    assert len(outputs) == 1, outputs  # the second thread found it built
    # <lib>.<pid>.<thread>.tmp: a file of this process and thread alone
    assert outputs[0].endswith(".tmp") and f".{os.getpid()}." in outputs[0]
    assert paths[0] == paths[1]
    assert paths[0].read_text() == "built"
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_a_library_loads_once_under_two_threads(monkeypatch):
    loads = []

    def slow_cdll(path):
        loads.append(path)
        time.sleep(0.05)  # a window for the other thread to race into
        return types.SimpleNamespace(flash_fwd=types.SimpleNamespace())

    monkeypatch.setattr(flash, "_lib", None)
    monkeypatch.setattr(build, "ensure_built", lambda name: f"/lib{name}.so")
    monkeypatch.setattr(ctypes, "CDLL", slow_cdll)
    start = threading.Barrier(2)
    libs = []

    def first_launch():
        start.wait()
        libs.append(flash._library())

    threads = [threading.Thread(target=first_launch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert loads == ["/libflash_fwd.so"]
    assert libs[0] is libs[1] and libs[0].flash_fwd.restype is ctypes.c_int


def test_launch_counts_are_exact_under_many_threads():
    """More counting threads than cores, switching as often as the
    interpreter allows: a lost update would leave the count short."""
    def kernel():
        pass

    kernel.launches = 0
    n, workers = 5_000, 2 * (os.cpu_count() or 4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [build.count(kernel)
                                                    for _ in range(n)])
                   for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == workers * n


def test_a_loaded_library_is_read_without_the_lock(monkeypatch):
    """A warm launch takes no build lock: with another thread holding it
    (a first build of another library, say), `_library` still returns."""
    lib = types.SimpleNamespace()
    monkeypatch.setattr(flash, "_lib", lib)
    held, done = threading.Event(), threading.Event()

    def builder():
        with build.lock:
            held.set()
            done.wait(30)

    t = threading.Thread(target=builder)
    t.start()
    try:
        assert held.wait(30)
        got = []
        reader = threading.Thread(target=lambda: got.append(flash._library()))
        reader.start()
        reader.join(timeout=5)
        assert not reader.is_alive() and got == [lib]
    finally:
        done.set()
        t.join(timeout=30)
