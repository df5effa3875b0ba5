"""Native (C++) host hot paths, bound through ctypes (port of
`solvingpapers_tpu/native`).

Tokenization and the batch gather that feeds the device, as compiled
host code: the byte-level BPE merge-loop encoder and its incremental
trainer (`data/bpe.py`), and the window gather of memory-mapped token
files (`data/batches.py`). `_src/native.cpp` is the reference's source,
unchanged; it is host C++ for the CPU, not a device kernel.

The shared library is built with `g++` at first use into `native/build/`
(listed in `.gitignore`). Its file name carries a hash of the source and
the flags, so an edited source is never served by a stale build, and
the build writes a temporary file and renames it into place, so
concurrent builders (test workers, several processes) never load a
half-written library.

A failed build raises `NativeBuildError` with the compiler's message:
nothing falls back quietly. The pure-Python tokenizer and gather are the
plain versions; they run only when the caller asks for them by name —
an argument (``native=False``) or the environment variable
``SOLVINGPAPERS_TPU_TORCH_NO_NATIVE=1`` (`use_native`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "_src" / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
# set to a non-empty value to run the plain Python paths instead
NO_NATIVE_ENV = "SOLVINGPAPERS_TPU_TORCH_NO_NATIVE"

_lock = threading.Lock()
_lib = None

_DTYPE_CODES = {
    np.dtype(np.uint16): 0,
    np.dtype(np.uint32): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.uint8): 3,
    np.dtype(np.int64): 4,
}


class NativeBuildError(RuntimeError):
    """The native library did not build or load; carries the compiler's
    (or the loader's) message."""


def use_native(native: bool | None) -> bool:
    """Whether a consumer runs the native path: an explicit argument
    wins; None means native unless ``SOLVINGPAPERS_TPU_TORCH_NO_NATIVE``
    is set."""
    if native is None:
        return not os.environ.get(NO_NATIVE_ENV)
    return bool(native)


def library_path() -> Path:
    """Where the library lives once built (hashed over source and flags)."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `_src/native.cpp` if it is not built yet; returns the
    library's path. Raises NativeBuildError with the compiler's output."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no g++ on PATH
        raise NativeBuildError(f"native build failed: {e}") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"native build failed (g++ exit {proc.returncode}):\n"
            f"{proc.stderr or proc.stdout}")
    os.replace(tmp, path)  # atomic under concurrent builders
    return path


def load():
    """The loaded library, building it on first use (thread-safe).
    Raises NativeBuildError when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except OSError as e:
            raise NativeBuildError(f"native library failed to load: {e}") from None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.bpe_ctx_new.restype = ctypes.c_void_p
        lib.bpe_ctx_new.argtypes = [i32p, i32p, i32p, i32p, ctypes.c_int64]
        lib.bpe_ctx_free.argtypes = [ctypes.c_void_p]
        lib.bpe_encode.restype = ctypes.c_int64
        lib.bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), i64p,
            ctypes.c_int64, i32p, ctypes.c_int64, i32p, ctypes.c_int32,
        ]
        lib.bpe_train.restype = ctypes.c_int64
        lib.bpe_train.argtypes = [
            i32p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, i32p, i32p,
        ]
        lib.gather_windows.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i64p, ctypes.c_int64,
            ctypes.c_int64, i32p, i32p, ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeBpeEncoder:
    """Merge-loop encoder over a fixed merge table (ids, not strings).

    byte_to_id: (256,) initial symbol id per byte; merges: (n, 3) array of
    (left_id, right_id, merged_id) in rank order.
    """

    def __init__(self, byte_to_id, merges):
        lib = load()
        self._lib = lib
        merges = np.asarray(merges, dtype=np.int32).reshape(-1, 3)
        b2i = _as_i32(byte_to_id)
        if b2i.shape != (256,):
            raise ValueError("byte_to_id must have shape (256,)")
        lefts = np.ascontiguousarray(merges[:, 0])
        rights = np.ascontiguousarray(merges[:, 1])
        merged = np.ascontiguousarray(merges[:, 2])
        self._ctx = lib.bpe_ctx_new(
            _ptr(b2i, ctypes.c_int32), _ptr(lefts, ctypes.c_int32),
            _ptr(rights, ctypes.c_int32), _ptr(merged, ctypes.c_int32),
            len(merges),
        )
        self._chunk_cache: dict[str, np.ndarray] = {}
        self._cache_limit = 1_000_000

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.bpe_ctx_free(ctx)
            self._ctx = None

    def encode_chunks(self, data: bytes, offsets: np.ndarray,
                      n_threads: int | None = None,
                      counts_out: np.ndarray | None = None) -> np.ndarray:
        """Encode chunks data[offsets[i]:offsets[i+1]] -> flat int32 ids.
        If counts_out (int32, n_chunks) is given it receives per-chunk
        token counts."""
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        n_chunks = len(offsets) - 1
        if n_chunks <= 0:
            return np.empty(0, np.int32)
        if n_threads is None:
            n_threads = min(os.cpu_count() or 1, 16)
        buf = np.frombuffer(data, dtype=np.uint8)
        cap = max(int(offsets[-1]), 16)
        out = np.empty(cap, np.int32)
        counts_ptr = (
            _ptr(counts_out, ctypes.c_int32) if counts_out is not None else None
        )
        n = self._lib.bpe_encode(
            self._ctx, _ptr(buf, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
            n_chunks, _ptr(out, ctypes.c_int32), cap, counts_ptr, n_threads,
        )
        if n < 0:  # pragma: no cover - cap == total bytes always suffices
            out = np.empty(-n, np.int32)
            n = self._lib.bpe_encode(
                self._ctx, _ptr(buf, ctypes.c_uint8),
                _ptr(offsets, ctypes.c_int64), n_chunks,
                _ptr(out, ctypes.c_int32), -n, counts_ptr, n_threads,
            )
        return out[:n].copy()

    def encode_texts(self, chunks: list[str]) -> np.ndarray:
        """Encode pre-split text chunks with per-unique-chunk caching (the
        native analogue of ByteBPETokenizer._bpe's memo): only novel chunks
        hit the C++ merge loop; repeats are concatenated from the cache."""
        cache = self._chunk_cache
        novel = [c for c in dict.fromkeys(chunks) if c not in cache]
        if novel:
            raw = [c.encode("utf-8") for c in novel]
            offsets = np.zeros(len(raw) + 1, np.int64)
            np.cumsum([len(r) for r in raw], out=offsets[1:])
            counts = np.empty(len(raw), np.int32)
            flat = self.encode_chunks(b"".join(raw), offsets, counts_out=counts)
            bounds = np.zeros(len(raw) + 1, np.int64)
            np.cumsum(counts, out=bounds[1:])
            for i, c in enumerate(novel):
                cache[c] = flat[bounds[i]:bounds[i + 1]]
        if not chunks:
            return np.empty(0, np.int32)
        # resolve before any eviction: this call may reference chunks
        # cached by earlier calls, which the growth guard may drop
        out = np.concatenate([cache[c] for c in chunks])
        if len(cache) > self._cache_limit:  # unbounded growth guard
            cache.clear()
            for i, c in enumerate(novel):
                cache[c] = flat[bounds[i]:bounds[i + 1]]
        return out


def bpe_train_native(words_flat, offsets, freqs, n_merges_target: int,
                     min_pair_count: int = 2) -> np.ndarray:
    """Run the incremental BPE trainer; returns (n, 2) (left_id, right_id)
    merges in rank order, merged ids being 256+rank."""
    lib = load()
    words_flat = _as_i32(words_flat)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    freqs = np.ascontiguousarray(freqs, dtype=np.int64)
    n_words = len(offsets) - 1
    out_l = np.empty(max(n_merges_target, 1), np.int32)
    out_r = np.empty(max(n_merges_target, 1), np.int32)
    n = lib.bpe_train(
        _ptr(words_flat, ctypes.c_int32), _ptr(offsets, ctypes.c_int64),
        _ptr(freqs, ctypes.c_int64), n_words, n_merges_target,
        min_pair_count, _ptr(out_l, ctypes.c_int32),
        _ptr(out_r, ctypes.c_int32),
    )
    return np.stack([out_l[:n], out_r[:n]], axis=1)


def gather_windows_native(
    tokens: np.ndarray, starts: np.ndarray, block_size: int,
    x_out: np.ndarray | None = None, y_out: np.ndarray | None = None,
    n_threads: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) int32 windows of `tokens` at `starts` — the native twin of
    the numpy crop in `data.batches.lm_batch_iterator`'s memmap branch
    (y is x shifted by one)."""
    code = _DTYPE_CODES.get(np.dtype(tokens.dtype))
    if code is None:
        raise ValueError(f"unsupported token dtype {tokens.dtype}")
    if not tokens.flags["C_CONTIGUOUS"]:
        raise ValueError(
            "gather_windows_native needs a C-contiguous token array "
            "(a strided view's base pointer would be misread)"
        )
    lib = load()
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    batch = len(starts)
    if x_out is None:
        x_out = np.empty((batch, block_size), np.int32)
    if y_out is None:
        y_out = np.empty((batch, block_size), np.int32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    lib.gather_windows(
        ctypes.c_void_p(tokens.ctypes.data), code,
        _ptr(starts, ctypes.c_int64), batch, block_size,
        _ptr(x_out, ctypes.c_int32), _ptr(y_out, ctypes.c_int32), n_threads,
    )
    return x_out, y_out
