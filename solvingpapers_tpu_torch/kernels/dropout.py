"""The port's dropout keep function and the dropout built on it: the
`dropout_mask` and `dropout_apply` kernels (two modes of one source,
`csrc/dropout_mask.cu`) and their plain PyTorch versions.

What it replaces: `_dropout_keep` and the tile uid `_uid` of
`solvingpapers_tpu/kernels/flash_attention.py` (lines 60-70, 128-131),
drawn inside the three Pallas flash kernels, and the test-only
`mask_kernel` that reads that mask out (`tests/test_flash_dropout_tpu.py`,
pallas_call at line 120). The TPU's hardware random bits depend on the
tile sizes and cannot be reproduced, so the port defines one
counter-based keep function instead (see `csrc/philox.cuh`):

    keep(seed, bh, row, col) = word(seed, bh, row, col) < threshold

with the reference's ``threshold = min(int((1 - rate) * 2**32), 2**32 - 1)``
and `word` one output of Philox4x32-10 with key (seed low, seed high) and
counter ``(row & ~8, col & ~8, bh, 0)``; the element takes word
``2 * bit3(row) + bit3(col)``. The flash kernels, this module's plain
version (uint32 arithmetic carried in int64) and the `dropout_mask` kernel
all compute it, so `use_flash` on and off, the CPU and the card apply the
same mask at the same seed, and a recomputation (remat) redraws it.

`dropout_mask` writes the mask (the dense attention paths' probability
mask); `dropout` applies it in one pass, ``keep ? x / (1 - rate) : 0``
(Flax's `nn.Dropout`), as a `torch.autograd.Function` whose backward is
the same map on the gradient. Each kernel's wrapper launches it on a
CUDA device and counts it in ``.launches``; on the CPU it computes its
plain version (`dropout_keep_reference`, `dropout_apply_reference`),
which counts its calls in ``.calls``. There is no fallback between the
two. The division is IEEE float32 division by ``float32(1 - rate)`` on
both: PyTorch on a CUDA tensor turns division by a Python scalar into
multiplication by its reciprocal, one ulp off in places, so the plain
version divides by a float32 tensor; the kernel forms the same correctly
rounded quotient from ``float32(1 - rate)`` and its float32 reciprocal
(`apply_args`) without a division on its fast path.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from solvingpapers_tpu_torch.kernels import build

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_GRID_MAX = 65535

# the dtype codes every C entry point of the port takes, and the largest
# index its int32 arithmetic holds
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT32_MAX = 2**31 - 1

_lib = None  # the loaded mask library, built at first CUDA use


def _library():
    global _lib
    if _lib is not None:  # warm: a launch takes no lock here
        return _lib
    with build.lock:  # one build and load, whichever thread comes first
        if _lib is None:
            lib = ctypes.CDLL(str(build.ensure_built("dropout_mask")))
            lib.dropout_mask.argtypes = [ctypes.c_uint64, ctypes.c_uint32] + [
                ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
            lib.dropout_mask.restype = ctypes.c_int
            # (dtype, seed, threshold, d, 1 / d, BH, Sq, Skv, x, y, stream)
            lib.dropout_apply.argtypes = [ctypes.c_int, ctypes.c_uint64,
                                          ctypes.c_uint32, ctypes.c_float,
                                          ctypes.c_float] + [
                ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
            lib.dropout_apply.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_region(bh: int, sq: int, skv: int) -> None:
    """A (bh, sq, skv) region the kernels' grid covers: bh blocks along y,
    each bh's 2 x 16 strips in int32."""
    strips = (sq + 15) // 16 * 8 * ((skv + 15) // 16)
    if bh > _GRID_MAX or strips > INT32_MAX:
        raise ValueError(f"region out of the dropout kernels' range: "
                         f"({bh}, {sq}, {skv})")


def check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")


def keep_threshold(rate: float) -> int:
    """The uint32 threshold below which a word keeps its element: the
    reference's ``min(int((1 - rate) * 2**32), 2**32 - 1)``."""
    check_rate(rate)
    return min(int((1.0 - rate) * 4294967296.0), 4294967295)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for int64 `a` in [0, 2**32) and a
    32-bit constant `m`, in int64 without overflow (16-bit limbs of m)."""
    x = a * (m & 0xFFFF)  # < 2**48
    y = a * (m >> 16)  # < 2**48
    t = x + ((y & 0xFFFF) << 16)
    return (t >> 32) + (y >> 16), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Random123) on int64 tensors holding uint32 values,
    broadcast together; the key is two Python ints. Returns 4 tensors."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _group_firsts(n: int, device) -> torch.Tensor:
    """First element of every 2x2-group index along an axis of n:
    (g // 8) * 16 + g % 8 for g < ceil(n / 16) * 8, as int64."""
    g = torch.arange((n + 15) // 16 * 8, device=device)
    return (g // 8) * 16 + g % 8


def dropout_keep_reference(seed: int, rate: float, bh: int, sq: int, skv: int,
                           *, bh_start: int = 0,
                           device: str | torch.device | None = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of the keep function: a bool (bh, sq, skv)
    tensor, element [i, r, c] = keep(seed, bh_start + i, r, c)."""
    dropout_keep_reference.calls += 1
    thr = keep_threshold(rate)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    rows = _group_firsts(sq, device)
    cols = _group_firsts(skv, device)
    heads = torch.arange(bh_start, bh_start + bh, device=device)
    words = philox4x32_10(rows[None, :, None], cols[None, None, :],
                          heads[:, None, None], torch.zeros((), dtype=torch.long,
                                                            device=device),
                          seed & _MASK32, seed >> 32)
    nr, nc = rows.numel() // 8, cols.numel() // 8
    # word 2i + h of group (row, col) is element (row + 8i, col + 8h)
    w = torch.stack([x.expand(bh, nr * 8, nc * 8) for x in words]) < thr
    w = w.view(2, 2, bh, nr, 8, nc, 8).permute(2, 3, 0, 4, 5, 1, 6)
    return w.reshape(bh, nr * 16, nc * 16)[:, :sq, :skv]


dropout_keep_reference.calls = 0


def dropout_mask(seed: int, rate: float, bh: int, sq: int, skv: int,
                 device: str | torch.device) -> torch.Tensor:
    """The keep mask of (seed, rate) over a (bh, sq, skv) region as a bool
    tensor on `device`: the sm_90a `dropout_mask` kernel on a CUDA device
    (raises if the build or the launch fails), the plain version on the
    CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return dropout_keep_reference(seed, rate, bh, sq, skv, device=device)
    if device.type != "cuda":
        raise ValueError(f"dropout_mask runs on a CUDA device or the CPU, got "
                         f"{device}")
    thr = keep_threshold(rate)
    out = torch.empty((bh, sq, skv), dtype=torch.uint8, device=device)
    if bh * sq * skv == 0:
        return out.bool()
    _check_region(bh, sq, skv)
    lib = _library()
    with torch.cuda.device(device):
        err = lib.dropout_mask(int(seed) & 0xFFFFFFFFFFFFFFFF, thr, bh, sq, skv,
                               out.data_ptr(),
                               torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout_mask kernel launch failed: CUDA error {err}")
    build.count(dropout_mask)
    return out.view(torch.bool)


dropout_mask.launches = 0


def _region(x: torch.Tensor) -> tuple[int, int, int]:
    """(leading slices, S, D) of `x` (..., S, D): the keep function's
    (bh, row, col) axes."""
    s, d = x.shape[-2], x.shape[-1]
    return x.numel() // max(s * d, 1), s, d


def dropout_apply_reference(x: torch.Tensor, rate: float,
                            seed: int) -> torch.Tensor:
    """Plain PyTorch version of the `dropout_apply` kernel:
    ``where(keep, float(x) / float32(1 - rate), 0)`` in x's dtype, with
    element (..., s, d) of the b-th leading slice kept iff keep(seed, b, s,
    d). On the CPU this is bit for bit ``torch.where(keep, x / (1 - rate),
    0)``."""
    dropout_apply_reference.calls += 1
    lead, s, d = _region(x)
    keep = dropout_keep_reference(seed, rate, lead, s, d,
                                  device=x.device).view(x.shape)
    denom = torch.tensor(1.0 - rate, dtype=torch.float32, device=x.device)
    return torch.where(keep, x.float() / denom, 0.0).to(x.dtype)


dropout_apply_reference.calls = 0


@functools.lru_cache(maxsize=64)
def apply_args(rate: float) -> tuple[int, float, float]:
    """The apply kernel's constants of a rate: the keep threshold, d =
    float32(1 - rate) and its float32 reciprocal RN(1 / d), from which the
    kernel forms the correctly rounded quotient x / d."""
    d = np.float32(1.0 - rate)
    return keep_threshold(rate), float(d), float(np.float32(1.0) / d)


def dropout_apply(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """``keep ? x / (1 - rate) : 0`` over `x` (..., S, D), float32 or
    bfloat16 on a CUDA device, by the sm_90a `dropout_apply` kernel in one
    pass (x read once, y written once, the mask never stored); raises if
    the build or the launch fails. The result equals
    `dropout_apply_reference`'s bit for bit."""
    if x.device.type != "cuda":
        raise ValueError(f"the dropout_apply kernel takes CUDA tensors, got "
                         f"{x.device}")
    code = DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"the dropout_apply kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    thr, d, rcp = apply_args(rate)
    if not x.is_contiguous():
        x = x.contiguous()
    y = torch.empty_like(x)
    lead, s, dd = _region(x)
    if x.numel() == 0:
        return y
    _check_region(lead, s, dd)
    launch = _library().dropout_apply
    args = (code, int(seed) & 0xFFFFFFFFFFFFFFFF, thr, d, rcp, lead, s, dd,
            x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(x.device):
            err = launch(*args)
    if err != 0:
        raise RuntimeError(f"dropout_apply kernel launch failed: error {err}")
    build.count(dropout_apply)
    return y


dropout_apply.launches = 0


def _apply(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return dropout_apply_reference(x, rate, seed)
    return dropout_apply(x, rate, seed)


class _Dropout(torch.autograd.Function):
    """y = where(keep, x / (1 - rate), 0): linear in x with a diagonal
    Jacobian, so the backward is the same map on the gradient, redrawn
    from (seed, rate); nothing is saved."""

    @staticmethod
    def forward(ctx, x, rate, seed):
        ctx.rate, ctx.seed = rate, seed
        return _apply(x, rate, seed)

    @staticmethod
    def backward(ctx, g):
        return _apply(g, ctx.rate, ctx.seed), None, None


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout of `x` (..., S, D) with the keep function: element
    (..., s, d) of the b-th leading slice is kept iff keep(seed, b, s, d);
    kept values become ``x / (1 - rate)`` in x's dtype, as Flax's
    `nn.Dropout` computes them. A pure function of (x, rate, seed), so a
    recomputation draws the same mask; one kernel pass forward and one
    backward on the card."""
    check_rate(rate)
    if rate == 0.0:
        return x
    return _Dropout.apply(x, float(rate), int(seed))


def _splitmix64(z: int) -> int:
    """splitmix64's step: add the golden gamma, then its finaliser (a
    bijection of 64-bit words)."""
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def mix_seed(seed: int, *salts: int) -> int:
    """A 64-bit seed derived from `seed` and `salts`: for each salt in
    turn, the running seed is scrambled, the salt added and the sum
    scrambled again (splitmix64), so (seed, salt) pairs that differ give
    unrelated seeds. How a step's seed becomes one per layer and per
    use."""
    z = int(seed) & 0xFFFFFFFFFFFFFFFF
    for salt in salts:
        z = _splitmix64((_splitmix64(z) + int(salt)) & 0xFFFFFFFFFFFFFFFF)
    return z
