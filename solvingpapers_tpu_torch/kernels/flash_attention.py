"""Flash attention: the hand-written Hopper kernels (forward, and the
dq and dk/dv backward) and their plain PyTorch versions.

What they replace: the Pallas TPU kernels of
`solvingpapers_tpu/kernels/flash_attention.py` — `_fwd_kernel` (launched
by `_fwd`, pallas_call at line 271), `_bwd_dq_kernel` and
`_bwd_dkv_kernel` (launched by `_bwd_chunk`, pallas_calls at lines 484
and 517) — and the `_flash` custom VJP that joins them, here the
`_Flash` autograd function behind the public `flash_attention`. They
compute the same functions — online-softmax attention over BSNH
tensors, causal with the END-aligned mask (``offset = Skv - Sq``) or
bidirectional, GQA by ``q_head // group`` without repeating kv, rows
that see no key giving ``o = 0`` and ``lse = 0`` and no gradient — with
the in-kernel attention-prob dropout: at ``dropout_rate > 0`` the
forward's row sums take the undropped probabilities and its PV product
``keep * p / (1 - rate)``, and the backward kernels redraw the same mask,
`kernels.dropout`'s keep function of ``(dropout_seed, b * N + h, row,
col)``, which the plain versions here and the dense paths apply too.

What bounds them on an H100, and how the designs answer, is in the
headers of `csrc/flash_fwd.cu` and `csrc/flash_bwd.cu`: at the serving
and training shapes (LLaMA-3 `llama3_long`: N 16, Nkv 8, D 64, bf16,
sequences in the thousands) all three are compute-bound at the bf16
tensor-core peak; none writes an (Sq, Skv) matrix to device memory.

Each kernel's wrapper (`flash_attention_fwd`, `flash_bwd_dq`,
`flash_bwd_dkv`) launches its kernel on CUDA tensors or raises — there is
no fallback — and counts its launches in ``.launches``. On CPU tensors
`flash_attention_fwd` and `flash_attention_bwd` compute the plain
versions (`flash_attention_reference`, `flash_attention_bwd_reference`,
the CPU tests' path), which count their calls in ``.calls``, so a run
can show which one its main path went through.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from solvingpapers_tpu_torch.kernels import build
from solvingpapers_tpu_torch.kernels.dropout import (
    DTYPE_CODES,
    INT32_MAX,
    check_rate,
    dropout_keep_reference,
    keep_threshold,
)
from solvingpapers_tpu_torch.ops.attention import BIG_NEG, causal_mask

# the (dtype, head_dim) pairs the kernels are built for: the float32
# kernels (3xTF32 forward, dq and dk/dv) at any of these, the
# bf16 wgmma kernels at whole 64-column panels
HEAD_DIMS = {torch.float32: (16, 32, 64, 128), torch.bfloat16: (64, 128)}
_GRID_Y_MAX = 65535

# (dropout on, Philox seed, keep threshold, 1 / (1 - rate))
_DROPOUT_ARGTYPES = [ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32,
                     ctypes.c_float]

_lib = None  # the loaded forward library, built at first CUDA use
_bwd_lib = None  # the loaded backward library, likewise


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.ensure_built("flash_fwd")))
        fn = lib.flash_fwd
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_int] + _DROPOUT_ARGTYPES
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        lib = ctypes.CDLL(str(build.ensure_built("flash_bwd")))
        # (dtype, head_dim, q, k, v, dO, lse, delta, <outputs>, B, N, Nkv,
        #  Sq, Skv, scale, causal, dropout, seed, threshold, drop_scale,
        #  [splits,] tiles, stream)
        for fn, n_out, n_splits in ((lib.flash_bwd_dq, 1, 0),
                                    (lib.flash_bwd_dkv, 2, 1)):
            fn.argtypes = (
                [ctypes.c_int, ctypes.c_int]
                + [ctypes.c_void_p] * (6 + n_out)
                + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_int] + _DROPOUT_ARGTYPES
                + [ctypes.c_int] * n_splits
                + [ctypes.c_void_p] * 2
            )
            fn.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash attention takes BSNH tensors, got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, _, n, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch "
            "or head_dim"
        )
    if n % k.shape[2]:
        raise ValueError(f"q heads {n} not a multiple of kv heads {k.shape[2]}")


_TMA_STRIDE_LIMIT = 2**40  # bytes: a tensor map's strides stay below it


def tma_strides(x: torch.Tensor) -> tuple | None:
    """The (B, S, H) strides, in elements, with which the forward kernels
    read the (B, S, H, D) tensor `x` in place (bf16 through TMA tensor
    maps, float32 by 16-byte cp.async copies), or
    None when they cannot: a base off 16 bytes, or a stride that is not a
    positive multiple of 16 bytes below 2**40. An axis of length 1 is
    never stepped over, so its stride is replaced by the one a contiguous
    layout would give it. The kernel takes the extents from the shape, so
    a cache slice keeps its own batch stride and TMA zero-fills past its
    length."""
    el = x.element_size()
    if x.data_ptr() % 16:
        return None
    strides, inner = [], x.shape[3]  # inner: the elements one step spans
    for size, st in zip(reversed(x.shape[:3]), reversed(x.stride()[:3])):
        st = inner if size == 1 else st
        if st <= 0 or st * el % 16 or st * el >= _TMA_STRIDE_LIMIT:
            return None
        strides.append(st)
        inner = size * st
    return tuple(reversed(strides))


def fwd_tma_inputs(q, k, v):
    """q, k and v as the forward kernels read them, each with its
    `tma_strides`: a tensor TMA can read in place passes as it is (a
    sequence slice of the serving cache among them); only one it cannot
    is copied, contiguous, first."""
    out = []
    for x in (q, k, v):
        strides = tma_strides(x)
        if strides is None:
            x = x.clone(memory_format=torch.contiguous_format)
            strides = tma_strides(x)
        out.append((x, strides))
    return out


def _visible(sq, skv, causal, device):
    if causal:
        return causal_mask(sq, skv, device=device)
    return torch.ones(sq, skv, dtype=torch.bool, device=device)


def _head_keep(dropout_rate, dropout_seed, bh, sq, skv, device):
    """The (Sq, Skv) keep mask of q head `bh`, or None at rate 0."""
    if dropout_rate == 0.0:
        return None
    return dropout_keep_reference(dropout_seed, dropout_rate, 1, sq, skv,
                                  bh_start=bh, device=device)[0]


def flash_attention_reference(q, k, v, *, causal=False, scale=None,
                              dropout_rate=0.0, dropout_seed=0):
    """Plain PyTorch version of the kernel: same inputs, same outputs
    ``(o (B, Sq, N, D) in q's dtype, lse (B*N, 1, Sq) float32)``, the
    TPU kernel's float32 arithmetic (q scaled before QK^T, unnormalized
    PV in float32, masked probabilities zeroed, empty rows -> o = 0,
    lse = 0; with dropout, the row sums of the undropped probabilities
    and PV of ``keep * p / (1 - rate)``). One q head at a time, so a
    long sequence holds float32 (Sq, Skv) matrices of one head only."""
    flash_attention_reference.calls += 1
    _check_shapes(q, k, v)
    check_rate(dropout_rate)
    b, sq, n, d = q.shape
    skv, group = k.shape[1], n // k.shape[2]
    if scale is None:
        scale = d**-0.5
    vis = _visible(sq, skv, causal, q.device)
    o = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    for bi in range(b):
        for h in range(n):
            kf = k[bi, :, h // group].float()  # (Skv, D)
            vf = v[bi, :, h // group].float()
            s = (q[bi, :, h].float() * scale) @ kf.T  # (Sq, Skv)
            s = s.masked_fill(~vis, BIG_NEG)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m).masked_fill(~vis, 0.0)
            l = p.sum(dim=-1, keepdim=True)
            keep = _head_keep(dropout_rate, dropout_seed, bi * n + h, sq, skv,
                              q.device)
            if keep is not None:
                p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
            empty = l <= 0.0
            safe_l = torch.where(empty, torch.ones_like(l), l)
            o[bi, :, h] = torch.where(empty, torch.zeros_like(l),
                                      (p @ vf) / safe_l).to(q.dtype)
            lse[bi, h] = torch.where(empty, torch.zeros_like(l),
                                     m + torch.log(safe_l))[:, 0]
    return o, lse.reshape(b * n, 1, sq)


flash_attention_reference.calls = 0


def _dropout_args(dropout_rate: float, dropout_seed: int) -> tuple:
    """The kernels' (dropout, seed, threshold, drop_scale) arguments."""
    if dropout_rate == 0.0:
        return (0, 0, 0, 1.0)
    return (1, int(dropout_seed) & 0xFFFFFFFFFFFFFFFF,
            keep_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate))


def _on_cpu(*xs: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version's
    case), False when all lie on one CUDA device (the kernel's); raises
    for anything else — nothing is ever computed quietly elsewhere."""
    devices = {x.device for x in xs}
    if {dev.type for dev in devices} == {"cpu"}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            "flash attention needs its tensors on one CUDA device (or all "
            f"on the CPU for the plain version), got {[str(x.device) for x in xs]}"
        )
    return False


def _check_kernel_inputs(q, k, v) -> None:
    """What the kernels take: float32 or bfloat16 of one dtype, a
    (dtype, D) pair of HEAD_DIMS, unit stride on the head_dim axis, sizes
    within range."""
    b, sq, n, d = q.shape
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"the kernel takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in HEAD_DIMS[q.dtype]:
        built = "; ".join(f"{str(t)[6:]} at head_dim {', '.join(map(str, ds))}"
                          for t, ds in HEAD_DIMS.items())
        raise ValueError(f"the kernels are not built for ({str(q.dtype)[6:]}, "
                         f"head_dim {d}); they take {built}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k, v need unit stride on the head_dim axis")
    if b * n > _GRID_Y_MAX or max(sq, k.shape[1], q.numel() // d) > INT32_MAX:
        raise ValueError(f"shape out of the kernel's range: q {tuple(q.shape)}")


def positive_scale(q: torch.Tensor, scale: float):
    """``(q', scale')`` with ``scale' > 0`` and ``q' k^T scale' = q k^T
    scale`` exactly, for the bf16 kernels, whose softmax keeps the row
    maximum of unscaled scores and so needs ``scale > 0``: ``(-q, -scale)``
    for a negative scale (negation is exact in bf16, and ``(-q) . k =
    -(q . k)`` in any summation order), ``(q * 0, 1)`` for scale 0 (every
    score 0, as in the reference), ``(q, scale)`` otherwise, with no copy.
    Applied before `_Flash`, autograd carries dq back through it."""
    if scale > 0:
        return q, scale
    if scale < 0:
        return -q, -scale
    return q * 0, 1.0


def flash_attention_fwd(q, k, v, *, causal=False, scale=None,
                        dropout_rate=0.0, dropout_seed=0):
    """Flash-attention forward over BSNH tensors; returns ``(o, lse)``.

    q: (B, Sq, N, D); k, v: (B, Skv, Nkv, D) with N % Nkv == 0. On CPU
    tensors this is the plain version; on CUDA tensors it launches the
    sm_90a kernel (float32 at D 16, 32, 64 or 128, bfloat16 at D 64 or
    128 — `HEAD_DIMS` —, unit stride on the last axis — other strides are
    passed through, so a cache slice needs no copy; see `fwd_tma_inputs`
    for what is copied) on the current stream, and raises if the build,
    a tensor map or the launch fails; bf16 takes any scale through
    `positive_scale`. ``dropout_rate > 0`` drops attention probabilities
    with the keep mask of `dropout_seed` (a 64-bit int; see
    `kernels.dropout`).
    """
    _check_shapes(q, k, v)
    check_rate(dropout_rate)
    b, sq, n, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
    if _on_cpu(q, k, v):
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         dropout_rate=dropout_rate,
                                         dropout_seed=dropout_seed)
    _check_kernel_inputs(q, k, v)
    if q.dtype == torch.bfloat16:
        q, scale = positive_scale(q, scale)
    # the kernels read q, k, v in place at their own strides: bf16 through
    # TMA tensor maps, float32 by cp.async, both 16 bytes at a time
    (q, qs), (k, ks), (v, vs) = fwd_tma_inputs(q, k, v)
    strides = [*qs, *ks, *vs]
    o = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * n, 1, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return o, lse
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            DTYPE_CODES[q.dtype], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, n, n_kv, sq, skv, *strides,
            float(scale), int(bool(causal)),
            *_dropout_args(dropout_rate, dropout_seed),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: error {err} "
                           "(-2: no tensor map could be encoded)")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


# -------------------------------------------------------------------- backward


def _check_bwd_shapes(q, k, v, do, lse, delta) -> None:
    _check_shapes(q, k, v)
    b, sq, n, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} differs from q {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b * n, 1, sq) or x.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 of shape {(b * n, 1, sq)}, got "
                f"{x.dtype} {tuple(x.shape)}"
            )


def flash_attention_bwd_reference(q, k, v, do, lse, delta, *, causal=False,
                                  scale=None, dropout_rate=0.0, dropout_seed=0):
    """Plain PyTorch version of the backward kernels: same inputs, same
    outputs ``(dq, dk, dv)`` in the dtypes of q, k and v, the TPU
    kernels' float32 arithmetic — q scaled before QK^T, ``p = exp(s -
    lse)`` with masked entries 0, ``ds = p * (dp - delta)``, kv repeated
    to the q heads and the per-head dk, dv summed back; with dropout,
    ``dp <- keep * dp / (1 - rate)`` and dv of ``keep * p / (1 - rate)``
    (`ds` keeps the undropped p). One q head at a time, its dk and dv
    added to its kv head's in head order, so a long sequence holds
    float32 (Sq, Skv) matrices of one head only."""
    flash_attention_bwd_reference.calls += 1
    _check_bwd_shapes(q, k, v, do, lse, delta)
    check_rate(dropout_rate)
    b, sq, n, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    group = n // n_kv
    if scale is None:
        scale = d**-0.5
    vis = _visible(sq, skv, causal, q.device)
    lse3 = lse.reshape(b, n, sq, 1)
    delta3 = delta.reshape(b, n, sq, 1)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for bi in range(b):
        for h in range(n):
            kh = h // group
            qs = q[bi, :, h].float() * scale  # (Sq, D)
            dos = do[bi, :, h].float()
            kf, vf = k[bi, :, kh].float(), v[bi, :, kh].float()  # (Skv, D)
            p = torch.where(vis, torch.exp(qs @ kf.T - lse3[bi, h]), 0.0)
            dp = dos @ vf.T
            pv = p
            keep = _head_keep(dropout_rate, dropout_seed, bi * n + h, sq, skv,
                              q.device)
            if keep is not None:
                dp = torch.where(keep, dp / (1.0 - dropout_rate), 0.0)
                pv = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
            ds = p * (dp - delta3[bi, h])
            dq[bi, :, h] = ds @ kf * scale
            dk[bi, :, kh] += ds.T @ qs
            dv[bi, :, kh] += pv.T @ dos
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_bwd_reference.calls = 0


def _bwd_kernel_inputs(q, k, v, do, lse, delta):
    """The CUDA kernels' inputs, checked and made contiguous with rows
    on 16-byte boundaries (a copy only where a tensor is not already)."""
    _check_bwd_shapes(q, k, v, do, lse, delta)
    if _on_cpu(q, k, v, do, lse, delta):
        raise ValueError("the backward kernels take CUDA tensors")
    _check_kernel_inputs(q, k, v)
    if do.dtype != q.dtype:
        raise ValueError(f"dO is {do.dtype}, q is {q.dtype}")

    def ready(x):
        x = x.contiguous()
        return x if x.data_ptr() % 16 == 0 else x.clone()

    return tuple(ready(x) for x in (q, k, v, do, lse, delta))


# The backward kernels' work split, decided here and read by
# csrc/flash_bwd.cu. A bf16 block is BWD_CONSUMERS warpgroups, each owning
# BWD_TILE output rows, that loop over BWD_TILE-row tiles of the other
# sequence axis; a float32 dk/dv block owns F32_DKV_ROWS kv rows (4 pairs
# of warps, each pair 16 rows, each warp half of D) and loops over q tiles
# from the first BWD_TILE-row tile that sees its rows. dk/dv splits a kv
# head's q heads over several blocks while it would have fewer than
# BWD_WAVES blocks per SM of the card.
BWD_TILE = 64
BWD_CONSUMERS = 2
BWD_BLOCK_ROWS = BWD_TILE * BWD_CONSUMERS
F32_DKV_ROWS = 64
BWD_WAVES = 4
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward kernels' blocks at one shape. Each kernel's
    output tiles of `rows` rows (dq: q tiles; dk/dv: kv tiles)
    launch in the order of `dq_tiles` / `dkv_tiles`, heaviest first: the
    kernel's block i takes tile ``tiles[i // per_tile]`` and, as
    ``i % per_tile``, ``b * N + h`` (dq) or ``(b * Nkv + kv head) * splits
    + split`` (dk/dv). A dk/dv block takes ``group // splits``
    consecutive q heads of its kv head; with ``splits > 1`` the blocks
    write float32 partials that `fold_partials` sums in head order, else
    the group folds inside the block."""

    b: int
    sq: int
    skv: int
    n: int
    n_kv: int
    causal: bool
    splits: int
    dq_tiles: tuple
    dkv_tiles: tuple
    rows: int = BWD_BLOCK_ROWS

    @property
    def group(self) -> int:
        return self.n // self.n_kv

    @property
    def dq_blocks(self) -> int:
        return len(self.dq_tiles) * self.b * self.n

    @property
    def dkv_blocks(self) -> int:
        return len(self.dkv_tiles) * self.b * self.n_kv * self.splits


def _kv_end(sq, skv, causal, r0, rows):
    """One past the last kv column rows [r0, r0 + rows) (clipped to Sq)
    see; 0 when the range holds no row."""
    if r0 >= sq:
        return 0
    if not causal:
        return skv
    last = min(r0 + rows, sq) - 1
    return max(0, min(skv, last + skv - sq + 1))


def _first_live_q(sq, skv, causal, col):
    """The first BWD_TILE-row q tile with a row that sees kv column col."""
    r = col - (skv - sq) if causal else 0
    return 0 if r <= 0 else r // BWD_TILE * BWD_TILE


@functools.cache
def bwd_plan(b, sq, skv, n, n_kv, causal, sms=H100_SMS,
             rows=BWD_BLOCK_ROWS) -> BwdPlan:
    """The work split of the backward kernels whose blocks own `rows`
    output rows (bf16: BWD_BLOCK_ROWS; float32 dk/dv: F32_DKV_ROWS): dk/dv
    takes the fewest splits of the GQA group (a divisor of it) that give
    BWD_WAVES blocks per SM, or one q head per block when none does; each
    kernel's tiles launch by the BWD_TILE x BWD_TILE tile pairs their
    blocks compute, most first (ties: later q tiles, earlier kv tiles
    first)."""
    causal = bool(causal)
    t, group = BWD_TILE, n // n_kv
    folded = -(-skv // rows) * b * n_kv
    splits = next((s for s in range(1, group + 1)
                   if group % s == 0 and folded * s >= BWD_WAVES * sms), group)

    def dq_work(j):  # kv tiles the consumers of q tile j compute
        return sum(-(-_kv_end(sq, skv, causal, r0, t) // t) for r0 in
                   range(j * rows, (j + 1) * rows, t))

    def dkv_work(j):  # q tiles the consumers of kv tile j compute, a head
        return sum(-(-(sq - _first_live_q(sq, skv, causal, c)) // t)
                   for c in range(j * rows, min((j + 1) * rows, skv), t))

    dq_tiles = sorted(range(-(-sq // rows)), key=lambda j: (-dq_work(j), -j))
    dkv_tiles = sorted(range(-(-skv // rows)), key=lambda j: (-dkv_work(j), j))
    return BwdPlan(b, sq, skv, n, n_kv, causal, splits, tuple(dq_tiles),
                   tuple(dkv_tiles), rows)


@functools.cache
def _tiles_on(tiles: tuple, device: torch.device) -> torch.Tensor:
    """A plan's tile order as the kernels read it: int32 on the card, made
    once per order and device and kept for later launches."""
    return torch.tensor(tiles, dtype=torch.int32, device=device)


def fold_partials(parts: torch.Tensor) -> torch.Tensor:
    """The sum over the first axis of float32 partials, in index order
    (head order): the fold of the GQA group's per-head dk, dv that the
    reference's `_flash_bwd` does after its kernels."""
    out = parts[0].clone()
    for part in parts[1:]:
        out += part
    return out


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_args(q, k, scale, causal, dropout_rate, dropout_seed):
    b, sq, n, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    scale = d**-0.5 if scale is None else scale
    check_rate(dropout_rate)
    return ((b, n, n_kv, sq, skv, float(scale), int(bool(causal)),
             *_dropout_args(dropout_rate, dropout_seed)),
            b * n * sq * skv == 0)


def _plan_of(q, k, causal):
    """`bwd_plan` for a launch on q's device, with the rows of q's dtype's
    blocks (float32: the dk/dv kernel's)."""
    b, sq, n, _ = q.shape
    rows = F32_DKV_ROWS if q.dtype == torch.float32 else BWD_BLOCK_ROWS
    return bwd_plan(b, sq, k.shape[1], n, k.shape[2], bool(causal),
                    sms=_sm_count(q.device), rows=rows)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal=False, scale=None,
                 dropout_rate=0.0, dropout_seed=0):
    """dq by the sm_90a dq kernel (CUDA tensors only; raises on others
    and when the build or the launch fails). bf16 blocks launch in
    `bwd_plan`'s order; float32 blocks (64 q rows each) heaviest first by
    their index, which is the order `bwd_plan(..., rows=64)` would give."""
    q, k, v, do, lse, delta = _bwd_kernel_inputs(q, k, v, do, lse, delta)
    args, empty = _launch_args(q, k, scale, causal, dropout_rate, dropout_seed)
    if empty:
        return torch.zeros_like(q)
    tiles = None
    if q.dtype == torch.bfloat16:
        tiles = _tiles_on(_plan_of(q, k, causal).dq_tiles, q.device).data_ptr()
    dq = torch.empty_like(q)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_dq(
            DTYPE_CODES[q.dtype], q.shape[3], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *args, tiles,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: CUDA error {err}")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal=False, scale=None,
                  dropout_rate=0.0, dropout_seed=0):
    """(dk, dv) by the sm_90a dk/dv kernel (CUDA tensors only; raises on
    others and when the build or the launch fails). It takes `bwd_plan`'s
    split of each kv head's q heads over blocks and folds their float32
    partials here in head order; with one split the group folds inside
    the block."""
    return _launch_dkv(q, k, v, do, lse, delta, None, causal=causal,
                       scale=scale, dropout_rate=dropout_rate,
                       dropout_seed=dropout_seed)


def _launch_dkv(q, k, v, do, lse, delta, splits, *, causal=False, scale=None,
                dropout_rate=0.0, dropout_seed=0):
    """`flash_bwd_dkv` with the split given (None: the plan's), for the
    checks and timings that compare the split with the in-block fold."""
    q, k, v, do, lse, delta = _bwd_kernel_inputs(q, k, v, do, lse, delta)
    args, empty = _launch_args(q, k, scale, causal, dropout_rate, dropout_seed)
    if empty:
        return torch.zeros_like(k), torch.zeros_like(v)
    plan = _plan_of(q, k, causal)
    splits = plan.splits if splits is None else splits
    tiles = _tiles_on(plan.dkv_tiles, q.device).data_ptr()
    if splits == 1:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
    else:
        dk, dv = (torch.empty((splits, *k.shape), dtype=torch.float32,
                              device=k.device) for _ in range(2))
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_dkv(
            DTYPE_CODES[q.dtype], q.shape[3], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *args, int(splits), tiles,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: CUDA error {err}")
    flash_bwd_dkv.launches += 1
    if splits > 1:
        dk, dv = fold_partials(dk).to(k.dtype), fold_partials(dv).to(v.dtype)
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, do, lse, delta, *, causal=False, scale=None,
                        dropout_rate=0.0, dropout_seed=0):
    """Flash-attention backward over BSNH tensors with un-repeated GQA
    kv: ``(dq, dk, dv)`` from the forward's inputs, the output's
    cotangent `do`, the forward's `lse` and ``delta = rowsum(do * o)``
    (both float32 (B*N, 1, Sq); a chunked caller passes global ones) and
    the forward's dropout rate and seed. On CPU tensors this is the plain
    version; on CUDA tensors it launches the dq kernel, then the dk/dv
    kernel."""
    kw = dict(causal=causal, scale=scale, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed)
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_attention_bwd_reference(q, k, v, do, lse, delta, **kw)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def flash_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(do * o)`` in float32 as (B*N, 1, Sq), computed
    outside the kernels as the reference does (`_flash_bwd`)."""
    b, sq, n, _ = o.shape
    delta = (do.float() * o.float()).sum(-1)  # (B, Sq, N)
    return delta.permute(0, 2, 1).reshape(b * n, 1, sq)


class _Flash(torch.autograd.Function):
    """The reference's `_flash` custom VJP: the forward saves (q, k, v,
    o, lse) and the dropout seed, the backward computes delta (from the
    dropped o) and runs the backward kernels, which redraw the forward's
    mask. A tensor passed as both k and v (MLA's latent stream) gets
    dk + dv from autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_rate, dropout_seed):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                     dropout_rate=dropout_rate,
                                     dropout_seed=dropout_seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, scale=scale, dropout_rate=dropout_rate,
                      dropout_seed=dropout_seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, flash_delta(do, o),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=False, scale=None, dropout_rate=0.0,
                    dropout_seed=0):
    """Flash attention over BSNH tensors (drop-in for
    `ops.dot_product_attention` when there is no cache mask); returns o,
    differentiable in q, k and v through the backward kernels. At
    ``dropout_rate > 0`` attention probabilities are dropped in the
    kernels with the keep mask of `dropout_seed` (`kernels.dropout`).
    bf16 takes any scale: `positive_scale` turns it into the kernels'
    ``scale > 0`` before the autograd function, so dq flows back through
    the exact transform."""
    check_rate(dropout_rate)
    if q.dtype == torch.bfloat16 and scale is not None:
        q, scale = positive_scale(q, scale)
    return _Flash.apply(q, k, v, causal, scale, float(dropout_rate),
                        int(dropout_seed))
