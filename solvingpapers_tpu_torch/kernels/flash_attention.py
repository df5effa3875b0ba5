"""Flash-attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

What it replaces: the Pallas TPU kernel `_fwd_kernel`, launched by
`_fwd` (`solvingpapers_tpu/kernels/flash_attention.py`, pallas_call at
line 271), reached through the public `flash_attention`. It computes the
same function — online-softmax attention over BSNH tensors, causal with
the END-aligned mask (``offset = Skv - Sq``) or bidirectional, GQA by
``q_head // group`` without repeating kv, rows that see no key giving
``o = 0`` and ``lse = 0`` — minus the in-kernel dropout, which comes
with the training slice (``dropout_rate > 0`` raises here).

What bounds it on an H100: at the serving prefill shapes (LLaMA-3
`llama3_long`: N 16, Nkv 8, D 64, bf16, Sq a prefill chunk of up to
2048, Skv = attend_len >= Sq) it does ~4·D operations per visible
(row, column) pair against ~2·D bytes per kv row, so it is
compute-bound: the bound is the causal FLOPs over the bf16 tensor-core
peak. How the design answers: nothing of the (Sq, Skv) score matrix
reaches device memory; each block keeps one q tile resident and loops
over kv tiles only up to the last one its rows can see (the causal
skip), with the softmax state in registers. bf16 inputs run both
products on the tensor cores (`mma.sync` m16n8k16, P split into two bf16
parts so PV keeps ~16 bits of it); float32 inputs run them as float32
FMAs on the CUDA cores, exact to ~1e-6. Tiles are staged through shared
memory with plain loads, so the kernel stays below the tensor-core
bound; `PERF.md` keeps its measured time beside the bound. `wgmma`
tiles fed by TMA are the next step.

`flash_attention_fwd` is the wrapper: on CPU tensors it computes the
plain version (`flash_attention_reference`, the CPU tests' path); on
CUDA tensors it launches the kernel or raises — there is no fallback.
`flash_attention_fwd.launches` counts kernel launches and
`flash_attention_reference.calls` counts plain-version calls, so a run
can show which one its main path went through.
"""

from __future__ import annotations

import ctypes

import torch

from solvingpapers_tpu_torch.kernels import build
from solvingpapers_tpu_torch.ops.attention import BIG_NEG, causal_mask

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_INT32_MAX = 2**31 - 1
_GRID_Y_MAX = 65535

_lib = None  # the loaded shared library, built at first CUDA use


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
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def _rows_16b_aligned(x: torch.Tensor) -> bool:
    """Every (b, s, h) row of `x` starts on a 16-byte boundary."""
    el = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        (st * el) % 16 == 0 for st, size in zip(x.stride()[:3], x.shape[:3])
        if size > 1)


def flash_attention_reference(q, k, v, *, causal=False, scale=None):
    """Plain PyTorch version of the kernel: same inputs, same outputs
    ``(o (B, Sq, N, D) in q's dtype, lse (B*N, 1, Sq) float32)``, the
    TPU kernel's float32 arithmetic (q scaled before QK^T, unnormalized
    PV in float32, masked probabilities zeroed, empty rows -> o = 0,
    lse = 0)."""
    flash_attention_reference.calls += 1
    _check_shapes(q, k, v)
    b, sq, n, d = q.shape
    skv, group = k.shape[1], n // k.shape[2]
    if scale is None:
        scale = d**-0.5
    q3 = q.float().permute(0, 2, 1, 3) * scale
    k3 = k.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    v3 = v.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    s = q3 @ k3.transpose(-1, -2)  # (B, N, Sq, Skv)
    if causal:
        vis = causal_mask(sq, skv, device=q.device)
    else:
        vis = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    s = s.masked_fill(~vis, BIG_NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~vis, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    empty = l <= 0.0
    safe_l = torch.where(empty, torch.ones_like(l), l)
    o = torch.where(empty, torch.zeros_like(l), (p @ v3) / safe_l)
    lse = torch.where(empty, torch.zeros_like(l), m + torch.log(safe_l))
    return (o.permute(0, 2, 1, 3).to(q.dtype),
            lse.reshape(b * n, 1, sq))


flash_attention_reference.calls = 0


def flash_attention_fwd(q, k, v, *, causal=False, scale=None,
                        dropout_rate=0.0):
    """Flash-attention forward over BSNH tensors; returns ``(o, lse)``.

    q: (B, Sq, N, D); k, v: (B, Skv, Nkv, D) with N % Nkv == 0. On CPU
    tensors this is the plain version; on CUDA tensors it launches the
    sm_90a kernel (float32 or bfloat16, D in {64, 128}, unit stride on
    the last axis — other strides are passed through, so a cache slice
    needs no copy) on the current stream, and raises if the build or the
    launch fails.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "in-kernel attention dropout is not ported yet (it comes with "
            "the training slice and its backward kernels); this forward "
            "kernel is inference-only"
        )
    _check_shapes(q, k, v)
    b, sq, n, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    if devices != {"cuda"} or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash attention needs q, k, v on one CUDA device (or all on "
            f"the CPU for the plain version), got {q.device}, {k.device}, "
            f"{v.device}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"the kernel takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head_dim in {HEAD_DIMS}, got {d}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k, v need unit stride on the head_dim axis")
    if b * n > _GRID_Y_MAX or max(sq, skv, q.numel() // d) > _INT32_MAX:
        raise ValueError(f"shape out of the kernel's range: q {tuple(q.shape)}")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel moves rows as 16-byte chunks
        q, k, v = (x if _rows_16b_aligned(x)
                   else x.clone(memory_format=torch.contiguous_format)
                   for x in (q, k, v))
    o = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * n, 1, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return o, lse
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            _DTYPE_CODES[q.dtype], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, n, n_kv, sq, skv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, causal=False, scale=None, dropout_rate=0.0):
    """Flash attention over BSNH tensors (drop-in for
    `ops.dot_product_attention` when there is no cache mask); returns o."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                               dropout_rate=dropout_rate)[0]
