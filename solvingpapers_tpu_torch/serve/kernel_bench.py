"""Kernel microbench of the serving stack's hot inner ops, each timed in
isolation (port of `solvingpapers_tpu/serve/kernel_bench.py`; `cli
kernel-bench`).

The serving bench measures end-to-end throughput; it bounds the paged
pool's and the int8 pool's costs but cannot attribute them. This module
times each hot op alone at the bench's shapes, as the minimum of fenced
repetitions (an isolated op's cost is its floor, not the box's noise):

    gather          the pool -> logical (S, max_len, ...) lane view.
                    paged: `gather_lanes`, or `quant_gather_lanes` (int8
                    pages and per-page scales dequantized on read); lane:
                    the pool IS the view and the decode block reads it in
                    place, so the unquantized row times a reduction over
                    every byte (a read that materializes nothing), and
                    int8 times `quant_lanes_view` (dequantize on read).
    scatter         ONE write-back. paged: one `scatter_written_pages`
                    window (`quant_scatter_written_pages` bounded by the
                    decode block's window on int8); lane: each slot
                    writes one token of its lane view back
                    (`quant_store_written` of span 1 on int8).
    quant_roundtrip `quantize_tree` + `dequantize_tree` of the whole lane
                    view, on the unquantized rows too (what a kv_quant
                    flip would pay).
    splice          prefix-cache segment traffic. lane: a splice then an
                    extract of half a lane (`KVSlotPool.splice_prefix`,
                    `extract_prefix`, their quantized forms on int8);
                    paged: `gather_lane` + `scatter_lane_pages` (a paged
                    hit is a host-side table append, nothing to time).
    sample          `fused_sample` on a half-greedy / half-stochastic batch
                    at the engine's (S, vocab) logits and `sample_cap`.
    spec_verify     the speculative verify window (`spec_verify`) over (S,
                    k + 1, vocab) logits. The reference's rows draw a
                    uniform and a categorical; the port's draw once a
                    row, keyed by token id (`serve/spec.py`), and that is
                    what is timed.

"Fenced" in eager PyTorch: an op is a run of launches, not one program.
`fenced_wall_s` calls it once outside the timing, then `reps` times
between two `torch.cuda.synchronize()` calls on the card (the host clock
alone on the CPU), and keeps the minimum.

Every family is timed over the full (pool layout x kv_quant) grid, one
entry a cell, with the reference's fields.

`paged_decode_decomposition` joins these walls to a MEASURED paged
decode-block wall: gather, dequant and scatter as shares of the step,
and `attention_share_pct`, the remainder (the model's forward and the
sampling).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from solvingpapers_tpu_torch.ops.quant import dequantize_tree, quantize_tree
from solvingpapers_tpu_torch.serve.kv_pool import (
    KVSlotPool,
    QuantStore,
    cache_bytes,
    gather_lane,
    gather_lanes,
    make_quant_store,
    quant_gather_lane,
    quant_gather_lanes,
    quant_lanes_view,
    quant_pool_bytes,
    quant_scatter_lane_pages,
    quant_scatter_written_pages,
    quant_store_written,
    scatter_lane_pages,
    scatter_written_pages,
)
from solvingpapers_tpu_torch.serve.sampling import PackedSampling, fused_sample
from solvingpapers_tpu_torch.serve.spec import spec_verify

OP_FAMILIES = ("gather", "scatter", "quant_roundtrip", "splice",
               "sample", "spec_verify")

POOL_LAYOUTS = ("lane", "paged")
KV_QUANTS = (None, "int8")


def _fields(cache) -> dict:
    """{field name: tensor} of one layer's cache dataclass."""
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)}


def _tree_bytes(tree) -> int:
    """Bytes of a cache list or of a `QuantStore` (codes, scales and the
    exact sidecar)."""
    if isinstance(tree, QuantStore):
        pool, _, exact, _ = quant_pool_bytes(tree)
        return pool + exact
    return cache_bytes(tree)


def fenced_wall_s(fn, args=(), *, reps: int = 5, clock=time.monotonic,
                  device: torch.device | None = None) -> float:
    """The minimum over `reps` of ``fn(*args)``'s wall seconds, each run
    between two synchronizations of `device` (a CUDA device; on the CPU
    the host clock alone), after one warm-up call outside the timing. The
    minimum, not the mean: an isolated op's cost is its floor."""
    card = device is not None and device.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize(device)

    with torch.no_grad():
        fn(*args)
        best = math.inf
        for _ in range(max(reps, 1)):
            sync()
            t0 = clock()
            fn(*args)
            sync()
            best = min(best, clock() - t0)
    return best


def _mixed_packed(n_slots: int, device) -> PackedSampling:
    """Half-greedy / half-stochastic knobs: the mixed batch the engine's
    fused sampler serves (all-greedy would take the argmax branch and
    time nothing else)."""
    half = torch.arange(n_slots, device=device) % 2 == 0
    return PackedSampling(
        temperature=torch.where(half, 0.0, 0.8).float(),
        top_p=torch.full((n_slots,), 0.95, device=device),
        min_p=torch.zeros(n_slots, device=device),
        top_k=torch.where(half, 0, 40).long(),
    )


def _lane_token_write(caches: list, lanes: list, pos: torch.Tensor) -> list:
    """The lane pool's decode write site alone: each slot writes ONE
    token, its lane view's row at ``pos[s]``, back into the pool."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    for c, lane in zip(caches, lanes):
        view = _fields(lane)
        for name, t in _fields(c).items():
            t[rows, pos] = view[name][rows, pos]
    return caches


def _write_positions(rng, n_slots: int, max_len: int, page_size: int,
                     device) -> torch.Tensor:
    """Seeded per-slot decode write positions: past the first page when
    the lane is long enough (the steady state), never an empty range (a
    one-page lane draws from [0, max_len - 1))."""
    lo = min(page_size, max(max_len - 2, 0))
    return torch.as_tensor(
        rng.integers(lo, max(max_len - 1, lo + 1), size=n_slots),
        dtype=torch.long, device=device)


def _paged_pool_ops(model, *, n_slots: int, max_len: int, page_size: int,
                    kv_quant: str | None, decode_block: int = 16,
                    seed: int = 0):
    """The paged grid cell's tensors and its gather / write-back window
    scatter / splice closures: ONE construction that `build_kernel_ops`
    and `paged_decode_decomposition` share, so the grid's walls and the
    shares are measured on the same shapes (contiguous page tables, seeded
    positions). `decode_block` bounds the int8 scatter's window as the
    engine passes it. Returns ``(ops, pool, lane_view)``."""
    dev = model.device
    rng = np.random.default_rng(seed)
    ppl = max_len // page_size
    n_pages = n_slots * ppl + 1  # the lane-equivalent budget + the trash page
    lane_view = model.init_caches(n_slots, max_len)
    # slot s owns pages [1 + s * ppl, ...): the layout after in-order
    # allocation
    table = torch.as_tensor(
        1 + np.arange(n_slots * ppl).reshape(n_slots, ppl), device=dev)
    pos = _write_positions(rng, n_slots, max_len, page_size, dev)
    eidx_row = np.zeros(n_slots, np.int64)
    row = table[0]
    if kv_quant is not None:
        store = make_quant_store(model, n_pages, page_size, page_size)
        # the engine's write-back always bounds the requantized window
        # (lo = pos, hi = pos + block): on lossy dtypes that is the merge
        # branch the program runs
        hi = pos + decode_block
        ops = {
            "gather": (lambda s, t: quant_gather_lanes(s, t, eidx_row),
                       (store, table)),
            "scatter": (lambda s, ln, t, p: quant_scatter_written_pages(
                s, ln, t, p, lo=pos, hi=hi), (store, lane_view, table, pos)),
            "splice": (lambda s, r: quant_scatter_lane_pages(
                s, quant_gather_lane(s, r, 0), r, 0, 0), (store, row)),
        }
        return ops, store, lane_view
    phys = model.init_caches(n_pages, page_size)
    ops = {
        "gather": (gather_lanes, (phys, table)),
        "scatter": (scatter_written_pages, (phys, lane_view, table, pos)),
        "splice": (lambda ph, r: scatter_lane_pages(ph, gather_lane(ph, r),
                                                    r, 0), (phys, row)),
    }
    return ops, phys, lane_view


def build_kernel_ops(model, *, pool: str, kv_quant: str | None,
                     n_slots: int, max_len: int, page_size: int,
                     quant_block: int, vocab: int, sample_cap: int = 64,
                     spec_k: int = 4, decode_block: int = 16,
                     seed: int = 0) -> dict:
    """The six families' closures for one (pool, kv_quant) grid cell:
    {family: (fn, args)}, plus ``_view_bytes``, ``_pool_bytes`` and
    ``_kv_dtype``. Every input is a seeded tensor on the model's device
    at the cell's serving shapes; nothing runs or is timed here."""
    if pool not in POOL_LAYOUTS:
        raise ValueError(f"pool must be one of {POOL_LAYOUTS}, got {pool!r}")
    if max_len % page_size or max_len % quant_block:
        raise ValueError(
            f"max_len {max_len} must be a multiple of page_size "
            f"{page_size} and quant_block {quant_block}")
    dev = model.device
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ops: dict = {}
    roundtrip_block = page_size if pool == "paged" else quant_block
    if pool == "paged":
        paged_ops, pool_tree, lane_view = _paged_pool_ops(
            model, n_slots=n_slots, max_len=max_len, page_size=page_size,
            kv_quant=kv_quant, decode_block=decode_block, seed=seed)
        ops.update(paged_ops)
    else:
        lane_view = model.init_caches(n_slots, max_len)
        pos = _write_positions(rng, n_slots, max_len, page_size, dev)
        eidx_row = np.zeros(n_slots, np.int64)
        lanes = KVSlotPool(model, n_slots, max_len, quant=kv_quant,
                           quant_block=quant_block)
        pool_tree = lanes.caches
        if kv_quant is not None:
            ops["gather"] = (lambda s: quant_lanes_view(s, eidx_row),
                             (pool_tree,))
            ops["scatter"] = (lambda s, ln, p: quant_store_written(
                s, ln, p, 1, eidx_row), (pool_tree, lane_view, pos))
            seg_len = max(quant_block, max_len // 2 // quant_block * quant_block)
        else:
            # the lane decode reads the pool in place: its "gather" is a
            # pure read, timed as a reduction over every byte (an
            # identity would time a copy the program never makes)
            def read_all(c):
                return sum(t.float().sum() for layer in c
                           for t in _fields(layer).values())

            ops["gather"] = (read_all, (pool_tree,))
            ops["scatter"] = (_lane_token_write, (pool_tree, lane_view, pos))
            seg_len = max(page_size, max_len // 2 // page_size * page_size)
        seg = lanes.extract_prefix(0, 0, seg_len)

        def splice(p, sg):
            p.splice_prefix(0, sg, 0)
            return p.extract_prefix(0, 0, seg_len)

        ops["splice"] = (splice, (lanes, seg))

    view_dtype = next(iter(_fields(lane_view[0]).values())).dtype
    ops["quant_roundtrip"] = (
        lambda v: dequantize_tree(*quantize_tree(v, roundtrip_block),
                                  view_dtype), (lane_view,))

    cap = min(sample_cap, vocab)
    packed = _mixed_packed(n_slots, dev)
    logits = torch.randn((n_slots, vocab), generator=gen, device=dev) * 4.0
    keys = torch.as_tensor(rng.integers(0, 2**62, size=n_slots), device=dev)
    ops["sample"] = (lambda lg, pk, ks: fused_sample(lg, pk, ks, cap=cap),
                     (logits, packed, keys))

    big_l = spec_k + 1
    spec_logits = torch.randn((n_slots, big_l, vocab), generator=gen,
                              device=dev) * 4.0
    drafts = torch.as_tensor(rng.integers(0, vocab, size=(n_slots, spec_k)),
                             device=dev)
    avail = torch.full((n_slots,), spec_k, dtype=torch.long, device=dev)
    spec_keys = torch.as_tensor(rng.integers(0, 2**62, size=(n_slots, big_l)),
                                device=dev)
    ops["spec_verify"] = (
        lambda lg, dr, av, pk, ks: spec_verify(lg, dr, av, pk, ks, cap=cap),
        (spec_logits, drafts, avail, packed, spec_keys))

    assert set(ops) == set(OP_FAMILIES), sorted(ops)
    ops["_view_bytes"] = cache_bytes(lane_view)
    ops["_pool_bytes"] = _tree_bytes(pool_tree)
    # the pool's true storage dtype: the unquantized rows are labelled
    # "f32" in the grid, but a bf16 model's exact pool stores bf16
    ops["_kv_dtype"] = kv_quant or str(view_dtype).removeprefix("torch.")
    return ops


def bench_kernel_cell(model, *, pool: str, kv_quant: str | None,
                      n_slots: int, max_len: int, page_size: int,
                      quant_block: int, vocab: int, sample_cap: int = 64,
                      spec_k: int = 4, decode_block: int = 16,
                      reps: int = 5, seed: int = 0) -> dict:
    """Time every family of one grid cell: {family: wall seconds} and the
    view and pool byte facts its entry records."""
    ops = build_kernel_ops(
        model, pool=pool, kv_quant=kv_quant, n_slots=n_slots,
        max_len=max_len, page_size=page_size, quant_block=quant_block,
        vocab=vocab, sample_cap=sample_cap, spec_k=spec_k,
        decode_block=decode_block, seed=seed)
    out = {"_view_bytes": ops.pop("_view_bytes"),
           "_pool_bytes": ops.pop("_pool_bytes"),
           "_kv_dtype": ops.pop("_kv_dtype")}
    for family in OP_FAMILIES:
        fn, args = ops[family]
        out[family] = fenced_wall_s(fn, args, reps=reps, device=model.device)
    return out


def run_kernel_bench(config="gpt_shakespeare", n_slots: int = 8,
                     max_len: int = 256, page_size: int = 16,
                     quant_block: int = 16, sample_cap: int = 64,
                     spec_k: int = 4, decode_block: int = 16, reps: int = 5,
                     seed: int = 0, device=None) -> list[dict]:
    """The full grid: one entry a (pool layout x kv_quant) cell, every
    family timed at the cell's serving shapes on `device` (default
    ``cuda``), the model built as the serving bench builds it.

    An entry's headline (`value`) is the gather bandwidth in GB/s, the
    logical lane view's bytes over the gather wall (higher is better),
    with each family's wall in microseconds as `<family>_wall_us`;
    `detail.config` encodes the shape knobs."""
    from solvingpapers_tpu_torch.serve.bench import _config_name, build_serve_model

    model, vocab = build_serve_model(config, device)
    grain = math.lcm(page_size, quant_block)
    max_len = max_len // grain * grain
    limit = getattr(model, "max_positions", None)
    if limit is not None and max_len > limit:
        max_len = limit // grain * grain
    if max_len < grain:
        raise ValueError(
            f"max_len {max_len} cannot fit one page/quant-block grain "
            f"{grain} under the model's position budget")
    name = _config_name(config)
    shape_tag = (f"{name}@s{n_slots}l{max_len}p{page_size}"
                 f"b{quant_block}c{sample_cap}k{spec_k}")
    entries = []
    for pool in POOL_LAYOUTS:
        for kv_quant in KV_QUANTS:
            cell = bench_kernel_cell(
                model, pool=pool, kv_quant=kv_quant, n_slots=n_slots,
                max_len=max_len, page_size=page_size, quant_block=quant_block,
                vocab=vocab, sample_cap=sample_cap, spec_k=spec_k,
                decode_block=decode_block, reps=reps, seed=seed)
            dtype = kv_quant or "f32"
            view_bytes = cell.pop("_view_bytes")
            detail = {
                "workload": f"kernels-{pool}-{dtype}",
                "config": shape_tag,
                "pool": pool,
                "kv_quant": kv_quant,
                # the pool's true storage dtype; "f32" in the workload key
                # is the grid's label
                "kv_dtype": cell.pop("_kv_dtype"),
                "n_slots": n_slots,
                "max_len": max_len,
                "page_size": page_size,
                "quant_block": quant_block,
                "sample_cap": sample_cap,
                "spec_k": spec_k,
                "decode_block": decode_block,
                "reps": reps,
                "lane_view_bytes": view_bytes,
                "pool_bytes": cell.pop("_pool_bytes"),
            }
            for family in OP_FAMILIES:
                detail[f"{family}_wall_us"] = round(cell[family] * 1e6, 2)
            gather_gbps = view_bytes / cell["gather"] / 1e9
            detail["gather_gbps"] = round(gather_gbps, 3)
            entries.append({
                "metric": "kernel_gather_bandwidth",
                "value": round(gather_gbps, 3),
                "unit": (f"GB/s logical-lane-view gather "
                         f"({pool} pool, {dtype})"),
                "detail": detail,
            })
    return entries


def paged_decode_decomposition(model, *, n_slots: int, max_len: int,
                               page_size: int, decode_block: int,
                               step_wall_s: float,
                               kv_quant: str | None = None, reps: int = 5,
                               seed: int = 0) -> dict:
    """Decompose a MEASURED paged decode-block wall (`step_wall_s`, seconds
    a `decode_block` call) into the paged pool's op shares: the gather,
    (int8) the dequant and the written-page scatter, each timed alone at
    the block's shapes, as percentages of the step:

        gather_share_pct     the page-table gather (int8: net of the
                             dequant below)
        dequant_share_pct    dequantizing the gathered view (0.0 on an
                             unquantized pool: an explicit zero)
        scatter_share_pct    the written-page scatter times the
                             ``(decode_block - 1) // page_size + 2``
                             write-back windows a call: the windows the
                             port's `_paged_decode_program` runs
                             (`serve/engine.py`), the reference's count
        attention_share_pct  the remainder: the model's forward and the
                             sampling, what a fused paged-attention
                             kernel must keep

    The op walls and the step wall come from different runs, so on a
    noisy host the measured shares can sum past 100: they are then scaled
    down in proportion and ``decomposition_clamped`` is set (present only
    then). The remainder is arithmetic, not a measurement."""
    if step_wall_s <= 0:
        raise ValueError(f"step_wall_s must be > 0, got {step_wall_s}")
    quant = kv_quant is not None
    dev = model.device
    ops, _, lane_view = _paged_pool_ops(
        model, n_slots=n_slots, max_len=max_len, page_size=page_size,
        kv_quant=kv_quant, decode_block=decode_block, seed=seed)
    view_dtype = next(iter(_fields(lane_view[0]).values())).dtype
    gather_fn, gather_args = ops["gather"]
    scatter_fn, scatter_args = ops["scatter"]
    t_gather = fenced_wall_s(gather_fn, gather_args, reps=reps, device=dev)
    t_scatter1 = fenced_wall_s(scatter_fn, scatter_args, reps=reps, device=dev)
    t_dequant = 0.0
    if quant:
        # the dequant alone: int8 codes and scales at the gathered view's
        # shape, back to the compute dtype
        lane_store = make_quant_store(model, n_slots, max_len, page_size)
        t_dequant = fenced_wall_s(
            lambda q, s: dequantize_tree(q, s, view_dtype),
            (lane_store.q, lane_store.scale), reps=reps, device=dev)
    n_scatters = (decode_block - 1) // page_size + 2
    t_scatter = t_scatter1 * n_scatters
    dequant = min(t_dequant, t_gather)
    gather = max(t_gather - dequant, 0.0) if quant else t_gather
    g = 100.0 * gather / step_wall_s
    d = 100.0 * dequant / step_wall_s if quant else 0.0
    sc = 100.0 * t_scatter / step_wall_s
    total = g + d + sc
    clamped = total > 100.0
    if clamped:
        scale = 100.0 / total
        g, d, sc = g * scale, d * scale, sc * scale
    att = max(100.0 - g - d - sc, 0.0)
    out = {
        "decode_step_wall_s": round(step_wall_s, 6),
        "gather_wall_s": round(t_gather, 6),
        "dequant_wall_s": round(t_dequant, 6),
        "scatter_wall_s": round(t_scatter, 6),
        "gather_share_pct": round(g, 2),
        "dequant_share_pct": round(d, 2) if quant else 0.0,
        "scatter_share_pct": round(sc, 2),
        "attention_share_pct": round(att, 2),
    }
    if clamped:
        out["decomposition_clamped"] = True
    return out
