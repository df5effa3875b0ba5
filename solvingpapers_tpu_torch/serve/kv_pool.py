"""Slot-pooled KV cache for the serving engine (port of the lane pool of
`solvingpapers_tpu/serve/kv_pool.py`: `_SlotBook`, `KVSlotPool`,
`extract_lane`, `store_lane`; the paged pool and the quantized store are
later slices).

Layout: the pool is the model's own per-layer cache list with batch =
n_slots — slot s is batch row s of every tensor of every layer's cache
(the (n_slots, max_len, n_kv, head_dim) k/v of a `KVCache`, the
(n_slots, max_len, latent) rows of MLA's `LatentCache`), one contiguous
`max_len` lane per slot. Lanes are carved field by field from any cache
dataclass, as the reference carves its pytrees.

Stale data is harmless by construction, as in the reference: a freed
lane is not cleared; the next prefill overwrites positions
[0, prompt_len) before anything reads them, and decode attention masks
with ``kv_index <= position``, so stale slots past the position get
probability 0. Idle slots in a decode block write their dummy k/v into
their own lane's position 0, which the next prefill overwrites.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _tensors(cache) -> dict:
    """{field name: tensor} of one layer's cache dataclass."""
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)}


def extract_lane(caches: list, slot: int) -> list:
    """Slot `slot`'s batch-1 lane as VIEWS of the pooled caches (any
    cache dataclass: `KVCache`, `LatentCache`): a cached forward on the
    lane writes straight into the pool."""
    return [dataclasses.replace(c, **{name: t[slot:slot + 1]
                                      for name, t in _tensors(c).items()})
            for c in caches]


def store_lane(caches: list, lane: list, slot: int) -> list:
    """Write a batch-1 lane back into the pool at `slot`. A lane from
    `extract_lane` already IS the pool's storage and is not copied; any
    other lane is copied in. Dtypes must match exactly (no silent cast)."""
    for c, l in zip(caches, lane):
        lane_ts = _tensors(l)
        for name, pool_t in _tensors(c).items():
            lane_t = lane_ts[name]
            if lane_t.dtype != pool_t.dtype:
                raise TypeError(
                    f"store_lane: lane dtype {lane_t.dtype} != pool dtype "
                    f"{pool_t.dtype}; implicit casts are not performed"
                )
            dst = pool_t[slot:slot + 1]
            if lane_t.data_ptr() != dst.data_ptr():
                dst.copy_(lane_t)
    return caches


class _SlotBook:
    """Slot bookkeeping: a LIFO free list (the freshest slot is reused
    first) plus an O(1) membership mask for the double-release guard."""

    def _init_slots(self, n_slots: int) -> None:
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.n_slots = n_slots
        self.positions = np.zeros(n_slots, np.int32)
        self._free = list(range(n_slots - 1, -1, -1))
        self._free_mask = np.ones(n_slots, bool)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.n_active / self.n_slots

    def acquire(self) -> int | None:
        """Claim a free slot (or None when all are taken)."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._free_mask[slot] = False
        self.positions[slot] = 0
        return slot

    def release(self, slot: int) -> None:
        """Return a lane to the pool; it is immediately reusable."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if self._free_mask[slot]:
            raise ValueError(f"slot {slot} is already free (double release)")
        self.positions[slot] = 0
        self._free.append(slot)
        self._free_mask[slot] = True


class KVSlotPool(_SlotBook):
    """`n_slots` cache lanes + free-list bookkeeping.

    `caches` is the pooled per-layer cache list (batch = slot), updated in
    place by every forward. `positions[slot]` is the lane's fill level:
    prompt plus every emitted token except the newest (a sampled token's
    KV is written when it is fed back)."""

    def __init__(self, model, n_slots: int, max_len: int):
        self._init_slots(n_slots)
        self.max_len = max_len
        self.caches = model.init_caches(n_slots, max_len)
