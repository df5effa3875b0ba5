"""Batch construction for LM training (port of
`solvingpapers_tpu/data/batches.py`).

Two strategies, one implementation each:
  * random-crop batches — memory-mapped token files crop host-side from
    ``numpy.random.default_rng(seed)`` exactly as the reference does (the
    same starts, the same int32 windows: a run reads the same batches in
    both packages); in-memory corpora crop with index arithmetic from a
    `torch.Generator` (a different stream than JAX's key, the same
    distribution);
  * sliding-window split (deepseekv3's `CausalDataset`).
"""

from __future__ import annotations

import numpy as np
import torch


def random_crop_batch(tokens: torch.Tensor, starts: torch.Tensor,
                      block_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Crops of length block_size + 1 at explicit `starts` (the parity
    tests hand both packages the same starts); returns (x, y), y shifted
    by one."""
    idx = starts[:, None] + torch.arange(block_size + 1, device=tokens.device)
    crop = tokens[idx]
    return crop[:, :-1], crop[:, 1:]


def lm_batch_iterator(tokens, batch_size: int, block_size: int, seed: int = 0,
                      *, generator: torch.Generator | None = None):
    """Infinite iterator of {'x', 'y'} int32 LM batches of (batch_size,
    block_size), as CPU tensors (the trainer moves them to its device).

    A `np.memmap` corpus crops host-side, bit-exact with the reference's
    numpy path. Any other corpus is cropped by index arithmetic with
    starts drawn from `generator` (default: a CPU one seeded with
    `seed`).
    """
    if len(tokens) < block_size + 2:
        raise ValueError(
            f"corpus of {len(tokens)} tokens is too short for "
            f"block_size {block_size} (need >= block_size + 2)"
        )
    max_start = len(tokens) - block_size - 1
    if isinstance(tokens, np.memmap):
        rng = np.random.default_rng(seed)
        while True:
            starts = rng.integers(0, max_start, size=batch_size)
            x = np.stack([tokens[s:s + block_size] for s in starts]
                         ).astype(np.int32)
            y = np.stack([tokens[s + 1:s + block_size + 1] for s in starts]
                         ).astype(np.int32)
            yield {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    toks = torch.as_tensor(np.asarray(tokens, np.int32))
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    while True:
        starts = torch.randint(0, max_start, (batch_size,), generator=generator)
        x, y = random_crop_batch(toks, starts, block_size)
        yield {"x": x, "y": y}


def prefetch_batches(iterator, depth: int = 2):
    """Run `iterator` in a background thread, keeping up to `depth` batches
    ready, so host-side gathers (the memmap branch above) overlap the
    device step. Order is preserved, so determinism in `seed` is
    unchanged; an exception in the producer is raised in the consumer.
    """
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterator:
                if not put(batch):
                    return
        except BaseException as e:  # surfaced to the consumer, not swallowed
            put(e)
            return
        put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            batch = q.get()
            if batch is _END:
                return
            if isinstance(batch, BaseException):
                raise batch
            yield batch
    finally:
        stop.set()


def sliding_window_split(
    tokens: np.ndarray, block_size: int, stride: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Materialize (x, y) pairs with a sliding window (deepseekv3's
    CausalDataset uses stride 1; the default here is block_size, the sane
    packing — pass stride=1 for reference-faithful behavior)."""
    stride = stride or block_size
    # last valid start s satisfies s + block_size + 1 <= len(tokens)
    starts = np.arange(0, len(tokens) - block_size, stride)
    x = np.stack([tokens[s:s + block_size] for s in starts])
    y = np.stack([tokens[s + 1:s + block_size + 1] for s in starts])
    return x, y
