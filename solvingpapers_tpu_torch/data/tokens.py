"""Pre-tokenized LM streams (port of `solvingpapers_tpu/data/tokens.py`).

The on-disk format is a flat uint16/uint32 `.bin` with a `.meta` sidecar
(line 1 the dtype, then ``key=value`` lines; ``max_id`` recorded at
write time), memory-mapped so corpora larger than RAM stream from disk,
or a `.npy`. Files written by either package read in the other.
"""

from __future__ import annotations

import os

import numpy as np


def tokenize_to_file(
    text: str, tokenizer, path: str, *, dtype=None
) -> np.ndarray:
    """Encode `text` and write a flat token file next to a .meta sidecar.

    dtype defaults to uint16 when the vocab fits (gpt2's 50257 does), else
    uint32. Returns the in-memory tokens.
    """
    ids = np.asarray(tokenizer.encode(text))
    if dtype is None:
        dtype = (np.uint16 if tokenizer.vocab_size <= np.iinfo(np.uint16).max + 1
                 else np.uint32)
    ids = ids.astype(dtype)
    if path.endswith(".npy"):
        np.save(path, ids)
    else:
        ids.tofile(path)
        max_id = int(ids.max()) if ids.size else -1
        with open(path + ".meta", "w") as f:
            f.write(f"{np.dtype(dtype).name}\nmax_id={max_id}\n")
    return ids


def token_file_max_id(path: str, tokens: np.ndarray) -> int:
    """Largest token id: from the .meta sidecar when recorded, else one
    full pass over `tokens` (O(file size) for memmaps)."""
    meta = path + ".meta"
    if os.path.exists(meta):
        with open(meta) as f:
            for line in f.read().splitlines()[1:]:
                if line.startswith("max_id="):
                    return int(line.split("=", 1)[1])
    return int(np.max(tokens))


def load_token_file(path: str, *, dtype=None) -> np.ndarray:
    """Memory-map a token file written by `tokenize_to_file` (or any flat
    binary of the given dtype; .npy loads with mmap_mode)."""
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r")
    if dtype is None:
        meta = path + ".meta"
        if not os.path.exists(meta):
            raise ValueError(
                f"{path} has no .meta sidecar recording its dtype; pass "
                "dtype= explicitly (guessing would silently misparse uint32 "
                "token files as uint16 garbage)"
            )
        with open(meta) as f:
            dtype = np.dtype(f.read().splitlines()[0].strip())
    return np.memmap(path, dtype=dtype, mode="r")
