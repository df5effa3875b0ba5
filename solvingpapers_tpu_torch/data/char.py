"""Character-level corpus helpers (port of `solvingpapers_tpu/data/char.py`:
only `split_train_val`, which the token-file path uses; the char
tokenizer and corpus loader come with the GPT slice)."""

from __future__ import annotations

import numpy as np


def split_train_val(
    data: np.ndarray, val_fraction: float = 0.1
) -> tuple[np.ndarray, np.ndarray]:
    """Tail split (the gpt/gemma notebooks' 90/10 convention), at least
    1 val token."""
    n_val = max(int(len(data) * val_fraction), 1)
    return data[:-n_val], data[-n_val:]
