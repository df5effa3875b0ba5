"""Character-level tokenization and corpus loading (port of
`solvingpapers_tpu/data/char.py`): the char vocab of the GPT notebook
(sorted unique chars, stoi/itos maps) and its 90/10 train/val split."""

from __future__ import annotations

import os

import numpy as np

from solvingpapers_tpu_torch.data.synthetic import synthetic_text


class CharTokenizer:
    def __init__(self, text: str):
        self.chars = sorted(set(text))
        self.stoi = {c: i for i, c in enumerate(self.chars)}
        self.itos = dict(enumerate(self.chars))

    @property
    def vocab_size(self) -> int:
        return len(self.chars)

    def encode(self, s: str) -> np.ndarray:
        return np.asarray([self.stoi[c] for c in s], dtype=np.int32)

    def decode(self, ids) -> str:
        return "".join(self.itos[int(i)] for i in ids)


def load_text(path: str | None = None, synthetic_chars: int = 200_000,
              seed: int = 0) -> str:
    """Raw corpus text: the local file if given and present, else
    synthetic."""
    if path is not None and os.path.exists(path):
        with open(path, "r", encoding="utf-8") as f:
            return f.read()
    return synthetic_text(synthetic_chars, seed)


def split_train_val(
    data: np.ndarray, val_fraction: float = 0.1
) -> tuple[np.ndarray, np.ndarray]:
    """Tail split (the gpt/gemma notebooks' 90/10 convention), at least
    1 val token."""
    n_val = max(int(len(data) * val_fraction), 1)
    return data[:-n_val], data[-n_val:]


def load_char_corpus(
    path: str | None = None,
    val_fraction: float = 0.1,
    synthetic_chars: int = 200_000,
    seed: int = 0,
) -> tuple[CharTokenizer, np.ndarray, np.ndarray]:
    """A text corpus (the local file if given and present, else synthetic)
    with its char vocab: (tokenizer, train tokens, val tokens)."""
    text = load_text(path, synthetic_chars, seed)
    tok = CharTokenizer(text)
    train, val = split_train_val(tok.encode(text), val_fraction)
    return tok, train, val
