"""Byte-level BPE tokenization (port of `solvingpapers_tpu/data/bpe.py`).

The reference's subword pipelines use tiktoken's GPT-2 tables (LLaMA-3)
and HF's `AutoTokenizer('gpt2')` (DeepSeek-V3, vocab 50257). Both fetch
their tables on first use, so this module provides a self-contained
byte-level BPE with three sources:

  1. `ByteBPETokenizer.train(text, vocab_size)` — learn merges from a local
     corpus (classic BPE: iteratively merge the most frequent symbol pair);
  2. `ByteBPETokenizer.from_files(vocab.json, merges.txt)` — load GPT-2
     format tables if the user has them locally;
  3. `gpt2_tokenizer()` — best-effort tiktoken / HF fast paths when their
     caches exist, else a clear error.

Byte-level means no <unk>: any UTF-8 string round-trips exactly.

Training and encoding run through the port's native library
(`solvingpapers_tpu_torch.native`) by default; a failed native build
raises. The Python merge loops are the plain versions: they run when
the caller passes ``native=False`` or sets
``SOLVINGPAPERS_TPU_TORCH_NO_NATIVE``. `trained_native` and
`encodes_native` say which path a tokenizer took.
"""

from __future__ import annotations

import json
import time
from collections import Counter

import numpy as np

from solvingpapers_tpu_torch import native as native_lib

try:  # stdlib `re` lacks \p{L}; `regex` ships with transformers
    import regex as _re

    _GPT2_SPLIT = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
    )
except ImportError:  # pragma: no cover
    import re as _re

    _GPT2_SPLIT = _re.compile(r" ?\w+| ?[^\w\s]+|\s+")


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping (so merges
    files are text-safe). Standard table: printable ASCII + latin-1 ranges
    stay themselves; the rest shift up past 255."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENC = bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def _best_pair(pairs: Counter, vocab: dict[str, int]):
    """Canonical best pair: max count, tie-break smallest (left, right) id."""
    best = max(
        pairs.items(),
        key=lambda kv: (kv[1], -vocab[kv[0][0]], -vocab[kv[0][1]]),
    )
    return best[0], best[1]


class ByteBPETokenizer:
    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 *, native: bool | None = None):
        """`native`: encode through the native library (None: unless
        ``SOLVINGPAPERS_TPU_TORCH_NO_NATIVE`` is set; False: the Python
        merge loop)."""
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self._cache: dict[str, list[str]] = {}
        # the native encoder, built at first encode; False = Python loop
        self._native = None if native_lib.use_native(native) else False
        self.trained_native = False  # set by `train` on the native path
        self.train_seconds = None  # host seconds `train` took

    @property
    def encodes_native(self) -> bool:
        """True when `encode` runs through the native library."""
        return self._native is not False

    def _native_encoder(self):
        """Native merge-loop encoder in vocab-id space (None on the
        Python path). Raises `native.NativeBuildError` when the library
        does not build, and KeyError when the tables lack a byte symbol
        or a merge's result (a malformed vocab, never a quiet fallback)."""
        if self._native is None:
            byte_to_id = np.asarray(
                [self.vocab[_BYTE_ENC[b]] for b in range(256)], np.int32
            )
            merges = np.asarray(
                [
                    (self.vocab[a], self.vocab[b], self.vocab[a + b])
                    for (a, b) in sorted(self.ranks, key=self.ranks.get)
                ],
                np.int32,
            ).reshape(-1, 3)
            self._native = native_lib.NativeBpeEncoder(byte_to_id, merges)
        return self._native or None

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ------------------------------------------------------------ construct

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "ByteBPETokenizer":
        """Load GPT-2-format vocab.json + merges.txt."""
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                line = line.rstrip("\n")
                # only the optional '#version' header is metadata — '#' is a
                # legitimate merge symbol (e.g. GPT-2's '# #' -> '##')
                if not line.strip() or (i == 0 and line.startswith("#version")):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def train(
        cls, text: str, vocab_size: int, *, min_pair_count: int = 2,
        native: bool | None = None,
    ) -> "ByteBPETokenizer":
        """Learn merges from `text` until `vocab_size` (>= 256) is reached.

        Best pair per round: max count, tie-break smallest (left_id,
        right_id) — the canonical order shared with the native trainer, so
        both produce identical tables. The native incremental trainer
        (native/_src/native.cpp) runs unless `native` is False or
        ``SOLVINGPAPERS_TPU_TORCH_NO_NATIVE`` is set (then this Python
        loop, the plain version and the parity oracle); the returned
        tokenizer encodes on the same path.
        """
        if vocab_size < 256:
            raise ValueError("byte-level BPE needs vocab_size >= 256")
        t0 = time.perf_counter()
        # word frequency over pre-tokenized chunks, as byte-unicode symbols
        words = Counter(
            tuple(_BYTE_ENC[b] for b in tok.encode("utf-8"))
            for tok in _GPT2_SPLIT.findall(text)
        )
        vocab = {c: i for i, c in enumerate(_BYTE_ENC[b] for b in range(256))}
        if native_lib.use_native(native):
            tok = cls._train_native(words, vocab, vocab_size, min_pair_count)
            tok.train_seconds = time.perf_counter() - t0
            return tok
        merges: list[tuple[str, str]] = []
        while len(vocab) < vocab_size:
            pairs: Counter = Counter()
            for word, freq in words.items():
                for pair in zip(word[:-1], word[1:]):
                    pairs[pair] += freq
            if not pairs:
                break
            best, count = _best_pair(pairs, vocab)
            if count < min_pair_count:
                break
            merges.append(best)
            merged = best[0] + best[1]
            vocab[merged] = len(vocab)

            def apply(word: tuple[str, ...]) -> tuple[str, ...]:
                out, i = [], 0
                while i < len(word):
                    if (
                        i < len(word) - 1
                        and word[i] == best[0]
                        and word[i + 1] == best[1]
                    ):
                        out.append(merged)
                        i += 2
                    else:
                        out.append(word[i])
                        i += 1
                return tuple(out)

            words = Counter(
                {apply(w): f for w, f in words.items()}
            )
        tok = cls(vocab, merges, native=False)
        tok.train_seconds = time.perf_counter() - t0
        return tok

    @classmethod
    def _train_native(cls, words: Counter, base_vocab: dict[str, int],
                      vocab_size: int, min_pair_count: int):
        """Run the C++ incremental trainer (raises when the library does
        not build). Byte symbols map to ids 0..255 (base_vocab's
        assignment) and merge i creates id 256+i, matching the Python
        loop exactly."""
        items = list(words.items())
        flat, offsets, freqs = [], [0], []
        for word, freq in items:
            flat.extend(_BYTE_DEC[c] for c in word)
            offsets.append(len(flat))
            freqs.append(freq)
        pairs = native_lib.bpe_train_native(
            np.asarray(flat, np.int32), np.asarray(offsets, np.int64),
            np.asarray(freqs, np.int64), vocab_size - 256, min_pair_count,
        )
        syms = [_BYTE_ENC[b] for b in range(256)]
        vocab = dict(base_vocab)
        merges: list[tuple[str, str]] = []
        for left, right in pairs:
            a, b = syms[int(left)], syms[int(right)]
            merges.append((a, b))
            syms.append(a + b)
            vocab[a + b] = len(vocab)
        tok = cls(vocab, merges, native=True)
        tok.trained_native = True
        return tok

    def save(self, vocab_path: str, merges_path: str) -> None:
        with open(vocab_path, "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        with open(merges_path, "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for a, b in sorted(self.ranks, key=self.ranks.get):
                f.write(f"{a} {b}\n")

    # --------------------------------------------------------------- encode

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = _get_pairs(word)
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        result = list(word)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> np.ndarray:
        chunks = _GPT2_SPLIT.findall(text)
        enc = self._native_encoder()
        if enc is not None:
            return enc.encode_texts(chunks)
        ids: list[int] = []
        for tok in chunks:
            symbols = "".join(_BYTE_ENC[b] for b in tok.encode("utf-8"))
            ids.extend(self.vocab[s] for s in self._bpe(symbols))
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        text = "".join(self.inv_vocab[int(i)] for i in ids)
        return bytes(_BYTE_DEC[c] for c in text).decode("utf-8", errors="replace")


def gpt2_tokenizer(vocab_path: str | None = None,
                   merges_path: str | None = None):
    """The reference's GPT-2 BPE (50257 tokens) if obtainable offline:
    local files > tiktoken cache > HF cache; raises with guidance otherwise."""
    if vocab_path and merges_path:
        return ByteBPETokenizer.from_files(vocab_path, merges_path)
    try:
        import tiktoken

        enc = tiktoken.get_encoding("gpt2")

        class _Tik:
            vocab_size = enc.n_vocab

            def encode(self, text):
                return np.asarray(
                    enc.encode(text, allowed_special="all"), dtype=np.int32
                )

            def decode(self, ids):
                return enc.decode([int(i) for i in ids])

        return _Tik()
    except Exception:
        pass
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained("gpt2", local_files_only=True)

        class _HF:
            vocab_size = tok.vocab_size

            def encode(self, text):
                return np.asarray(tok.encode(text), dtype=np.int32)

            def decode(self, ids):
                return tok.decode([int(i) for i in ids])

        return _HF()
    except Exception:
        pass
    raise RuntimeError(
        "GPT-2 BPE tables unavailable offline. Pass vocab.json/merges.txt "
        "paths, or train a corpus tokenizer with ByteBPETokenizer.train()."
    )
