"""Deterministic synthetic corpora (port of the text half of
`solvingpapers_tpu/data/synthetic.py`).

The reference fetches Tiny-Shakespeare by URL; with no network, its
char pipelines train on seeded synthetic text instead. Everything here is
numpy `default_rng` code, so the port's text equals the reference's bit
for bit at the same seed. The image sources (`GaussianImageSource`,
`synthetic_images`) come with the image families.
"""

from __future__ import annotations

import functools
import string

import numpy as np

_WORDS = (
    "the quick brown fox jumps over lazy dog when winter comes to verona "
    "and all our yesterdays have lighted fools the way to dusty death out "
    "brief candle life is but walking shadow a poor player that struts and "
    "frets his hour upon the stage and then is heard no more it is a tale "
    "told by an idiot full of sound and fury signifying nothing my lord "
    "what say you to this most noble friend shall we proceed anon good sir"
).split()


def synthetic_text(n_chars: int = 200_000, seed: int = 0) -> str:
    """Pseudo-prose with word/sentence structure (learnable char statistics)."""
    rng = np.random.default_rng(seed)
    out: list[str] = []
    total = 0
    while total < n_chars:
        sent_len = int(rng.integers(4, 12))
        words = rng.choice(_WORDS, size=sent_len)
        sent = " ".join(words).capitalize() + ". "
        if rng.random() < 0.1:
            sent = "\n" + sent
        out.append(sent)
        total += len(sent)
    return "".join(out)[:n_chars]


class MarkovSource:
    """Seeded order-k Markov chain over a printable alphabet with an exactly
    computable per-token entropy rate (nats).

    Purpose: give held-out loss an ABSOLUTE target in a zero-egress
    environment (the verification contract of SURVEY.md §4 items 1-2 — the
    reference validates against real Shakespeare/TinyStories val losses,
    gpt/gpt-jax.ipynb cell 18). The chain's entropy rate
    ``H = sum_s pi(s) * H(T[s, :])`` is the information-theoretic floor for
    per-token cross-entropy on held-out text: an ideal order-k model attains
    exactly H, while a model that memorizes the training stream stays near
    the unconditional entropy (~ln(vocab)) on validation. ``val_loss - H``
    is therefore a calibrated generalization gap that table lookup cannot
    fake.

    Transitions are Dirichlet(alpha) draws per state — ``alpha`` tunes the
    entropy rate (smaller = peakier = lower H). Everything is derived from
    the seed; the same (vocab, order, alpha, seed) always yields the same
    chain, so entropy numbers are comparable across rounds.
    """

    def __init__(self, vocab: int = 64, order: int = 2, alpha: float = 0.1,
                 seed: int = 1234):
        if not (2 <= vocab <= 64):
            raise ValueError(f"vocab must be in [2, 64], got {vocab}")
        self.vocab = vocab
        self.order = order
        self.alpha = alpha
        self.seed = seed
        # 64 distinct printable symbols, no regex/JSON metacharacters
        self.alphabet = (string.ascii_lowercase + string.ascii_uppercase
                         + string.digits + " .")[:vocab]
        self.n_states = vocab ** order
        rng = np.random.default_rng(seed)
        # (S, V) conditional distributions; float64 so entropy sums are exact
        self.T = rng.dirichlet(np.full(vocab, alpha), size=self.n_states)

    @functools.cached_property
    def stationary(self) -> np.ndarray:
        """Stationary distribution over order-k states (power iteration).

        State s = last k symbols; emitting c moves s -> (s mod V^(k-1))*V + c.
        """
        V, S = self.vocab, self.n_states
        target = (np.arange(S)[:, None] % (S // V)) * V + np.arange(V)[None, :]
        pi = np.full(S, 1.0 / S)
        for _ in range(500):
            nxt = np.bincount(target.ravel(), weights=(pi[:, None] * self.T).ravel(),
                              minlength=S)
            if np.abs(nxt - pi).sum() < 1e-13:
                pi = nxt
                break
            pi = nxt
        return pi / pi.sum()

    @functools.cached_property
    def entropy_rate_nats(self) -> float:
        """Exact per-token conditional entropy H(X_t | last k symbols), nats."""
        Hs = -np.sum(np.where(self.T > 0, self.T * np.log(self.T), 0.0), axis=1)
        return float(self.stationary @ Hs)

    @classmethod
    def from_config(cls, data_cfg: dict) -> "MarkovSource":
        """The single source of chain hyperparameter defaults — used by both
        the data factory (corpus construction) and markov_entropy_nats (the
        gating floor), so the trained-on chain and the entropy target can
        never drift apart. Returns a cached instance per parameter tuple
        (the Dirichlet draw + power iteration are worth building once)."""
        return _cached_source(
            data_cfg.get("markov_vocab", 64),
            data_cfg.get("markov_order", 2),
            data_cfg.get("markov_alpha", 0.1),
            data_cfg.get("markov_seed", 1234),
        )

    def sample(self, n_chars: int, seed: int = 0) -> str:
        """Draw n_chars symbols; start state from the stationary distribution."""
        V = self.vocab
        rng = np.random.default_rng((self.seed, seed))
        cdf = np.cumsum(self.T, axis=1)
        cdf[:, -1] = 1.0  # guard fp round-off at the tail
        state = int(rng.choice(self.n_states, p=self.stationary))
        u = rng.random(n_chars)
        wrap = self.n_states // V
        out = np.empty(n_chars, np.int64)
        for i in range(n_chars):
            c = int(np.searchsorted(cdf[state], u[i], side="right"))
            out[i] = c
            state = (state % wrap) * V + c
        syms = np.frombuffer(self.alphabet.encode(), np.uint8)
        return syms[out].tobytes().decode()


@functools.lru_cache(maxsize=4)
def _cached_source(vocab: int, order: int, alpha: float, seed: int) -> MarkovSource:
    return MarkovSource(vocab=vocab, order=order, alpha=alpha, seed=seed)


def markov_entropy_nats(data_cfg: dict) -> float:
    """Entropy rate for a ``{"source": "markov", ...}`` data config — the
    absolute val-loss target its corpus carries."""
    return MarkovSource.from_config(data_cfg).entropy_rate_nats


@functools.lru_cache(maxsize=4)
def _sample_cached(vocab: int, order: int, alpha: float, seed: int,
                   n_chars: int, sample_seed: int) -> str:
    # value-tuple key (not source identity): entries stay reachable even
    # after the source instance is evicted from _cached_source
    return _cached_source(vocab, order, alpha, seed).sample(
        n_chars, seed=sample_seed
    )


def markov_text(data_cfg: dict) -> str:
    """Corpus text for a markov data config. Cached: the parity suite's four
    LM rows share one pinned chain, and the sequential sampler is a
    per-character Python loop (~10s per 4M chars) worth running once."""
    src = MarkovSource.from_config(data_cfg)
    return _sample_cached(
        src.vocab, src.order, src.alpha, src.seed,
        data_cfg.get("n_chars", 1_000_000), data_cfg.get("sample_seed", 0),
    )
