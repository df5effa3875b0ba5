"""The port's text corpora and char tokenizer vs the JAX package's.

Both are numpy `default_rng` code, so at the same seeds the port's text
must equal the reference's exactly: `synthetic_text`, the Markov chain
(`MarkovSource`: transitions, stationary distribution, entropy rate and
samples), `markov_text` and `markov_entropy_nats` of a data config, and
the `CharTokenizer` and `load_char_corpus` built on them (vocab, ids,
train/val split).
"""

import numpy as np
import pytest

from solvingpapers_tpu.data import char as jchar
from solvingpapers_tpu.data import synthetic as jsyn
from solvingpapers_tpu_torch.data import char, synthetic


@pytest.mark.parametrize("n_chars,seed", [(5_000, 0), (20_000, 7), (1, 3)])
def test_synthetic_text_equals_the_reference(n_chars, seed):
    assert synthetic.synthetic_text(n_chars, seed) == jsyn.synthetic_text(n_chars, seed)


@pytest.mark.parametrize("vocab,order,alpha,seed", [(64, 2, 0.1, 1234),
                                                    (16, 1, 0.5, 5)])
def test_markov_source_equals_the_reference(vocab, order, alpha, seed):
    ours = synthetic.MarkovSource(vocab, order, alpha, seed)
    ref = jsyn.MarkovSource(vocab, order, alpha, seed)
    assert ours.alphabet == ref.alphabet
    assert np.array_equal(ours.T, ref.T)
    assert np.array_equal(ours.stationary, ref.stationary)
    assert ours.entropy_rate_nats == ref.entropy_rate_nats
    assert ours.sample(3_000, seed=2) == ref.sample(3_000, seed=2)


@pytest.mark.parametrize("data", [
    {"source": "markov", "n_chars": 6_000},
    {"source": "markov", "n_chars": 4_000, "markov_vocab": 32,
     "markov_alpha": 0.3, "markov_seed": 9, "sample_seed": 4},
])
def test_markov_text_and_entropy_of_a_config_equal_the_reference(data):
    assert synthetic.markov_text(data) == jsyn.markov_text(data)
    assert synthetic.markov_entropy_nats(data) == jsyn.markov_entropy_nats(data)
    assert (synthetic.MarkovSource.from_config(data).T.shape
            == jsyn.MarkovSource.from_config(data).T.shape)


def test_markov_source_refuses_a_vocab_out_of_range():
    with pytest.raises(ValueError, match="vocab"):
        synthetic.MarkovSource(vocab=65)


def test_char_tokenizer_equals_the_reference():
    text = jsyn.synthetic_text(3_000, 1) + "\n!?"
    ours, ref = char.CharTokenizer(text), jchar.CharTokenizer(text)
    assert ours.chars == ref.chars and ours.vocab_size == ref.vocab_size
    ids = ours.encode(text)
    assert ids.dtype == np.int32 and np.array_equal(ids, ref.encode(text))
    assert ours.decode(ids) == text == ref.decode(ids)


@pytest.mark.parametrize("kw", [dict(), dict(synthetic_chars=7_000, seed=5,
                                             val_fraction=0.2)])
def test_load_char_corpus_equals_the_reference(kw):
    tok, train, val = char.load_char_corpus(**kw)
    jtok, jtrain, jval = jchar.load_char_corpus(**kw)
    assert tok.chars == jtok.chars
    assert np.array_equal(train, jtrain) and np.array_equal(val, jval)


def test_load_text_reads_a_local_file(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("to be or not to be\n", encoding="utf-8")
    assert char.load_text(str(path)) == jchar.load_text(str(path))
    assert char.load_text(str(tmp_path / "missing.txt"), 100, 2) == \
        jsyn.synthetic_text(100, 2)
