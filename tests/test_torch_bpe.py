"""The port's byte-level BPE and its native library against the JAX
package's (`data/bpe.py`, `native/`).

* Trained natively and in Python, the port's BPE gives the reference's
  merges, vocab and ids on the same text; decode round-trips bytes
  exactly (multi-byte UTF-8 and whitespace runs included); GPT-2 format
  tables save and load back.
* `gather_windows_native` equals the numpy crop for every token dtype,
  and a memory-mapped corpus streams the reference's batches bit for bit
  on either path.
* The factory's "bpe" branch builds the reference's tokenizer and resizes
  the model's vocab to it.
* A failed native build raises with the compiler's message; the plain
  Python paths run only when asked for by name.

Builds go to the gitignored `solvingpapers_tpu_torch/native/build/` (or
a temporary directory for the failing build).
"""

import numpy as np
import pytest

from solvingpapers_tpu.data.batches import lm_batch_iterator as jlm_batch_iterator
from solvingpapers_tpu.data.bpe import ByteBPETokenizer as JByteBPETokenizer
from solvingpapers_tpu_torch import native
from solvingpapers_tpu_torch.configs import get_config
from solvingpapers_tpu_torch.configs.factory import build_char_lm_run
from solvingpapers_tpu_torch.data import ByteBPETokenizer, lm_batch_iterator, synthetic_text

SAMPLES = ["The quick brown fox jumps over the lazy dog. éü☃ 漢字",
           "", "  \n\t mixed   whitespace 123 #tags", "don't we'll I'm"]


@pytest.fixture(scope="module")
def text():
    return synthetic_text(15_000, seed=4)


@pytest.fixture(scope="module")
def reference(text):
    return JByteBPETokenizer.train(text, vocab_size=380)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_train_and_encode_match_the_reference(text, reference, use_native):
    tok = ByteBPETokenizer.train(text, vocab_size=380, native=use_native)
    assert tok.trained_native is use_native and tok.encodes_native is use_native
    assert tok.vocab == reference.vocab and tok.ranks == reference.ranks
    for sample in SAMPLES + [text[:2000]]:
        ids = tok.encode(sample)
        np.testing.assert_array_equal(ids, reference.encode(sample))
        assert tok.decode(ids) == sample


def test_save_and_from_files_round_trip(text, tmp_path):
    tok = ByteBPETokenizer.train(text, vocab_size=300)
    v, m = str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")
    tok.save(v, m)
    back = ByteBPETokenizer.from_files(v, m)
    ref = JByteBPETokenizer.from_files(v, m)
    assert back.vocab == tok.vocab == ref.vocab and back.ranks == ref.ranks
    np.testing.assert_array_equal(back.encode(text[:500]), ref.encode(text[:500]))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.int32, np.uint8,
                                   np.int64])
def test_gather_windows_equals_the_numpy_crop(dtype):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 200, size=5_000).astype(dtype)
    starts = rng.integers(0, 5_000 - 65, size=16)
    x, y = native.gather_windows_native(toks, starts, 64)
    np.testing.assert_array_equal(
        x, np.stack([toks[s:s + 64] for s in starts]).astype(np.int32))
    np.testing.assert_array_equal(
        y, np.stack([toks[s + 1:s + 65] for s in starts]).astype(np.int32))


def test_memmap_batches_are_the_reference_batches_on_both_paths(tmp_path):
    path = tmp_path / "toks.bin"
    np.random.default_rng(1).integers(0, 50_000, size=20_000).astype(
        np.uint16).tofile(path)
    toks = np.memmap(path, dtype=np.uint16, mode="r")
    ref = jlm_batch_iterator(toks, 4, 32, seed=3)
    fast = lm_batch_iterator(toks, 4, 32, seed=3)
    plain = lm_batch_iterator(toks, 4, 32, seed=3, native=False)
    for _ in range(3):
        want = next(ref)
        for got in (next(fast), next(plain)):
            np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
            np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))


def test_factory_bpe_branch_builds_the_reference_tokenizer():
    cfg = get_config("dsv3_long")
    cfg = cfg.__class__(**{**cfg.__dict__, "data": {
        **cfg.data, "block_size": 64, "bpe_vocab_size": 320,
        "synthetic_chars": 20_000}})
    cfg, _, tok, train_iter, _ = build_char_lm_run(cfg, device="meta")
    ref = JByteBPETokenizer.train(synthetic_text(20_000, 0), 320)
    assert tok.vocab == ref.vocab and cfg.model.vocab_size == tok.vocab_size == 320
    assert tok.trained_native
    batch = next(train_iter)
    assert batch["x"].shape == (cfg.train.batch_size, 64)
    assert int(batch["x"].max()) < 320


def test_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    bad = tmp_path / "native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ exit"):
        ByteBPETokenizer.train("a b c a b", 260)
    with pytest.raises(native.NativeBuildError, match="error"):
        native.gather_windows_native(np.arange(10, dtype=np.int32), [0], 4)
    assert not list((tmp_path / "build").glob("*.so"))
    # the plain paths run only when asked for by name
    assert ByteBPETokenizer.train("a b c a b", 260, native=False).vocab_size == 257
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    tok = ByteBPETokenizer.train("a b c a b", 260)
    assert not tok.trained_native and not tok.encodes_native
    assert tok.decode(tok.encode("a b")) == "a b"
