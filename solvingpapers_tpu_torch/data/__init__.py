"""Data pipelines (port of `solvingpapers_tpu/data`: the LM batch
streams, the token files, the char and byte-level BPE tokenizers, the
corpora, and the synthetic text corpora). The image sources come with a
later slice."""

from solvingpapers_tpu_torch.data.batches import (
    lm_batch_iterator,
    prefetch_batches,
    random_crop_batch,
    sliding_window_split,
)
from solvingpapers_tpu_torch.data.bpe import ByteBPETokenizer, gpt2_tokenizer
from solvingpapers_tpu_torch.data.char import (
    CharTokenizer,
    load_char_corpus,
    load_text,
    split_train_val,
)
from solvingpapers_tpu_torch.data.synthetic import (
    MarkovSource,
    markov_entropy_nats,
    markov_text,
    synthetic_text,
)
from solvingpapers_tpu_torch.data.tokens import (
    load_token_file,
    token_file_max_id,
    tokenize_to_file,
)

__all__ = [
    "ByteBPETokenizer",
    "CharTokenizer",
    "MarkovSource",
    "gpt2_tokenizer",
    "lm_batch_iterator",
    "load_char_corpus",
    "load_text",
    "load_token_file",
    "markov_entropy_nats",
    "markov_text",
    "prefetch_batches",
    "random_crop_batch",
    "sliding_window_split",
    "split_train_val",
    "synthetic_text",
    "token_file_max_id",
    "tokenize_to_file",
]
