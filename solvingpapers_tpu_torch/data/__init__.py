"""Data pipelines (port of `solvingpapers_tpu/data`: the token-file LM
stream the training slice reads). Tokenizers (char, BPE) and the
synthetic corpora come with later slices."""

from solvingpapers_tpu_torch.data.batches import (
    lm_batch_iterator,
    prefetch_batches,
    random_crop_batch,
    sliding_window_split,
)
from solvingpapers_tpu_torch.data.char import split_train_val
from solvingpapers_tpu_torch.data.tokens import (
    load_token_file,
    token_file_max_id,
    tokenize_to_file,
)

__all__ = [
    "lm_batch_iterator",
    "load_token_file",
    "prefetch_batches",
    "random_crop_batch",
    "sliding_window_split",
    "split_train_val",
    "token_file_max_id",
    "tokenize_to_file",
]
