"""Token cross-entropy (port of `cross_entropy` in
`solvingpapers_tpu/ops/losses.py`).

Mean cross-entropy of integer labels over logits of any float dtype,
computed in float32, with an optional ``ignore_index``. Past
``2**28`` logit elements the loss chunks itself over rows (8192 at a
time) under `torch.utils.checkpoint`, so the float32 log-softmax of one
chunk exists at a time and is recomputed in the backward: only the
logits in their own dtype persist. At the training slice's shape
(16384 rows x 50257) that is the difference between one 1.6 GB bf16
tensor and three 3.3 GB float32 ones.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

_AUTO_CHUNK_ELEMENTS = 2**28
_AUTO_CHUNK_ROWS = 8192


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int | None = None,
                  chunk_size: int | None | str = "auto") -> torch.Tensor:
    """Mean cross-entropy of `labels` (..., int) under `logits` (..., V).

    chunk_size: rows per chunk, None for one pass, or "auto" (the
    reference's rule: chunk at 8192 rows once ``logits.numel() > 2**28``).
    Rows whose label is `ignore_index` count neither in the sum nor in
    the mean's denominator (which is at least 1).
    """
    if chunk_size == "auto":
        chunk_size = (_AUTO_CHUNK_ROWS
                      if logits.numel() > _AUTO_CHUNK_ELEMENTS else None)
    flat = logits.reshape(-1, logits.shape[-1])
    lab = labels.reshape(-1).long()
    if chunk_size is None:
        tot, num = _nll_sum_count(flat, lab, ignore_index)
    else:
        tot = num = 0.0
        # split (not slicing): one backward node concatenates the chunks'
        # gradients instead of allocating a full-size zero tensor per chunk
        for lg, lb in zip(flat.split(chunk_size), lab.split(chunk_size)):
            t, c = checkpoint(_nll_sum_count, lg, lb, ignore_index,
                              use_reentrant=False)
            tot, num = tot + t, num + c
    return tot / num.clamp(min=1.0)


def _nll_sum_count(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int | None):
    """(sum of the rows' negative log-likelihoods, number of rows
    counted), in float32."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    if ignore_index is None:
        picked = lg.gather(-1, labels[:, None])[:, 0]
        return (lse - picked).sum(), torch.tensor(
            float(labels.shape[0]), device=lg.device)
    valid = labels != ignore_index
    # gather with sanitized indices: a sentinel such as -100 is no row
    picked = lg.gather(-1, torch.where(valid, labels, 0)[:, None])[:, 0]
    mask = valid.float()
    return ((lse - picked) * mask).sum(), mask.sum()
