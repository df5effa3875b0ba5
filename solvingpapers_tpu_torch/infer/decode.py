"""One-shot autoregressive generation (port of
`solvingpapers_tpu/infer/decode.py::generate`) — the reference stream the
serving engine is held against.

Prefill passes a static `attend_len` to the model, so cached attention
runs END-aligned causal over only the written cache slots (the flash
kernel for `use_flash` models) instead of masked dense scores over the
whole preallocated cache. `prefill_chunk` feeds the prompt in chunks —
chunk i attends to cache slots [0, end_i) with the same kernel call,
writing as it goes — and prompts above 4096 tokens are chunked at 2048
when no chunk is given. Then one single-token forward per emitted token.
"""

from __future__ import annotations

from typing import Callable

import torch

from solvingpapers_tpu_torch import ops
from solvingpapers_tpu_torch.device import resolve_device


@torch.no_grad()
def generate(
    model,
    prompt: torch.Tensor,
    *,
    max_new_tokens: int = 64,
    sampler: Callable = ops.sample_greedy,
    generator: torch.Generator | None = None,
    max_len: int | None = None,
    eos_id: int | None = None,
    prefill_chunk: int | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Generate `max_new_tokens` continuations of `prompt` (B, S0) ints.

    Returns (B, S0 + max_new_tokens) int64 on `device` (default ``cuda``,
    raising when there is none; the model must already live there).
    `sampler(logits, generator)` draws one token per row from (B, vocab)
    logits. With `eos_id`, once a row samples EOS every later position of
    that row is EOS (the loop itself always runs max_new_tokens steps,
    as in the reference).
    """
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model lives on {model.device}, generate was asked "
                         f"to run on {device}")
    prompt = torch.as_tensor(prompt, device=device).long()
    b, s0 = prompt.shape
    total = s0 + max_new_tokens
    if max_len is None:
        max_len = total
    if total > max_len:
        raise ValueError(f"prompt+new tokens {total} exceed cache max_len {max_len}")
    limit = getattr(model, "max_positions", None)
    if limit is not None and total > limit:
        raise ValueError(
            f"prompt+new tokens {total} exceed the model's max positions {limit}"
        )

    caches = model.init_caches(b, max_len)
    if prefill_chunk is None and s0 > 4096:
        # the reference's auto-chunk threshold for long prompts
        prefill_chunk = 2048
    step = s0 if prefill_chunk is None else prefill_chunk
    for start in range(0, s0, step):
        end = min(start + step, s0)
        positions = torch.arange(start, end, device=device).expand(b, end - start)
        logits, caches = model(prompt[:, start:end], positions=positions,
                               caches=caches, attend_len=end)
    tok = sampler(logits[:, -1], generator).long()
    done = tok == eos_id if eos_id is not None else None
    out = [tok]
    for pos in range(s0, total - 1):
        logits, caches = model(tok[:, None],
                               positions=torch.full((b, 1), pos, device=device),
                               caches=caches)
        new_tok = sampler(logits[:, -1], generator).long()
        if eos_id is not None:
            new_tok = torch.where(done, torch.full_like(new_tok, eos_id), new_tok)
            done = done | (new_tok == eos_id)
        out.append(new_tok)
        tok = new_tok
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
