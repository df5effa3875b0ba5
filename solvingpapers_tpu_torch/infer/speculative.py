"""MTP self-speculative decoding for the DeepSeek-V3 family (port of
`solvingpapers_tpu/infer/speculative.py`).

Each iteration runs ONE main forward over a chunk: the last committed
token and the MTP head drafts after it. The chunk's logits verify the
drafts with accept-prefix semantics; an iteration commits 1 + the number
of accepted drafts. Committed tokens are always the main model's argmax,
so the output equals greedy `generate` token for token: drafts change
how many forwards it takes, not what comes out.

* Each head is a small autoregressive model over merged rows, so it has
  its OWN latent cache, prefilled beside the main one
  (`models.deepseekv3.mtp_head_apply`).
* A rejected draft leaves garbage in the chunk's later cache rows (main
  and heads). The next chunk starts at exactly that position and writes
  over it before any query attends it: the masks are positional.
* Two drafts (`n_drafts=2`) chain the heads as training does: head 1's
  layer output is head 2's input, and head 2's newest column embeds head
  1's fresh draft, the only token that exists at that offset yet (an
  unverified row that can lower later acceptance, never change output).
* Greedy and batch 1 only. The serving engine (`ServeConfig(
  speculative="mtp")`) runs the same mechanics per slot.

The decode forwards write a 2-3 token chunk at per-row offsets, which
clamp column by column (`infer.cache._write_rows`); the caches carry
``n_drafts + 1`` rows of slack past the last position besides, as the
serving lanes do, so no chunk write reaches the cache's end.

Each iteration reads back one small tensor (the committed tokens, the
accepted count and the next drafts): the loop's length depends on it.
"""

from __future__ import annotations

import torch

from solvingpapers_tpu_torch.device import resolve_device
from solvingpapers_tpu_torch.infer.cache import LatentCache


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


@torch.no_grad()
def generate_speculative(model, prompt: torch.Tensor, *,
                         max_new_tokens: int = 64,
                         prefill_chunk: int | None = None,
                         n_drafts: int = 1,
                         device: str | torch.device | None = None):
    """Greedy decode of `prompt` (1, S0) with MTP-draft speculation.

    Returns (tokens (1, S0 + max_new_tokens) int64, stats): stats holds
    `forwards` (main forwards in the decode loop) and `accepted` (drafts
    that verified), so tokens a forward = 1 + accepted / forwards. The
    model must have ``mtp_heads >= n_drafts`` and be in eval mode on
    `device` (default ``cuda``)."""
    from solvingpapers_tpu_torch.models.deepseekv3 import mtp_head_apply

    if n_drafts not in (1, 2):
        raise ValueError(f"n_drafts must be 1 or 2, got {n_drafts}")
    cfg = model.cfg
    if getattr(cfg, "mtp_heads", 0) < n_drafts:
        raise ValueError(
            f"speculative decode with n_drafts={n_drafts} needs a model "
            f"with mtp_heads >= {n_drafts}")
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model lives on {model.device}, generate_speculative "
                         f"was asked to run on {device}")
    prompt = torch.as_tensor(prompt, device=device).long()
    b, s0 = prompt.shape
    if b != 1:
        raise ValueError(
            "speculative decode supports batch 1: rows accept drafts at "
            "different rates, which breaks the contiguous cache write")
    if s0 < n_drafts + 1:
        raise ValueError(f"prompt must have at least {n_drafts + 1} tokens")
    # chunk positions reach s0 + max_new + n_drafts - 2 (p tops out at
    # s0 + max_new - 2 entering the last iteration)
    limit = getattr(model, "max_positions", None)
    if limit is not None and s0 + max_new_tokens + n_drafts - 1 > limit:
        raise ValueError(
            f"prompt+new+drafts = {s0 + max_new_tokens + n_drafts - 1} "
            f"exceeds the model's max positions {limit}")
    if prefill_chunk is None and s0 > 4096:
        prefill_chunk = 2048  # generate()'s auto-chunk rule
    total = s0 + max_new_tokens + n_drafts + 1
    width = cfg.latent_dim + cfg.rope_dim

    def head_cache():
        return LatentCache.init(1, total, width, cfg.compute_dtype,
                                device=device)

    def arange(start, end):
        return torch.arange(start, end, device=device)[None]

    caches = model.init_caches(1, total)
    # ---- prefill the main caches, keeping the post-norm hiddens
    step = prefill_chunk or s0
    hs = []
    for start in range(0, s0, step):
        end = min(start + step, s0)
        (logits, h), caches = model(prompt[:, start:end],
                                    positions=arange(start, end),
                                    caches=caches, attend_len=end,
                                    return_hidden=True)
        hs.append(h)
    h_all = torch.cat(hs, dim=1)  # (1, s0, D)
    t1 = _argmax(logits[:, -1])  # (1,)

    # ---- head 1's cache over positions [0, s0 - 1), where the
    # next-token stream is the prompt itself; keep its layer outputs
    # (head 2's input stream)
    c1 = head_cache()
    y1s = []
    for start in range(0, s0 - 1, step):
        end = min(start + step, s0 - 1)
        _, y1, c1, _ = mtp_head_apply(model, h_all[:, start:end],
                                      prompt[:, start + 1:end + 1],
                                      arange(start, end), cache=c1,
                                      attend_len=end)
        y1s.append(y1)
    # bootstrap at position s0 - 1: the prompt's last hidden and the
    # decoded t1 draft position s0 + 1
    g, y1_last, c1, _ = mtp_head_apply(model, h_all[:, -1:], t1[:, None],
                                       arange(s0 - 1, s0), cache=c1)
    d1 = _argmax(g[:, -1])
    c2 = d2 = None
    if n_drafts == 2:
        # head 2's cache over positions [0, s0 - 2): merged(y1_i, emb of
        # token i + 2), both verified there
        c2 = head_cache()
        y1_all = torch.cat([*y1s, y1_last], dim=1)  # (1, s0, D)
        for start in range(0, s0 - 2, step):
            end = min(start + step, s0 - 2)
            _, _, c2, _ = mtp_head_apply(model, y1_all[:, start:end],
                                         prompt[:, start + 2:end + 2],
                                         arange(start, end), cache=c2,
                                         attend_len=end, head=2)
        # bootstrap head 2 over columns [s0 - 2, s0 - 1]: next tokens t1
        # (verified) and head 1's draft d1 (the documented taint)
        g2, _, c2, _ = mtp_head_apply(model, y1_all[:, s0 - 2:s0],
                                      torch.stack([t1, d1], dim=1),
                                      arange(s0 - 2, s0), cache=c2, head=2)
        d2 = _argmax(g2[:, -1])

    out = [int(t1[0])]
    forwards = accepted = 0
    cols = torch.arange(n_drafts + 1, device=device)
    p = s0
    t = t1
    while len(out) < max_new_tokens:
        drafts = [d1] if n_drafts == 1 else [d1, d2]
        chunk = torch.stack([t, *drafts], dim=1)  # (1, 1 + n)
        positions = (p + cols)[None]
        (lg, hk), caches = model(chunk, positions=positions, caches=caches,
                                 return_hidden=True)
        true = _argmax(lg[0])  # (1 + n,): the token after each column
        ok = (true[:-1] == chunk[0, 1:]).long().cumprod(0)
        a = ok.sum()  # accepted drafts, a tensor: no read yet
        # head 1 over the chunk's columns: its next-token stream is the
        # main model's argmax (columns past the cut are overwritten by
        # the next chunk before anything attends them)
        g1, y1, c1, _ = mtp_head_apply(model, hk, true[None], positions,
                                       cache=c1)
        d1 = _argmax(g1[0, a])[None]
        if n_drafts == 2:
            # head 2 on head 1's layer output; column a embeds head 1's
            # fresh draft
            nxt2 = torch.cat([true[1:], true[-1:]])
            nxt2 = torch.where(cols == a, d1, nxt2)
            g2, _, c2, _ = mtp_head_apply(model, y1, nxt2[None], positions,
                                          cache=c2, head=2)
            d2 = _argmax(g2[0, a])[None]
        # one read: the committed tokens, the accepted count, the drafts
        got = torch.cat([true, a[None], d1] + ([d2] if n_drafts == 2 else []))
        got = got.tolist()
        n_ok = got[n_drafts + 1]
        out.extend(got[:n_ok + 1])
        t = true[n_ok][None]
        p += 1 + n_ok
        forwards += 1
        accepted += n_ok
    tokens = torch.cat([prompt, torch.as_tensor(out[:max_new_tokens],
                                                device=device)[None]], dim=1)
    return tokens, {"forwards": forwards, "accepted": accepted}
