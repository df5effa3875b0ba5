"""Task objectives beyond the default LM loss (port of the DeepSeek-V3
objective of `solvingpapers_tpu/train/objectives.py`).

An objective is ``loss_fn(model, batch, dropout_seed) -> (loss, aux,
model_state)``: `aux` holds scalar metrics, `model_state` the model's new
non-trainable state ({buffer name: tensor}, or None), which `Trainer`
installs after the optimizer step — the reference's
``apply_gradients(grads, new_model_state)``.
"""

from __future__ import annotations

import torch

from solvingpapers_tpu_torch import ops
from solvingpapers_tpu_torch.models.deepseekv3 import moe_metrics, routing_state


def dsv3_loss_fn(model, batch, dropout_seed=None):
    """DeepSeek-V3 objective: next-token CE, plus `balance_loss_weight`
    times the mean per-layer balance loss when that weight is set, plus
    `mtp_loss_weight` times the multi-token-prediction loss when the
    model has MTP heads (`aux["mtp_loss"]`; added to the accumulated
    loss, balance term included, as the reference adds it). In training,
    the `moe_*` stats averaged over every MoE layer, the MTP layers'
    included (the `ci` load vector skipped), and the new routing biases
    as the model state."""
    cfg = model.cfg
    use_mtp = cfg.mtp_heads > 0
    new_ms, metrics, balance = None, {}, []
    if model.training:
        out, _, stats = model(batch["x"], dropout_seed=dropout_seed,
                              return_stats=True, return_mtp=use_mtp)
        new_ms = routing_state(stats, cfg.n_layers)
        metrics = moe_metrics(stats)
        balance = [st["balance_loss"] for st in stats if "balance_loss" in st]
    else:
        out, _ = model(batch["x"], return_mtp=use_mtp)
    logits, mtp_logits = out if use_mtp else (out, None)
    main = ops.cross_entropy(logits, batch["y"])
    aux = {"perplexity": torch.exp(main), **metrics}
    loss = main
    if balance:
        bal = torch.stack(balance).mean()
        aux["balance_loss"] = bal
        loss = loss + cfg.balance_loss_weight * bal
    if mtp_logits is not None:
        # head j's target is token i + (j + 1) + 1: y holds tokens 1..T,
        # the unknown tail is padded with the ignored -1
        k = cfg.mtp_heads
        y = batch["y"]
        pad = torch.full((y.shape[0], k), -1, dtype=y.dtype, device=y.device)
        mtp = ops.mtp_loss(mtp_logits, torch.cat([y, pad], dim=1), k,
                           ignore_index=-1)
        aux["mtp_loss"] = mtp
        loss = loss + cfg.mtp_loss_weight * mtp
    return loss, aux, new_ms
