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
    times the mean per-layer balance loss when that weight is set; in
    training, the `moe_*` stats averaged over layers (the `ci` load vector
    skipped) and the new routing biases as the model state. Multi-token
    prediction is not ported (the model refuses `mtp_heads > 0`)."""
    cfg = model.cfg
    new_ms, metrics, balance = None, {}, []
    if model.training:
        logits, _, stats = model(batch["x"], dropout_seed=dropout_seed,
                                 return_stats=True)
        new_ms = routing_state(stats)
        metrics = moe_metrics(stats)
        balance = [st["balance_loss"] for st in stats if "balance_loss" in st]
    else:
        logits, _ = model(batch["x"])
    main = ops.cross_entropy(logits, batch["y"])
    aux = {"perplexity": torch.exp(main), **metrics}
    loss = main
    if balance:
        bal = torch.stack(balance).mean()
        aux["balance_loss"] = bal
        loss = loss + cfg.balance_loss_weight * bal
    return loss, aux, new_ms
