"""Training (port of `solvingpapers_tpu/train`: the single-device LM
training loop, its optimizer and state)."""

from solvingpapers_tpu_torch.train.engine import TrainConfig, Trainer, lm_loss_fn
from solvingpapers_tpu_torch.train.optim import (
    Optimizer,
    OptimizerConfig,
    make_optimizer,
    warmup_cosine,
)
from solvingpapers_tpu_torch.train.state import TrainState

__all__ = [
    "Optimizer",
    "OptimizerConfig",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "lm_loss_fn",
    "make_optimizer",
    "warmup_cosine",
]
