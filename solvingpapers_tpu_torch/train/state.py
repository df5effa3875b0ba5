"""Training state (port of `solvingpapers_tpu/train/state.py`).

The reference's `TrainState` is a pytree of params, optimizer state,
step and PRNG key. Here the model owns its parameters and the optimizer
its state and schedule, so the train state holds the two objects, the
step count and a `torch.Generator` (which draws the initial parameters
and seeds every step's dropout), and (de)serialises them for
checkpoints.
"""

from __future__ import annotations

import dataclasses

import torch

from solvingpapers_tpu_torch.kernels.dropout import mix_seed
from solvingpapers_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: Optimizer
    generator: torch.Generator  # seeded from TrainConfig.seed

    def step_seed(self) -> int:
        """This step's 64-bit dropout seed: the generator's seed mixed
        with the step count (the reference folds the step into its key),
        so a resumed run draws the masks an unbroken one would."""
        return mix_seed(self.generator.initial_seed(), self.step)

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        # a generator's state is a CPU byte tensor, whatever its device
        self.generator.set_state(state["generator"].cpu())
