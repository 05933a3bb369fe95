"""The stage-1 train state: the port's counterpart of ``dsrg_tpu/train/train_state.py``.

The JAX state is one immutable tree (params, optimizer state, PRNG key,
step).  Here the module holds the parameters, the optimizer the velocities
and the step count, and a ``torch.Generator`` on the model's device the
random stream of dropout and mirroring; the step function updates them in
place.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from dsrg_tpu_torch.train.optimizer import CaffeSGD


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: CaffeSGD
    generator: torch.Generator

    @property
    def step(self) -> int:
        return self.optimizer.step_count

    def load_state_dict(self, state: Mapping) -> None:
        """Load ``{"model": state_dict, "optimizer": {"velocity", "step"}}``
        (what ``models.convert.state_from_flax`` returns)."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
