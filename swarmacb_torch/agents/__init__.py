"""POCA stack: rollout container, λ-returns, losses and the trainer."""

from ..config.poca_cfg import POCAConfig
from .buffer import Rollout
from .trainer import POCATrainer

__all__ = ["POCAConfig", "POCATrainer", "Rollout"]
