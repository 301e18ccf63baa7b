"""POCA stack: rollout container, λ-returns, losses, the trainer and its
checkpoints."""

from ..config.poca_cfg import POCAConfig
from .buffer import Rollout
from .checkpoint import Checkpointer
from .trainer import POCATrainer

__all__ = ["Checkpointer", "POCAConfig", "POCATrainer", "Rollout"]
