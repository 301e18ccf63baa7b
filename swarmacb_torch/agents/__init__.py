"""POCA acting stack: rollout container and trainer (acting half)."""

from ..config.poca_cfg import POCAConfig
from .buffer import Rollout
from .trainer import POCATrainer

__all__ = ["POCAConfig", "POCATrainer", "Rollout"]
