"""POCA stack: rollout container, λ-returns, losses, the trainer (one
device, or a rank of a data-parallel run over ``swarmacb_torch.parallel``),
the seed-parallel trainer (one device or a seed mesh) and their
checkpoints."""

from ..config.poca_cfg import POCAConfig
from .buffer import Rollout
from .checkpoint import Checkpointer
from .seed_parallel import SeedParallelTrainer
from .trainer import POCATrainer

__all__ = ["Checkpointer", "POCAConfig", "POCATrainer", "Rollout", "SeedParallelTrainer"]
