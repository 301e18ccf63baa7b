"""PyTorch networks: the Gaussian POCA actor and the attention critic."""

from .networks import (
    Actor,
    EntityEmbedding,
    LinearEncoder,
    POCACritic,
    ResidualSelfAttention,
)

__all__ = [
    "Actor",
    "EntityEmbedding",
    "LinearEncoder",
    "POCACritic",
    "ResidualSelfAttention",
]
