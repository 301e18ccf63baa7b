"""PyTorch networks: the Gaussian and categorical POCA actors and the
attention critic."""

from .networks import (
    Actor,
    DiscreteActor,
    EntityEmbedding,
    LinearEncoder,
    POCACritic,
    ResidualSelfAttention,
)

__all__ = [
    "Actor",
    "DiscreteActor",
    "EntityEmbedding",
    "LinearEncoder",
    "POCACritic",
    "ResidualSelfAttention",
]
