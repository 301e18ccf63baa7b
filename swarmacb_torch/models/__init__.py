"""PyTorch networks: the Gaussian, categorical and recurrent POCA actors
and the attention critic."""

from .networks import (
    Actor,
    DiscreteActor,
    EntityEmbedding,
    LinearEncoder,
    LSTMCell,
    POCACritic,
    RecurrentDiscreteActor,
    ResidualSelfAttention,
)

__all__ = [
    "Actor",
    "DiscreteActor",
    "EntityEmbedding",
    "LinearEncoder",
    "LSTMCell",
    "POCACritic",
    "RecurrentDiscreteActor",
    "ResidualSelfAttention",
]
