"""Batched swarm environment on PyTorch tensors."""

from .directional_gate import DirectionalGateEnv
from .registry import available_tasks, make_env, register
from .state import BehaviorState, EnvState, TimeStep

__all__ = [
    "BehaviorState",
    "DirectionalGateEnv",
    "EnvState",
    "TimeStep",
    "available_tasks",
    "make_env",
    "register",
]
