"""Tiny task registry — counterpart of ``swarmacb_tpu/env/registry.py``.

The reference registers ``"SwarmACB-DirectionalGate-v0"`` via gymnasium
(missions/directional_gate/__init__.py:8-15); here a plain dict maps task
ids to (env class, default config factory).
"""

from __future__ import annotations

from ..config.env_cfg import DirectionalGateEnvCfg
from .directional_gate import DirectionalGateEnv

_REGISTRY = {
    "SwarmACB-DirectionalGate-v0": (DirectionalGateEnv, DirectionalGateEnvCfg),
}


def register(task_id: str, env_cls, cfg_cls):
    _REGISTRY[task_id] = (env_cls, cfg_cls)


def available_tasks() -> list[str]:
    return sorted(_REGISTRY)


def make_env(task_id: str, cfg=None, device=None, shard=None, **cfg_overrides):
    """Instantiate an env by task id on ``device`` (default: the card),
    optionally overriding config fields; ``shard`` as in
    ``DirectionalGateEnv``."""
    if task_id not in _REGISTRY:
        raise KeyError(f"Unknown task {task_id!r}; available: {available_tasks()}")
    env_cls, cfg_cls = _REGISTRY[task_id]
    if cfg is None:
        cfg = cfg_cls()
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    return env_cls(cfg, device=device, shard=shard)
