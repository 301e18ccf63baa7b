"""ML-Agents-schema YAML → (run_name, variant, POCAConfig, env overrides).

The reference's five ``configs/DirGate_*.yaml`` files (ML-Agents schema:
``behaviors.<run>.{variant, hyperparameters, network_settings(+memory),
reward_signals.extrinsic, max_steps, time_horizon, summary_freq,
checkpoint_interval, keep_checkpoints, environment{num_envs,
decision_period, episode_length_s}}`` — reference config_loader.py:29-118)
must load unmodified. A copy of ``swarmacb_tpu.config.loader``: the port
imports nothing of the JAX package. Rather than hand-written per-key plumbing, the
schema lives in one declarative table: each row maps a dotted YAML path
inside the behavior block to a ``POCAConfig`` field, applied only when the
key is present (every fallback equals the dataclass default, which the
config tests pin). Precedence stays YAML → CLI overrides win
(scripts/train.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import yaml

from .poca_cfg import POCAConfig

# (dotted path inside the behavior block) → POCAConfig field.
# Applied only when the YAML key exists; absent keys keep the dataclass
# default (reference fallbacks and POCAConfig defaults are identical —
# guarded by tests/test_config.py).
_SCHEMA: dict[str, str] = {
    "hyperparameters.batch_size": "mini_batch_size",
    "hyperparameters.learning_rate": "lr",
    "hyperparameters.beta": "beta",
    "hyperparameters.epsilon": "clip_eps",
    "hyperparameters.lambd": "lam",
    "hyperparameters.num_epoch": "num_epochs",
    "hyperparameters.buffer_size": "buffer_size_hint",
    "hyperparameters.learning_rate_schedule": "lr_schedule",
    "hyperparameters.epsilon_schedule": "eps_schedule",
    "hyperparameters.beta_schedule": "beta_schedule",
    "network_settings.hidden_units": "hidden_dim",
    "network_settings.num_layers": "num_layers",
    "network_settings.memory.memory_size": "memory_size",
    "network_settings.memory.sequence_length": "sequence_length",
    "reward_signals.extrinsic.gamma": "gamma",
    "reward_signals.extrinsic.strength": "reward_strength",
    "max_steps": "total_timesteps",
    "time_horizon": "horizon",
    "summary_freq": "summary_freq",
    "checkpoint_interval": "checkpoint_interval",
    "keep_checkpoints": "keep_checkpoints",
    "environment.decision_period": "decision_period",
}

# ``environment`` keys that belong to the env config, not the trainer.
_ENV_OVERRIDE_KEYS = ("num_envs", "episode_length_s")

_MISSING = object()


def _dig(tree: dict, dotted: str):
    """Fetch a dotted path from nested dicts; _MISSING when absent."""
    node: Any = tree
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return _MISSING
        node = node[part]
    return node


def load_config(path: str | Path) -> tuple[str, str, POCAConfig, dict[str, Any]]:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Config file not found: {path}")
    raw = yaml.safe_load(path.read_text(encoding="utf-8"))

    behaviors = raw.get("behaviors", raw)
    if not behaviors:
        raise ValueError("Config must have a top-level 'behaviors' key.")
    run_name = next(iter(behaviors))
    block = behaviors[run_name]
    variant = block.get("variant", "dandelion")

    cfg = POCAConfig()
    for dotted, field in _SCHEMA.items():
        value = _dig(block, dotted)
        if value is not _MISSING:
            setattr(cfg, field, value)

    # a memory block (or the cyclamen variant) switches on the LSTM actor
    # (reference config_loader.py:84)
    cfg.recurrent = bool(_dig(block, "network_settings.memory") not in
                         (_MISSING, None, {})) or variant == "cyclamen"

    # run-name-derived output dirs (reference config_loader.py:108-109)
    cfg.log_dir = f"runs/{run_name}"
    cfg.checkpoint_dir = f"checkpoints/{run_name}"

    environment = block.get("environment", {}) or {}
    env_overrides = {k: environment[k] for k in _ENV_OVERRIDE_KEYS
                     if k in environment}
    return run_name, variant, cfg, env_overrides


# ── banner ──────────────────────────────────────────────────────────────
# Declarative layout: sections of (label, value-getter, visibility) rows,
# rendered by one loop. ``None`` getters emit the section title.

def _banner_rows(run_name, variant, cfg: POCAConfig, env_ov: dict):
    yield None, f"Run name : {run_name}"
    yield None, f"CASA variant : {variant}"
    yield None, "Trainer : POCA (PyTorch)"
    yield None, None                           # rule between header and body
    yield "Hyperparameters", None
    yield "batch_size", cfg.mini_batch_size
    yield "learning_rate", f"{cfg.lr}  (schedule: {cfg.lr_schedule})"
    yield "beta", f"{cfg.beta}  (schedule: {cfg.beta_schedule})"
    yield "epsilon", f"{cfg.clip_eps}  (schedule: {cfg.eps_schedule})"
    yield "lambd", cfg.lam
    yield "num_epoch", cfg.num_epochs
    yield "gamma", cfg.gamma
    yield "Network", None
    yield "hidden_units", cfg.hidden_dim
    yield "num_layers", cfg.num_layers
    if cfg.recurrent:
        yield "memory_size", cfg.memory_size
        yield "sequence_length", cfg.sequence_length
    # a checkpoint does not record it, so a resumed run shows it here
    yield "precision", (f"bf16 projections '{cfg.mp_stages}'" if cfg.mixed_precision
                        else "float32")
    yield "Training", None
    yield "max_steps", f"{cfg.total_timesteps:,}"
    yield "time_horizon", cfg.horizon
    yield "decision_period", cfg.decision_period
    yield "checkpoint_interval", f"{cfg.checkpoint_interval:,}"
    yield "summary_freq", f"{cfg.summary_freq:,}"
    if cfg.reward_strength != 1.0:
        yield "reward_strength", cfg.reward_strength
    if env_ov:
        yield "Environment overrides", None
        for k, v in env_ov.items():
            yield k, v


def print_config(run_name: str, variant: str, cfg: POCAConfig, env_ov: dict):
    """Human-readable config banner, rendered from the declarative rows."""
    rule = "─" * 60
    lines = [rule]
    for label, value in _banner_rows(run_name, variant, cfg, env_ov):
        if label is None and value is None:    # explicit rule row
            lines.append(rule)
        elif label is None:                    # header line
            lines.append(f"  {value}")
        elif value is None:                    # section title
            lines.append(f"  {label}")
        else:
            lines.append(f"    {label:<20}: {value}")
    lines.append(rule)
    print("\n" + "\n".join(lines) + "\n")
