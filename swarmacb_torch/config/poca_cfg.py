"""POCA trainer hyper-parameters — loadable from ML-Agents-style YAML.

A copy of ``swarmacb_tpu.config.poca_cfg``. Field names and defaults match
the reference ``POCAConfig`` (poca_trainer.py:43-105) so the YAML loader and
CLI map one-to-one. ``recurrent=True`` (cyclamen) trains the LSTM actor
with BPTT over windows of ``sequence_length`` decisions;
``mixed_precision=True`` gives the critic's attention projections named in
``mp_stages`` bfloat16 operands.
"""

from __future__ import annotations

import dataclasses

MP_STAGES = "qkvo"


def check_mp_stages(stages: str) -> str:
    """``stages`` if it is a subset of ``"qkvo"`` (the attention's q, k, v
    and output projections), else ValueError."""
    bad = sorted(set(stages) - set(MP_STAGES))
    if bad:
        raise ValueError(f"mp_stages must be a subset of {MP_STAGES!r}; "
                         f"{stages!r} has {bad}")
    return stages


@dataclasses.dataclass
class POCAConfig:
    # Rollout
    horizon: int = 1000               # time_horizon
    num_epochs: int = 3               # num_epoch
    mini_batch_size: int = 2048       # batch_size

    # PPO / POCA
    clip_eps: float = 0.2             # epsilon
    beta: float = 0.005               # entropy coefficient

    # λ-return
    gamma: float = 0.99
    lam: float = 0.95                 # lambd

    # Optimiser
    lr: float = 3e-4
    adam_eps: float = 1e-8

    # Schedules: "linear" or "constant"
    lr_schedule: str = "constant"
    eps_schedule: str = "constant"
    beta_schedule: str = "constant"

    # Run control (agent-decisions)
    total_timesteps: int = 120_000_000
    checkpoint_interval: int = 120_000
    summary_freq: int = 120_000
    keep_checkpoints: int = 5
    checkpoint_dir: str = "checkpoints/poca"

    decision_period: int = 1
    reward_strength: float = 1.0

    # Network
    hidden_dim: int = 512
    num_layers: int = 2
    critic_num_heads: int = 4
    recurrent: bool = False
    memory_size: int = 128
    sequence_length: int = 64

    # TensorBoard
    log_dir: str = "runs/poca"

    # buffer_size hint from YAML (drives batches-per-epoch derivation,
    # poca_trainer.py:663-674)
    buffer_size_hint: int = 0

    # Memory ceiling for one gradient computation, in GROUPS (arena
    # timesteps): a larger minibatch is split into chunks of at most this
    # many groups whose gradients accumulate (POCATrainer._accumulate_grads).
    accum_chunk_groups: int = 1024

    # The fields below are kept so configs written for the JAX package
    # load unchanged (same names, same defaults).

    # JAX-program splitting knobs; the port runs eagerly and has no
    # single-program wall-time ceiling to bound.
    split_update_groups: int = 16384
    rollout_segments: int = 1

    # Kernel switches of the JAX package. The port dispatches its kernels
    # by the device of the tensors, never by these flags: on the card the
    # critic's counterfactual tail always runs the hand-written CUDA kernel
    # (ops/baseline_tail.py), on the CPU its plain PyTorch version.
    # ``fused_tail`` is therefore accepted with any value.
    fused_tail: "bool | None" = None
    # True routes the critic's all_baselines through the fused
    # counterfactual attention (ops/cf_attention.py: kernels K5f/K5b on the
    # card, the plain version on the CPU) instead of the assembled softmax
    # and the tail; None (auto) means off, as in the JAX trainer.
    fused_attention: "bool | None" = None
    # True keeps the env state in the arena-on-lanes layout for the whole
    # rollout and runs each env step as one call of ops.fused_env_step
    # (kernel K4 on the card, its plain version on the CPU); None (auto)
    # means off, as in the JAX trainer.
    fused_env_step: "bool | None" = None

    # Mixed precision: bfloat16 operands for the critic's attention
    # projections named in ``mp_stages`` (q/k: the scores' path, v/o: the
    # values' and output's), each product and its bias add rounded to
    # bfloat16 as flax's Dense(dtype=bf16) rounds them; the scores, the
    # value folds, the tail kernels, LayerNorm, softmax, the losses, the
    # parameters and Adam stay float32 (models/networks.py). Off by default.
    mixed_precision: bool = False
    # a subset of "qkvo"; inert unless mixed_precision
    mp_stages: str = MP_STAGES

    # RNG
    seed: int = 0

    def __post_init__(self):
        check_mp_stages(self.mp_stages)
