"""Environment state for the Directional Gate mission: dataclasses of tensors.

Counterpart of ``swarmacb_tpu/env/state.py`` plus the ``BehaviorState``
container of ``swarmacb_tpu/env/behaviors.py:36-71``. Every step carries
the behaviour machines and zeroes them on the folded auto-reset; the
discrete variants advance them in ``env/behaviors.py:dispatch`` (or in the
fused step, ``ops/fused_step.py``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class BehaviorState:
    """Per-robot avoidance state machines (behavior_modules.py:132-155)."""

    explore_state: torch.Tensor    # (E, N) int32: 0=walk, 1=avoid
    explore_steps: torch.Tensor    # (E, N) int32
    explore_dir: torch.Tensor      # (E, N) f32: +1 right / −1 left
    photo_avoiding: torch.Tensor   # (E, N) bool
    photo_steps: torch.Tensor      # (E, N) int32
    photo_dir: torch.Tensor        # (E, N) f32
    antiphoto_avoiding: torch.Tensor
    antiphoto_steps: torch.Tensor
    antiphoto_dir: torch.Tensor

    _DTYPES = (torch.int32, torch.int32, torch.float32, torch.bool,
               torch.int32, torch.float32, torch.bool, torch.int32,
               torch.float32)

    @classmethod
    def init(cls, E: int, N: int, device) -> "BehaviorState":
        return cls(*(torch.zeros((E, N), dtype=dt, device=device)
                     for dt in cls._DTYPES))

    def reset_where(self, env_mask: torch.Tensor) -> "BehaviorState":
        """Zero all machines for envs where ``env_mask`` (E,) is True.

        Matches behavior_modules.py:161-173.
        """
        m = env_mask[:, None]
        return BehaviorState(*(
            torch.where(m, torch.zeros_like(old), old)
            for old in (getattr(self, f.name)
                        for f in dataclasses.fields(self))))


@dataclasses.dataclass
class EnvState:
    """Full per-arena-batch simulation state (all tensors lead with E).

    Mirrors the reference env's mutable members (directional_gate_env.py:53-66
    plus Isaac's ``episode_length_buf``). ``generator`` takes the place of
    the JAX package's threaded PRNG key: the auto-reset's spawn draws come
    from it. It is one mutable object, shared by every state derived from
    this one.
    """

    pos: torch.Tensor                    # (E, N, 2) world XY
    yaw: torch.Tensor                    # (E, N) heading, rad
    prev_ground: torch.Tensor            # (E, N) previous ground colour scalar
    step_count: torch.Tensor             # (E,) int32 — Isaac episode_length_buf
    episode_reward: torch.Tensor         # (E,) running group reward this episode
    completed_group_reward: torch.Tensor  # (E,) snapshot at last episode end
    behavior: BehaviorState              # avoidance state machines
    generator: torch.Generator           # spawn draws of the auto-reset


@dataclasses.dataclass
class TimeStep:
    """One transition's outputs."""

    obs: torch.Tensor        # (E, N, obs_dim)
    reward: torch.Tensor     # (E,) shared team reward
    done: torch.Tensor       # (E,) bool — truncation (time limit only)
