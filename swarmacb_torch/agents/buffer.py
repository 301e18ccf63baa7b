"""Rollout storage and λ-returns / counterfactual advantages — counterpart
of ``swarmacb_tpu/agents/buffer.py``.

One collected rollout is a dataclass of ``(T, E, …)`` tensors, stacked from
the per-decision outputs of ``POCATrainer.rollout``.

λ-return recursion (poca_buffer.py:125-151, = ML-Agents ``lambda_return``):

    ret[T−1] = r[T−1] + γ·m[T−1]·V_boot
    ret[t]   = γλ·m[t]·ret[t+1] + r[t] + (1−λ)·γ·m[t]·V[t+1]

    advantage_i[t] = ret[t] − baseline_i[t]     (poca_buffer.py:152-154)

written as a reverse Python loop over T on (E,) tensors — (T, E)-sized
work that needs no kernel — with the T−1 step kept in its exact reference
form.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Rollout:
    """One collected rollout, all tensors (T, E, …)."""

    obs: torch.Tensor            # (T, E, N, obs_dim)
    critic_states: torch.Tensor  # (T, E, N, 5)
    actions: torch.Tensor        # (T, E, N, act_dim) — raw (pre env-preprocess)
    log_probs: torch.Tensor      # (T, E, N, act_dim) — PER-DIM
    rewards: torch.Tensor        # (T, E) team reward (strength applied)
    dones: torch.Tensor          # (T, E) float
    team_values: torch.Tensor    # (T, E)
    baselines: torch.Tensor      # (T, E, N)
    # the recurrent actor's carry BEFORE each decision, (T, E, N, M); None
    # for a feedforward actor
    memory_h: Optional[torch.Tensor] = None
    memory_c: Optional[torch.Tensor] = None

    @classmethod
    def stack(cls, steps: list[dict]) -> "Rollout":
        """Stack per-decision dicts of (E, …) tensors along a new time axis;
        a field that is missing or None in the steps stays None."""
        return cls(**{f.name: (None if steps[0].get(f.name) is None
                               else torch.stack([s[f.name] for s in steps]))
                      for f in dataclasses.fields(cls)})

    def items(self):
        """(name, tensor) of every field that is not None."""
        return ((f.name, getattr(self, f.name)) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None)


def lambda_returns(rewards, dones, team_values, bootstrap_value, gamma: float,
                   lam: float):
    """λ-returns over (T, E) tensors; reverse loop, reference-exact formulas."""
    T = rewards.shape[0]
    mask = 1.0 - dones
    ret = rewards[T - 1] + gamma * mask[T - 1] * bootstrap_value
    rets = [ret]
    for t in range(T - 2, -1, -1):
        ret = (gamma * lam * mask[t] * ret + rewards[t]
               + (1.0 - lam) * gamma * mask[t] * team_values[t + 1])
        rets.append(ret)
    return torch.stack(rets[::-1])


def compute_advantages(rollout: Rollout, bootstrap_value, gamma: float,
                       lam: float):
    """Returns (returns (T,E), advantages (T,E,N) = ret − baseline_i)."""
    returns = lambda_returns(rollout.rewards, rollout.dones,
                             rollout.team_values, bootstrap_value, gamma, lam)
    return returns, returns[..., None] - rollout.baselines


def normalize_advantages(advantages, eps: float = 1e-10):
    """Mean-0 / std-1 over the WHOLE buffer before the epoch loop
    (poca_trainer.py:676-683), with Bessel's correction (ddof = 1)."""
    return (advantages - advantages.mean()) / (advantages.std() + eps)


def flatten_time_env(x):
    """(T, E, …) → (T·E, …)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))
