"""Rollout storage — counterpart of the ``Rollout`` container of
``swarmacb_tpu/agents/buffer.py``.

One collected rollout is a dataclass of ``(T, E, …)`` tensors, stacked from
the per-decision outputs of ``POCATrainer.rollout``. λ-returns, advantages
and their normalisation arrive with the update (ROADMAP.md §1 item 6).
"""

from __future__ import annotations

import dataclasses

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

    @classmethod
    def stack(cls, steps: list[dict]) -> "Rollout":
        """Stack per-decision dicts of (E, …) tensors along a new time axis."""
        return cls(**{f.name: torch.stack([s[f.name] for s in steps])
                      for f in dataclasses.fields(cls)})

    def items(self):
        return ((f.name, getattr(self, f.name)) for f in dataclasses.fields(self))
