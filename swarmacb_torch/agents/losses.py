"""POCA / trust-region losses and schedules — counterpart of
``swarmacb_tpu/agents/losses.py``, ML-Agents-exact math.

  - trust_region_value_loss   poca_trainer.py:139-152
  - trust_region_policy_loss  poca_trainer.py:155-173 (PER-ACTION-DIM ratio)
  - PolynomialDecay           poca_trainer.py:112-132 with the ML-Agents
    floors lr→1e-10, ε→0.1, β→1e-5 (poca_trainer.py:281-287)
  - total loss = policy + 0.5·(value + 0.5·baseline) − β·entropy,
    NO gradient clipping (poca_trainer.py:703-712)
"""

from __future__ import annotations

import torch

# ML-Agents polynomial_decay floors (poca_trainer.py:281-287)
LR_MIN = 1e-10
EPS_MIN = 0.1
BETA_MIN = 1e-5


def trust_region_value_loss(values, old_values, returns, epsilon):
    """Clipped value loss: mean of max((R−V)², (R−clip(V))²)."""
    clipped = old_values + torch.clamp(values - old_values, -epsilon, epsilon)
    loss_a = (returns - values) ** 2
    loss_b = (returns - clipped) ** 2
    return torch.maximum(loss_a, loss_b).mean()


def trust_region_policy_loss(advantages, log_probs, old_log_probs, epsilon):
    """Clipped policy loss with PER-DIMENSION ratio.

    ML-Agents clips each action dimension's ratio separately against the
    (broadcast) advantage — different from standard PPO which sums
    log-probs first. Shapes: advantages (B, 1) broadcast against
    log_probs/old (B, act_dim).
    """
    r_theta = torch.exp(log_probs - old_log_probs)
    p_opt_a = r_theta * advantages
    p_opt_b = torch.clamp(r_theta, 1.0 - epsilon, 1.0 + epsilon) * advantages
    return -torch.minimum(p_opt_a, p_opt_b).mean()


def poca_total_loss(policy_loss, value_loss, baseline_loss, entropy, beta):
    """poca_trainer.py:703-707."""
    return policy_loss + 0.5 * (value_loss + 0.5 * baseline_loss) - beta * entropy


class PolynomialDecay:
    """Polynomial (linear by default) decay, ML-Agents ModelUtils semantics."""

    def __init__(self, initial: float, min_value: float, max_step: int,
                 power: float = 1.0):
        self.initial = initial
        self.min_value = min_value
        self.max_step = max(max_step, 1)
        self.power = power

    def __call__(self, step: int) -> float:
        step = min(step, self.max_step)
        return (self.initial - self.min_value) * (
            1.0 - step / self.max_step
        ) ** self.power + self.min_value


def make_schedule(kind: str, initial: float, min_value: float, max_step: int):
    """'linear' → PolynomialDecay; anything else → constant."""
    if kind == "linear":
        return PolynomialDecay(initial, min_value, max_step)
    return lambda step: initial
