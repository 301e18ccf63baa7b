"""Weight initializers matching ML-Agents / torch semantics.

Counterpart of ``swarmacb_tpu/models/init.py`` with the same distributions
(init.py:28-76). The reference builds every layer through
``_linear_layer`` (poca_networks.py:58-82) with three kernel inits plus a
gain multiplier:

  - "kaiming_normal": torch ``kaiming_normal_(nonlinearity="linear")`` →
    N(0, 1/fan_in) (gain 1, mode fan_in)
  - "xavier_uniform": U(±√(6/(fan_in+fan_out)))
  - "normal": N(0, 1)
  then ``weight *= kernel_gain``; biases zero.

The critic's value head uses a bare ``nn.Linear`` (poca_networks.py:521),
i.e. torch's default init: kaiming_uniform(a=√5) → U(±1/√fan_in) for both
kernel and bias.

Each initializer fills an ``nn.Linear`` weight, (out, in) layout so
fan_in = weight.shape[1], in place from an explicit ``torch.Generator``.
The LSTM's two initializers (init.py:79-100) fill the cell's stacked
matrices in the flax layout instead: ``w_ih`` (in, 4M) and ``w_hh``
(M, 4M). The draws are not the JAX package's (different generators); the
distributions are.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def kaiming_normal_(weight, generator, gain: float = 1.0):
    """torch kaiming_normal_(nonlinearity='linear', mode='fan_in') × gain."""
    std = 1.0 / math.sqrt(weight.shape[1])
    return weight.normal_(0.0, std * gain, generator=generator)


@torch.no_grad()
def xavier_uniform_(weight, generator, gain: float = 1.0):
    """torch xavier_uniform_ × gain."""
    fan_out, fan_in = weight.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return weight.uniform_(-bound, bound, generator=generator).mul_(gain)


@torch.no_grad()
def normal_gain_(weight, generator, gain: float = 1.0):
    """N(0, 1) × gain — used with the T-Fixup gain (0.125/h)^0.5."""
    return weight.normal_(0.0, 1.0, generator=generator).mul_(gain)


@torch.no_grad()
def torch_linear_default_(weight, bias, generator):
    """torch nn.Linear default: weight and bias U(±1/√fan_in)."""
    bound = 1.0 / math.sqrt(weight.shape[1])
    weight.uniform_(-bound, bound, generator=generator)
    bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def lstm_xavier_ih_(w_ih, generator):
    """torch LSTM ``weight_ih``: xavier_uniform over the stacked matrix,
    U(±√(6/(in + 4M))) on the (in, 4M) layout (the bound is symmetric in
    the two fans, so the transpose does not change it)."""
    fan_in, four_m = w_ih.shape
    bound = math.sqrt(6.0 / (fan_in + four_m))
    return w_ih.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def lstm_orthogonal_hh_(w_hh, generator):
    """torch ``orthogonal_`` on the stacked (M, 4M) recurrent matrix:
    semi-orthogonal, with orthonormal rows (w_hh @ w_hhᵀ = I)."""
    return torch.nn.init.orthogonal_(w_hh, generator=generator)


KERNEL_INITS = {
    "kaiming_normal": kaiming_normal_,
    "xavier_uniform": xavier_uniform_,
    "normal": normal_gain_,
}
