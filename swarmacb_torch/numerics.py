"""Float32 arithmetic rounded as the JAX package rounds it."""

from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of ``x``, in ``x``'s dtype.

    PyTorch's vectorised float32 ``torch.sqrt`` on some CPU builds is not
    correctly rounded: for q = 0x1.07df5cp-7 it gives 0x1.6f902ep-4 where
    numpy, XLA and CUDA's ``sqrtf`` give 0x1.6f9030p-4. The root is taken in
    float64 and rounded once to float32; rounding twice cannot move it,
    since 53 >= 2·24 + 2. The same path runs on the card and on the CPU.
    """
    return torch.sqrt(x.double()).to(x.dtype)
