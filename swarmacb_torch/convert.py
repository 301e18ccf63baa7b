"""Flax params → the port's ``state_dict``s.

The JAX package's params are nested dicts (here: of numpy arrays, so this
module needs no JAX). The port's modules mirror the flax tree, so the
mapping is mechanical:

  - ``dense_i`` (a LinearEncoder layer) → ``layers.i``;
  - ``kernel`` → ``weight``, transposed: flax ``Dense`` kernels are
    (in, out), ``nn.Linear.weight`` is (out, in);
  - ``bias`` and ``log_std`` keep their names and layout, and so do the
    recurrent actor's LSTM leaves ``lstm.w_ih`` (in, 4M), ``lstm.w_hh``
    (M, 4M) and ``lstm.bias`` (4M): the port's ``LSTMCell`` stores them in
    the flax layout, so none is transposed.

``fc_out`` is square (h × h), so a missing transpose would pass every shape
check; the parity tests catch it. ``POCACritic.all_baselines`` rebuilds the
flax-layout (H, d, h) split of that kernel from ``weight.T``
(networks.py:473-476 in the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _torch_key(path) -> tuple[str, bool]:
    """(state_dict key, whether the array is a kernel to transpose)."""
    parts = []
    for p in path[:-1]:
        parts.append(f"layers.{p[len('dense_'):]}" if p.startswith("dense_") else p)
    leaf = path[-1]
    is_kernel = leaf == "kernel"
    parts.append("weight" if is_kernel else leaf)
    return ".".join(parts), is_kernel


def flax_to_state_dict(params) -> dict[str, torch.Tensor]:
    """One module's flax params (nested dicts of arrays) → its state_dict."""
    out = {}
    for path, arr in _flatten(params):
        key, is_kernel = _torch_key(path)
        a = np.asarray(arr, dtype=np.float32)
        out[key] = torch.from_numpy(np.array(a.T if is_kernel else a, order="C"))
    return out


def load_flax_params(trainer, params) -> None:
    """Copy ``{"actor": ..., "critic": ...}`` flax params (as the JAX
    trainer's ``init_params_for_seed`` returns them, the recurrent actor's
    included) into a POCATrainer's actor and critic. Every key must match
    both ways."""
    for name in ("actor", "critic"):
        module = getattr(trainer, name)
        sd = {k: v.to(next(module.parameters()).device)
              for k, v in flax_to_state_dict(params[name]).items()}
        module.load_state_dict(sd, strict=True)
