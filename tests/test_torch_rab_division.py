"""The plain versions' one-division weights against the JAX package's, bit
for bit, on the CPU.

The JAX package takes each RAB attraction weight alpha / (1 + d) and the
wheel scale max_speed / max_val as one IEEE float32 division
(``swarmacb_tpu/env/sensors.py``, ``ops/fused_step.py``), and so do the
CUDA kernels. PyTorch takes a Python scalar over a tensor as the tensor's
reciprocal times the scalar, two roundings, which differ from the one
division in about a fifth of the values for alpha = 5; the port therefore
divides a tensor of the scalar by the tensor.

The inputs make every other operation of the attraction exact or the same
on both sides, so that only the division can tell the two apart:

  - arenas of robot pairs 1 m apart, so that each robot has one neighbour
    in RAB range and no sum order enters;
  - each pair on one axis with headings 0, so that the bearing is 0, ±π/2
    or π, whose cosines and sines both packages round alike;
  - each pair's q = dx² + 1e-8 (float32) the exact square of a float32 s of
    12 significant bits, so that the distance sqrt(q) = s is exact.
    (PyTorch's vectorised CPU square root is not correctly rounded: it
    parts from numpy's and XLA's in a few values in a thousand; that is not
    what this file holds.)

Held: the composed env's ``sensors.compute_rab`` against the JAX one (eager
and jitted) and the fused step's plain ``sensor_block`` against the JAX
``_sensor_block``. (The wheel scale max_speed / max_val takes one division
too, but its max_val is max(|cos|, 1) and the rsqrt cosine never exceeds 1
on the CPU, so both forms give max_speed there.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.env import sensors as jsensors
from swarmacb_tpu.ops import fused_step as jfused

from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import geometry, sensors
from swarmacb_torch.ops import fused_step
from torch_threads import one_torch_thread  # noqa: F401

CFG = DirectionalGateEnvCfg()
F32 = np.float32
E, PAIRS = 64, 10
N = 2 * PAIRS
WALLS = geometry.wall_segments(CFG.arena_circumradius, CFG.arena_num_sides)


def _exact_distances(rng, n):
    """n pairs (dx, s), float32: dx > 0 with fl(fl(dx·dx) + fl(1e-8)) = s·s
    exactly, s of 12 significant bits in [0.01, 0.19)."""
    out = []
    while len(out) < n:
        s = F32(rng.uniform(0.01, 0.19))
        s = F32(np.ldexp(np.round(np.ldexp(s, 11 - np.frexp(s)[1])), np.frexp(s)[1] - 11))
        want = s * s                       # exact: 24 significant bits at most
        base = F32(np.sqrt(np.float64(want) - 1e-8))
        cand = (np.asarray(base, F32).view(np.int32) + np.arange(-8, 9, dtype=np.int32)).view(F32)
        hit = cand[cand * cand + F32(1e-8) == want]
        if len(hit):
            out.append((hit[0], s))
    return np.array(out, F32)


def _pairs(axis, seed):
    """(E, N, 2) positions: pair p of each arena at a centre of its own
    (1 m apart), its second robot dx away along ``axis``, on either side;
    and the pairs' distances s."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((E, N, 2), F32)
    ds = _exact_distances(rng, E * PAIRS)
    d = ds[:, 0].reshape(E, PAIRS)
    side = rng.choice(F32([-1.0, 1.0]), (E, PAIRS))
    for p in range(PAIRS):
        centre = F32([(p % 4) - 1.5, (p // 4) - 1.0])
        pos[:, 2 * p] = centre
        pos[:, 2 * p + 1] = centre
        pos[:, 2 * p + 1, axis] += side[:, p] * d[:, p]
    return pos, ds[:, 1]


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return got.shape == want.shape and np.array_equal(got.view(np.int32), want.view(np.int32))


def _n_apart(alpha, s):
    """Of the weights alpha / (1 + s), how many the reciprocal form rounds
    apart from the one division."""
    t = torch.from_numpy(s)
    return int(((alpha / (1.0 + t)) != (torch.full_like(t, alpha) / (1.0 + t))).sum())


@pytest.mark.parametrize("axis", [0, 1])
def test_composed_rab_attraction_is_the_jax_package_s(axis):
    pos, s = _pairs(axis, seed=axis)
    yaw = np.zeros((E, N), F32)
    args = (CFG.rab_range, CFG.alpha_parameter)
    _, _, ax, ay = sensors.compute_rab(torch.from_numpy(pos), torch.from_numpy(yaw), *args)
    eager = jsensors.compute_rab(jnp.asarray(pos), jnp.asarray(yaw), *args)
    jitted = jax.jit(lambda p, y: jsensors.compute_rab(p, y, *args))(pos, yaw)
    for want in (eager, jitted):
        assert _same_bits(ax.numpy(), want[2]) and _same_bits(ay.numpy(), want[3])
    # each robot sees its one neighbour, and many weights are ones that the
    # reciprocal form rounds apart
    assert (np.abs((ax if axis == 0 else ay).numpy()) > 1.0).all()
    assert _n_apart(CFG.alpha_parameter, s) > 50


def _jax_sensor_block(px, py, cos_y, sin_y):
    segments = tuple((float(a[0]), float(a[1]), float(a[2] - a[0]), float(a[3] - a[1]))
                     for a in np.asarray(WALLS, np.float64))
    return jfused._sensor_block(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(cos_y), jnp.asarray(sin_y), N=N,
        prox_range=CFG.prox_range, robot_radius=CFG.robot_radius, rab_range=CFG.rab_range,
        alpha_rab=CFG.alpha_parameter, segments=segments,
        light_xy=(float(CFG.light_position[0]), float(CFG.light_position[1])),
        light_threshold=CFG.light_threshold)


@pytest.mark.parametrize("axis", [0, 1])
def test_fused_step_rab_attraction_is_the_jax_package_s(axis, monkeypatch):
    """The bearing's cosine and sine are the offset times rsqrt and a
    Newton step; XLA's CPU rsqrt and PyTorch's part in the last bit, so the
    JAX side takes the port's here (``w_x``, ``w_y``, which share those
    factors, then agree too) and the weights are left as the only
    difference."""
    monkeypatch.setattr(jfused, "_nr_rsqrt", lambda x: jnp.asarray(
        fused_step._nr_rsqrt(torch.from_numpy(np.array(x))).numpy()))
    pos, s = _pairs(axis, seed=10 + axis)
    px, py = (np.ascontiguousarray(pos[..., c].T) for c in (0, 1))   # (N, E) tiles
    cos_y, sin_y = np.ones_like(px), np.zeros_like(px)
    k = fused_step.constants(CFG)
    got = fused_step.sensor_block(*(torch.from_numpy(a) for a in (px, py, cos_y, sin_y)), k, N)
    want = _jax_sensor_block(px, py, cos_y, sin_y)
    for name in ("w_x", "w_y", "rab_x", "rab_y"):
        assert _same_bits(got[name].numpy(), want[name]), name
    assert (np.abs((got["rab_x"] if axis == 0 else got["rab_y"]).numpy()) > 1.0).all()
    assert _n_apart(k.alpha, s) > 50
