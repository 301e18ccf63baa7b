"""Float32 square roots in the port rounded as the JAX package rounds them,
on the CPU.

PyTorch's vectorised float32 ``torch.sqrt`` on some CPU builds is not
correctly rounded: for q = 0x1.07df5cp-7 it gives 0x1.6f902ep-4 where
numpy and XLA give 0x1.6f9030p-4, and over uniform draws in [0, 0.05) it
parts from them in about 0.7 % of the values. So the port takes every
float32 root through ``swarmacb_torch.numerics.sqrt_rn``: float64, then one
rounding to float32.

On one axis the offset dx is a float32 and q = fl(dx²) (+ 1e-12), whose
root lies near dx, far from a rounding boundary, so no build's root goes
wrong there: robots at x = 0.5 and 0.41026294 give q = 0x1.07df46p-7, held
here too but not telling. The pair at (0, 0) and (0.08917819, 0.01) gives
q = 0x1.07df5cp-7 exactly, and there the proximity readings,
1 − dist/(range + r), of ``torch.sqrt``'s distance part from the JAX
package's in the last bit.

Held: the composed env's proximity readings (``sensors.
detect_robots_proximity``) against the JAX package's op by op, bit for bit,
with each robot's eight rays along the offset to the other so that every ray
hits (under jit XLA fuses 1 − dist/(range + r) and rounds it one bit apart
at the second pair, with or without the right root: not a root's matter),
and the distance against XLA's root op by op and under jit; the
RAB outputs of the same pairs at headings 0; a sweep of 160,000 float32
values through ``sqrt_rn`` against ``np.sqrt``; and no ``torch.sqrt`` left
in the port outside the helper.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.env import sensors as jsensors

from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import sensors
from swarmacb_torch.numerics import sqrt_rn
from torch_threads import one_torch_thread  # noqa: F401

CFG = DirectionalGateEnvCfg()
F32 = np.float32
E = 64
ROOT = Path(__file__).resolve().parents[1]
PAIRS = {"one axis": ((0.5, 0.0), (0.41026294, 0.0), "0x1.07df46p-7"),
         "q = 0x1.07df5cp-7": ((0.0, 0.0), (0.08917819, 0.01), "0x1.07df5cp-7")}


def _bits(a):
    return np.asarray(a, F32).view(np.int32)


def _arenas(a, b):
    """(E, 2, 2) positions, the pair in every arena, and (E, 2, 8) ray
    directions: robot 0's along the offset to robot 1, robot 1's back."""
    pos = np.zeros((E, 2, 2), F32)
    pos[:, 0], pos[:, 1] = F32(a), F32(b)
    d = (pos[0, 1] - pos[0, 0]).astype(np.float64)
    u = (d / np.linalg.norm(d)).astype(F32)
    wdx, wdy = np.zeros((E, 2, 8), F32), np.zeros((E, 2, 8), F32)
    wdx[:, 0], wdy[:, 0], wdx[:, 1], wdy[:, 1] = u[0], u[1], -u[0], -u[1]
    return pos, wdx, wdy


@pytest.mark.parametrize("pair", PAIRS, ids=list(PAIRS))
def test_proximity_distances_are_the_jax_package_s(pair):
    a, b, q_hex = PAIRS[pair]
    pos, wdx, wdy = _arenas(a, b)
    diff = torch.from_numpy(pos[:, 1] - pos[:, 0])
    q = diff[:, 0] ** 2 + diff[:, 1] ** 2 + 1e-12
    assert q[0].item() == float.fromhex(q_hex)
    args = (CFG.prox_range, CFG.robot_radius)
    got = sensors.detect_robots_proximity(*(torch.from_numpy(x) for x in (pos, wdx, wdy)),
                                          *args).numpy()
    want = jsensors.detect_robots_proximity(*(jnp.asarray(x) for x in (pos, wdx, wdy)), *args)
    # every ray of both robots sees the other: reading = 1 − dist/(range + r)
    assert (got > 0.3).all()
    assert np.array_equal(_bits(got), _bits(want))
    # the distance itself, against XLA's root op by op and under jit, and
    # numpy's
    dist = sqrt_rn(q).numpy()
    for root in (jnp.sqrt(jnp.asarray(q.numpy())), jax.jit(jnp.sqrt)(q.numpy()),
                 np.sqrt(q.numpy())):
        assert np.array_equal(_bits(dist), _bits(root))


@pytest.mark.parametrize("pair", PAIRS, ids=list(PAIRS))
def test_rab_at_headings_zero_is_the_jax_package_s(pair):
    a, b, _ = PAIRS[pair]
    pos, _, _ = _arenas(a, b)
    yaw = np.zeros((E, 2), F32)
    args = (CFG.rab_range, CFG.alpha_parameter)
    got = sensors.compute_rab(torch.from_numpy(pos), torch.from_numpy(yaw), *args)
    want = jsensors.compute_rab(jnp.asarray(pos), jnp.asarray(yaw), *args)
    assert float(got[0].min()) > 0            # each robot counts the other
    for name, g, w in zip(("ztilde", "proj", "attr_x", "attr_y"), got, want):
        assert np.array_equal(_bits(g.numpy()), _bits(w)), name


def test_sqrt_rn_is_numpy_s_float32_root():
    """160,000 float32 values, bit for bit: distances' squares as the env
    forms them (sums of two squares, uniform in [0, 0.05)), and values
    spread over the exponents from 2^-149 (subnormals included) to 2^127."""
    rng = np.random.default_rng(23)
    xy = rng.uniform(-0.3, 0.3, (40_000, 2)).astype(F32)
    sums = xy[:, 0] * xy[:, 0] + xy[:, 1] * xy[:, 1] + F32(1e-12)
    spread = np.ldexp(rng.uniform(1.0, 2.0, 40_000),
                      rng.integers(-149, 128, 40_000)).astype(F32)
    values = np.concatenate([sums, rng.uniform(0, 0.05, 40_000).astype(F32), spread,
                             rng.uniform(0, 1, 40_000).astype(F32),
                             F32([0.0, np.inf, float.fromhex("0x1.07df5cp-7")])])
    assert values.dtype == F32 and len(values) >= 100_000 and np.isfinite(values[:-2]).all()
    t = torch.from_numpy(values)
    got = sqrt_rn(t)
    assert got.dtype == torch.float32
    want = np.sqrt(values)
    bad = np.nonzero(_bits(got.numpy()) != _bits(want))[0]
    assert not len(bad), [(values[i].item().hex(), got[i].item().hex()) for i in bad[:5]]
    # what the plain float32 root of this build makes of them, for the record
    off = int((_bits(torch.sqrt(t).numpy()) != _bits(want)).sum())
    print(f"torch.sqrt parts from np.sqrt in {off} of {len(values)} values")


def test_no_float32_torch_sqrt_is_left_in_the_port():
    """Every square root of the port goes through ``sqrt_rn``; ``torch.rsqrt``
    stays where it matches the kernels' ``rsqrtf``."""
    found = []
    for path in sorted((ROOT / "swarmacb_torch").rglob("*.py")):
        if path.name == "numerics.py":
            continue
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "sqrt"
                    and not (isinstance(node.func.value, ast.Name)
                             and node.func.value.id in ("math", "np"))):
                found.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not found, found
