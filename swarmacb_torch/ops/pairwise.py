"""The env's N² pairwise passes: CUDA kernels and their plain versions.

Counterpart of ``swarmacb_tpu/ops/pairwise.py``. Two kernels in
``csrc/pairwise.cu``, tuned for arenas of up to 32 robots:

  - ``pairwise_sensors``: the 8-ray wall raycast fused with the robot
    proximity cone test, the range-and-bearing neighbour count, its 4
    projections and the attraction vector — one read of the positions;
  - ``resolve_robot_collisions``: the single Jacobi pass of elastic push-out,
    which skips, exactly, the pairs whose squared distance reaches
    ``collision_skip_d2(robot_radius)``.

Past 32 robots an arena takes the wide route, ``csrc/pairwise_wide.cu``:
the same two passes for any robot count (``route``). Its sensor kernel
takes each pair's squared distance once and passes over, exactly, the
pairs beyond the sensors' reach (``least_d2``) and the wall segments no
ray can reach; its collision kernel stages the arenas in shared memory and
skips the pairs the tuned one skips, word by word of 32 neighbours.

Each wrapper dispatches by the device of its input: a CPU tensor goes to
the plain PyTorch version (the env's own sensor and physics functions), a
CUDA tensor to the kernel — or the wrapper raises. There is no fallback
from the card to the plain version.
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from ..env import physics, sensors
from . import _cuda

TUNED_MAX_AGENTS = 32   # robots an arena of the tuned kernels: a 32-bit mask a robot
# Wall segments the kernels stage. The env's arena is the mission's polygon
# of ``arena_num_sides`` faces and the gate's two side walls; no YAML,
# script or loader sets another side count than the dodecagon's 12, so the
# kernels see 14 segments.
MAX_SEGMENTS = 64


def route(N) -> str:
    """The kernels a CUDA call takes for arenas of N robots, by N alone:
    "tuned" (``csrc/pairwise.cu``, ``csrc/fused_step.cu``) where N <= 32,
    "wide" (``csrc/pairwise_wide.cu``, ``csrc/fused_step_wide.cu``) past it."""
    return "tuned" if N <= TUNED_MAX_AGENTS else "wide"


def pairwise_sensors_plain(pos, yaw, *, prox_range, robot_radius, rab_range,
                           alpha_rab, wall_segments):
    """Plain version: sensors.raycast_segments, detect_robots_proximity and
    compute_rab composed — the jnp path of the JAX package."""
    wdx, wdy = sensors.sensor_world_dirs(yaw)
    wall = sensors.raycast_segments(pos, wdx, wdy, wall_segments, prox_range)
    robot = sensors.detect_robots_proximity(pos, wdx, wdy, prox_range,
                                            robot_radius)
    prox = torch.maximum(torch.clamp(wall, min=0.0), robot)
    ztilde, rab_proj, attr_x, attr_y = sensors.compute_rab(
        pos, yaw, rab_range, alpha_rab)
    return prox, ztilde, rab_proj, attr_x, attr_y


@functools.lru_cache(maxsize=None)
def least_d2(reach, eps) -> float:
    """The least float32 q >= 0 with sqrt(q + eps) >= reach, each operation
    rounded to float32 as the kernels take it (reach and eps rounded to
    float32 first); the smallest positive float where q = 0 already
    passes, so that a threshold is always positive. The sum and the square
    root round monotonically, so every float32 q at or above it passes and
    every one below fails: a pair whose squared distance lies below it is
    within ``reach`` by the kernels' own test, exactly. Found by bisection
    over the bit patterns of the non-negative floats."""
    f32 = np.float32
    r, e = f32(reach), f32(eps)

    def passes(bits):
        q = np.array([bits], np.uint32).view(np.float32)
        return bool(np.sqrt(q + e)[0] >= r)

    lo, hi = 0, 0x7F800000       # +inf passes
    if passes(lo):
        return float(np.array([1], np.uint32).view(np.float32)[0])
    while hi - lo > 1:           # passes(hi) and not passes(lo)
        mid = (lo + hi) // 2
        if passes(mid):
            hi = mid
        else:
            lo = mid
    return float(np.array([hi], np.uint32).view(np.float32)[0])


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU or a CUDA "
                         f"device, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def sensor_constants(wall_segments):
    """Packed constants of the sensor kernel, on the segments' device:
    cos/sin of the sensor angles, cos/sin of the RAB projection angles, then
    (ax, ay, bx − ax, by − ay) per segment — the values the plain version
    computes, so both read the same numbers."""
    cos_a, sin_a, rab_cos, rab_sin = sensors.angle_tables(wall_segments.device)
    seg = wall_segments
    packed = torch.stack([seg[:, 0], seg[:, 1], seg[:, 2] - seg[:, 0],
                          seg[:, 3] - seg[:, 1]], dim=-1).reshape(-1)
    return torch.cat([cos_a, sin_a, rab_cos, rab_sin, packed])


_CONSTS = {}  # id(segments) -> (weak reference to them, their version, constants)


def cached_sensor_constants(wall_segments):
    """``sensor_constants(wall_segments)``, built at a segments tensor's
    first call and again only after the tensor is changed in place, so the
    env's steps build none of it. An entry goes with its tensor."""
    key = id(wall_segments)
    hit = _CONSTS.get(key)
    if hit is None or hit[0]() is not wall_segments:
        weakref.finalize(wall_segments, _CONSTS.pop, key, None)
    elif hit[1] == wall_segments._version:
        return hit[2]
    consts = sensor_constants(wall_segments)
    _CONSTS[key] = (weakref.ref(wall_segments), wall_segments._version, consts)
    return consts


def pairwise_sensors(pos, yaw, *, prox_range, robot_radius, rab_range,
                     alpha_rab, wall_segments):
    """Fused sensor pass. pos (E, N, 2), yaw (E, N), wall_segments (S, 4).
    On the card the kernel reads the segments through their packed
    constants (``cached_sensor_constants``).

    Returns prox (E, N, 8) — already max(wall, robot) per sensor —,
    ztilde (E, N), rab_proj (E, N, 4), rab_attr_x (E, N), rab_attr_y (E, N).
    """
    if pos.device.type == "cpu":
        return pairwise_sensors_plain(
            pos, yaw, prox_range=prox_range, robot_radius=robot_radius,
            rab_range=rab_range, alpha_rab=alpha_rab,
            wall_segments=wall_segments)
    _check_cuda("pairwise_sensors", pos, yaw, wall_segments)
    E, N = yaw.shape
    S = wall_segments.shape[0]
    if pos.shape != (E, N, 2) or wall_segments.shape != (S, 4):
        raise ValueError(f"pairwise_sensors: bad shapes pos {tuple(pos.shape)}"
                         f" yaw {tuple(yaw.shape)} "
                         f"segments {tuple(wall_segments.shape)}")
    if N < 1 or S > MAX_SEGMENTS:
        raise ValueError(f"pairwise_sensors: the kernels take N >= 1 robots and "
                         f"<= {MAX_SEGMENTS} segments, got N={N}, S={S}")
    consts = cached_sensor_constants(wall_segments)
    prox = torch.empty((E, N, 8), dtype=torch.float32, device=pos.device)
    ztilde = torch.empty((E, N), dtype=torch.float32, device=pos.device)
    rab_proj = torch.empty((E, N, 4), dtype=torch.float32, device=pos.device)
    attr_x = torch.empty((E, N), dtype=torch.float32, device=pos.device)
    attr_y = torch.empty((E, N), dtype=torch.float32, device=pos.device)
    args = (pos.data_ptr(), yaw.data_ptr(), consts.data_ptr(), S,
            prox.data_ptr(), ztilde.data_ptr(), rab_proj.data_ptr(),
            attr_x.data_ptr(), attr_y.data_ptr(), E, N, float(prox_range),
            float(prox_range + robot_radius), float(rab_range), float(alpha_rab))
    if route(N) == "wide":
        lib = _cuda.library("pairwise_wide")
        # the proximity test's and the RAB range's thresholds on d2 (their
        # epsilons under the square roots: sensors.py)
        _cuda.launch(pos, "pairwise_sensors_wide", lib.pairwise_sensors_wide_launch, *args,
                     least_d2(prox_range + robot_radius, 1e-12), least_d2(rab_range, 1e-8))
        _cuda.launches["pairwise_sensors_wide"] += 1
    else:
        lib = _cuda.library("pairwise")
        _cuda.launch(pos, "pairwise_sensors", lib.pairwise_sensors_launch, *args)
        _cuda.launches["pairwise_sensors"] += 1
    return prox, ztilde, rab_proj, attr_x, attr_y


@functools.lru_cache(maxsize=None)
def collision_skip_d2(robot_radius) -> float:
    """The collision kernels' skip threshold: the least float32 at or above
    (fl32(2r))². A pair whose float32 squared distance (ε included) reaches
    it has sqrt ≥ fl32(2r), hence no overlap and a push of exactly zero
    (the proof is in ``csrc/pairwise.cu`` and ``csrc/pairwise_wide.cu``). The square of a float32 is exact
    in float64, so the value is exact."""
    m2 = float(np.float32(2.0 * robot_radius)) ** 2
    t = np.float32(m2)
    if float(t) < m2:
        t = np.nextafter(t, np.float32(np.inf))
    return float(t)


def resolve_robot_collisions(pos, robot_radius):
    """Single-pass elastic push-out. pos (E, N, 2) → new (E, N, 2)."""
    if pos.device.type == "cpu":
        return physics.resolve_robot_collisions(pos, robot_radius)
    _check_cuda("resolve_robot_collisions", pos)
    E, N = pos.shape[:2]
    if pos.shape != (E, N, 2) or N < 1:
        raise ValueError(f"resolve_robot_collisions: pos must be (E, N>=1, 2), "
                         f"got {tuple(pos.shape)}")
    if pos.data_ptr() % 8 != 0:
        raise ValueError("resolve_robot_collisions: pos must be 8-byte aligned "
                         "(the kernels load each robot as one float2)")
    out = torch.empty_like(pos)
    args = (pos.data_ptr(), out.data_ptr(), E, N, float(2.0 * robot_radius),
            collision_skip_d2(robot_radius))
    if route(N) == "wide":
        lib = _cuda.library("pairwise_wide")
        _cuda.launch(pos, "resolve_robot_collisions_wide", lib.robot_collisions_wide_launch,
                     *args)
        _cuda.launches["resolve_robot_collisions_wide"] += 1
        return out
    lib = _cuda.library("pairwise")
    _cuda.launch(pos, "resolve_robot_collisions", lib.robot_collisions_launch, *args)
    _cuda.launches["resolve_robot_collisions"] += 1
    return out
