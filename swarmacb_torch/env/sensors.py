"""Batched e-puck sensor suite — plain PyTorch, shapes (E, N, ...).

Counterpart of ``swarmacb_tpu/env/sensors.py``, with the same math and
the same epsilon placements as the reference (file:line cited per
function):

  - 8 IR proximity sensors (walls via ray–segment batch, robots via
    pairwise 15°-cone test), aggregated to (value, angle)
  - 8 light sensors (inverse-distance × clamped dot), thresholded
  - 3 ground sensors (mission-provided colour field)
  - range-and-bearing (ztilde neighbour count, 4 projections,
    α-weighted attraction vector)
  - 5-D polar critic state

``raycast_segments``, ``detect_robots_proximity`` and ``compute_rab`` make
up the plain version of the CUDA kernel in ``ops/pairwise.py``; the env
calls that op, which picks the kernel or these functions by device.
"""

from __future__ import annotations

import functools

import torch

from ..numerics import sqrt_rn
from .geometry import EPUCK_SENSOR_ANGLES, RAB_PROJ_ANGLES


@functools.lru_cache(maxsize=None)
def angle_tables(device: torch.device):
    """cos/sin of the 8 sensor angles and the 4 RAB projection angles.

    float32, computed once on the CPU and copied to ``device``, so the
    CUDA kernel and the plain version read the very same constants.
    """
    sa = torch.from_numpy(EPUCK_SENSOR_ANGLES)
    ra = torch.from_numpy(RAB_PROJ_ANGLES)
    return tuple(t.to(device) for t in
                 (torch.cos(sa), torch.sin(sa), torch.cos(ra), torch.sin(ra)))


def sensor_world_dirs(yaw):
    """World-frame unit direction of each of the 8 sensors. yaw (E,N) → (E,N,8)×2.

    Matches epuck_sensors.py:97-109 (body-frame dirs rotated by yaw).
    """
    cos_a, sin_a, _, _ = angle_tables(yaw.device)
    cos_y = torch.cos(yaw)[..., None]
    sin_y = torch.sin(yaw)[..., None]
    lx = cos_a[None, None, :]
    ly = sin_a[None, None, :]
    world_dx = lx * cos_y - ly * sin_y
    world_dy = lx * sin_y + ly * cos_y
    return world_dx, world_dy


def raycast_segments(pos, world_dx, world_dy, segments, prox_range: float):
    """Batched ray–segment intersection over all wall segments at once.

    Matches epuck_sensors.py:178-236. ``segments`` is an (S, 4) float32
    tensor of [ax, ay, bx, by] on pos's device. Returns per-sensor readings
    (E, N, 8) = max over segments of (1 − t/range) for valid hits.
    """
    seg = segments                                   # (S, 4)
    seg_ax = seg[:, 0][None, None, :, None]          # (1,1,S,1)
    seg_ay = seg[:, 1][None, None, :, None]
    sx = (seg[:, 2] - seg[:, 0])[None, None, :, None]
    sy = (seg[:, 3] - seg[:, 1])[None, None, :, None]

    ox = pos[:, :, None, 0:1]                        # (E,N,1,1)
    oy = pos[:, :, None, 1:2]
    rdx = world_dx[:, :, None, :]                    # (E,N,1,8)
    rdy = world_dy[:, :, None, :]

    denom = rdx * sy - rdy * sx                      # (E,N,S,8)
    valid = torch.abs(denom) > 1e-8
    t = ((seg_ax - ox) * sy - (seg_ay - oy) * sx) / (denom + 1e-12)
    u = ((seg_ax - ox) * rdy - (seg_ay - oy) * rdx) / (denom + 1e-12)

    hit = valid & (t >= 0) & (t <= prox_range) & (u >= 0) & (u <= 1)
    reading = torch.where(hit, 1.0 - t / prox_range, torch.zeros_like(t))
    return reading.amax(dim=2)                       # (E,N,8)


def detect_robots_proximity(pos, world_dx, world_dy, prox_range: float, robot_radius: float):
    """Other-robot detections in the 8 IR rays (pairwise, 15° cone).

    Matches epuck_sensors.py:238-284: hit if dist < range+radius, the ray
    direction is within 15° of the target bearing (cos > 0.9659), and the
    target is not self (dist < 1e-4). Reading = clip(1 − dist/(range+r), 0, 1).
    """
    diff_x = pos[:, None, :, 0] - pos[:, :, None, 0]  # (E,N,N): x_j − x_i
    diff_y = pos[:, None, :, 1] - pos[:, :, None, 1]
    dist = sqrt_rn(diff_x**2 + diff_y**2 + 1e-12)

    is_self = dist < 1e-4
    in_range = dist < (prox_range + robot_radius)

    # dot of each sensor dir with each target offset: (E,N,8,N)
    dot = (
        world_dx[:, :, :, None] * diff_x[:, :, None, :]
        + world_dy[:, :, :, None] * diff_y[:, :, None, :]
    )
    cos_angle = dot / (dist[:, :, None, :] + 1e-8)
    angular_hit = cos_angle > 0.9659

    hit = in_range[:, :, None, :] & angular_hit & ~is_self[:, :, None, :]
    reading_val = torch.clamp(
        1.0 - dist[:, :, None, :] / (prox_range + robot_radius), 0.0, 1.0)
    reading = torch.where(hit, reading_val, torch.zeros_like(reading_val))
    return reading.amax(dim=-1)                       # (E,N,8)


def aggregate_prox(prox_values):
    """Aggregate 8 readings → (value, angle) via body-frame unit-vector sum.

    Matches epuck_sensors.py:128-136.
    """
    cos_a, sin_a, _, _ = angle_tables(prox_values.device)
    sum_x = (prox_values * cos_a[None, None, :]).sum(-1)
    sum_y = (prox_values * sin_a[None, None, :]).sum(-1)
    value = torch.clamp(sqrt_rn(sum_x**2 + sum_y**2), max=1.0)
    angle = torch.atan2(sum_y, sum_x)
    return value, angle


def compute_proximity(pos, yaw, segments, prox_range: float, robot_radius: float):
    """Full proximity pipeline: walls + robots → (values (E,N,8), value, angle).

    Matches epuck_sensors.py:79-136.
    """
    world_dx, world_dy = sensor_world_dirs(yaw)
    wall_readings = raycast_segments(pos, world_dx, world_dy, segments, prox_range)
    robot_readings = detect_robots_proximity(pos, world_dx, world_dy, prox_range, robot_radius)
    prox_values = torch.maximum(torch.clamp(wall_readings, min=0.0), robot_readings)
    value, angle = aggregate_prox(prox_values)
    return prox_values, value, angle


def compute_light(pos, yaw, light_pos, light_threshold: float):
    """Light sensor: inverse-distance × clamped directional dot, thresholded.

    Matches epuck_sensors.py:290-348. ``light_pos`` is a pair of floats.
    Returns (values (E,N,8), value, angle); value/angle are zeroed when max
    reading ≤ threshold.
    """
    cos_a, sin_a, _, _ = angle_tables(pos.device)
    lx = float(light_pos[0]) - pos[..., 0]
    ly = float(light_pos[1]) - pos[..., 1]
    dist = sqrt_rn(lx**2 + ly**2 + 1e-6)
    intensity = 1.0 / dist

    world_dx, world_dy = sensor_world_dirs(yaw)
    norm_lx = lx / (dist + 1e-8)
    norm_ly = ly / (dist + 1e-8)
    dot = world_dx * norm_lx[..., None] + world_dy * norm_ly[..., None]
    dot = torch.clamp(dot, min=0.0)
    light_values = torch.clamp(intensity[..., None] * dot, 0.0, 1.0)

    max_val = light_values.amax(-1)
    sum_x = (light_values * cos_a[None, None, :]).sum(-1)
    sum_y = (light_values * sin_a[None, None, :]).sum(-1)
    net_angle = torch.atan2(sum_y, sum_x)

    above = max_val > light_threshold
    light_value = torch.where(above, max_val, torch.zeros_like(max_val))
    light_angle = torch.where(above, net_angle, torch.zeros_like(net_angle))
    return light_values, light_value, light_angle


def compute_rab(pos, yaw, rab_range: float, alpha_rab: float):
    """Range-and-bearing: neighbour count, 4 projections, attraction vector.

    Matches epuck_sensors.py:374-442. Returns
    (ztilde (E,N), rab_proj (E,N,4), rab_attr_x (E,N), rab_attr_y (E,N)).
    """
    _, _, rab_cos, rab_sin = angle_tables(pos.device)
    N = pos.shape[1]
    cos_y = torch.cos(yaw)
    sin_y = torch.sin(yaw)

    dx = pos[:, None, :, 0] - pos[:, :, None, 0]      # (E,N,N): x_j − x_i
    dy = pos[:, None, :, 1] - pos[:, :, None, 1]
    dist = sqrt_rn(dx**2 + dy**2 + 1e-8)

    not_self = ~torch.eye(N, dtype=torch.bool, device=pos.device)[None]
    in_range = (dist < rab_range) & not_self

    n_neighbors = in_range.to(pos.dtype).sum(-1)
    ztilde = 1.0 - 2.0 / (1.0 + torch.exp(n_neighbors))

    inv_dist = 1.0 / (dist + 1e-8)
    body_x = dx * cos_y[..., None] + dy * sin_y[..., None]
    body_y = -dx * sin_y[..., None] + dy * cos_y[..., None]
    bearing = torch.atan2(body_y, body_x)
    cos_b = torch.cos(bearing)
    sin_b = torch.sin(bearing)
    in_f = in_range.to(pos.dtype)

    w_x = (inv_dist * cos_b * in_f).sum(-1)
    w_y = (inv_dist * sin_b * in_f).sum(-1)
    rab_proj = (w_x[..., None] * rab_cos[None, None, :]
                + w_y[..., None] * rab_sin[None, None, :])

    # one IEEE division, as the JAX package and the kernels take it (a
    # Python scalar over a tensor is PyTorch's reciprocal times the scalar)
    alpha_w = torch.full_like(dist, alpha_rab) / (1.0 + dist)
    rab_attr_x = (alpha_w * cos_b * in_f).sum(-1)
    rab_attr_y = (alpha_w * sin_b * in_f).sum(-1)
    return ztilde, rab_proj, rab_attr_x, rab_attr_y


def ground_color(pos, cfg):
    """Ground colour scalar per robot: 0=black, 0.5=grey, 1=white. (E,N).

    Matches directional_gate_env.py:409-452 (white gate test first, black
    corridor override second; note gate uses strict y bounds, corridor
    inclusive south bound).
    """
    x = pos[..., 0]
    y = pos[..., 1]
    ni = cfg.north_inradius
    corr_south = cfg.corridor_south_y
    gate_south = cfg.gate_south_y
    corr_hw = cfg.corridor_width / 2.0
    gate_hw = cfg.gate_width / 2.0

    color = torch.full_like(x, 0.5)
    in_gate = (torch.abs(x) < gate_hw) & (y > gate_south) & (y < corr_south)
    color = torch.where(in_gate, torch.ones_like(color), color)
    in_corr = (torch.abs(x) < corr_hw) & (y >= corr_south) & (y < ni)
    color = torch.where(in_corr, torch.zeros_like(color), color)
    return color


def ground_obs(pos, cfg):
    """3-channel ground observation (all channels identical).

    Matches directional_gate_env.py:452 / epuck_sensors.py:354-368.
    """
    c = ground_color(pos, cfg)
    return c[..., None].expand(c.shape + (3,))


def critic_state_5d(pos, yaw, arena_center, arena_radius: float, light_dir):
    """5-D polar critic state (ρ, cos α, sin α, cos β, sin β). (E,N,5).

    Matches epuck_sensors.py:486-522. ``arena_center`` and ``light_dir``
    are pairs of floats.
    """
    rel = torch.stack([pos[..., 0] - float(arena_center[0]),
                       pos[..., 1] - float(arena_center[1])], dim=-1)
    norm = torch.clamp(
        torch.linalg.vector_norm(rel, dim=-1, keepdim=True), min=1e-6
    )
    rho = torch.clamp(norm / arena_radius, 0.0, 1.0)[..., 0]
    rhat = rel / norm

    ldx, ldy = float(light_dir[0]), float(light_dir[1])
    cos_alpha = rhat[..., 0] * ldx + rhat[..., 1] * ldy
    sin_alpha = rhat[..., 0] * ldy - rhat[..., 1] * ldx

    hx = torch.cos(yaw)
    hy = torch.sin(yaw)
    cos_beta = hx * rhat[..., 0] + hy * rhat[..., 1]
    sin_beta = rhat[..., 0] * hy - rhat[..., 1] * hx
    return torch.stack([rho, cos_alpha, sin_alpha, cos_beta, sin_beta], dim=-1)


def collect_obs_dandelion(prox_values, light_values, ground, ztilde, rab_proj):
    """24-dim obs: [8 prox | 8 light | 3 ground | 1 ztilde | 4 RAB].

    Matches epuck_sensors.py:448-466.
    """
    return torch.cat(
        [prox_values, light_values, ground, ztilde[..., None], rab_proj], dim=-1
    )


def collect_obs_lily(ground, ztilde):
    """4-dim obs: [3 ground | 1 ztilde]. Matches epuck_sensors.py:468-480."""
    return torch.cat([ground, ztilde[..., None]], dim=-1)
