"""Kinematic physics for batched e-puck arenas — plain PyTorch.

Counterpart of ``swarmacb_tpu/env/physics.py``: differential-drive
integration plus the three analytical collision passes (arena wall
push-out, gate side-wall clamp, inter-robot elastic push-out) on
``(E, N, ...)`` batches. Formula order and epsilon placements mirror the
reference for trajectory parity:

  - differential drive:    epuck_sensors.py:528-553
  - wall push-out:         directional_gate_env.py:584-610
  - gate-wall clamp:       directional_gate_env.py:360-407
  - robot push-out:        directional_gate_env.py:612-644

``resolve_robot_collisions`` here is the plain version of the CUDA kernel
in ``ops/pairwise.py``; the env calls the op, which picks by device.
"""

from __future__ import annotations

import torch

from ..numerics import sqrt_rn


def differential_drive(left_vel, right_vel, yaw, wheelbase: float, dt: float):
    """Differential-drive displacement: v=(l+r)/2, ω=(r−l)/wheelbase, Euler.

    Matches epuck_sensors.py:528-553. All args (E, N); returns (dx, dy, dyaw).
    """
    v = 0.5 * (left_vel + right_vel)
    omega = (right_vel - left_vel) / wheelbase
    cos_y = torch.cos(yaw)
    sin_y = torch.sin(yaw)
    return v * cos_y * dt, v * sin_y * dt, omega * dt


def integrate_and_wrap(pos, yaw, left_vel, right_vel, wheelbase: float, dt: float):
    """Integrate one step and wrap yaw to [-π, π] via atan2(sin, cos).

    Matches directional_gate_env.py:527-536. Returns new tensors.
    """
    dx, dy, dyaw = differential_drive(left_vel, right_vel, yaw, wheelbase, dt)
    pos = torch.stack([pos[..., 0] + dx, pos[..., 1] + dy], dim=-1)
    yaw = yaw + dyaw
    yaw = torch.atan2(torch.sin(yaw), torch.cos(yaw))
    return pos, yaw


def resolve_wall_collisions(pos, face_normals, face_points, robot_radius: float):
    """Push robots inside the polygonal boundary (sum over penetrating faces).

    Matches directional_gate_env.py:584-610: penetration = r − dot(pos − p, n),
    displacement = Σ_faces max(0, pen)·n.

    Args:
        pos: (E, N, 2); face_normals/points: (F, 2) tensors on pos's device.
    """
    normals = face_normals[None, None]                # (1, 1, F, 2)
    points = face_points[None, None]
    diff = pos[:, :, None, :] - points                # (E, N, F, 2)
    signed_dist = (diff * normals).sum(-1)            # (E, N, F)
    penetration = robot_radius - signed_dist
    penetration = penetration * (penetration > 0).to(pos.dtype)
    push = (penetration[..., None] * normals).sum(2)  # (E, N, 2)
    return pos + push


def resolve_gate_wall_collisions(
    pos,
    robot_radius: float,
    corridor_half_width: float,
    gate_south_y: float,
    side_wall_length: float,
):
    """Clamp robots out of the two vertical gate side walls.

    Matches directional_gate_env.py:360-407 including its sequencing: the
    left-wall snap is applied first and the right-wall test reads the
    updated x.
    """
    hw = corridor_half_width
    wall_top = gate_south_y + side_wall_length

    px = pos[..., 0]
    py = pos[..., 1]
    in_wall_y = (py > gate_south_y) & (py < wall_top)

    # Left wall at x = -hw
    dx_left = px - (-hw)
    pen_left = robot_radius - torch.abs(dx_left)
    near_left = (pen_left > 0) & in_wall_y & (px < 0)
    sign_l = torch.sign(dx_left)
    sign_l = torch.where(sign_l == 0, -torch.ones_like(sign_l), sign_l)
    px = torch.where(near_left, -hw + sign_l * robot_radius, px)

    # Right wall at x = +hw (reads updated px)
    dx_right = px - hw
    pen_right = robot_radius - torch.abs(dx_right)
    near_right = (pen_right > 0) & in_wall_y & (px > 0)
    sign_r = torch.sign(dx_right)
    sign_r = torch.where(sign_r == 0, torch.ones_like(sign_r), sign_r)
    px = torch.where(near_right, hw + sign_r * robot_radius, px)

    return torch.stack([px, py], dim=-1)


def resolve_robot_collisions(pos, robot_radius: float):
    """Single-pass elastic push-out between robot pairs.

    Matches directional_gate_env.py:612-644: overlap computed on the upper
    triangle (i<j), each robot pushed half the overlap along ±(pos_i−pos_j).
    Every pair reads the pre-push positions (one Jacobi pass). The
    reference early-exits when no pairs overlap (:629); applying a zero push
    is numerically identical, so this stays dense.
    """
    N = pos.shape[1]
    min_dist = 2.0 * robot_radius

    dx = pos[:, :, None, 0] - pos[:, None, :, 0]      # (E, N, N): x_i − x_j
    dy = pos[:, :, None, 1] - pos[:, None, :, 1]
    dist = sqrt_rn(dx**2 + dy**2 + 1e-8)

    triu = torch.triu(torch.ones((N, N), dtype=torch.bool, device=pos.device),
                      diagonal=1)[None]               # i<j
    overlap = torch.clamp(min_dist - dist, min=0.0) * triu.to(pos.dtype)

    nx = dx / (dist + 1e-8)
    ny = dy / (dist + 1e-8)

    half_x = overlap * nx * 0.5
    half_y = overlap * ny * 0.5

    px = pos[..., 0] + half_x.sum(2) - half_x.sum(1)
    py = pos[..., 1] + half_y.sum(2) - half_y.sum(1)
    return torch.stack([px, py], dim=-1)
