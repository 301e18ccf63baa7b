"""Static arena geometry for the Directional Gate mission.

A copy of ``swarmacb_tpu.env.geometry``. Everything in this module is
host-side numpy computed once per config; the env moves the tables to its
device once, and nothing here runs per step.

Behavioural parity notes (citations into the reference repo):
  - wall segments:      directional_gate_env.py:316-329
  - gate wall segments: directional_gate_env.py:331-346
  - wall face table:    directional_gate_env.py:554-582  (see the
    ``fixed`` flag below for the reference's duplicated-west-face quirk)
"""

from __future__ import annotations

import math

import numpy as np

# E-puck IR sensor angles, body frame (epuck_sensors.py:27-37, from
# ARGoS reference model RM 1.1).
EPUCK_SENSOR_ANGLES = np.array(
    [
        math.pi / 10.5884,  # ~17°  front-right
        math.pi / 3.5999,   # ~50°
        math.pi / 2.0,      # 90°   right
        math.pi / 1.2,      # 150°
        math.pi / 0.8571,   # 210°
        math.pi / 0.6667,   # 270°  left
        math.pi / 0.5806,   # 310°
        math.pi / 0.5247,   # 342°  front-left
    ],
    dtype=np.float32,
)

# Range-and-bearing projection angles: 45/135/225/315° (epuck_sensors.py:39-41)
RAB_PROJ_ANGLES = np.deg2rad(
    np.array([45.0, 135.0, 225.0, 315.0], dtype=np.float32)
).astype(np.float32)


def arena_vertices(circumradius: float, n_sides: int) -> np.ndarray:
    """Dodecagon vertices, offset by π/n so a flat side faces south.

    Matches directional_gate_env.py:316-323.
    Returns (n, 2) float32.
    """
    angles = 2.0 * np.pi * np.arange(n_sides) / n_sides + np.pi / n_sides
    return np.stack(
        [circumradius * np.cos(angles), circumradius * np.sin(angles)], axis=-1
    ).astype(np.float32)


def wall_segments(circumradius: float, n_sides: int) -> np.ndarray:
    """Arena boundary segments (ax, ay, bx, by) — (n, 4) float32.

    Matches directional_gate_env.py:324-329.
    """
    v = arena_vertices(circumradius, n_sides)
    nxt = np.roll(v, -1, axis=0)
    return np.concatenate([v, nxt], axis=-1).astype(np.float32)


def gate_wall_segments(
    corridor_width: float, gate_south_y: float, side_wall_length: float
) -> np.ndarray:
    """Two vertical side walls flanking the gate — (2, 4) float32.

    Matches directional_gate_env.py:331-346: walls at x = ±corridor_width/2,
    spanning gate_south_y .. gate_south_y + side_wall_length.
    """
    hw = corridor_width / 2.0
    return np.array(
        [
            [-hw, gate_south_y, -hw, gate_south_y + side_wall_length],
            [hw, gate_south_y, hw, gate_south_y + side_wall_length],
        ],
        dtype=np.float32,
    )


def wall_faces(
    circumradius: float, n_sides: int, fixed: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Inward face normals + on-face points for collision push-out.

    Returns (normals (n,2), points (n,2)), both float32.

    ``fixed=False`` reproduces the reference table verbatim
    (directional_gate_env.py:561-582): each face's mid-angle is the plain
    average of consecutive *wrapped* vertex angles, so the last face
    (between vertex 23π/12 and π/12) averages to π instead of 0 — it
    duplicates the west face and the east face gets no constraint.

    ``fixed=True`` computes the geometrically correct mid-angles
    2π(i+1)/n for every face.
    """
    inradius = circumradius * math.cos(math.pi / n_sides)
    normals, points = [], []
    for i in range(n_sides):
        if fixed:
            mid = 2.0 * math.pi * (i + 1) / n_sides
        else:
            angle = 2.0 * math.pi * i / n_sides + math.pi / n_sides
            next_angle = 2.0 * math.pi * ((i + 1) % n_sides) / n_sides + math.pi / n_sides
            mid = (angle + next_angle) / 2.0
        normals.append([-math.cos(mid), -math.sin(mid)])
        points.append([inradius * math.cos(mid), inradius * math.sin(mid)])
    return (
        np.asarray(normals, dtype=np.float32),
        np.asarray(points, dtype=np.float32),
    )
