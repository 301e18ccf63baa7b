"""The tie rule of the port's discrete-variant tests.

The port and the JAX package compute the same float32 formulas, but may
sum in other orders (XLA contracts products into fused multiply-adds on
the CPU, and reduces an axis in its own order). An integer or boolean
result that hangs on a threshold test of such a sum can then differ where
the sum lies within a few ulps of its threshold:

  - the obstacle test (``prox_value ≥ threshold`` and ``|angle| ≤ π/2``,
    or the fused kernel's band ``sum_x·2²⁴ > −|sum_y|``) and the turn
    direction (``sum_y < 0``) on the 8-term sums of the proximity readings
    (sensors.py:106-107). A robot alongside a wall reads equal values on
    symmetric sensor pairs, so its sum_x is rounding noise for many steps
    (swarmacb_tpu/ops/fused_step.py:284-305);
  - the ground colour of a position near a zone edge (the reward counts).

``TieRule`` accepts an integer mismatch only where its decision input lies
within ``ULPS`` ulps of its threshold, measured against the magnitude of
what was summed (Σ|term| for the sensor sums, 1 m for positions), counts
every such exemption, and fails on any other mismatch.
"""

import numpy as np

ULPS = 16
EPS32 = float(np.finfo(np.float32).eps)


def _window(scale):
    return ULPS * EPS32 * scale


def prox_ties(prox_vals, cos_a, sin_a, threshold, band=False):
    """(E, N) mask of robots whose obstacle or turn test is within the
    window of its threshold. ``prox_vals`` (E, N, 8)."""
    v = np.asarray(prox_vals, dtype=np.float64)
    tx = v * np.asarray(cos_a, np.float64)
    ty = v * np.asarray(sin_a, np.float64)
    sx, sy = tx.sum(-1), ty.sum(-1)
    scale_x = np.abs(tx).sum(-1)
    scale_y = np.abs(ty).sum(-1)
    front = sx + np.abs(sy) * 2.0 ** -24 if band else sx
    value = np.minimum(np.hypot(sx, sy), 1.0)
    return ((np.abs(front) <= _window(scale_x))
            | (np.abs(sy) <= _window(scale_y))
            | (np.abs(value - threshold) <= _window(scale_x + scale_y)))


def colour_ties(pos, cfg):
    """(E,) mask of arenas with a robot within the window (of 1 m) of a
    ground-zone edge. ``pos`` (E, N, 2)."""
    x, y = np.abs(np.asarray(pos[..., 0], np.float64)), np.asarray(pos[..., 1], np.float64)
    edges_x = (cfg.gate_width / 2.0, cfg.corridor_width / 2.0)
    edges_y = (cfg.gate_south_y, cfg.corridor_south_y, cfg.north_inradius)
    near = np.zeros(x.shape, bool)
    for b in edges_x:
        near |= np.abs(x - b) <= _window(1.0)
    for b in edges_y:
        near |= np.abs(y - b) <= _window(1.0)
    return near.any(-1)


class TieRule:
    """Exact integer comparisons with the exemptions above, counted."""

    def __init__(self):
        self.exempt = 0
        self.compared = 0

    def equal(self, got, want, tie, what):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, what
        tie = np.broadcast_to(np.asarray(tie).reshape(
            tie.shape + (1,) * (got.ndim - np.ndim(tie))), got.shape)
        bad = got != want
        stray = bad & ~tie
        assert not stray.any(), (
            f"{what}: {int(stray.sum())} mismatches away from any tie, at "
            f"{np.argwhere(stray)[:5].tolist()}")
        self.exempt += int(bad.sum())
        self.compared += got.size
        return bad

    def report(self, name):
        print(f"{name}: {self.exempt} tie exemptions in {self.compared} "
              "integer comparisons")
