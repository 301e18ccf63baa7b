"""K2, the collision push-out, on the CPU: the skip threshold of its CUDA
kernel and the exactness of the skip.

The kernel (``swarmacb_torch/ops/csrc/pairwise.cu``, ``robot_collisions_kernel``)
takes each pair's half push into one of two sums in ascending j, and skips
the square root and divisions of a pair whose float32 squared distance q
reaches the threshold ``pairwise.collision_skip_d2(r)``. These tests hold,
in order:

  (a) the threshold against an independent computation with fractions;
  (b) that the plain formula's overlap is exactly 0 for every float32 q at
      or above it, within 64 steps, and that the kernel's one unsigned
      comparison of bit patterns is the range test skip_d2 <= q <= FLT_MAX;
  (c) a torch emulation of the kernel's loop with and without the skip:
      the same bits on spread, packed and tie inputs (``chip_smoke``'s
      generators), also with a NaN or an infinite coordinate, and within
      1e-6 of the plain version with NaN in the same places;
  (d) the plain version against the Pallas kernel in interpret mode on
      packed and tie inputs, within 2e-6, as ``tests/test_torch_env.py``
      holds it on spread inputs;
  (e) ``chip_smoke``'s measures of what K2 meets in a rollout: the
      positions ``drive_dandelion`` hands over are K2's input, and
      ``near_pair_counts`` matches a count pair by pair.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from swarmacb_tpu.ops import pairwise as jpairwise

from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import physics
from swarmacb_torch.ops import pairwise

CFG = DirectionalGateEnvCfg()
R = CFG.robot_radius
F32_MAX = float(np.finfo(np.float32).max)
# 0.035 is the env's; 2r = 0.0625 has an exact float32 square
RADII = (0.035, 0.05, 0.03125)


def _f32_steps(x, k):
    """The float32 k steps from x (x > 0)."""
    return (np.asarray(x, np.float32).view(np.int32) + np.int32(k)).view(np.float32)


def _least_f32_at_or_above(x: Fraction) -> np.float32:
    c = np.float32(float(x))
    while Fraction(float(c)) < x:
        c = _f32_steps(c, 1)
    while Fraction(float(_f32_steps(c, -1))) >= x:
        c = _f32_steps(c, -1)
    return c


# ── (a) the threshold ────────────────────────────────────────────────────

@pytest.mark.parametrize("r", RADII)
def test_skip_threshold_is_least_float32_at_or_above_min_dist_squared(r):
    m = Fraction(float(np.float32(2.0 * r)))
    want = _least_f32_at_or_above(m * m)
    got = pairwise.collision_skip_d2(r)
    assert got == float(want)
    assert float(np.float32(got)) == got, "the threshold is a float32"
    assert pairwise.collision_skip_d2(r) is got, "cached per radius"
    if r == R:
        assert int(np.float32(got).view(np.int32)) == 0x3BA0902E


# ── (b) the skip's exactness at the threshold ────────────────────────────

@pytest.mark.parametrize("r", RADII)
def test_overlap_is_zero_at_and_above_the_threshold(r):
    T = np.float32(pairwise.collision_skip_d2(r))
    q = torch.from_numpy(_f32_steps(T, np.arange(-64, 65)))
    m = torch.tensor(np.float32(2.0 * r))
    overlap = torch.clamp(m - torch.sqrt(q), min=0.0)
    at_or_above = q >= float(T)
    assert int(at_or_above.sum()) == 65
    assert bool((overlap[at_or_above] == 0).all())
    assert bool((overlap[~at_or_above] > 0).any()), "the window misses the boundary"


def test_skip_bit_test_is_the_range_test():
    """The kernel tests skip_d2 <= q <= FLT_MAX as one unsigned comparison,
    bits(q) - bits(skip_d2) <= bits(FLT_MAX) - bits(skip_d2); on every q
    that it can meet (positive, +inf, NaN of either sign) the two agree."""
    T = np.float32(pairwise.collision_skip_d2(R))
    rng = np.random.default_rng(0)
    special = np.array([0x7F800000, 0x7FC00000, 0xFFC00000, 0x7F800001, 0x7F7FFFFF,
                        0x00000001, 0x32ABCC77], np.uint32)   # +inf, NaNs, FLT_MAX, 1e-8
    bits = np.concatenate([_f32_steps(T, np.arange(-64, 65)).view(np.uint32), special,
                           rng.integers(1, 0x7F800000, 100_000).astype(np.uint32)])
    q = bits.view(np.float32)
    tb = np.uint32(T.view(np.uint32))
    by_bits = (bits - tb) <= (np.uint32(0x7F7FFFFF) - tb)
    with np.errstate(invalid="ignore"):
        by_range = (q >= T) & (q <= F32_MAX)
    np.testing.assert_array_equal(by_bits, by_range)
    assert by_bits.any() and not by_bits.all()


# ── (c) the kernel's loop, with and without the skip ─────────────────────

def _kernel_loop(pos, r, skip_d2=None):
    """The CUDA kernel's arithmetic in float32 torch: for each robot i, the
    pairs (i, j) in ascending j (the kernel marks the pairs to evaluate in
    one loop and evaluates them, in that order, in a second); the pair's
    half push half(i, j) goes into ``own`` where j > i and is taken from
    ``other`` where j < i; the overlap is fmaxf's (a NaN difference gives
    0); given ``skip_d2``, a pair with skip_d2 <= q <= FLT_MAX is left out;
    a robot with a coordinate off the finite plane ends NaN in both.
    Returns the new positions and the count of pairs skipped."""
    m = torch.tensor(np.float32(2.0 * r))
    x, y = pos[..., 0], pos[..., 1]
    N = pos.shape[1]
    i = torch.arange(N)
    own_x, own_y, other_x, other_y = (torch.zeros_like(x) for _ in range(4))
    n_skipped = 0
    for j in range(N):
        dx = x - x[:, j:j + 1]
        dy = y - y[:, j:j + 1]
        q = dx * dx + dy * dy + 1e-8
        take = (i != j).expand_as(q)
        if skip_d2 is not None:
            skipped = take & (q >= skip_d2) & (q <= F32_MAX)
            n_skipped += int(skipped.sum())
            take = take & ~skipped
        dist = torch.sqrt(q)
        overlap = torch.fmax(m - dist, torch.zeros_like(dist))
        tx = overlap * (dx / (dist + 1e-8)) * 0.5
        ty = overlap * (dy / (dist + 1e-8)) * 0.5
        up, down = take & (j > i), take & (j < i)
        own_x = torch.where(up, own_x + tx, own_x)
        own_y = torch.where(up, own_y + ty, own_y)
        other_x = torch.where(down, other_x - tx, other_x)
        other_y = torch.where(down, other_y - ty, other_y)
    off_plane = ~(torch.isfinite(x) & torch.isfinite(y))
    own_x = torch.where(off_plane, torch.nan, own_x)
    own_y = torch.where(off_plane, torch.nan, own_y)
    out = torch.stack([(x + own_x) - other_x, (y + own_y) - other_y], -1)
    return out, n_skipped


def _inputs(kind, E, N, seed):
    rng = np.random.default_rng(seed)
    if kind == "spread":
        return cs._arena_poses(rng, CFG, E, N)[0]
    if kind == "packed":
        return cs._packed_poses(rng, CFG, E, N)
    return cs._tie_poses(rng, CFG, E, N)[0]


def _same_bits(a, b):
    """Equal bits, NaN payloads aside: NaN in the same places, and the
    same bits everywhere else."""
    nan_a, nan_b = a.isnan(), b.isnan()
    return (bool(torch.equal(nan_a, nan_b))
            and bool(torch.equal(a[~nan_a].view(torch.int32), b[~nan_b].view(torch.int32))))


@pytest.mark.parametrize("poison", [None, "nan", "inf"])
@pytest.mark.parametrize("kind", ["spread", "packed", "tie"])
@pytest.mark.parametrize("E,N,seed", [(64, 20, 0), (37, 7, 1), (9, 31, 2), (5, 32, 3)])
def test_kernel_loop_skip_is_exact(E, N, seed, kind, poison):
    pos_np = _inputs(kind, E, N, seed)
    if poison == "nan":
        pos_np[1, N // 2, 0] = np.nan
    elif poison == "inf":
        pos_np[1, N // 2, 1] = np.inf
        pos_np[2, 0, 0] = -np.inf
    pos = torch.from_numpy(pos_np)
    full, _ = _kernel_loop(pos, R)
    fast, n_skipped = _kernel_loop(pos, R, pairwise.collision_skip_d2(R))
    assert n_skipped > 0
    assert _same_bits(full, fast)
    # the emulation computes the plain version's function
    plain = physics.resolve_robot_collisions(pos, R)
    assert bool(torch.equal(plain.isnan(), full.isnan()))
    if poison is not None:
        assert int(plain.isnan().sum()) >= 2 * N, "the poison spread through its arena"
    ok = ~plain.isnan()
    err = float((plain[ok].double() - full[ok].double()).abs().max())
    assert err <= 1e-6, err
    assert float((full[ok] - pos[ok]).abs().max()) > 1e-4, "no overlaps — weak test"


def test_tie_inputs_straddle_the_threshold():
    """Each tie pair's q lies within ±8 float32 steps of the threshold, on
    both sides, and the inputs are sharp enough that a threshold two steps
    too low changes output bits."""
    pos_np, steps = cs._tie_poses(np.random.default_rng(4), CFG, 256, 20)
    assert int(np.abs(steps).max()) <= 8
    assert (steps >= 0).any() and (steps < 0).any()
    pos = torch.from_numpy(pos_np)
    full, _ = _kernel_loop(pos, R)
    low = float(_f32_steps(pairwise.collision_skip_d2(R), -2))
    assert not _same_bits(full, _kernel_loop(pos, R, low)[0])


# ── what K2 receives in a rollout, and what it does there ────────────────

@pytest.mark.parametrize("policy", ["random", "gate"])
def test_drive_dandelion_hands_over_what_k2_receives(policy):
    """The positions handed over in the last step are K2's input: pushed
    apart, they are the state's positions after that step."""
    seen = []
    state = cs.drive_dandelion(torch, 3, 4, policy, 7,
                               lambda step, pos: seen.append((step, pos)), device="cpu")
    assert [step for step, _ in seen] == [0, 1, 2, 3]
    pos = seen[-1][1]
    assert pos.shape == (3, CFG.num_agents, 2) and pos.dtype == torch.float32
    assert bool(torch.equal(physics.resolve_robot_collisions(pos, R), state.pos))


@pytest.mark.parametrize("kind", ["spread", "packed", "tie"])
@pytest.mark.parametrize("E,N,seed", [(8, 20, 0), (37, 7, 1)])
def test_near_pair_counts_match_a_count_pair_by_pair(E, N, seed, kind):
    pos_np = _inputs(kind, E, N, seed)
    T = np.float32(pairwise.collision_skip_d2(R))
    f32_max = np.finfo(np.float32).max
    near = np.zeros((E, N, N), bool)
    for i in range(N):
        for j in range(N):
            q = cs._pair_d2(pos_np[:, i, 0], pos_np[:, i, 1], pos_np[:, j, 0], pos_np[:, j, 1])
            near[:, i, j] = (i != j) & ~((q >= T) & (q <= f32_max))
    lanes = np.concatenate([near.reshape(E * N, N), np.zeros((-(E * N) % 32, N), bool)])
    warps = lanes.reshape(-1, 32, N)
    lane_max, union = warps.sum(-1).max(1), warps.any(1).sum(-1)
    got = cs.near_pair_counts(torch, torch.from_numpy(pos_np), float(T))
    assert got["share"] == near.sum() / (E * N * (N - 1))
    assert got["lane_max"] == (pytest.approx(lane_max.mean()), int(lane_max.max()))
    assert got["union"] == (pytest.approx(union.mean()), int(union.max()))
    assert got["lane_max"][1] > 0 or kind == "spread"


# ── (d) the plain version against the Pallas kernel ──────────────────────

@pytest.mark.parametrize("kind", ["packed", "tie"])
@pytest.mark.parametrize("E,N,seed", [(5, 20, 2), (3, 32, 4), (4, 7, 5)])
def test_plain_robot_collisions_matches_pallas(E, N, seed, kind):
    pos = _inputs(kind, E, N, seed)
    got = physics.resolve_robot_collisions(torch.from_numpy(pos), R)
    want = jpairwise.resolve_robot_collisions(jnp.asarray(pos), R, interpret=True)
    assert np.abs(got.numpy() - pos).max() > 1e-4, "no overlaps — weak test"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
