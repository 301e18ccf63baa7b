"""The launch plans and the exact skips of the env's wide route (K1-wide and
K2-wide in ``csrc/pairwise_wide.cu``, K4-wide in
``csrc/fused_step_wide.cu``), on the CPU, where no kernel runs.

On the card K4-wide takes up to 64 robot rows a block, K1-wide 32 robots a
block of eight lanes each, and K2-wide whole arenas a block of up to 128
robots, or 128 robots of one arena (each launch computes its grid; the
plans are mirrored here, ``k4_plan``, ``k1_plan`` and ``k2_plan``, from the
sources' constants); each takes each pair's squared distance
once and passes over what cannot count: the pairs at or past a threshold
(``pairwise.least_d2``, ``fused_step.sensor_skip_d2``,
``pairwise.collision_skip_d2``) and the wall
segments whose hit distance exceeds the range for every ray.
``chip_smoke.py`` (phase 2i) holds the kernels to their plain versions at
each edge of the plans. Here:

  (a) the plans mirror the sources' constants, take every N (33 … 4100) at
      ragged E, and fit a block's shared memory;
  (b) each threshold is exact in numpy float32 over the values around it:
      every q at or above it fails the kernels' range tests, the float
      below passes one, and the kernels' unsigned comparison of bit
      patterns is the test threshold <= q <= FLT_MAX at ±0, subnormals,
      FLT_MAX, ±inf and NaN of either sign;
  (c) a torch emulation of the kernels' sums, in their order, with the
      skips and without: the same bits on spread poses, on pairs within 8
      float32 steps of each threshold, and with an infinite or NaN
      coordinate and a non-finite heading (NaN where the full sums have
      it); K2-wide's push-out (words of 32 neighbours, the marked pairs in
      ascending j) against the form that evaluates every pair, bit for bit
      on spread, packed and tie inputs and with infinite and NaN
      coordinates, at N = 33 … 300; and K1-wide's bearing (rsqrt and a Newton step) within
      ``chip_smoke.K1_TOL``'s Σ|term| rule of the plain version's atan2.
"""

import re
from typing import NamedTuple

import numpy as np
import pytest
import torch

import chip_smoke as cs

from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import geometry
from swarmacb_torch.ops import _cuda, fused_step, pairwise
from torch_threads import one_torch_thread  # noqa: F401

K4_SRC = (_cuda.CSRC / "fused_step_wide.cu").read_text(encoding="utf-8")
K4_TUNED = (_cuda.CSRC / "fused_step.cu").read_text(encoding="utf-8")
K1_SRC = (_cuda.CSRC / "pairwise_wide.cu").read_text(encoding="utf-8")
SMEM_DEFAULT = 48 * 1024     # dynamic shared memory a launch takes without opting in
CFG = DirectionalGateEnvCfg(num_agents=40)
K = fused_step.constants(CFG)
F32 = np.float32
F32_MAX = np.finfo(np.float32).max
EDGE_N = (33, 64, 100, 256, 257, 300, 4100)
RAGGED_E = (1, 37, 128, 1000, 1024, 32768)


def _constant(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


# ── (a) the plans ────────────────────────────────────────────────────────

# csrc/fused_step_wide.cu: robot rows a block (4 a warp), arenas a block,
# the block buffers (x0, y0, x1, y1, rw) and the robots they hold in shared
# memory; csrc/pairwise_wide.cu: robots a block of the sensor pass (eight
# lanes each), neighbours a mask word, the constants' head
K4_MAX_ROWS, GROUP, K4_BUFFERS, K4_MAX_STAGED = 64, 8, 5, 256
K1_ROBOTS, K1_CHUNK, K1_CONST_HEAD = 32, 64, 2 * 8 + 2 * 4
# csrc/pairwise_wide.cu: robots a block of the push-out, neighbours a mark word
K2_ROBOTS, K2_WORD = 128, 32


class K4Plan(NamedTuple):
    rows: int           # robot rows a block; a thread takes rows i, i + rows, ...
    threads: int        # GROUP · rows
    blocks: int         # Ep / GROUP
    passes: int         # robots a thread takes, at most
    smem_bytes: int     # shared memory of a block, the buffers' and the reaches'
    scratch_bytes: int  # the buffers in device memory past K4_MAX_STAGED robots


class K1Plan(NamedTuple):
    blocks: int         # a one-dimensional grid, an arena's blocks side by side
    threads: int        # a block: 32 robots of one arena, eight lanes a robot
    words: int          # mask words of a robot's neighbours
    smem_bytes: int     # static shared memory of a block


class K2Plan(NamedTuple):
    arenas: int         # whole arenas a block; 1 where an arena spans blocks
    spans: int          # blocks an arena spans
    threads: int        # the block's robots rounded up to whole warps
    blocks: int         # a one-dimensional grid
    words: int          # mask words of a robot's neighbours


def k2_plan(E, N) -> K2Plan:
    """How ``robot_collisions_wide_launch`` launches K2-wide at (E, N):
    where an arena fits a block, the most whole arenas it holds; else
    ceil(N / K2_ROBOTS) blocks an arena, side by side."""
    whole = N <= K2_ROBOTS
    A = K2_ROBOTS // N if whole else 1
    spans = 1 if whole else -(-N // K2_ROBOTS)
    return K2Plan(arenas=A, spans=spans,
                  threads=-(-(A * N) // 32) * 32 if whole else K2_ROBOTS,
                  blocks=-(-E // A) if whole else E * spans, words=-(-N // K2_WORD))


def k4_plan(E, N) -> K4Plan:
    """How ``fused_step_wide_launch`` runs E arenas (padded to tiles of
    ``fused_step.LANES``) of N robots: the fewest passes of at most
    K4_MAX_ROWS rows, the rows as even as whole warps allow."""
    Ep = -(-E // fused_step.LANES) * fused_step.LANES
    passes = -(-N // K4_MAX_ROWS)
    rows = -(-(-(-N // passes)) // 4) * 4
    buffers = 4 * K4_BUFFERS * GROUP * N
    staged = N <= K4_MAX_STAGED
    return K4Plan(rows=rows, threads=GROUP * rows, blocks=Ep // GROUP, passes=passes,
                  smem_bytes=(buffers if staged else 0) + 4 * fused_step.MAX_SEGMENTS,
                  scratch_bytes=0 if staged else buffers * (Ep // GROUP))


def k1_plan(E, N) -> K1Plan:
    """How ``pairwise_sensors_wide_launch`` launches K1-wide at (E, N)."""
    smem = 4 * (K1_CONST_HEAD + 5 * pairwise.MAX_SEGMENTS)
    return K1Plan(blocks=E * -(-N // K1_ROBOTS), threads=8 * K1_ROBOTS,
                  words=-(-N // K1_CHUNK), smem_bytes=smem)


def test_plans_mirror_the_kernel_sources():
    assert _constant(K4_SRC, "kMaxRows") == K4_MAX_ROWS
    assert _constant(K4_SRC, "kBuffers") == K4_BUFFERS
    assert _constant(K4_SRC, "kMaxStaged") == K4_MAX_STAGED
    assert _constant(K4_SRC, "kChunk") == 32
    assert _constant(K4_TUNED, "kGroup") == GROUP
    assert "constexpr int kRows = 32 / kGroup;" in K4_TUNED   # rows a warp: 4
    assert _constant(K4_TUNED, "kMaxSeg") == fused_step.MAX_SEGMENTS
    assert _constant(K1_SRC, "kSensorRobots") == K1_ROBOTS
    assert _constant(K1_SRC, "kChunk") == K1_CHUNK
    assert _constant(K1_SRC, "kMaxSeg") == pairwise.MAX_SEGMENTS
    assert "constexpr int kConstHead = 2 * kSensors + 2 * kRabProj;" in K1_SRC
    # the launch computes the rows; the buffers go to a global scratch past
    # kMaxStaged robots
    assert "const int passes = (N + kMaxRows - 1) / kMaxRows;" in K4_SRC
    assert "const int rows = ((N + passes - 1) / passes + kRows - 1) / kRows * kRows;" in K4_SRC
    assert "if (N > kMaxStaged) {" in K4_SRC
    assert "fused_step_wide_kernel<<<Ep / kGroup, kGroup * rows," in K4_SRC
    assert "__shared__ float s_wall[kMaxSeg];" in K4_SRC
    assert ("static_cast<long long>(E) * ((N + kSensorRobots - 1) / kSensorRobots);"
            in K1_SRC)
    assert "const int blocks = (N + kSensorRobots - 1) / kSensorRobots;" in K1_SRC
    assert "__shared__ float s_c[kConstHead + 4 * kMaxSeg];" in K1_SRC
    assert "__shared__ float s_wall[kMaxSeg];" in K1_SRC
    assert _constant(K1_SRC, "kCollisionRobots") == K2_ROBOTS
    assert _constant(K1_SRC, "kWord") == K2_WORD
    assert "const int A = whole ? kCollisionRobots / N : 1;" in K1_SRC
    assert "const int threads = whole ? (A * N + 31) / 32 * 32 : kCollisionRobots;" in K1_SRC
    assert ("const long long blocks = whole ? (static_cast<long long>(E) + A - 1) / A\n"
            "                                 : static_cast<long long>(E) *\n"
            "                                       ((N + kCollisionRobots - 1) / "
            "kCollisionRobots);") in K1_SRC
    assert "const int spans = whole ? 1 : (N + kCollisionRobots - 1) / kCollisionRobots;" in K1_SRC
    assert "for (int j0 = 0; j0 < N; j0 += kWord) {" in K1_SRC


@pytest.mark.parametrize("N,want", [
    (33, (36, 1, False)), (64, (64, 1, False)), (100, (52, 2, False)),
    (256, (64, 4, False)), (257, (52, 5, True)), (300, (60, 5, True)),
    (4100, (64, 65, True)),
])
def test_k4_wide_plan_at_the_edges(N, want):
    rows, passes, scratch = want
    for E in RAGGED_E:
        p = k4_plan(E, N)
        Ep = -(-E // fused_step.LANES) * fused_step.LANES
        assert (p.rows, p.passes, p.scratch_bytes > 0) == (rows, passes, scratch)
        assert p.blocks == Ep // GROUP and p.threads == GROUP * p.rows
        buffers = 4 * K4_BUFFERS * GROUP * N
        assert p.scratch_bytes == (buffers * p.blocks if scratch else 0)
        assert p.smem_bytes == (0 if scratch else buffers) + 4 * fused_step.MAX_SEGMENTS


def test_k4_wide_plan_takes_every_robot_count():
    """Every N: whole warps of rows, at most 64, enough passes for every
    robot and no fewer rows would do; the block's buffers in shared memory
    only where they fit a launch that does not opt in to more."""
    for N in [*range(1, 300), 511, 512, 513, 1000, 4099, 4100, 4101, 20000]:
        p = k4_plan(37, N)
        assert p.rows % 4 == 0 and 4 <= p.rows <= K4_MAX_ROWS, N
        assert p.passes == -(-N // K4_MAX_ROWS), N
        assert p.rows * p.passes >= N > (p.rows - 4) * p.passes, N
        assert p.threads <= 1024 and p.smem_bytes <= SMEM_DEFAULT, N
        assert (p.scratch_bytes > 0) == (N > K4_MAX_STAGED), N


@pytest.mark.parametrize("N", EDGE_N)
def test_k1_wide_plan_at_the_edges(N):
    for E in RAGGED_E:
        p = k1_plan(E, N)
        assert p.blocks == E * -(-N // 32) < 2 ** 31 and p.threads == 256
        assert p.words == -(-N // 64) and p.smem_bytes == 4 * (24 + 5 * 64) <= SMEM_DEFAULT


@pytest.mark.parametrize("N,want", [
    (33, (3, 1, 128)), (40, (3, 1, 128)), (64, (2, 1, 128)), (65, (1, 1, 96)),
    (100, (1, 1, 128)), (128, (1, 1, 128)), (129, (1, 2, 128)), (300, (1, 3, 128)),
    (4100, (1, 33, 128)),
])
def test_k2_wide_plan_at_the_edges(N, want):
    arenas, spans, threads = want
    for E in RAGGED_E:
        p = k2_plan(E, N)
        assert (p.arenas, p.spans, p.threads) == want
        assert p.blocks == (-(-E // arenas) if N <= K2_ROBOTS else E * spans) < 2 ** 31
        assert p.words == -(-N // 32)
    # the timed shape fills the card: several blocks for each of its 132 SMs
    assert k2_plan(1024, 64).blocks == 512 >= 3 * 132


def test_k2_wide_plan_takes_every_robot_count():
    """Every N: whole warps, every robot a lane of one block, no lane idle
    but the last warp's and the arenas a block cannot hold whole."""
    for N in [*range(1, 300), 511, 512, 513, 4099, 4100, 4101, 20000]:
        p = k2_plan(37, N)
        assert p.threads % 32 == 0 and p.threads <= K2_ROBOTS, N
        robots = p.arenas * N if N <= K2_ROBOTS else K2_ROBOTS
        assert robots <= p.threads < robots + 32, N
        if N <= K2_ROBOTS:   # every arena in one block, the last block not empty
            assert (p.blocks - 1) * p.arenas < 37 <= p.blocks * p.arenas, N
        else:                # an arena's robots over its blocks
            assert p.blocks == 37 * p.spans and (p.spans - 1) * K2_ROBOTS < N, N


def test_the_wrappers_hand_each_entry_point_its_arguments():
    """The C entry points take the thresholds, as many arguments as
    ``_cuda.SIGNATURES`` declares."""
    for src, name in ((K4_SRC, "fused_step_wide_launch"), (K1_SRC, "pairwise_sensors_wide_launch"),
                      (K1_SRC, "robot_collisions_wide_launch")):
        params = re.search(rf"\nint {name}\((.*?)\) \{{", src, re.S).group(1)
        lib = "fused_step_wide" if "fused" in name else "pairwise_wide"
        assert params.count(",") + 1 == len(_cuda.SIGNATURES[lib][name])
    assert "int max_episode_length, float pair_d2, float touch_d2,\n" in K4_SRC
    assert "float alpha, float prox_d2, float rab_d2, void* stream" in K1_SRC
    assert "int N, float min_dist,\n                                 float skip_d2, void* stream)" in K1_SRC


# ── (b) the thresholds ───────────────────────────────────────────────────

def _steps(x, k):
    return (np.asarray(x, F32).view(np.int32) + np.int32(k)).view(F32)


THRESHOLDS = {   # name: (threshold, [(reach, eps), ...] that every q at or past it fails)
    "K4 sensors": (fused_step.sensor_skip_d2(K), [(K.prox_plus_r, 1e-12), (K.rab_range, 1e-8)]),
    "K1 proximity": (pairwise.least_d2(CFG.prox_range + CFG.robot_radius, 1e-12),
                     [(CFG.prox_range + CFG.robot_radius, 1e-12)]),
    "K1 RAB": (pairwise.least_d2(CFG.rab_range, 1e-8), [(CFG.rab_range, 1e-8)]),
}


@pytest.mark.parametrize("name", THRESHOLDS)
def test_threshold_is_exact_around_its_value(name):
    T, tests = THRESHOLDS[name]
    assert float(F32(T)) == T > 0, "a positive float32"
    q = _steps(T, np.arange(-64, 65))
    at_or_past = q >= F32(T)
    for reach, eps in tests:
        out = np.sqrt(q + F32(eps)) >= F32(reach)
        assert (out[at_or_past]).all(), "every q at or past it fails the range test"
    # the float below passes one of the tests: the least such threshold
    below = _steps(T, -1)
    assert any(not (np.sqrt(below + F32(eps)) >= F32(reach)) for reach, eps in tests)
    # and the one-sided tests the kernels make are the range tests themselves
    for reach, eps in tests:
        t = np.float32(pairwise.least_d2(reach, eps))
        assert ((q < t) == (np.sqrt(q + F32(eps)) < F32(reach))).all()


def test_least_d2_is_positive_where_zero_already_passes():
    assert pairwise.least_d2(1e-7, 1e-8) == float(np.array([1], np.uint32).view(F32)[0])
    assert pairwise.least_d2(0.2, 1e-8) == pairwise.least_d2(np.float32(0.2), np.float32(1e-8))


def _finite_at_least(q, T):
    """csrc/fused_step_wide.cu: finite_at_least, in uint32 arithmetic."""
    lo = np.uint32(np.float32(T).view(np.uint32))
    bits = np.asarray(q, F32).view(np.uint32)
    with np.errstate(over="ignore"):
        return (bits - lo) <= (np.uint32(0x7F7FFFFF) - lo)


@pytest.mark.parametrize("T", [fused_step.sensor_skip_d2(K), pairwise.collision_skip_d2(0.035)])
def test_bit_comparison_is_the_finite_range_test(T):
    specials = np.array([0x00000000, 0x80000000, 0x00000001, 0x007FFFFF, 0x7F7FFFFF,
                         0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001],
                        np.uint32).view(F32)
    q = np.concatenate([specials, _steps(T, np.arange(-64, 65)),
                        np.array([1e-8, 0.5, 3.0, 1e30], F32)])
    with np.errstate(invalid="ignore"):
        want = (q >= F32(T)) & (q <= F32_MAX)
    assert (_finite_at_least(q, T) == want).all()


# ── (c) the sums with and without the skips ──────────────────────────────

def t32(x):
    return torch.tensor(x, dtype=torch.float32)


def _nr_rsqrt(x):
    r0 = torch.rsqrt(x)
    return r0 * (t32(1.5) - t32(0.5) * x * r0 * r0)


def _poses(kind, E=6, N=40, seed=0):
    """(px, py, yaw) float32 (E, N): spread over a disc of 0.5 m (a few
    neighbours in every range); tie: pairs (2k, 2k + 1) whose d2 lies within
    8 float32 steps of a threshold, cycling over the four; poison: spread,
    with an infinite x, an infinite y, a NaN x and a non-finite heading."""
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0, 1, (E, N))) * 0.5
    th = rng.uniform(0, 2 * np.pi, (E, N))
    px, py = (r * np.cos(th)).astype(F32), (r * np.sin(th)).astype(F32)
    yaw = rng.uniform(-np.pi, np.pi, (E, N)).astype(F32)
    if kind == "tie":
        targets = [(fused_step.sensor_skip_d2(K), 0.0),
                   (pairwise.least_d2(K.prox_plus_r, 1e-12), 0.0),
                   (pairwise.least_d2(K.rab_range, 1e-8), 0.0),
                   (pairwise.collision_skip_d2(CFG.robot_radius), 1e-8)]
        for e in range(E):
            for p in range(N // 2):
                T, eps = targets[(p + e) % len(targets)]
                want = _steps(T, rng.integers(-8, 9))
                dx = np.sqrt(float(want) - eps)
                cand = _steps(dx, np.arange(-4, 5))
                q = cand * cand + F32(eps)
                dx = cand[np.argmin(np.abs(q.view(np.int32).astype(np.int64)
                                           - int(want.view(np.int32))))]
                x0, y0 = F32(0.0), F32(0.25 * (p - N // 4))   # exact offsets: x0 = 0
                along_x = rng.integers(2) == 0
                px[e, 2 * p], py[e, 2 * p] = x0, y0
                px[e, 2 * p + 1] = x0 + dx if along_x else x0
                py[e, 2 * p + 1] = y0 if along_x else y0 + dx
    if kind == "poison":
        px[0, 3] = np.inf
        py[1, 7] = -np.inf
        px[2, 11] = np.nan
        yaw[3, 5] = np.inf
    return tuple(torch.from_numpy(a) for a in (px, py, yaw))


def _mark(d2, T, i, j, self_zero):
    """The kernels' mark: the pair is evaluated unless T <= d2 <= FLT_MAX;
    the pair (i, i) is not where ``self_zero``."""
    skip = torch.from_numpy(_finite_at_least(d2.numpy(), T))
    return ~skip & ~(self_zero & (i == j))


def _k4_sensor_sums(px, py, yaw, skip):
    """fused_step_wide.cu's sensor_block_sparse (``skip``) or the full form
    (fused_step.cu's sensor_block) on (E, N) poses, term by term in j."""
    E, N = px.shape
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    wdx = [t32(K.cos_a[s]) * cy - t32(K.sin_a[s]) * sy for s in range(8)]
    wdy = [t32(K.cos_a[s]) * sy + t32(K.sin_a[s]) * cy for s in range(8)]
    zero = torch.zeros_like(px)
    prox = [zero.clone() for _ in range(8)]
    count, w_x, w_y, a_x, a_y = (zero.clone() for _ in range(5))
    finite = lambda t: t.abs() <= F32_MAX  # noqa: E731
    self_zero = finite(px) & finite(py) & finite(cy) & finite(sy)
    idx = torch.arange(N)
    for j in range(N):
        dx = px[:, j:j + 1] - px
        dy = py[:, j:j + 1] - py
        d2 = dx * dx + dy * dy
        take = (_mark(d2, fused_step.sensor_skip_d2(K), idx, j, self_zero) if skip
                else torch.ones_like(d2, dtype=torch.bool))
        dist_p = torch.sqrt(d2 + t32(1e-12))
        base = (dist_p < t32(K.prox_plus_r)) & ~(dist_p < t32(1e-4))
        rv = torch.clamp(t32(1.0) - dist_p / t32(K.prox_plus_r), 0.0, 1.0)
        rhs = t32(0.9659) * (dist_p + t32(1e-8))
        for s in range(8):
            hit = take & base & (wdx[s] * dx + wdy[s] * dy > rhs)
            prox[s] = torch.where(hit, torch.maximum(prox[s], rv), prox[s])
        dist_r = torch.sqrt(d2 + t32(1e-8))
        in_f = ((dist_r < t32(K.rab_range)) & (idx != j)).to(torch.float32)
        inv_dist = t32(1.0) / (dist_r + t32(1e-8))
        body_x = dx * cy + dy * sy
        body_y = (-dx) * sy + dy * cy
        inv_hyp = _nr_rsqrt(d2 + t32(1e-12))
        cos_b, sin_b = body_x * inv_hyp, body_y * inv_hyp
        alpha_w = t32(K.alpha) / (t32(1.0) + dist_r)
        upd = lambda acc, term: torch.where(take, acc + term, acc)  # noqa: E731
        count = upd(count, in_f)
        w_x = upd(w_x, inv_dist * cos_b * in_f)
        w_y = upd(w_y, inv_dist * sin_b * in_f)
        a_x = upd(a_x, alpha_w * cos_b * in_f)
        a_y = upd(a_y, alpha_w * sin_b * in_f)
    t_reach = t32(K.prox_range) * t32(1.0 + 2.0 ** -20)
    for ax, ay, sx_s, sy_s in K.segments:
        rel_x, rel_y = t32(ax) - px, t32(ay) - py
        num = rel_x * t32(sy_s) - rel_y * t32(sx_s)
        reach = (torch.sqrt(t32(sx_s) * t32(sx_s) + t32(sy_s) * t32(sy_s)) * t32(1.001)) * t_reach
        take = ~(num.abs() > reach) if skip else torch.ones_like(num, dtype=torch.bool)
        for s in range(8):
            denom = wdx[s] * t32(sy_s) - wdy[s] * t32(sx_s)
            inv_denom = t32(1.0) / (denom + t32(1e-12))
            t = num * inv_denom
            u = (rel_x * wdy[s] - rel_y * wdx[s]) * inv_denom
            hit = ((denom.abs() > t32(1e-8)) & (t >= 0) & (t <= t32(K.prox_range))
                   & (u >= 0) & (u <= 1))
            w_read = torch.where(hit, t32(1.0) - t * t32(K.inv_range), zero)
            prox[s] = torch.where(take, torch.maximum(prox[s], w_read), prox[s])
    return dict(count=count, w_x=w_x, w_y=w_y, a_x=a_x, a_y=a_y, prox=torch.stack(prox))


def _k4_push_sums(px, py, skip):
    """The push-out's two sums of each robot, in ascending j."""
    E, N = px.shape
    T = pairwise.collision_skip_d2(CFG.robot_radius)
    own_x, own_y, oth_x, oth_y = (torch.zeros_like(px) for _ in range(4))
    idx = torch.arange(N)
    for j in range(N):
        dx, dy = px - px[:, j:j + 1], py - py[:, j:j + 1]
        q = dx * dx + dy * dy + t32(1e-8)
        take = _mark(q, T, idx, j, True) if skip else idx != j
        # the pair (lo, hi): x_lo - x_hi, which is -dx where j < i
        lo_first = idx < j
        cdx = torch.where(lo_first, dx, px[:, j:j + 1] - px)
        cdy = torch.where(lo_first, dy, py[:, j:j + 1] - py)
        cdist = torch.sqrt(cdx * cdx + cdy * cdy + t32(1e-8))
        overlap = torch.clamp(t32(K.two_r) - cdist, min=0.0)
        cinv = t32(1.0) / (cdist + t32(1e-8))
        hx = overlap * cdx * cinv * t32(0.5)
        hy = overlap * cdy * cinv * t32(0.5)
        own = take & lo_first
        oth = take & ~lo_first
        own_x, own_y = torch.where(own, own_x + hx, own_x), torch.where(own, own_y + hy, own_y)
        oth_x, oth_y = torch.where(oth, oth_x + hx, oth_x), torch.where(oth, oth_y + hy, oth_y)
    return dict(own_x=own_x, own_y=own_y, oth_x=oth_x, oth_y=oth_y)


def _same_bits(a, b):
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)) for k in a)


@pytest.mark.parametrize("kind", ["spread", "tie", "poison"])
def test_k4_wide_skips_keep_every_bit(kind):
    px, py, yaw = _poses(kind)
    full, sparse = _k4_sensor_sums(px, py, yaw, False), _k4_sensor_sums(px, py, yaw, True)
    assert _same_bits(full, sparse)
    assert _same_bits(_k4_push_sums(px, py, False), _k4_push_sums(px, py, True))
    counted = full["count"][torch.isfinite(full["count"])]
    assert float(counted.sum()) > 0 and float(full["prox"].max()) > 0, "weak poses"
    if kind == "poison":   # NaN reaches the sums where the full form has it
        assert bool(torch.isnan(full["w_x"][3, 5])), "a non-finite heading"
        assert bool(torch.isnan(sparse["w_x"][0]).all()), "an infinite neighbour"


def _k2_wide_push(px, py, skip):
    """pairwise_wide.cu's robot_collisions_wide_kernel (``skip``) or the
    form that evaluates every pair j != i in ascending j, on (E, N)
    positions: the words of K2_WORD neighbours in turn, each word's marks
    from one loop over its 32 neighbours (in the arena's last word, robot
    N - 1 past N, masked off), then the marked pairs, lowest first, through
    the full arithmetic. Returns the new positions."""
    E, N = px.shape
    T = pairwise.collision_skip_d2(CFG.robot_radius)
    m = t32(2.0 * CFG.robot_radius)
    idx = torch.arange(N)
    own_x, own_y, oth_x, oth_y = (torch.zeros_like(px) for _ in range(4))
    for j0 in range(0, N, K2_WORD):
        marks = []
        for k in range(K2_WORD):
            j = min(j0 + k, N - 1)
            dx, dy = px - px[:, j:j + 1], py - py[:, j:j + 1]
            q = dx * dx + dy * dy + t32(1e-8)
            marks.append(~torch.from_numpy(_finite_at_least(q.numpy(), T)) if skip
                         else torch.ones_like(q, dtype=torch.bool))
        for k in range(min(K2_WORD, N - j0)):   # the marked pairs in ascending j
            j = j0 + k
            take = marks[k] & (idx != j)
            dx, dy = px - px[:, j:j + 1], py - py[:, j:j + 1]
            dist = torch.sqrt(dx * dx + dy * dy + t32(1e-8))
            overlap = torch.fmax(m - dist, torch.zeros_like(dist))
            tx = overlap * (dx / (dist + t32(1e-8))) * t32(0.5)
            ty = overlap * (dy / (dist + t32(1e-8))) * t32(0.5)
            up, down = take & (j > idx), take & (j < idx)
            own_x, own_y = torch.where(up, own_x + tx, own_x), torch.where(up, own_y + ty, own_y)
            oth_x = torch.where(down, oth_x - tx, oth_x)
            oth_y = torch.where(down, oth_y - ty, oth_y)
    off_plane = ~(torch.isfinite(px) & torch.isfinite(py))
    own_x = torch.where(off_plane, torch.nan, own_x)
    own_y = torch.where(off_plane, torch.nan, own_y)
    return torch.stack([(px + own_x) - oth_x, (py + own_y) - oth_y], -1)


@pytest.mark.parametrize("poison", [None, "nan", "inf"])
@pytest.mark.parametrize("kind", ["spread", "packed", "tie"])
@pytest.mark.parametrize("E,N", [(5, 33), (4, 40), (3, 64), (3, 65), (3, 100), (3, 300)])
def test_k2_wide_skip_keeps_every_bit(E, N, kind, poison):
    """The marks give the full form's bits on ``chip_smoke``'s inputs: spread,
    packed (a disc of radius 2r) and tie (pairs within ±8 float32 steps of
    the skip threshold), also with a NaN or infinite coordinates, which
    reach their arena as NaN where the full form has it; and they skip."""
    p = cs._collision_inputs(CFG, E, N)[kind]
    if poison == "nan":
        p[0, N // 2, 0] = np.nan
    elif poison == "inf":
        p[-1, N - 1, 1] = np.inf
        p[0, 0, 0] = -np.inf
    px, py = torch.from_numpy(p[..., 0].copy()), torch.from_numpy(p[..., 1].copy())
    full, sparse = _k2_wide_push(px, py, False), _k2_wide_push(px, py, True)
    nan_f, nan_s = full.isnan(), sparse.isnan()
    assert torch.equal(nan_f, nan_s)
    assert torch.equal(full[~nan_f].view(torch.int32), sparse[~nan_s].view(torch.int32))
    ok = ~nan_f
    assert float((full[ok] - torch.from_numpy(p)[ok]).abs().max()) > 1e-4, "no overlaps"
    if poison is not None:
        assert int(nan_f.sum()) >= 2 * N, "the poison spread through its arena"


def _k1_sums(px, py, yaw, skip, bearing="rsqrt"):
    """pairwise_wide.cu's sensor kernel (``skip``: the thresholds, the
    cone's robots in reach, the segments some ray can hit) or the full form
    (every pair's range test dist_r < rab_range, every pair's and segment's
    test): in each word of 64 neighbours, the one in range of rank r taken
    by lane r mod 8 in ascending j, the partial sums meeting by three xor
    steps."""
    E, N = px.shape
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    ppr, rab = t32(CFG.prox_range + CFG.robot_radius), t32(CFG.rab_range)
    lanes = {k: [torch.zeros_like(px) for _ in range(8)] for k in ("w_x", "w_y", "a_x", "a_y")}
    count = torch.zeros_like(px)
    rank = torch.zeros_like(px, dtype=torch.int64)   # in range so far in this word of 64
    idx = torch.arange(N)
    cos_a, sin_a = (t32(np.cos(geometry.EPUCK_SENSOR_ANGLES)), t32(np.sin(geometry.EPUCK_SENSOR_ANGLES)))
    wdx = [cos_a[s] * cy - sin_a[s] * sy for s in range(8)]
    wdy = [cos_a[s] * sy + sin_a[s] * cy for s in range(8)]
    reading = [torch.zeros_like(px) for _ in range(8)]
    for j in range(N):
        dx = px[:, j:j + 1] - px
        dy = py[:, j:j + 1] - py
        d2 = dx * dx + dy * dy
        if skip:
            in_r = (idx != j) & (d2 < t32(pairwise.least_d2(CFG.rab_range, 1e-8)))
            near = (idx != j) & (d2 < t32(pairwise.least_d2(CFG.prox_range + CFG.robot_radius,
                                                            1e-12)))
        else:
            in_r = (idx != j) & (torch.sqrt(d2 + t32(1e-8)) < rab)
            near = torch.ones_like(in_r)
        dist_r = torch.sqrt(d2 + t32(1e-8))
        inv_dist = t32(1.0) / (dist_r + t32(1e-8))
        body_x, body_y = dx * cy + dy * sy, (-dx) * sy + dy * cy
        if bearing == "rsqrt":
            inv_hyp = _nr_rsqrt(d2)
            small = d2 < t32(2.0 ** -100)
            b = torch.atan2(body_y, body_x)
            cb = torch.where(small, torch.cos(b), body_x * inv_hyp)
            sb = torch.where(small, torch.sin(b), body_y * inv_hyp)
        else:
            b = torch.atan2(body_y, body_x)
            cb, sb = torch.cos(b), torch.sin(b)
        alpha_w = t32(CFG.alpha_parameter) / (t32(1.0) + dist_r)
        if j % 64 == 0:
            rank.zero_()
        count += in_r
        for s in range(8):   # the neighbour in range of rank r goes to lane r mod 8
            take = in_r & (rank % 8 == s)
            for name, term in (("w_x", inv_dist * cb), ("w_y", inv_dist * sb),
                               ("a_x", alpha_w * cb), ("a_y", alpha_w * sb)):
                lanes[name][s] = torch.where(take, lanes[name][s] + term, lanes[name][s])
        rank += in_r
        dist_p = torch.sqrt(d2 + t32(1e-12))
        ok = near & (dist_p < ppr) & ~(dist_p < t32(1e-4))
        rv = torch.clamp(t32(1.0) - dist_p / ppr, 0.0, 1.0)
        for r in range(8):
            hit = ok & ((wdx[r] * dx + wdy[r] * dy) / (dist_p + t32(1e-8)) > t32(0.9659))
            reading[r] = torch.where(hit, torch.maximum(reading[r], rv), reading[r])
    out = {"count": count}
    for name, v in lanes.items():
        for off in (1, 2, 4):
            v = [v[s] + v[s ^ off] for s in range(8)]
        assert all(torch.equal(v[0].view(torch.int32), x.view(torch.int32)) for x in v)
        out[name] = v[0]
    prox_range = t32(CFG.prox_range)
    t_reach = prox_range * t32(1.0 + 2.0 ** -20)
    walls = geometry.wall_segments(CFG.arena_circumradius, CFG.arena_num_sides)
    for a in walls:
        ax, ay = t32(float(a[0])), t32(float(a[1]))
        sx, sy_s = t32(float(a[2])) - ax, t32(float(a[3])) - ay
        rel_x, rel_y = ax - px, ay - py
        num = rel_x * sy_s - rel_y * sx
        seg_ok = (~(num.abs() > (torch.sqrt(sx * sx + sy_s * sy_s) * t32(1.001)) * t_reach)
                  if skip else torch.ones_like(num, dtype=torch.bool))
        for r in range(8):
            denom = wdx[r] * sy_s - wdy[r] * sx
            den = denom + t32(1e-12)
            ray_ok = seg_ok & (denom.abs() > t32(1e-8))
            if skip:
                ray_ok &= ~(num.abs() > den.abs() * t_reach)
            t = num / den
            u = (rel_x * wdy[r] - rel_y * wdx[r]) / den
            hit = ray_ok & (t >= 0) & (t <= prox_range) & (u >= 0) & (u <= 1)
            reading[r] = torch.where(hit, torch.maximum(reading[r], t32(1.0) - t / prox_range),
                                     reading[r])
    out["prox"] = torch.stack(reading)
    return out


@pytest.mark.parametrize("kind", ["spread", "tie", "poison"])
def test_k1_wide_skips_keep_every_bit(kind):
    px, py, yaw = _poses(kind)
    full, sparse = _k1_sums(px, py, yaw, False), _k1_sums(px, py, yaw, True)
    assert _same_bits(full, sparse)
    assert float(full["count"].max()) > 0 and float(full["prox"].max()) > 0, "weak poses"


@pytest.mark.parametrize("kind", ["spread", "tie"])
def test_k1_wide_bearing_within_the_plain_version_s_rule(kind):
    """The rsqrt bearing against the atan2 one and against the plain
    version (``pairwise.pairwise_sensors_plain``): the RAB sums within
    1e-5 + 1e-5·Σ|term| (``chip_smoke.K1_TOL``), the count and readings
    exact; coincident robots (d2 = 0) take atan2 in both."""
    px, py, yaw = _poses(kind)
    px[0, 1], py[0, 1] = px[0, 0], py[0, 0]      # coincident robots
    ours, theirs = _k1_sums(px, py, yaw, True), _k1_sums(px, py, yaw, True, bearing="atan2")
    walls = torch.from_numpy(geometry.wall_segments(CFG.arena_circumradius,
                                                    CFG.arena_num_sides).astype(np.float32))
    pos = torch.stack([px, py], -1)
    prox, ztilde, rab_proj, attr_x, attr_y = pairwise.pairwise_sensors_plain(
        pos, yaw, prox_range=CFG.prox_range, robot_radius=CFG.robot_radius,
        rab_range=CFG.rab_range, alpha_rab=CFG.alpha_parameter, wall_segments=walls)
    assert torch.equal(ours["count"], theirs["count"])
    assert float((ours["prox"] - prox.permute(2, 0, 1)).abs().max()) <= 1e-6
    d = torch.sqrt(((pos[:, None] - pos[:, :, None]) ** 2).sum(-1).double() + 1e-8)
    on = (d < CFG.rab_range) & ~torch.eye(pos.shape[1], dtype=torch.bool)
    mag_w = (on / (d + 1e-8)).sum(-1)
    mag_a = (on * CFG.alpha_parameter / (1 + d)).sum(-1)
    rc, rs = (np.cos(geometry.RAB_PROJ_ANGLES), np.sin(geometry.RAB_PROJ_ANGLES))
    for k in range(4):
        got = ours["w_x"].double() * float(rc[k]) + ours["w_y"].double() * float(rs[k])
        assert ((got - rab_proj[..., k].double()).abs() <= 1e-5 + 1e-5 * mag_w + 1e-6).all()
    for name, want in (("a_x", attr_x), ("a_y", attr_y)):
        for other in (want, theirs[name]):
            assert ((ours[name].double() - other.double()).abs() <= 1e-5 + 1e-5 * mag_a).all()
    assert float(ours["w_x"][0].abs().max()) > 1e3, "the coincident pair counted"
