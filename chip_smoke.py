#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``swarmacb_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass for the run to pass:

  1. the card: its name and power limit (``nvidia-smi``), TF32 switched
     off for matrix products and convolutions, and the build of every
     CUDA kernel of the port from ``swarmacb_torch/ops/csrc`` (one nvcc
     per source, all started together);
  2. one phase per kernel, at the shapes of the main path (K1, K2 and K4:
     E = 1024 arenas of N = 20 robots; K3f, K3b, K5f and K5b: B = 1024
     groups, N = 20, H = 4 heads, h = 512): the kernel against its plain
     PyTorch version on the same inputs, made from a numpy seed, with the
     tolerance printed beside the error; the median device time of each
     over 25 runs after warm-up; and the least time the card could take
     (bound). Phase 2a also prints the launch floor (an empty kernel under
     the same timing) and ptxas's registers and spills for K1 and K2, and
     holds K1 and K2 at bench.py's E = 32768 too, as phase 2g holds K4's
     daisy form with observations: against the plain version, two calls
     giving the same bits, the kernel alone timed beside its bound there.
     K2 is held on three kinds of positions (spread as the env spawns
     them, packed so that most pairs overlap, and pairs placed on its skip
     threshold), also at ragged shapes and with non-finite coordinates. K3f
     (``tail_forward.cu``, its product in 3xTF32 on the tensor cores) is
     also held at h = 128 and at a small ragged shape, two calls of it
     must give the same bits, and its time is printed
     beside the bound of its route and that of a float32 CUDA-core route,
     with ptxas's registers and spills. K3b's seven and K5b's nine
     cotangents come from
     ``torch.autograd.grad`` through ``ops.fused_tail`` and
     ``ops.fused_cf_attention``; K5b's are held against a float64 plain run
     on the card, as the JAX package's kernel test holds its kernel. K3b
     runs as three kernels (rows, then the batched products for d_wa and
     d_attn_lhs) joined by a d_fc scratch: phase 2c holds that scratch
     against the staged plain version (``tail_backward_reference``),
     checks that two calls give the same bits, and times each stage alone
     beside its bound and, for the two products, ``torch.bmm``, at h = 512
     and again at tulip's and cyclamen's h = 128 (the JSON row is
     h = 512's); phases 2d and 2e hold K5f's pooled rows and K5b's
     cotangents at h = 128 too. K5f runs
     as two kernels (the base products, K5b's first stage; the rows)
     joined by scratch: phase 2d holds its pooled rows against
     ``cf_reference`` at score scales 3 and 12 (and at a small ragged
     shape), each stage's outputs and scratch against the staged plain
     version (``cf_forward_reference``), checks that two calls give the
     same bits, prints ptxas's registers and spills, and times each stage
     alone beside its bound (``torch.bmm`` beside the base products), and
     K5f beside the algorithm's bound and the staged route's. K5b
     runs as four kernels (the base products, the rows, the sums over
     counterfactuals, the small products) joined by scratch: phase 2e also
     holds each stage's outputs and scratch against the staged plain version
     (``cf_backward_reference``), checks that two calls give the same bits,
     prints ptxas's registers and spills, and times each stage alone beside
     its bound and, for the base and products stages, ``torch.bmm``; K5b's
     time stands beside two bounds, the algorithm's and the staged route's
     (its scratch counted). Phase 2f times ``POCACritic.all_baselines`` forward and backward on one
     chunk of 1,024 groups on both critic paths (the tail kernels, and
     ``fused_attention``). Phase 2g holds K4 (``fused_env_step``) against
     its plain version in its four compiled forms (daisy, lily, dandelion,
     and daisy without observation tiles): integer and boolean tiles
     exactly, but for decision inputs within 16 ulps of their thresholds
     (the exemptions are counted), floats to the printed tolerance, two
     calls giving the same bits; and prints ptxas's registers and spills
     and how far a 200-step free run of each drifts from the plain one.
     Phase 2h holds the critic kernels' wide route (``tail_wide.cu``,
     ``cf_attention_wide.cu``: the shapes ``route`` sends past the tuned
     kernels' limits) at B = 1024, N = 20, H = 4, h = 1024 and at ragged
     shapes (for K3 also the edges of ``baseline_tail.wide_plan``: N = 100,
     h = 1000; for K5 those of ``cf_attention.cf_wide_plan``: one
     counterfactual a block at h = 2048, the rows in device memory at
     h = 3000, dout / N there too at h = 30000, N = 130, whose products
     read E_aa and E_sa from device memory, and N = 900, whose products
     read every row from there), through ``ops.fused_tail``,
     ``ops.fused_cf_attention`` and their autograd: each forward and
     cotangent against its plain version, each stage's scratch against the
     staged plain version, two calls bit
     for bit, ptxas's registers and spills, and at h = 1024 each direction
     timed beside its bound (K3's products run in 3xTF32 on the tensor
     cores: beside the float32 bound, its route's; K5's beside the
     algorithm's bound and the staged route's byte bound; K3f-wide and
     K5f-wide also at the rollout's B = 16). Phase 2i holds the env kernels' wide route
     (``pairwise_wide.cu``, ``fused_step_wide.cu``: the robot counts past
     the tuned kernels' 32 that ``ops.pairwise.route`` sends there) through
     ``ops`` at (E, N) = (1, 33), (37, 40), (1024, 64), (3, 65), (5, 100),
     K1 and K2 also at (32768, 64) and (2, 4100), K4 past its
     shared-memory staging at (3, 300): each against its plain version (K1's RAB sums to
     the scale of their terms; K4's observations but where a neighbour lies
     within the two sets of poses' gap of a sensor's switch, each switch
     found printed with its pair), two calls bit for
     bit, the wide counter moved and the tuned one not, ptxas's registers
     and spills, each timed at (1024, 64) beside its plain version and its
     bound (K2 also on packed inputs, its mark loops' worst case) and at
     (32768, 64) beside its bound (K4 there held to the plain step too);
     K2 with a NaN and infinite coordinates, and refusing positions that
     are not 8-byte aligned; then 20 daisy ``step_lanes``
     steps at E = 1024, N = 40, each one K4-wide launch;
  3. the slice: ``configs/DirGate_dandelion.yaml`` through the port's
     loader, cut to E = 1024 arenas and a 200-decision horizon, drives
     ``DirectionalGateEnv.reset`` and ``POCATrainer.rollout`` (env step,
     actor, critic value, all N counterfactual baselines, bootstrap value)
     on the card, then one whole training iteration
     (``POCATrainer.train_iteration``: a rollout, λ-returns, and 3 epochs
     of minibatch POCA updates with Adam, at the YAML's minibatch and
     chunk sizes). Phase 3d drives the same rollout and iteration with
     ``fused_attention=True`` (``--fused_attention on``). Phase 3e takes
     ``configs/DirGate_daisy.yaml`` with the same cut: a rollout on the
     composed env step (K1, K2, K3f), then one whole training iteration
     with ``fused_env_step=True`` (K4 once per env step, K2 never, K1 only
     for the reset's observations), then the env arena-steps/s of both env
     paths at E = 1024 and at bench.py's E = 32768. Phase 3g takes
     ``configs/DirGate_cyclamen.yaml`` with the same cut: one whole
     training iteration of the LSTM actor (BPTT over the YAML's 64-decision
     windows, grouped by length: 64, 64, 64 and 8), its wall time split
     between the rollout and the update, and its peak memory. Every
     kernel's launch count must show that each path went through it, and
     each iteration's agent-decisions/s is printed. A small full-width
     rollout and update (E = 4, T = 4) is then held against the same
     rollout and update on the CPU, where every op takes its plain
     version: dandelion on both critic paths and daisy on both env paths
     at h = 512, tulip at h = 128, cyclamen on both env paths at
     h = 128 with windows of 3 decisions (two window groups), and
     dandelion at h = 1024 on both critic paths (the wide route). Phase 3f
     drives the command lines through their ``main(argv)`` in a temporary
     directory: ``scripts/train_torch.py --hidden_dim 1024 --num_envs 16``
     trains one iteration at T = 1000 on each critic path (default and
     ``--fused_attention on``) through the critic kernels' wide route (its
     counters > 0, the tuned K3 and K5 counters 0), its wall time printed;
     ``--config configs/DirGate_dandelion.yaml --num_envs
     64`` trains one iteration at the YAML's T = 1000 (K1, K2, K3f and K3b
     counted), saves ``poca_1280000`` and ``poca_final`` and writes its
     summaries; ``--checkpoint latest`` resumes with the saved actor,
     critic and Adam state bit for bit and trains one more iteration;
     ``scripts/play_torch.py`` plays the final checkpoint (64 episodes of
     99 steps, K1 and K2 counted); the checkpoint restores on the CPU bit
     for bit; and the iteration's wall time, the save and restore times
     and play's arena-steps/s are printed. Phase 3h trains one dandelion
     iteration at the smoke cut with ``mixed_precision=True`` at the stages
     ``--mp_stages auto`` gives dandelion ("qkvo": bf16 operands for the
     critic's q, k, v and output projections), on both critic paths, with
     the float32 launch counts, its time beside phases 3c and 3d; then the
     small reference above on both critic paths in bf16, at the YAML's
     width and at ``--hidden_dim 1024`` (the wide K3 and K5), each
     projection's product within float32 accumulation's bound of the exact
     sum and its bias added in bf16 on both devices, the projections
     bit-equal between the devices in at least 99.9 % of their elements at
     the YAML's width, the critic's outputs, losses and gradients within
     one bf16 step, and
     each of its six Adam steps' losses against the CPU's at the card's own
     parameters and against the CPU run's own step (``MP_SAME_TOL``,
     ``MP_RUN_TOL``).
     Phase 3i runs ``train_torch.py --seeds 0-3 --num_envs 16`` (T = 1000:
     four lanes of one iteration each, each lane's launches counted), checks
     the four ``_seed<s>`` checkpoint and log directories, holds lane 0
     against a serial run of seed 0 at the lane's chunk cap, plays lane 2's
     ``poca_final`` with ``play_torch.py``, and quarantines a lane poisoned
     with NaN parameters (E = 4, T = 8) while the other trains on. Phase
     3j trains data-parallel: ``train_torch.py --distributed`` under
     ``torchrun`` (NCCL at world = 1, phase 3f's cut) must save the plain
     command's ``poca_final`` bit for bit; then two gloo ranks that share
     the card (``parallel.make_mesh(backend="gloo")``), 512 arenas each,
     train one iteration at the smoke cut with each rank's launches
     counted, end with bit-identical parameters, make the all-reduces
     ``scripts/comm_account_torch.py`` counts (their time printed), and
     roll out 20 decisions equal to one process of 1,024 arenas. Phase 3k
     runs ``scripts/measure_drift_torch.py``'s six cases: dandelion, daisy
     and lily, 1200 steps of E = 4 on the composed env step (K1, K2) and
     the fused one (K4), the card against the CPU (whose runs go to six
     spawned processes), each held to the JAX package's drift criteria.
     Phase 3l drives ``scripts/manual_control_torch.py``'s core for 100
     frames at ``--sim-hz 60`` (6 sub-steps) at N = 20 (the tuned K1 and
     K2) and N = 40 (their wide route) on the card, each frame also on the
     CPU from the card's state (positions, headings, K+, K-, the machines
     and the HUD's sensor values held), counts K1 100 and K2 600 launches, prints
     the median frame time, and runs the script headless where pygame
     imports. Phase 3m runs ``scripts/sps_sweep_torch.py``'s measurement,
     dandelion at E = 16 and 256, T = 200, one timed iteration: each line's
     decisions/s and phase split, and its K1, K2, K3f and K3b launches;
  4. a JSON line with every kernel's numbers, then the final status line.

It exits non-zero, and prints no result, where there is no CUDA device or
where the port's package is not beside this script.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# float32 on the CUDA cores, TF32 on the tensor cores, and device-memory
# bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12            # dense, on the tensor cores
PEAK_BYTES_PER_S = 3.35e12

E_MAIN, N_MAIN = 1024, 20           # arenas × robots on the main path
E_BENCH = 32768                     # bench.py's arenas: K1, K4 and the env rate
H_MAIN, HID_MAIN = 4, 512           # critic heads × hidden width
HORIZON = 200                       # decisions in the smoke rollout
RUNS, WARMUP = 25, 3                # timed runs per function
SEED = 0
DEVICE = "cuda"

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        failures.append(what)


# ── timing ───────────────────────────────────────────────────────────────

def _sleep_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond of device time."""
    cycles = 10_000_000
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return cycles / a.elapsed_time(b)


def device_ms(torch, fn, cycles_per_ms: float) -> float:
    """Median device time of one call of ``fn``, in ms, over RUNS calls.

    A sleep kernel keeps the device busy while the host enqueues the calls,
    each between two CUDA events, so the intervals hold device time only
    and no host gaps between launches.
    """
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(RUNS + 1)]
    torch.cuda._sleep(int((2.0 * RUNS * host_s * 1e3 + 5.0) * cycles_per_ms))
    events[0].record()
    for i in range(RUNS):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(RUNS))


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over memory bandwidth or
    operations over the float32 peak, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, atol: float, rtol: float) -> tuple[float, bool]:
    """max |got − want| and whether every element is within atol + rtol·|want|."""
    diff = (got.double() - want.double()).abs()
    ok = bool((diff <= atol + rtol * want.double().abs()).all())
    return float(diff.max()), ok


# ── phase 1: the card and the build ──────────────────────────────────────

def phase_card(torch, ops):
    print("== phase 1: the card and the kernel build", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (phase 3h) sum in float32 and round once, as
    # scripts/train_torch.py sets it under --mixed_precision
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"  torch {torch.__version__} (CUDA {torch.version.cuda}) on "
          f"{torch.cuda.get_device_name(0)}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}",
          flush=True)
    t0 = time.perf_counter()
    per_source = ops.build()
    print(f"  kernel build: {time.perf_counter() - t0:.2f} s wall "
          f"({', '.join(f'{k}.cu {v:.2f} s' for k, v in per_source.items())})",
          flush=True)
    from swarmacb_torch.ops import _cuda

    for name in _cuda.SOURCES:
        for line in _cuda.build_log(name).splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    return card


# ── phase 2: each kernel against its plain version ───────────────────────

def _arena_poses(rng, cfg, E, N):
    """Robots spread uniformly over the arena's disc, as the env spawns them."""
    safe_r = cfg.inradius - 2 * cfg.robot_radius
    r = np.sqrt(rng.uniform(0, 1, (E, N))) * safe_r
    th = rng.uniform(0, 2 * np.pi, (E, N))
    pos = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (E, N)).astype(np.float32)
    return pos, yaw


def _packed_poses(rng, cfg, E, N):
    """Each arena's robots within a disc of radius 2r about a point of the
    arena, so that most pairs (~59 %) overlap and K2 takes its full path."""
    reach = 2 * cfg.robot_radius
    c_r = np.sqrt(rng.uniform(0, 1, (E, 1))) * (cfg.inradius - 2 * reach)
    c_th = rng.uniform(0, 2 * np.pi, (E, 1))
    r = np.sqrt(rng.uniform(0, 1, (E, N))) * reach
    th = rng.uniform(0, 2 * np.pi, (E, N))
    pos = np.stack([c_r * np.cos(c_th) + r * np.cos(th),
                    c_r * np.sin(c_th) + r * np.sin(th)], -1)
    return pos.astype(np.float32)


def _pair_d2(xi, yi, xj, yj):
    """K2's squared distance of a pair, in float32 as the kernel rounds it."""
    dx, dy = xi - xj, yi - yj
    return (dx * dx + dy * dy) + np.float32(1e-8)


def _tie_poses(rng, cfg, E, N):
    """Robots 2k and 2k + 1 of each arena a pair whose squared distance
    (``_pair_d2``) lies within ±8 float32 steps of K2's skip threshold,
    above it and below, the pairs on a grid of pitch 0.12 about the arena's
    centre (|x|, |y| < 0.25, where a float32 step of a coordinate moves the
    squared distance by a few steps); an odd last robot stands alone at
    (0, 0.6). Returns the positions and, per pair, its distance in steps."""
    from swarmacb_torch.ops.pairwise import collision_skip_d2

    f32 = np.float32
    T = f32(collision_skip_d2(cfg.robot_radius))
    P = N // 2
    pos = np.zeros((E, N, 2), f32)
    pos[:, 2 * P:] = (0.0, 0.6)
    if P == 0:
        return pos, np.zeros((E, 0), np.int64)
    side = int(np.ceil(np.sqrt(P)))
    k = np.arange(P)
    centre = (np.stack([k % side, k // side], -1) - (side - 1) / 2) * 0.12
    centre = centre[None] + rng.uniform(-0.01, 0.01, (E, P, 2))
    th = rng.uniform(0, 2 * np.pi, (E, P))
    want = rng.integers(-6, 7, (E, P))
    target = (int(T.view(np.int32)) + want).astype(np.int32).view(f32)
    half = np.sqrt(target.astype(np.float64) - float(f32(1e-8))) / 2
    u = np.stack([np.cos(th), np.sin(th)], -1)
    pi = (centre - half[..., None] * u).astype(f32)
    pj = (centre + half[..., None] * u).astype(f32)
    # move robot 2k + 1 by up to three float32 steps in x and y, onto the
    # squared distance nearest the pair's target
    steps = np.arange(-3, 4, dtype=np.float64)
    cx = (pj[..., 0, None, None] + steps[:, None] * np.spacing(pj[..., 0])[..., None, None]
          ).astype(f32)
    cy = (pj[..., 1, None, None] + steps[None, :] * np.spacing(pj[..., 1])[..., None, None]
          ).astype(f32)
    cx, cy = np.broadcast_arrays(cx, cy)
    q = _pair_d2(pi[..., 0, None, None], pi[..., 1, None, None], cx, cy)
    miss = np.abs(q.view(np.int32).astype(np.int64) - target.view(np.int32)[..., None, None])
    best = miss.reshape(E, P, -1).argmin(-1)
    pj = np.stack([np.take_along_axis(c.reshape(E, P, -1), best[..., None], -1)[..., 0]
                   for c in (cx, cy)], -1)
    pos[:, 0:2 * P:2], pos[:, 1:2 * P:2] = pi, pj
    q = _pair_d2(pi[..., 0], pi[..., 1], pj[..., 0], pj[..., 1])
    return pos, q.view(np.int32).astype(np.int64) - int(T.view(np.int32))


def _segments_in_reach(px, py, seg, prox_range):
    """How many (robot, wall segment) pairs the wide kernels' wall test
    keeps, robots at ``px``, ``py`` (numpy, any shape), segments ``seg``
    (S, 4) as (ax, ay, sx, sy): those where not |num| > fl(fl(1.001·|s|)
    ·t_reach), num the numerator of t, t_reach = prox_range·(1 + 2⁻²⁰), in
    float32 as the kernels take them. Every other pair has a hit distance
    past the range for every ray."""
    f32 = np.float32
    seg = np.asarray(seg, f32)
    ax, ay, sx, sy = (seg[:, k] for k in range(4))
    t_reach = f32(prox_range) * f32(1.0 + 2.0 ** -20)
    s_wall = (np.sqrt(sx * sx + sy * sy) * f32(1.001)) * t_reach
    px, py = (np.asarray(a, f32).reshape(-1, 1) for a in (px, py))
    n = 0
    for r0 in range(0, px.shape[0], 1 << 16):
        x, y = px[r0:r0 + (1 << 16)], py[r0:r0 + (1 << 16)]
        num = (ax - x) * sy - (ay - y) * sx
        n += int((~(np.abs(num) > s_wall)).sum())
    return n


def _sensor_work(pos, yaw, cfg, walls):
    """Bytes and float32 operations of one pairwise_sensors call on these
    inputs, the least the function needs, with what depends on the data
    counted on this data. Per ordered pair: the offsets and the squared
    distance (5); per pair inside the proximity reach, its distance, the
    clipped reading and the 8-ray cone test (46); per pair inside the RAB
    range, its distance, the bearing and the four sums (24). Walls,
    ``walls`` (S, 4) as numpy: per robot and segment, the offset to its
    start and the numerator of t with its magnitude, which no ray changes,
    and the test whether any ray can reach the segment (7,
    ``_segments_in_reach``); per ray and segment that passes it, the
    denominator, its test and ε, and the range test |num| ≤ |den|·reach
    that spares the divisions of a ray that cannot hit (9); per candidate
    passing that, t and its two bounds (3); per t that passes, u's
    numerator, quotient and bounds (6); per hit, the reading (3). Per
    robot, the sensor directions and the outputs (65). Transcendentals and
    divisions count one operation each."""
    from swarmacb_torch.env.geometry import EPUCK_SENSOR_ANGLES

    E, N = yaw.shape
    off = ~np.eye(N, dtype=bool)[None]
    n_prox = n_rab = 0
    for e0 in range(0, E, 1024):
        p = pos[e0:e0 + 1024]
        d = np.sqrt(((p[:, None] - p[:, :, None]) ** 2).sum(-1))
        n_prox += int(((d < cfg.prox_range + cfg.robot_radius) & off).sum())
        n_rab += int(((d < cfg.rab_range) & off).sum())
    # the wall candidates, in float32 as the kernel takes them
    f32 = np.float32
    ang = EPUCK_SENSOR_ANGLES.astype(np.float64)
    cos_a, sin_a = np.cos(ang).astype(f32)[:, None], np.sin(ang).astype(f32)[:, None]
    ax, ay = walls[:, 0], walls[:, 1]
    sx, sy = walls[:, 2] - walls[:, 0], walls[:, 3] - walls[:, 1]
    reach = f32(cfg.prox_range) * f32(1.0 + 2.0 ** -20)
    n_t = n_u = n_hit = 0
    for e0 in range(0, E, 1024):
        px, py = (pos[e0:e0 + 1024, :, None, None, k] for k in (0, 1))  # (e, N, 1, 1)
        th = yaw[e0:e0 + 1024, :, None, None]
        wdx = cos_a * np.cos(th) - sin_a * np.sin(th)                     # (e, N, 8, 1)
        wdy = cos_a * np.sin(th) + sin_a * np.cos(th)
        rx, ry = ax - px, ay - py                                         # (e, N, 1, S)
        num = rx * sy - ry * sx
        den = wdx * sy - wdy * sx                                         # (e, N, 8, S)
        cand = (np.abs(den) > f32(1e-8)) & (np.abs(num) <= np.abs(den + f32(1e-12)) * reach)
        den = np.where(cand, den + f32(1e-12), f32(1))
        t_ok = cand & (num / den >= 0) & (num / den <= f32(cfg.prox_range))
        u = (rx * wdy - ry * wdx) / den
        n_t += int(cand.sum())
        n_u += int(t_ok.sum())
        n_hit += int((t_ok & (u >= 0) & (u <= 1)).sum())
    n_seg = walls.shape[0]
    n_reach = _segments_in_reach(pos[..., 0], pos[..., 1],
                                 np.concatenate([walls[:, :2], walls[:, 2:] - walls[:, :2]], 1),
                                 cfg.prox_range)
    flops = (5 * E * N * (N - 1) + 46 * n_prox + 24 * n_rab + E * N * (7 * n_seg + 65)
             + 8 * 9 * n_reach + 3 * n_t + 6 * n_u + 3 * n_hit)
    n_bytes = 4 * (E * N * 3 + 24 + 4 * n_seg) + 4 * E * N * 15
    return n_bytes, flops


PAIRWISE_KERNELS = ("pairwise_sensors_kernel", "robot_collisions_kernel")
# (E, N) that leave K1's last block ragged, at 4, 4 and 2 arenas a block
K1_RAGGED = ((37, 7), (999, 31), (45, 10))
# and K2's, at 32, 32, 16 and 1 arenas a block (5 of 32 arenas, 7 of 32,
# 13 of 16 in the last block; one arena a block at N = 32)
K2_RAGGED = ((37, 7), (999, 31), (45, 10), (5, 32))


def _collision_inputs(cfg, E, N):
    """K2's three kinds of positions at (E, N), each from a seed of its own."""
    return {"spread": _arena_poses(np.random.default_rng(SEED), cfg, E, N)[0],
            "packed": _packed_poses(np.random.default_rng(SEED + 1), cfg, E, N),
            "tie": _tie_poses(np.random.default_rng(SEED + 2), cfg, E, N)[0]}


def drive_dandelion(torch, E, steps, policy, seed, on_k2_input, device=DEVICE):
    """Drive ``steps`` composed dandelion env steps at E arenas from the
    env's spawn and hand each step's K2 input, the (E, N, 2) positions
    after integration and the wall push-outs, to ``on_k2_input(step,
    pos)``. ``policy``: ``"random"``, wheel commands N(0, 1) each step, as
    an untrained Gaussian actor (mean ~0, log-std 0) draws them, clamped
    by the env; ``"gate"``, every robot turns towards the middle of the
    gate and drives for it, the densest crowd the mission draws. Returns
    the last state."""
    from swarmacb_torch import ops
    from swarmacb_torch.config import DirectionalGateEnvCfg
    from swarmacb_torch.env import DirectionalGateEnv

    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="dandelion", num_envs=E),
                             device=device)
    cfg = env.cfg
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state, _ = env.reset(gen)
    gate_y = 0.5 * (cfg.gate_south_y + cfg.corridor_south_y)
    k2, step = ops.resolve_robot_collisions, 0

    def record(pos, robot_radius):
        on_k2_input(step, pos)
        return k2(pos, robot_radius)

    ops.resolve_robot_collisions = record
    try:
        for step in range(steps):
            if policy == "random":
                act = torch.randn((E, cfg.num_agents, 2), generator=gen, device=device)
            else:
                x, y = state.pos[..., 0], state.pos[..., 1]
                err = torch.atan2(gate_y - y, -x) - state.yaw
                turn = 2.0 * torch.atan2(torch.sin(err), torch.cos(err))
                act = torch.stack([1.0 - turn, 1.0 + turn], -1)
            state, _ = env.step(state, act)
    finally:
        ops.resolve_robot_collisions = k2
    return state


def near_pair_counts(torch, pos, skip_d2):
    """What K2 does on these positions (E, N, 2): the share of ordered
    pairs (i, j), i != j, whose squared distance fails the skip test (K2
    evaluates them in full), and per warp of 32 robots in the kernel's
    order, the most such pairs of one lane (the mask form's second loop)
    and the count of j at which any lane has one (the full-path
    iterations of one loop with the test inside), each as (mean, max)
    over the warps."""
    E, N = pos.shape[:2]
    d = pos[:, :, None, :] - pos[:, None, :, :]
    q = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + 1e-8
    near = ~((q >= skip_d2) & (q <= float(np.finfo(np.float32).max)))
    near &= ~torch.eye(N, dtype=torch.bool, device=pos.device)
    # a block holds lcm(N, 32) robots from a multiple of it, so the warps
    # are the runs of 32 in the flat robot order
    rows = near.reshape(E * N, N)
    pad = -(E * N) % 32
    rows = torch.cat([rows, rows.new_zeros((pad, N))]).reshape(-1, 32, N)
    lane_max = rows.sum(-1).amax(1).double()
    union = rows.any(1).sum(-1).double()
    return dict(share=float(near.sum()) / (E * N * max(N - 1, 1)),
                lane_max=(float(lane_max.mean()), int(lane_max.max())),
                union=(float(union.mean()), int(union.max())))


def _collision_work(pos, robot_radius):
    """Bytes and float32 operations of one resolve_robot_collisions call on
    these positions, the least the function needs: each position read and
    written once; per unordered pair, the offset, the squared distance and
    its test against the skip threshold (7); per pair below the threshold,
    the distance, overlap, normal and the half push taken into both robots'
    sums (14); per robot, the two sums taken into the output (4)."""
    from swarmacb_torch.ops.pairwise import collision_skip_d2

    E, N = pos.shape[:2]
    iu, ju = np.triu_indices(N, 1)
    T, f32_max = np.float32(collision_skip_d2(robot_radius)), np.finfo(np.float32).max
    n_near = 0
    for e0 in range(0, E, 4096):
        p = pos[e0:e0 + 4096]
        q = _pair_d2(p[:, iu, 0], p[:, iu, 1], p[:, ju, 0], p[:, ju, 1])
        n_near += int((~((q >= T) & (q <= f32_max))).sum())
    return 2 * 4 * E * N * 2, 7 * E * len(iu) + 14 * n_near + 4 * E * N


def _bench_keys(at_bench: dict) -> dict:
    """A kernel's time and bound at E_BENCH, for its JSON row."""
    return {f"e{E_BENCH}_ms": at_bench["ms"], f"e{E_BENCH}_bound_ms": at_bench["bound_ms"]}


def phase_pairwise(torch, ops, cfg, walls, cycles_per_ms):
    print("== phase 2a: K1 pairwise_sensors and K2 resolve_robot_collisions "
          f"(E={E_MAIN} and E={E_BENCH}; N={N_MAIN}; K1 also at (E, N) in {K1_RAGGED}, "
          f"K2 at {K2_RAGGED})", flush=True)
    from swarmacb_torch.ops import _cuda, pairwise

    for name, info in ptxas_report(_cuda.build_log("pairwise"), PAIRWISE_KERNELS).items():
        print(f"  ptxas {name}: {info}", flush=True)
    floor = device_ms(torch, lambda: torch.cuda._sleep(0), cycles_per_ms)
    print(f"  launch floor: an empty kernel (torch.cuda._sleep(0)) {floor:.4f} ms",
          flush=True)
    kw = dict(prox_range=cfg.prox_range, robot_radius=cfg.robot_radius,
              rab_range=cfg.rab_range, alpha_rab=cfg.alpha_parameter,
              wall_segments=walls)
    # K1. prox and ztilde: same formulas, comparisons and max-reductions
    # (exact up to libm ulps); the RAB sums over up to N − 1 neighbours of
    # terms up to 1/(2r) ≈ 14 run in another order than PyTorch's sums.
    tol = {"prox": (1e-6, 0.0), "ztilde": (1e-6, 0.0), "rab_proj": (1e-5, 1e-5),
           "attr_x": (1e-5, 1e-5), "attr_y": (1e-5, 1e-5)}
    k1 = {}
    for E, N in ((E_MAIN, N_MAIN), (E_BENCH, N_MAIN), *K1_RAGGED):
        rng = np.random.default_rng(SEED)
        pos_np, yaw_np = _arena_poses(rng, cfg, E, N)
        pos = torch.from_numpy(pos_np).to(DEVICE)
        yaw = torch.from_numpy(yaw_np).to(DEVICE)
        call = lambda: ops.pairwise_sensors(pos, yaw, **kw)  # noqa: E731
        got, again = call(), call()
        want = pairwise.pairwise_sensors_plain(pos, yaw, **kw)
        torch.cuda.synchronize()
        worst = 0.0
        for (name, (atol, rtol)), g, w in zip(tol.items(), got, want):
            err, ok = max_err(g, w, atol, rtol)
            worst = max(worst, err)
            check(ok and tuple(g.shape) == tuple(w.shape),
                  f"K1 E={E} N={N} {name} {tuple(g.shape)}: max|Δ| {err:.3e} "
                  f"(tolerance {atol:g} + {rtol:g}·|plain|)")
        check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
              f"K1 E={E} N={N}: two calls give the same bits")
        check(float(got[0].max()) > 0 and float(got[2].abs().max()) > 0,
              f"K1 E={E} N={N}: inputs reach walls and neighbours (non-trivial readings)")
        del got, again, want
        k1[(E, N)] = dict(max_abs_err=worst)
        if N != N_MAIN:   # a ragged shape: held, not timed
            continue
        b_ms, b_by = bound_ms(*_sensor_work(pos_np, yaw_np, cfg, walls.cpu().numpy()))
        ms = device_ms(torch, call, cycles_per_ms)
        k1[(E, N)].update(ms=ms, bound_ms=b_ms, bound_by=b_by)
        if E != E_MAIN:   # the plain version is not timed at 32 times the size
            print(f"  K1 E={E} kernel {ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})",
                  flush=True)
            continue
        # the constants built in every call, as before they were cached
        per_call = device_ms(torch, lambda: (pairwise.sensor_constants(walls), call()),
                             cycles_per_ms)
        plain = device_ms(torch, lambda: pairwise.pairwise_sensors_plain(pos, yaw, **kw),
                          cycles_per_ms)
        k1[(E, N)]["plain_ms"] = plain
        print(f"  K1 E={E} kernel {ms:.4f} ms (with the constants built in the call "
              f"{per_call:.4f} ms), plain {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by})",
              flush=True)
    rows = [dict(name="pairwise_sensors", route="cuda",
                 source="swarmacb_torch/ops/csrc/pairwise.cu",
                 replaces="swarmacb_tpu/ops/pairwise.py:145", library_ms=None,
                 **{**k1[(E_MAIN, N_MAIN)],
                    "max_abs_err": max(v["max_abs_err"] for v in k1.values())},
                 **_bench_keys(k1[(E_BENCH, N_MAIN)]))]
    return rows + [_phase_collisions(torch, ops, cfg, cycles_per_ms)]


def _phase_collisions(torch, ops, cfg, cycles_per_ms):
    """K2 against its plain version on spread, packed and tie inputs at the
    main path's and bench.py's E and at ragged shapes, and on the positions
    it receives at the end of a dandelion rollout of HORIZON steps with an
    untrained actor's wheel commands at both E; two calls giving the same
    bits; a NaN and infinite coordinates give NaN where the plain version
    does; a position that is not 8-byte aligned is refused. Timed at E_MAIN
    (beside the plain version) and E_BENCH, each beside its bound on these
    inputs; the JSON row takes the rollout's times."""
    from swarmacb_torch.env import physics
    from swarmacb_torch.ops import pairwise

    r = cfg.robot_radius
    call = lambda p: ops.resolve_robot_collisions(p, r)  # noqa: E731
    worst, k2 = 0.0, {}

    def hold_and_time(E, N, kind, p, timed):
        nonlocal worst
        got, again = call(p), call(p)
        want = physics.resolve_robot_collisions(p, r)
        torch.cuda.synchronize()
        # sums of up to N − 1 pushes of ≤ r each, in another order than the
        # plain version's reductions
        err, ok = max_err(got, want, 1e-6, 0.0)
        worst = max(worst, err)
        moved = float((got - p).abs().max())
        check(ok and bool(torch.equal(got, again)) and moved > 1e-4,
              f"K2 E={E} N={N} {kind}: max|Δ| {err:.3e} (tolerance 1e-06), two "
              f"calls bit-identical, largest push {moved:.3e}")
        if not timed:
            return
        b_ms, b_by = bound_ms(*_collision_work(p.cpu().numpy(), r))
        ms = device_ms(torch, lambda: call(p), cycles_per_ms)
        k2[(E, kind)] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
        plain = ""
        if E == E_MAIN:   # the plain version is not timed at 32 times the size
            k2[(E, kind)]["plain_ms"] = device_ms(
                torch, lambda: physics.resolve_robot_collisions(p, r), cycles_per_ms)
            plain = f", plain {k2[(E, kind)]['plain_ms']:.4f} ms"
        print(f"  K2 E={E} {kind}: kernel {ms:.4f} ms{plain}, bound {b_ms:.6f} ms "
              f"({b_by})", flush=True)

    for E, N in ((E_MAIN, N_MAIN), (E_BENCH, N_MAIN), *K2_RAGGED):
        for kind, p_np in _collision_inputs(cfg, E, N).items():
            hold_and_time(E, N, kind, torch.from_numpy(p_np).to(DEVICE),
                          N == N_MAIN and kind != "tie")
    for E in (E_MAIN, E_BENCH):
        last = {}
        drive_dandelion(torch, E, HORIZON, "random", SEED + 5,
                        lambda step, pos: last.update(pos=pos))
        near = near_pair_counts(torch, last["pos"], pairwise.collision_skip_d2(r))
        print(f"  K2 E={E} rollout (step {HORIZON}): {near['share']:.4%} of pairs "
              f"evaluated, per warp the most of one lane {near['lane_max']}, "
              f"j with any {near['union']} (mean, max)", flush=True)
        hold_and_time(E, N_MAIN, "rollout", last.pop("pos"), True)
    # a robot off the finite plane: NaN where the plain version has NaN
    p_np = _collision_inputs(cfg, E_MAIN, N_MAIN)["tie"]
    p_np[1, 0, 0], p_np[3, 2, 1], p_np[2, N_MAIN - 1, 0] = np.nan, np.inf, -np.inf
    p = torch.from_numpy(p_np).to(DEVICE)
    got, want = call(p), physics.resolve_robot_collisions(p, r)
    same_nan = bool(torch.equal(got.isnan(), want.isnan()))
    fin = ~want.isnan()
    err, ok = max_err(got[fin], want[fin], 1e-6, 0.0)
    check(same_nan and ok, f"K2 with a NaN and two infinite coordinates: NaN in the same "
          f"{int(want.isnan().sum())} places as the plain version, elsewhere max|Δ| "
          f"{err:.3e}")
    # the kernel loads a robot as one float2
    odd = torch.empty(2 * E_MAIN * N_MAIN + 1, device=DEVICE)[1:].view(E_MAIN, N_MAIN, 2)
    try:
        call(odd)
        refused = False
    except ValueError:
        refused = True
    check(refused, "K2 refuses positions that are not 8-byte aligned")
    return dict(name="resolve_robot_collisions", route="cuda",
                source="swarmacb_torch/ops/csrc/pairwise.cu",
                replaces="swarmacb_tpu/ops/pairwise.py:246", library_ms=None,
                max_abs_err=max(worst, err), **k2[(E_MAIN, "rollout")],
                **_bench_keys(k2[(E_BENCH, "rollout")]))


def _tail_inputs(torch, B, N, H, h, seed):
    """Tail inputs at the critic's scale: attention rows that sum to one per
    head, W_out-folded values and layer-normalised residual entities."""
    rng = np.random.default_rng(seed)
    HM = H * N
    attn = rng.uniform(size=(B, N, H, N, N)).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)                        # (B,I,H,n,m)
    lhs = attn.transpose(0, 1, 3, 2, 4).reshape(B, N * N, HM)
    attn_mI = np.einsum("bIhnI->bhIn", attn)                   # m = I
    arrays = dict(
        attn_lhs=lhs, attn_mI=attn_mI,
        wa=rng.normal(size=(B, HM, h)) * 0.3,
        dws=rng.normal(size=(B, H, N, h)) * 0.2,
        x_a=rng.normal(size=(B, N, h)),
        delta=rng.normal(size=(B, N, h)) * 0.5,
        bias=rng.normal(size=(h,)) * 0.1)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(DEVICE)
            for a in arrays.values()]


def _tail_forward_work(B, N, H, h):
    """Bytes and operations of one K3f call. Bytes: the seven inputs read
    once and pooled written once. Operations per fc element: the HM-term
    product (2·HM), taken three times on the tensor cores in TF32 (3×TF32),
    and on the CUDA cores in float32 the rank-1 term over heads (2·H), bias,
    x_a and the diagonal delta (3), LayerNorm (6) and the pool (1).
    Returns (bytes, product operations, other operations)."""
    HM = H * N
    n_in = B * N * N * HM + B * H * N * N + B * HM * h + B * H * N * h + 2 * B * N * h + h
    fc = B * N * N * h
    return 4 * (n_in + B * N * h), fc * 2 * HM, fc * (2 * H + 3 + 6 + 1)


def tail_forward_bounds(B, N, H, h) -> dict:
    """K3f's least time on the card by its route, the larger of the bytes
    over the memory rate, the three TF32 products over the TF32 tensor-core
    rate, and the rest over the float32 rate; and, beside it, the bound of
    a float32 CUDA-core route (every operation at 67 TFLOP/s)."""
    n_bytes, n_product, n_rest = _tail_forward_work(B, N, H, h)
    times = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
             "operations": max(3 * n_product / PEAK_TF32_FLOPS,
                               n_rest / PEAK_F32_FLOPS) * 1e3}
    by = max(times, key=times.get)
    f32_ms, f32_by = bound_ms(n_bytes, n_product + n_rest)
    return dict(bound_ms=times[by], bound_by=by, f32_bound_ms=f32_ms, f32_bound_by=f32_by,
                bytes=n_bytes, product_flops=n_product, rest_flops=n_rest)


# K3f's shapes in phase 2b: (B, N, H, h) of the main path, tulip's and
# cyclamen's width, and a small ragged one (5 rows a counterfactual, 20 a
# block, h not a multiple of the 512 the main path fills)
TAIL_FORWARD_SHAPES = ((E_MAIN, N_MAIN, H_MAIN, HID_MAIN), (E_MAIN, N_MAIN, H_MAIN, 128),
                       (6, 5, H_MAIN, 32))


def phase_tail(torch, ops, cycles_per_ms):
    """K3f against ``tail_reference`` at TAIL_FORWARD_SHAPES, two calls
    bit-identical, and at the main shape its time beside both bounds."""
    print("== phase 2b: K3f fused_tail forward (tail_forward.cu, 3xTF32 on the "
          "tensor cores)", flush=True)
    from swarmacb_torch.ops import _cuda, baseline_tail

    for line in _cuda.build_log("tail_forward").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  K3f ptxas: {line.split('info    :')[-1].strip()}", flush=True)
    row = None
    for B, N, H, h in TAIL_FORWARD_SHAPES:
        args = _tail_inputs(torch, B, N, H, h, SEED + 1)
        with torch.no_grad():
            got = ops.fused_tail(*args, N)
            again = ops.fused_tail(*args, N)
            want = baseline_tail.tail_reference(*args, N)
            want3 = baseline_tail.tail_reference_3xtf32(*args, N)
        torch.cuda.synchronize()
        # LayerNorm outputs are O(1); each fc element is an 80-term product
        # in 3xTF32 (float32-level error), summed in another order than
        # cuBLAS's float32 (no TF32) product.
        err, ok = max_err(got, want, 1e-5, 1e-5)
        err3 = float((got.double() - want3.double()).abs().max())
        check(ok and tuple(got.shape) == (B, N, h),
              f"K3f pooled {tuple(got.shape)} (B={B}, N={N}, H={H}, h={h}): max|Δ| "
              f"{err:.3e} (tolerance 1e-05 + 1e-05·|plain|); against the plain "
              f"3xTF32 arithmetic {err3:.3e}")
        check(torch.equal(got, again), f"K3f (h={h}, N={N}): two calls give the same bits")
        if row is not None:
            continue
        with torch.no_grad():
            ms = device_ms(torch, lambda: ops.fused_tail(*args, N), cycles_per_ms)
            plain = device_ms(torch, lambda: baseline_tail.tail_reference(*args, N),
                              cycles_per_ms)
        bd = tail_forward_bounds(B, N, H, h)
        print(f"  K3f kernel {ms:.4f} ms, plain {plain:.4f} ms; bound by its route "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}: {bd['bytes'] / 1e6:.1f} MB, "
              f"3 x {bd['product_flops'] / 1e9:.2f} GFLOP in TF32, "
              f"{bd['rest_flops'] / 1e9:.2f} GFLOP in float32), "
              f"{100 * bd['bound_ms'] / ms:.1f} % of it; the float32 CUDA-core bound "
              f"{bd['f32_bound_ms']:.4f} ms ({bd['f32_bound_by']}), "
              f"{100 * bd['f32_bound_ms'] / ms:.1f} %", flush=True)
        row = dict(name="fused_tail", route="cuda",
                   source="swarmacb_torch/ops/csrc/tail_forward.cu",
                   replaces="swarmacb_tpu/ops/baseline_tail.py:201",
                   max_abs_err=err, ms=ms, plain_ms=plain,
                   bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                   f32_bound_ms=bd["f32_bound_ms"], library_ms=None)
        del args, got, again, want, want3
    return [row]


def _tail_backward_work(B, N, H, h):
    """Bytes and float32 operations of one K3b call. Bytes: the seven
    inputs and dout read once, seven cotangents of the inputs' shapes
    written once. Operations per fc element: the fc recompute as in the
    forward without the pool (2·HM + 2·H + 3 + 6); the LayerNorm backward
    (y, d_y·y and its sum, rstd·((d_y − m1) − y·m2): 7); d_attn_lhs and d_wa
    (2·HM each); d_attn_mI and d_dws (2·H each); the sums into d_xa and
    d_bias (2)."""
    HM = H * N
    n_in = B * N * N * HM + B * H * N * N + B * HM * h + B * H * N * h + 2 * B * N * h + h
    n_bytes = 4 * (2 * n_in + B * N * h)
    n_flops = B * N * N * h * ((2 * HM + 2 * H + 3 + 6) + 7 + 4 * HM + 4 * H + 2)
    return n_bytes, n_flops


def tail_backward_bounds(B, N, H, h) -> dict:
    """K3b's least time on the card by a route that takes its three
    products (the fc recompute, d_wa, d_attn_lhs: 2·HM operations per fc
    element each) in 3xTF32 on the tensor cores and the rest in float32:
    the larger of the bytes over the memory rate and the operations over
    their peaks; beside it the same with the (B, N², h) d_fc scratch
    written once and read three times (the wide route's stages), and the
    float32 CUDA-core bound."""
    n_bytes, n_flops = _tail_backward_work(B, N, H, h)
    n_product = B * N * N * h * 6 * H * N
    ops_ms = max(3 * n_product / PEAK_TF32_FLOPS, (n_flops - n_product) / PEAK_F32_FLOPS) * 1e3
    scratch = 4 * 4 * B * N * N * h
    times = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3, "operations": ops_ms}
    by = max(times, key=times.get)
    f32_ms, f32_by = bound_ms(n_bytes, n_flops)
    return dict(bound_ms=times[by], bound_by=by, f32_bound_ms=f32_ms, f32_bound_by=f32_by,
                scratch_bound_ms=max((n_bytes + scratch) / PEAK_BYTES_PER_S * 1e3, ops_ms),
                bytes=n_bytes, scratch_bytes=n_bytes + scratch, product_flops=n_product)


# K3b's three kernels, in launch order, and the stage that writes each cotangent
TAIL_STAGES = ("rows", "d_wa", "d_attn_lhs")
TAIL_STAGE_OF = {"attn_lhs": 3, "attn_mI": 1, "wa": 2, "dws": 1, "x_a": 2, "delta": 1,
                 "bias": 2}


def _tail_backward_stage_work(B, N, H, h):
    """Bytes and float32 operations of each K3b stage, with the d_fc scratch
    (B, N², h) as an output of stage 1 and an input of stages 2 and 3.
    rows: reads the seven inputs and dout, writes d_fc, d_attn_mI, d_dws and
    d_delta; per fc element the recompute (2·HM + 2·H + 9), the LayerNorm
    backward (7), d_attn_mI and d_dws (2·H each). d_wa: reads attn_lhs and
    d_fc, writes d_wa, d_xa and the (B, h) d_bias partial; per d_fc element
    2·HM and the sum into d_xa, per d_xa element the sum into d_bias.
    d_attn_lhs: reads d_fc and wa, writes d_attn_lhs; 2·HM per d_fc
    element."""
    HM, NN = H * N, N * N
    fc = B * NN * h
    rows_in = B * NN * HM + B * H * NN + B * HM * h + B * H * N * h + 3 * B * N * h + h
    rows_out = fc + B * H * NN + B * H * N * h + B * N * h
    return {"rows": (4 * (rows_in + rows_out), fc * (2 * HM + 2 * H + 9 + 7 + 4 * H)),
            "d_wa": (4 * (B * NN * HM + fc + B * HM * h + B * N * h + B * h),
                     fc * (2 * HM + 1) + B * N * h),
            "d_attn_lhs": (4 * (fc + B * HM * h + B * NN * HM), fc * 2 * HM)}


def time_tail_backward_stages(torch, args, dout, N, cycles_per_ms, wide=False):
    """Each K3b stage launched alone, at the shape of ``args``, on the tuned
    route or the wide one: its median device ms, its bound (the wide
    route's with each stage's product in 3xTF32 on the tensor cores, and
    beside it the float32 one), and for the two products the time of
    ``torch.bmm`` on the same operands (cuBLAS, float32 with TF32 off; the
    port never calls it). One whole backward fills the d_fc scratch first."""
    from swarmacb_torch.ops import baseline_tail

    B, _, HM = args[0].shape
    h = args[2].shape[-1]
    H = HM // N
    d_fc, _, stages = baseline_tail._stage_calls(args, dout, N, B, H, h, wide=wide)
    for launch in stages:
        launch()
    torch.cuda.synchronize()
    lhs_t, wa_t = args[0].transpose(1, 2), args[2].transpose(1, 2)
    library = {"d_wa": lambda: torch.bmm(lhs_t, d_fc),
               "d_attn_lhs": lambda: torch.bmm(d_fc, wa_t)}
    work = _tail_backward_stage_work(B, N, H, h)
    out = {}
    product = B * N * N * h * 2 * HM            # each stage's one product, 2·HM an fc element
    for name, launch in zip(TAIL_STAGES, stages):
        n_bytes, n_flops = work[name]
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        lib = library.get(name)
        out[name] = dict(ms=device_ms(torch, launch, cycles_per_ms),
                         library_ms=device_ms(torch, lib, cycles_per_ms) if lib else None,
                         bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, flops=n_flops)
        if wide:
            times = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
                     "operations": 1e3 * max(3 * product / PEAK_TF32_FLOPS,
                                             (n_flops - product) / PEAK_F32_FLOPS)}
            by = max(times, key=times.get)
            out[name].update(f32_bound_ms=b_ms, f32_bound_by=b_by, bound_ms=times[by],
                             bound_by=by)
    return out


def phase_tail_backward(torch, ops, card, cycles_per_ms):
    """K3b at the main path's width and at tulip's and cyclamen's h = 128;
    the JSON row is the main path's."""
    _tail_backward_at(torch, ops, card, cycles_per_ms, 128)
    return _tail_backward_at(torch, ops, card, cycles_per_ms, HID_MAIN)


def _tail_backward_at(torch, ops, card, cycles_per_ms, h):
    B, N, H = E_MAIN, N_MAIN, H_MAIN
    print(f"== phase 2c: K3b fused_tail backward (B={B}, N={N}, H={H}, h={h})",
          flush=True)
    from swarmacb_torch.ops import baseline_tail

    args = [a.requires_grad_() for a in _tail_inputs(torch, B, N, H, h, SEED + 1)]
    rng = np.random.default_rng(SEED + 3)
    dout = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).to(DEVICE)
    before = ops.launches["fused_tail_bwd"]
    got = torch.autograd.grad(ops.fused_tail(*args, N), args, dout)
    torch.cuda.synchronize()
    check(ops.launches["fused_tail_bwd"] == before + 1,
          "autograd through ops.fused_tail launched K3b once")
    plain_out = baseline_tail.tail_reference(*args, N)
    want = torch.autograd.grad(plain_out, args, dout, retain_graph=True)
    saved = [a.detach() for a in args]
    # stage 1's d_fc against the staged plain version: the same float32
    # LayerNorm backward on an fc recomputed in another order than cuBLAS's
    with torch.no_grad():
        want_fc = baseline_tail.tail_backward_reference(saved, dout, N)[0]
    got_fc, got_again, calls = baseline_tail._stage_calls(saved, dout, N, B, H, h)
    for launch in calls:
        launch()
    torch.cuda.synchronize()
    rel = 1e-5
    scale = float(want_fc.abs().max())
    err, ok = max_err(got_fc, want_fc, rel * scale, 0.0)
    check(ok and got_fc.shape == want_fc.shape,
          f"K3b stage 1 d_fc {tuple(got_fc.shape)}: max|Δ| {err:.3e} against the "
          f"staged plain version (tolerance {rel:g}·max|plain| = {rel * scale:.3e})")
    del want_fc, got_fc
    # Each cotangent is a float32 sum taken in another order than the plain
    # version's autograd (cuBLAS products without TF32, reductions over the
    # LayerNorm rows): d_attn_lhs and d_attn_mI over h columns, d_wa
    # over N² = 400 rows, d_dws over N, d_xa over N, d_bias over B·N² rows.
    # The tolerance is relative to each cotangent's largest element.
    names = ("attn_lhs", "attn_mI", "wa", "dws", "x_a", "delta", "bias")
    worst = 0.0
    for name, g, w in zip(names, got, want):
        scale = float(w.abs().max())
        err, ok = max_err(g, w, rel * scale, 0.0)
        worst = max(worst, err)
        check(ok and g.shape == w.shape,
              f"K3b d_{name} {tuple(g.shape)} (stage {TAIL_STAGE_OF[name]}): max|Δ| "
              f"{err:.3e} (tolerance {rel:g}·max|plain| = {rel * scale:.3e})")
    same = all(torch.equal(a, b) for a, b in zip(got, got_again))
    check(same, "K3b: two calls give bit-identical cotangents")
    del got_again
    ms = device_ms(torch, lambda: baseline_tail.backward_kernel(saved, dout, N),
                   cycles_per_ms)
    plain = device_ms(torch, lambda: torch.autograd.grad(
        plain_out, args, dout, retain_graph=True), cycles_per_ms)
    n_bytes, n_flops = _tail_backward_work(B, N, H, h)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    print(f"  K3b kernel at h={h} {ms:.4f} ms, plain backward {plain:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
          f"{n_flops / 1e9:.2f} GFLOP) on {card}; no single PyTorch call computes "
          "this function, so there is no library time", flush=True)
    stages = time_tail_backward_stages(torch, saved, dout, N, cycles_per_ms)
    for i, (name, st) in enumerate(stages.items(), 1):
        lib = ("" if st["library_ms"] is None
               else f", torch.bmm {st['library_ms']:.4f} ms")
        print(f"  K3b stage {i} ({name}) alone: {st['ms']:.4f} ms{lib}, bound "
              f"{st['bound_ms']:.4f} ms ({st['bound_by']}: {st['bytes'] / 1e6:.1f} MB, "
              f"{st['flops'] / 1e9:.2f} GFLOP) on {card}", flush=True)
    print("  K3b stages: " + json.dumps({"card": card, "shape": [B, N, H, h],
                                          "stages": stages}), flush=True)
    return [dict(name="fused_tail_bwd", route="cuda",
                 source="swarmacb_torch/ops/csrc/baseline_tail.cu",
                 replaces="swarmacb_tpu/ops/baseline_tail.py:224",
                 max_abs_err=worst, ms=ms, plain_ms=plain,
                 bound_ms=b_ms, bound_by=b_by, library_ms=None)]


def _cf_inputs(torch, B, N, H, h, seed, score_scale):
    """Raw scores at ``score_scale`` (3: trained-like, 12: saturated softmax
    rows), folded values, residual entities and bias, as the JAX package's
    kernel test draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s)  # noqa: E731
    arrays = [f(B, H, N, N) * score_scale, f(B, H, N, N) * score_scale,
              f(B, H, N, N) * score_scale, f(B, H, N, 1) * score_scale,
              f(B, H, N, h), f(B, H, N, h), f(B, N, h), f(B, N, h), f(h)]
    return [torch.from_numpy(a.astype(np.float32)).to(DEVICE) for a in arrays]


def _cf_forward_work(B, N, H, h):
    """Bytes and float32 operations of one K5f call as the algorithm needs
    them (each base product once per group and head). Bytes: the nine
    inputs read once, pooled written once. Operations per group and head:
    the scaled scores, row maxes, exponentials (one operation each),
    partitions and corrections (16·N² + 6·N); the base products E_aa·wa_h
    and E_sa·wa_h (4·N²·h); per (n, I, o) the two rank-1 terms, the division
    and the sum over heads (6·N²·h). Per fc element: bias, x_a and the
    diagonal delta (3), LayerNorm (6) and the pool (1)."""
    n_in = 3 * B * H * N * N + B * H * N + 2 * B * H * N * h + 2 * B * N * h + h
    n_bytes = 4 * (n_in + B * N * h)
    n_flops = B * H * (16 * N * N + 6 * N + 10 * N * N * h) + 10 * B * N * N * h
    return n_bytes, n_flops


def _cf_backward_work(B, N, H, h):
    """Bytes and float32 operations of one K5b call, from the operations of
    the backward body (cf_attention.py's ``_bwd_kernel``). Bytes: the nine
    inputs and dout read once, nine cotangents written once. Operations:
    the forward's recompute without the pool; the LayerNorm backward (7 per
    fc element); per head and (n, I, o): dctx, the dZ, d_zc and d_E_as dot
    products, the sums into d_num, d_wa and d_dws, and the two products
    with the finished d_num (16), plus the row I terms: the d_E_sa products
    and E_saᵀ·dctx (4·N²·h and 11·N·h); the scalar exp chain (11·N²); the
    sums into d_xa and d_bias (2 per fc element)."""
    n_in = 3 * B * H * N * N + B * H * N + 2 * B * H * N * h + 2 * B * N * h + h
    n_bytes = 4 * (2 * n_in + B * N * h)
    recompute = B * H * (16 * N * N + 6 * N + 10 * N * N * h) + 9 * B * N * N * h
    n_flops = (recompute + 7 * B * N * N * h
               + B * H * (20 * N * N * h + 11 * N * h + 11 * N * N)
               + 2 * B * N * N * h)
    return n_bytes, n_flops


# K5b's four kernels, in launch order, and the stage that writes each cotangent
CF_STAGES = ("base", "rows", "sums", "products")
CF_STAGE_OF = {"S_aa": 3, "S_as": 1, "S_sa": 3, "S_ss": 1, "wa": 3, "dws": 1, "x_a": 2,
               "delta": 1, "bias": 2}


def _cf_backward_stage_work(B, N, H, h):
    """Bytes and float32 operations of each K5b stage, with its scratch
    (terms 5·B·H·N², base products 2·B·H·N·h, d_fc B·N²·h, score scratch
    2·B·H·N², d_num B·H·N·h, the (B, h) d_bias partial) counted as an output
    of the stage that writes it and an input of each stage that reads it.
    base: the score tensors and wa in, terms and base out; per (b, head) the
    softmax terms (16·N² + 6·N) and the two base products (4·N²·h). rows:
    three terms, base, wa, dws, x_a, delta, bias and dout in; d_fc, dS_as,
    dS_ss, d_wa, d_dws, d_delta and the score scratch out; per fc element the
    rebuild (5 a head, 3 for the residual), the LayerNorm backward (11), the
    dot products (6 a head) and the sums over n (4 a head). sums: Z and d_fc
    in, d_num, d_xa and the partial out (and the partial in, d_bias out);
    per d_fc element 1 + 2·H. products: E_aa, E_sa, Z, wa, d_num, d_delta,
    the score scratch and the first term of d_wa in; dS_aa, dS_sa and d_wa
    out; per (b, head) four (N × h)·(h × N)-sized products (8·N²·h)."""
    NN, HNN, HNh, Nh = N * N, B * H * N * N, B * H * N * h, B * N * h
    fc = B * NN * h
    f = 4  # bytes per float32
    return {
        "base": (f * (3 * HNN + B * H * N + HNh + 5 * HNN + 2 * HNh),
                 B * H * (16 * NN + 6 * N + 4 * NN * h)),
        "rows": (f * (3 * HNN + 2 * HNh + 2 * HNh + 3 * Nh + h
                      + fc + HNN + B * H * N + 2 * HNh + Nh + 2 * HNN),
                 fc * (5 * H + 3 + 11 + 6 * H + 4 * H)),
        "sums": (f * (HNN + fc + HNh + Nh + 2 * B * h + h), fc * (1 + 2 * H)),
        "products": (f * (3 * HNN + HNh + HNh + Nh + 2 * HNN + HNh + 2 * HNN + HNh),
                     B * H * 8 * NN * h),
    }


def time_cf_backward_stages(torch, args, dout, d, cycles_per_ms, wide=False):
    """Each K5b stage launched alone, on the tuned route or the wide one
    (``cf_attention_wide.cu``), at the shape of ``args``: its median device
    ms and its bound, and for stages 0 and 3 the time of one ``torch.bmm``
    of the stage's products on the same operands (cuBLAS, float32 with TF32
    off; the port never calls it): [E_aa; E_sa]·wa_h for the base products,
    [d_num; dU2]·wa_hᵀ for the products' d_Eaa and d_Esa. One whole
    backward fills the scratch first."""
    from swarmacb_torch.ops import cf_attention

    B, H, N, h = args[4].shape
    scratch, grads, stages = cf_attention._stage_calls(args, dout, d, B, N, H, h, wide=wide)
    for launch in stages:
        launch()
    torch.cuda.synchronize()
    wa = args[4].reshape(B * H, N, h)
    e = scratch["terms"][:, :, :2].reshape(B * H, 2 * N, N)
    z2 = scratch["terms"][:, :, 4].diagonal(dim1=-2, dim2=-1)[..., None]
    u = torch.cat([scratch["d_num"], grads[7][:, None] / z2], dim=2)
    u = u.reshape(B * H, 2 * N, h)
    wa_t = wa.transpose(1, 2)
    library = {"base": lambda: torch.bmm(e, wa), "products": lambda: torch.bmm(u, wa_t)}
    work = _cf_backward_stage_work(B, N, H, h)
    out = {}
    for name, launch in zip(CF_STAGES, stages):
        b_ms, b_by = bound_ms(*work[name])
        lib = library.get(name)
        out[name] = dict(ms=device_ms(torch, launch, cycles_per_ms),
                         library_ms=device_ms(torch, lib, cycles_per_ms) if lib else None,
                         bound_ms=b_ms, bound_by=b_by, bytes=work[name][0],
                         flops=work[name][1])
    return out


def ptxas_report(log: str, kernels) -> dict[str, str]:
    """Registers, spills and shared memory of each named kernel in an nvcc
    log; a template's instances by their int or bool argument, as
    ``tail_bwd_wa_kernel<1>``."""
    lines = log.splitlines()
    report = {}
    for i, line in enumerate(lines):
        name = next((k for k in kernels if "Compiling entry" in line and k in line), None)
        if name is None:
            continue
        instance = re.search(r"IL[ib](\d+)E", line) or re.search(r"I\w*?\d(Store)E", line)
        if instance:
            name += f"<{instance.group(1)}>"
        end = next((j for j in range(i + 1, len(lines)) if "Compiling entry" in lines[j]),
                   len(lines))
        report[name] = "; ".join(x.split("info    :")[-1].strip() for x in lines[i + 1:end]
                                 if "registers" in x or "spill" in x)
    return report


CF_BACKWARD_KERNELS = ("cf_bwd_base_kernel", "cf_bwd_rows_kernel", "cf_bwd_sums_kernel",
                       "sum_over_groups_kernel", "cf_bwd_products_kernel")
# K5f's two kernels, in launch order (stage 0 is the backward's)
CF_FORWARD_STAGES = ("base", "rows")
CF_FORWARD_KERNELS = ("cf_bwd_base_kernel", "cf_fwd_rows_kernel")


def _cf_forward_stage_work(B, N, H, h):
    """Bytes and float32 operations of each K5f stage, with its scratch
    (terms 5·B·H·N², base products 2·B·H·N·h) counted as an output of stage 0
    and an input of stage 1. base: as K5b's stage 0. rows: three terms
    (corr, rep, Z), base, wa, dws, x_a, delta and bias in, pooled out; per fc
    element the rebuild (5 a head, 3 for the residual), LayerNorm (6) and the
    pool (1)."""
    HNN, HNh, Nh = B * H * N * N, B * H * N * h, B * N * h
    return {"base": _cf_backward_stage_work(B, N, H, h)["base"],
            "rows": (4 * (3 * HNN + 2 * HNh + 2 * HNh + 2 * Nh + h + Nh),
                     B * N * N * h * (5 * H + 3 + 7))}


def time_cf_forward_stages(torch, args, d, cycles_per_ms, wide=False):
    """Each K5f stage launched alone, on the tuned route or the wide one,
    at the shape of ``args``: its median device ms and its bound, for stage
    0 the time of one ``torch.bmm`` of its products on the same operands
    ([E_aa; E_sa]·wa_h; cuBLAS, float32 with TF32 off; the port never calls
    it). One whole forward fills the scratch first."""
    from swarmacb_torch.ops import cf_attention

    B, H, N, h = args[4].shape
    scratch, _, stages = cf_attention._forward_stage_calls(args, d, B, N, H, h, wide=wide)
    for launch in stages:
        launch()
    torch.cuda.synchronize()
    e = scratch["terms"][:, :, :2].reshape(B * H, 2 * N, N)
    wa = args[4].reshape(B * H, N, h)
    library = {"base": lambda: torch.bmm(e, wa)}
    work = _cf_forward_stage_work(B, N, H, h)
    out = {}
    for name, launch in zip(CF_FORWARD_STAGES, stages):
        b_ms, b_by = bound_ms(*work[name])
        lib = library.get(name)
        out[name] = dict(ms=device_ms(torch, launch, cycles_per_ms),
                         library_ms=device_ms(torch, lib, cycles_per_ms) if lib else None,
                         bound_ms=b_ms, bound_by=b_by, bytes=work[name][0],
                         flops=work[name][1])
    return out


def phase_cf_forward(torch, ops, card, cycles_per_ms):
    B, N, H, h = E_MAIN, N_MAIN, H_MAIN, HID_MAIN
    d = h // H
    print(f"== phase 2d: K5f fused_cf_attention forward (B={B}, N={N}, H={H}, "
          f"h={h}, d={d})", flush=True)
    from swarmacb_torch.ops import _cuda, cf_attention

    for name, info in ptxas_report(_cuda.build_log("cf_attention"),
                                   CF_FORWARD_KERNELS).items():
        print(f"  K5f ptxas {name}: {info}", flush=True)
    # LayerNorm outputs are O(1); the kernel's partition Z_b - E_aa + E_as
    # rounds otherwise than a fresh softmax row sum (the JAX package holds
    # its kernel to its plain version at the same tolerance). At
    # (6, 5, 4, 32) a group's last rows block holds one counterfactual of two;
    # h = 128 is tulip's and cyclamen's width.
    worst = 0.0
    for shape, scale in (((B, N, H, h), 3.0), ((B, N, H, h), 12.0), ((B, N, H, 128), 3.0),
                         ((6, 5, 4, 32), 3.0)):
        args = _cf_inputs(torch, *shape, SEED + 4, scale)
        with torch.no_grad():
            got = ops.fused_cf_attention(*args, shape[3] // shape[2])
            want = cf_attention.cf_reference(*args, shape[3] // shape[2])
        torch.cuda.synchronize()
        err, ok = max_err(got, want, 2e-5, 2e-5)
        worst = max(worst, err)
        check(ok and got.shape == want.shape,
              f"K5f pooled {tuple(got.shape)}, scores x{scale:g}: max|Δ| {err:.3e} "
              "(tolerance 2e-05 + 2e-05·|plain|)")
    args = _cf_inputs(torch, B, N, H, h, SEED + 4, 3.0)
    # Each stage's output against the staged plain version, which rebuilds fc
    # from the same base products in another order: within 1e-5 of the
    # largest element of each (phase 2e's rule)
    staged = {}
    with torch.no_grad():
        want = cf_attention.cf_forward_reference(args, d, stages=staged)
        first = ops.fused_cf_attention(*args, d)
        again = ops.fused_cf_attention(*args, d)
    scratch, pooled, calls = cf_attention._forward_stage_calls(args, d, B, N, H, h)
    for launch in calls:
        launch()
    torch.cuda.synchronize()
    rel = 1e-5
    for stage, name, g, w in ((0, "terms", scratch["terms"], staged["terms"]),
                              (0, "base", scratch["base"], staged["base"]),
                              (1, "pooled", pooled, want)):
        scale = float(w.abs().max())
        err, ok = max_err(g, w, rel * scale, 0.0)
        check(ok and g.shape == w.shape,
              f"K5f stage {stage} ({CF_FORWARD_STAGES[stage]}) {name} {tuple(g.shape)}: "
              f"max|Δ| {err:.3e} against the staged plain version (tolerance "
              f"{rel:g}·max|plain| = {rel * scale:.3e})")
    check(torch.equal(first, again) and torch.equal(first, pooled),
          "K5f: two calls give bit-identical pooled rows")
    del staged, want, first, again, scratch, pooled
    with torch.no_grad():
        ms = device_ms(torch, lambda: ops.fused_cf_attention(*args, d), cycles_per_ms)
        plain = device_ms(torch, lambda: cf_attention.cf_reference(*args, d),
                          cycles_per_ms)
    n_bytes, n_flops = _cf_forward_work(B, N, H, h)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    stages = time_cf_forward_stages(torch, args, d, cycles_per_ms)
    route_bytes = sum(st["bytes"] for st in stages.values())
    r_ms, r_by = bound_ms(route_bytes, n_flops)
    print(f"  K5f kernel {ms:.4f} ms, plain {plain:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by}: {n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.2f} GFLOP), the staged "
          f"route's bound {r_ms:.4f} ms ({r_by}: {route_bytes / 1e6:.1f} MB with its "
          f"scratch); no single PyTorch call computes this function, so there is no "
          f"library time; on {card}", flush=True)
    for i, (name, st) in enumerate(stages.items()):
        lib = ("" if st["library_ms"] is None
               else f", torch.bmm {st['library_ms']:.4f} ms")
        print(f"  K5f stage {i} ({name}) alone: {st['ms']:.4f} ms{lib}, bound "
              f"{st['bound_ms']:.4f} ms ({st['bound_by']}: {st['bytes'] / 1e6:.1f} MB, "
              f"{st['flops'] / 1e9:.2f} GFLOP) on {card}", flush=True)
    print("  K5f stages: " + json.dumps({"card": card, "shape": [B, N, H, h],
                                          "whole_ms": ms, "route_bound_ms": r_ms,
                                          "stages": stages}), flush=True)
    return [dict(name="fused_cf_attention", route="cuda",
                 source="swarmacb_torch/ops/csrc/cf_attention.cu",
                 replaces="swarmacb_tpu/ops/cf_attention.py:267",
                 max_abs_err=worst, ms=ms, plain_ms=plain,
                 bound_ms=b_ms, bound_by=b_by, route_bound_ms=r_ms, library_ms=None)]


def phase_cf_backward(torch, ops, card, cycles_per_ms):
    B, N, H, h = E_MAIN, N_MAIN, H_MAIN, HID_MAIN
    d = h // H
    print(f"== phase 2e: K5b fused_cf_attention backward (B={B}, N={N}, H={H}, "
          f"h={h})", flush=True)
    from swarmacb_torch.ops import _cuda, cf_attention

    for name, info in ptxas_report(_cuda.build_log("cf_attention"),
                                   CF_BACKWARD_KERNELS).items():
        print(f"  K5b ptxas {name}: {info}", flush=True)
    # tulip's and cyclamen's width first, its cotangents only
    _cf_backward_cotangents(torch, ops, B, N, H, 128)
    args, dout, got, plain_out, worst = _cf_backward_cotangents(torch, ops, B, N, H, h)
    saved = [a.detach() for a in args]
    # Each stage's output against the staged plain version, which rebuilds fc
    # from the same base products and takes the same dot products in another
    # order: within 1e-5 of the largest element of each (phase 2c's rule)
    staged = {}
    with torch.no_grad():
        want_fc, want_st = cf_attention.cf_backward_reference(saved, dout, d, stages=staged)
    staged["d_fc"] = want_fc
    scratch, got_again, calls = cf_attention._stage_calls(saved, dout, d, B, N, H, h)
    for launch in calls:
        launch()
    torch.cuda.synchronize()
    rel = 1e-5
    held = [(0, "terms", scratch["terms"], staged["terms"]),
            (0, "base", scratch["base"], staged["base"]),
            (1, "d_fc", scratch["d_fc"], staged["d_fc"]),
            (1, "d_scores", scratch["d_scores"], staged["d_scores"]),
            (2, "d_num", scratch["d_num"], staged["d_num"])]
    held += [(CF_STAGE_OF[n], f"d_{n}", g, w)
             for n, g, w in zip(cf_attention.NAMES, got_again, want_st)]
    for stage, name, g, w in sorted(held, key=lambda x: x[0]):
        scale = float(w.abs().max())
        err, ok = max_err(g, w, rel * scale, 0.0)
        check(ok and g.shape == w.shape,
              f"K5b stage {stage} ({CF_STAGES[stage]}) {name} {tuple(g.shape)}: max|Δ| "
              f"{err:.3e} against the staged plain version (tolerance {rel:g}·max|plain| "
              f"= {rel * scale:.3e})")
    del staged, want_fc, want_st, scratch, held
    same = all(torch.equal(a, b) for a, b in zip(got, got_again))
    check(same, "K5b: two calls give bit-identical cotangents")
    del got_again
    ms = device_ms(torch, lambda: cf_attention.backward_kernel(saved, dout, d),
                   cycles_per_ms)
    plain = device_ms(torch, lambda: torch.autograd.grad(
        plain_out, args, dout, retain_graph=True), cycles_per_ms)
    n_bytes, n_flops = _cf_backward_work(B, N, H, h)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    stages = time_cf_backward_stages(torch, saved, dout, d, cycles_per_ms)
    route_bytes = sum(st["bytes"] for st in stages.values())
    r_ms, r_by = bound_ms(route_bytes, n_flops)
    print(f"  K5b kernel {ms:.4f} ms, plain backward {plain:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by}: {n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.2f} GFLOP), the staged "
          f"route's bound {r_ms:.4f} ms ({r_by}: {route_bytes / 1e6:.1f} MB with its "
          f"scratch); max|kernel − plain| over the nine cotangents {worst:.3e}; no "
          f"single PyTorch call computes this function, so there is no library time; "
          f"on {card}", flush=True)
    for i, (name, st) in enumerate(stages.items()):
        lib = ("" if st["library_ms"] is None
               else f", torch.bmm {st['library_ms']:.4f} ms")
        print(f"  K5b stage {i} ({name}) alone: {st['ms']:.4f} ms{lib}, bound "
              f"{st['bound_ms']:.4f} ms ({st['bound_by']}: {st['bytes'] / 1e6:.1f} MB, "
              f"{st['flops'] / 1e9:.2f} GFLOP) on {card}", flush=True)
    print("  K5b stages: " + json.dumps({"card": card, "shape": [B, N, H, h],
                                          "whole_ms": ms, "route_bound_ms": r_ms,
                                          "stages": stages}), flush=True)
    return [dict(name="fused_cf_attention_bwd", route="cuda",
                 source="swarmacb_torch/ops/csrc/cf_attention.cu",
                 replaces="swarmacb_tpu/ops/cf_attention.py:290",
                 max_abs_err=worst, ms=ms, plain_ms=plain,
                 bound_ms=b_ms, bound_by=b_by, route_bound_ms=r_ms, library_ms=None)]


def _cf_backward_cotangents(torch, ops, B, N, H, h):
    """K5b's nine cotangents through autograd at (B, N, H, h), each held
    against a float64 plain run; returns (inputs, dout, the cotangents, the
    plain output, max|kernel − plain|)."""
    from swarmacb_torch.ops import cf_attention

    d = h // H
    args = [a.requires_grad_() for a in _cf_inputs(torch, B, N, H, h, SEED + 5, 3.0)]
    rng = np.random.default_rng(SEED + 6)
    dout = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).to(DEVICE)
    before = ops.launches["fused_cf_attention_bwd"]
    got = torch.autograd.grad(ops.fused_cf_attention(*args, d), args, dout)
    torch.cuda.synchronize()
    check(ops.launches["fused_cf_attention_bwd"] == before + 1,
          "autograd through ops.fused_cf_attention launched K5b once")
    plain_out = cf_attention.cf_reference(*args, d)
    want = torch.autograd.grad(plain_out, args, dout, retain_graph=True)
    args64 = [a.detach().double().requires_grad_() for a in args]
    truth = torch.autograd.grad(cf_attention.cf_reference(*args64, d), args64,
                                dout.double())
    torch.cuda.synchronize()
    # The JAX package's rule for its kernel (tests/test_cf_attention.py):
    # each cotangent's error against a float64 plain run is at most twice
    # the float32 plain version's (2.5 times for wa, whose recompute adds
    # the rounding of the incremental partition), or 4 ulp of the tensor's
    # largest element, where both sit at float32 resolution.
    worst = 0.0
    for name, g, w, t in zip(cf_attention.NAMES, got, want, truth):
        err_k = float((g.double() - t).abs().max())
        err_p = float((w.double() - t).abs().max())
        floor = 4 * float(np.spacing(np.float32(float(t.abs().max()))))
        band = 2.5 if name == "wa" else 2.0
        limit = max(band * err_p, floor)
        worst = max(worst, float((g - w).abs().max()))
        check(err_k <= limit and g.shape == w.shape,
              f"K5b d_{name} {tuple(g.shape)} (stage {CF_STAGE_OF[name]}): error "
              f"against float64 {err_k:.3e}, plain float32's {err_p:.3e} (tolerance "
              f"max({band:g}x plain, 4 ulp {floor:.3e}) = {limit:.3e})")
    return args, dout, got, plain_out, worst


def phase_critic_paths(torch, cycles_per_ms):
    """Device ms of ``all_baselines`` forward and backward (the gradient of
    every critic parameter) on one chunk of 1,024 groups, on both critic
    paths, with the same weights: scores, softmax and the tail kernels
    K3f/K3b, against the fused attention K5f/K5b. Timed in turns."""
    from swarmacb_torch.models import POCACritic

    B, N, H, h = E_MAIN, N_MAIN, H_MAIN, HID_MAIN
    print(f"== phase 2f: all_baselines forward + backward, {B} groups, on both "
          "critic paths", flush=True)
    rng = np.random.default_rng(SEED + 7)
    states = torch.from_numpy(rng.normal(size=(B, N, 5)).astype(np.float32)).to(DEVICE)
    actions = torch.from_numpy(rng.normal(size=(B, N, 2)).astype(np.float32)).to(DEVICE)
    critics = {}
    for fused in (False, True):
        critic = POCACritic(5, 2, N, hidden=h, num_heads=H, num_layers=2,
                            fused_attention=fused)
        critic.init_weights(torch.Generator().manual_seed(SEED))
        critics[fused] = critic.to(DEVICE)

    def step(critic):
        out = critic.all_baselines(states, actions)
        torch.autograd.grad(out.sum(), list(critic.parameters()))
        return out

    with torch.no_grad():
        outs = {k: c.all_baselines(states, actions) for k, c in critics.items()}
    err, ok = max_err(outs[True], outs[False], 1e-5, 1e-5)
    check(ok, f"all_baselines of the two paths: max|Δ| {err:.3e} "
              "(tolerance 1e-05 + 1e-05·|tail path|)")
    times = {False: [], True: []}
    for fused in (False, True, True, False):
        times[fused].append(device_ms(torch, lambda: step(critics[fused]),
                                      cycles_per_ms))
    print(f"  device ms per chunk: tail path (K3f/K3b) "
          f"{', '.join(f'{t:.3f}' for t in times[False])}; fused attention "
          f"(K5f/K5b) {', '.join(f'{t:.3f}' for t in times[True])}", flush=True)


# ── phase 2h: the critic's wide route ────────────────────────────────────

HID_WIDE = 1024                     # --hidden_dim 1024, the width phase 3f trains at
WIDE_ROLLOUT_B = 16                 # K3f-wide's groups in phase 3f's rollout (--num_envs 16)
# (B, N, H, h) of phase 2h: the full width, then shapes the tuned kernels
# refuse for each of their limits (N > 32, h % 4 != 0, H·N % 4 != 0, H > 4);
# for K3, also the edges of its plan (baseline_tail.wide_plan): N > 80 (one
# counterfactual a block, two row tiles of 80, the rows in device memory)
# and h not a multiple of the 256-column product tile
WIDE_TAIL_SHAPES = ((E_MAIN, N_MAIN, H_MAIN, HID_WIDE), (5, 33, 3, 130), (3, 100, 4, HID_WIDE),
                    (7, N_MAIN, H_MAIN, 1000))
# for K5, also the edges of its plan (cf_attention.cf_wide_plan): one
# counterfactual a block (h = 2048), the rows and their statistics in
# device memory (h = 3000, not a multiple of 4), dout / N read from device
# memory too (h = 30000), N = 130, whose products read E_aa and E_sa from
# device memory, and N = 900, past which no products tile fits (their rows
# then come from device memory too)
WIDE_CF_SHAPES = ((E_MAIN, N_MAIN, H_MAIN, HID_WIDE), (5, 33, 8, 136), (5, 7, 3, 6),
                  (3, N_MAIN, H_MAIN, 2048), (2, N_MAIN, 3, 3000), (1, 2, 1, 30000),
                  (1, 130, 1, 8), (1, 900, 1, 8))
WIDE_KERNELS = {
    "tail_wide": ("tail_wide_fwd_kernel", "tail_wide_bwd_rows_kernel", "tc_gemm_kernel",
                  "tail_wide_sums_kernel", "sum_over_groups_kernel"),
    "cf_attention_wide": ("cf_wide_terms_kernel", "cf_wide_base_kernel",
                          "cf_wide_fwd_rows_kernel", "cf_wide_bwd_rows_kernel",
                          "cf_wide_sums_kernel", "sum_over_groups_kernel",
                          "cf_wide_products_kernel", "cf_wide_products_dwa_kernel",
                          "cf_wide_products_ds_kernel")}
WIDE_COUNTERS = ("fused_tail", "fused_tail_bwd", "fused_tail_wide", "fused_tail_wide_bwd",
                 "fused_cf_attention", "fused_cf_attention_bwd", "fused_cf_attention_wide",
                 "fused_cf_attention_wide_bwd")


def phase_wide(torch, ops, card, cycles_per_ms):
    """The wide route of K3f, K3b, K5f and K5b (``tail_wide.cu``,
    ``cf_attention_wide.cu``) at the shapes ``route`` sends to it: through
    ``ops.fused_tail`` and ``ops.fused_cf_attention`` and their autograd,
    each output against its plain version, each stage's scratch against the
    staged plain version, two calls bit for bit; at the full width each
    direction timed beside its bound (K3: its route's, 3xTF32 products on
    the tensor cores, and the float32 one; K5: float32 on the CUDA
    cores)."""
    print(f"== phase 2h: the critic's wide route (tail_wide.cu, cf_attention_wide.cu) at "
          f"{', '.join(str(s) for s in WIDE_TAIL_SHAPES)} for K3 and "
          f"{', '.join(str(s) for s in WIDE_CF_SHAPES)} for K5, as (B, N, H, h)",
          flush=True)
    from swarmacb_torch.ops import _cuda

    for source, kernels in WIDE_KERNELS.items():
        for name, info in ptxas_report(_cuda.build_log(source), kernels).items():
            print(f"  ptxas {source} {name}: {info}", flush=True)
    rows = []
    for shape in WIDE_TAIL_SHAPES:
        rows += _wide_tail_at(torch, ops, card, cycles_per_ms, *shape)
    for shape in WIDE_CF_SHAPES:
        rows += _wide_cf_at(torch, ops, card, cycles_per_ms, *shape)
    return rows


def _wide_launches(torch, ops, run):
    """The critic counters of one ``run()`` from 0."""
    ops.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, {k: ops.launches[k] for k in WIDE_COUNTERS if ops.launches[k]}


def _hold_each(names, got, want, rel, what):
    """Each of ``got`` within rel·max|plain| of ``want``; the largest error."""
    worst = 0.0
    for name, g, w in zip(names, got, want):
        scale = float(w.abs().max())
        err, ok = max_err(g, w, rel * scale, 0.0)
        worst = max(worst, err)
        check(ok and g.shape == w.shape,
              f"{what} {name} {tuple(g.shape)}: max|Δ| {err:.3e} (tolerance "
              f"{rel:g}·max|plain| = {rel * scale:.3e})")
    return worst


def _wide_tail_at(torch, ops, card, cycles_per_ms, B, N, H, h):
    from swarmacb_torch.ops import baseline_tail

    full = B == E_MAIN
    print(f"  -- K3f and K3b, wide route, (B, N, H, h) = {(B, N, H, h)}", flush=True)
    check(baseline_tail.route(N, H, h) == "wide", f"fused_tail's route({N}, {H}, {h}) is wide")
    args = [a.requires_grad_() for a in _tail_inputs(torch, B, N, H, h, SEED + 11)]
    rng = np.random.default_rng(SEED + 12)
    dout = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).to(DEVICE)

    def both():
        out = ops.fused_tail(*args, N)
        return out.detach(), torch.autograd.grad(out, args, dout)

    (out, got), counts = _wide_launches(torch, ops, both)
    check(counts == {"fused_tail_wide": 1, "fused_tail_wide_bwd": 1},
          f"ops.fused_tail and its autograd launched {counts} (the wide route once each)")
    plain_out = baseline_tail.tail_reference(*args, N)
    want = torch.autograd.grad(plain_out, args, dout, retain_graph=True)
    # phase 2b's tolerance for K3f; phase 2c's for K3b's scratch and cotangents
    err_f, ok = max_err(out, plain_out.detach(), 1e-5, 1e-5)
    check(ok, f"K3f wide pooled {tuple(out.shape)}: max|Δ| {err_f:.3e} (tolerance "
              "1e-05 + 1e-05·|plain|)")
    saved = [a.detach() for a in args]
    with torch.no_grad():
        want_fc = baseline_tail.tail_backward_reference(saved, dout, N)[0]
        again = baseline_tail._forward_kernel(saved, N, wide=True)
    got_fc, got_again, calls = baseline_tail._stage_calls(saved, dout, N, B, H, h, wide=True)
    for launch in calls:
        launch()
    torch.cuda.synchronize()
    _hold_each(["d_fc"], [got_fc], [want_fc], 1e-5, "K3b wide stage 1")
    del want_fc, got_fc
    names = [f"d_{n}" for n in ("attn_lhs", "attn_mI", "wa", "dws", "x_a", "delta", "bias")]
    err_b = _hold_each(names, got, want, 1e-5, "K3b wide")
    check(torch.equal(out, again) and all(torch.equal(a, b) for a, b in zip(got, got_again)),
          "K3f and K3b wide: two calls give the same bits")
    del got_again, again
    if not full:
        return []
    with torch.no_grad():
        ms_f = device_ms(torch, lambda: baseline_tail._forward_kernel(saved, N, wide=True),
                         cycles_per_ms)
        plain_f = device_ms(torch, lambda: baseline_tail.tail_reference(*saved, N),
                            cycles_per_ms)
        # the rollout's shape at phase 3f's --num_envs 16 (1,000 of its 1,060 launches)
        small = [a[:WIDE_ROLLOUT_B].contiguous() for a in saved[:-1]] + [saved[-1]]
        ms_small = device_ms(torch, lambda: baseline_tail._forward_kernel(small, N, wide=True),
                             cycles_per_ms)
    ms_b = device_ms(torch, lambda: baseline_tail.backward_kernel(saved, dout, N, wide=True),
                     cycles_per_ms)
    plain_b = device_ms(torch, lambda: torch.autograd.grad(plain_out, args, dout,
                                                           retain_graph=True), cycles_per_ms)
    bf = tail_forward_bounds(B, N, H, h)
    bf_small = tail_forward_bounds(WIDE_ROLLOUT_B, N, H, h)
    bb = tail_backward_bounds(B, N, H, h)
    print(f"  K3f wide {ms_f:.4f} ms, plain {plain_f:.4f} ms; bound by its route "
          f"{bf['bound_ms']:.4f} ms ({bf['bound_by']}: 3 x {bf['product_flops'] / 1e9:.2f} "
          f"GFLOP in TF32), {100 * bf['bound_ms'] / ms_f:.1f} % of it; the float32 bound "
          f"{bf['f32_bound_ms']:.4f} ms ({bf['f32_bound_by']}); at B={WIDE_ROLLOUT_B} "
          f"{ms_small:.4f} ms (route bound {bf_small['bound_ms']:.4f} ms, "
          f"{bf_small['bound_by']}); on {card}", flush=True)
    print(f"  K3b wide {ms_b:.4f} ms, plain backward {plain_b:.4f} ms; bound by its route "
          f"{bb['bound_ms']:.4f} ms ({bb['bound_by']}: {bb['bytes'] / 1e9:.3f} GB, 3 x "
          f"{bb['product_flops'] / 1e9:.2f} GFLOP in TF32), {100 * bb['bound_ms'] / ms_b:.1f} % "
          f"of it; with the d_fc scratch written once and read three times "
          f"{bb['scratch_bound_ms']:.4f} ms ({bb['scratch_bytes'] / 1e9:.3f} GB); the float32 "
          f"bound {bb['f32_bound_ms']:.4f} ms ({bb['f32_bound_by']}); on {card}", flush=True)
    common = dict(route="cuda", source="swarmacb_torch/ops/csrc/tail_wide.cu", library_ms=None)
    return [dict(name="fused_tail_wide", replaces="swarmacb_tpu/ops/baseline_tail.py:201",
                 max_abs_err=err_f, ms=ms_f, plain_ms=plain_f, bound_ms=bf["bound_ms"],
                 bound_by=bf["bound_by"], f32_bound_ms=bf["f32_bound_ms"],
                 ms_rollout_b16=ms_small, **common),
            dict(name="fused_tail_wide_bwd", replaces="swarmacb_tpu/ops/baseline_tail.py:224",
                 max_abs_err=err_b, ms=ms_b, plain_ms=plain_b, bound_ms=bb["bound_ms"],
                 bound_by=bb["bound_by"], f32_bound_ms=bb["f32_bound_ms"],
                 scratch_bound_ms=bb["scratch_bound_ms"], **common)]


def _wide_cf_at(torch, ops, card, cycles_per_ms, B, N, H, h):
    from swarmacb_torch.ops import cf_attention

    full = B == E_MAIN
    d = h // H
    print(f"  -- K5f and K5b, wide route, (B, N, H, h) = {(B, N, H, h)}, d = {d}", flush=True)
    check(cf_attention.route(N, H, h) == "wide",
          f"fused_cf_attention's route({N}, {H}, {h}) is wide")
    args = [a.requires_grad_() for a in _cf_inputs(torch, B, N, H, h, SEED + 13, 3.0)]
    rng = np.random.default_rng(SEED + 14)
    dout = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).to(DEVICE)

    def both():
        out = ops.fused_cf_attention(*args, d)
        return out.detach(), torch.autograd.grad(out, args, dout)

    (out, got), counts = _wide_launches(torch, ops, both)
    check(counts == {"fused_cf_attention_wide": 1, "fused_cf_attention_wide_bwd": 1},
          f"ops.fused_cf_attention and its autograd launched {counts} (the wide route once "
          "each)")
    # phase 2d's tolerance for K5f. K5b: phase 2e's rules. Against a float64
    # plain run at the full width, as 2e holds K5b at B = 1024; at the small
    # ragged shapes the staged algebra that K5b, its plain version and the
    # Pallas kernel share (the partition Z_b - E_aa + E_as) itself misses
    # that rule by cancellation (tests/test_torch_wide_critic.py), so there
    # the float64 errors are printed, and every shape holds the cotangents
    # and scratch to the staged plain version below.
    plain_out = cf_attention.cf_reference(*args, d)
    err_f, ok = max_err(out, plain_out.detach(), 2e-5, 2e-5)
    check(ok, f"K5f wide pooled {tuple(out.shape)}: max|Δ| {err_f:.3e} (tolerance "
              "2e-05 + 2e-05·|plain|)")
    want = torch.autograd.grad(plain_out, args, dout, retain_graph=True)
    args64 = [a.detach().double().requires_grad_() for a in args]
    truth = torch.autograd.grad(cf_attention.cf_reference(*args64, d), args64, dout.double())
    del args64
    err_b = 0.0
    for name, g, w, t in zip(cf_attention.NAMES, got, want, truth):
        err_k = float((g.double() - t).abs().max())
        err_p = float((w.double() - t).abs().max())
        floor = 4 * float(np.spacing(np.float32(float(t.abs().max()))))
        band = 2.5 if name == "wa" else 2.0
        limit = max(band * err_p, floor)
        err_b = max(err_b, float((g - w).abs().max()))
        what = (f"K5b wide d_{name} {tuple(g.shape)}: error against float64 {err_k:.3e}, "
                f"plain float32's {err_p:.3e}")
        if full:
            check(err_k <= limit and g.shape == w.shape,
                  f"{what} (tolerance max({band:g}x plain, 4 ulp {floor:.3e}) = {limit:.3e})")
        else:
            print(f"  {what} (phase 2e's rule would allow {limit:.3e})", flush=True)
    del truth, want
    # each stage's scratch and the nine cotangents against the staged plain
    # version (phase 2e's rule)
    saved = [a.detach() for a in args]
    staged_f, staged_b = {}, {}
    with torch.no_grad():
        want_pooled = cf_attention.cf_forward_reference(saved, d, stages=staged_f)
        want_fc, want_st = cf_attention.cf_backward_reference(saved, dout, d, stages=staged_b)
    scratch_f, pooled, calls = cf_attention._forward_stage_calls(saved, d, B, N, H, h, wide=True)
    for launch in calls:
        launch()
    scratch, got_again, calls = cf_attention._stage_calls(saved, dout, d, B, N, H, h, wide=True)
    for launch in calls:
        launch()
    torch.cuda.synchronize()
    _hold_each(("terms", "base", "pooled"),
               (scratch_f["terms"], scratch_f["base"], pooled),
               (staged_f["terms"], staged_f["base"], want_pooled), 1e-5,
               "K5f wide against the staged plain version:")
    _hold_each(("d_fc", "d_scores", "d_num", *(f"d_{n}" for n in cf_attention.NAMES)),
               (scratch["d_fc"], scratch["d_scores"], scratch["d_num"], *got_again),
               (want_fc, staged_b["d_scores"], staged_b["d_num"], *want_st), 1e-5,
               "K5b wide against the staged plain version:")
    del staged_f, staged_b, want_fc, want_st, scratch_f, scratch
    check(torch.equal(out, pooled) and all(torch.equal(a, b) for a, b in zip(got, got_again)),
          "K5f and K5b wide: two calls give the same bits")
    del got_again, pooled
    if not full:
        return []
    with torch.no_grad():
        ms_f = device_ms(torch, lambda: cf_attention.forward_kernel(saved, d, wide=True),
                         cycles_per_ms)
        plain_f = device_ms(torch, lambda: cf_attention.cf_reference(*saved, d),
                            cycles_per_ms)
        # the rollout's shape at phase 3f's --num_envs 16
        small = [a[:WIDE_ROLLOUT_B].contiguous() for a in saved[:-1]] + [saved[-1]]
        ms_small = device_ms(torch, lambda: cf_attention.forward_kernel(small, d, wide=True),
                             cycles_per_ms)
    ms_b = device_ms(torch, lambda: cf_attention.backward_kernel(saved, dout, d, wide=True),
                     cycles_per_ms)
    plain_b = device_ms(torch, lambda: torch.autograd.grad(plain_out, args, dout,
                                                           retain_graph=True), cycles_per_ms)
    bf, bf_by = bound_ms(*_cf_forward_work(B, N, H, h))
    bb, bb_by = bound_ms(*_cf_backward_work(B, N, H, h))
    # the staged route's bound: each stage's inputs, outputs and scratch moved once
    rf, _ = bound_ms(sum(w[0] for w in _cf_forward_stage_work(B, N, H, h).values()), 0)
    rb, _ = bound_ms(sum(w[0] for w in _cf_backward_stage_work(B, N, H, h).values()), 0)
    print(f"  K5f wide {ms_f:.4f} ms, plain {plain_f:.4f} ms, bound {bf:.4f} ms ({bf_by}), "
          f"the staged route's byte bound {rf:.4f} ms; at B={WIDE_ROLLOUT_B} {ms_small:.4f} ms; "
          f"K5b wide {ms_b:.4f} ms, plain backward {plain_b:.4f} ms, bound {bb:.4f} ms "
          f"({bb_by}), the staged route's byte bound {rb:.4f} ms; on {card}", flush=True)
    common = dict(route="cuda", source="swarmacb_torch/ops/csrc/cf_attention_wide.cu",
                  library_ms=None)
    return [dict(name="fused_cf_attention_wide", replaces="swarmacb_tpu/ops/cf_attention.py:267",
                 max_abs_err=err_f, ms=ms_f, plain_ms=plain_f, bound_ms=bf, bound_by=bf_by,
                 route_bound_ms=rf, ms_rollout_b16=ms_small, **common),
            dict(name="fused_cf_attention_wide_bwd",
                 replaces="swarmacb_tpu/ops/cf_attention.py:290", max_abs_err=err_b, ms=ms_b,
                 plain_ms=plain_b, bound_ms=bb, bound_by=bb_by, route_bound_ms=rb, **common)]


# ── phase 2g: K4, the fused env step ─────────────────────────────────────

K4_FORMS = (("daisy", True), ("lily", True), ("dandelion", True), ("daisy", False))
K4_TIE_ULPS = 16
K4_FREE_STEPS = 200
# shapes that leave lanes of a block idle: a partial last warp row (4 ∤ N)
# and padded arenas (E below the lanes' multiple of 128), both env branches
K4_RAGGED = (("daisy", True, 37, 13), ("dandelion", True, 1000, 7))
# kernel against plain on the card, from one state: positions, yaw and the
# readings run the same float32 operations (the sums over the 8 sensors in
# one order); the sums over up to 19 neighbours (RAB vectors, push-outs)
# run in another order, and the RAB projections scale them by up to 1/(2r)
K4_TOL = {"px": 2e-6, "py": 2e-6, "yaw": 2e-6, "prox": 2e-6, "light": 2e-6,
          "ztilde": 2e-6, "rab_proj": 2e-5}


def _k4_state(torch, variant, E, N, seed):
    """A lanes state on the card for one K4 form, its actions, draws and
    spawns: robots spread over the arena's disc, random machine states,
    episode counters spread so that 1/16 of the arenas reset."""
    from swarmacb_torch.config import DirectionalGateEnvCfg
    from swarmacb_torch.env import DirectionalGateEnv, lanes
    from swarmacb_torch.ops import fused_step

    cfg = DirectionalGateEnvCfg(variant=variant, num_envs=E, num_agents=N)
    env = DirectionalGateEnv(cfg, device=DEVICE)
    rng = np.random.default_rng(seed)
    pos, yaw = _arena_poses(rng, cfg, E, N)
    L = cfg.max_episode_length
    sc = rng.integers(0, L - 2, E).astype(np.int32)
    sc[::16] = L - 2
    st = env.make_state(pos, yaw, torch.Generator(device=DEVICE), step_count=sc,
                        episode_reward=rng.integers(-3, 4, E).astype(np.float32))
    st.prev_ground = torch.from_numpy(rng.choice(
        np.array([0.0, 0.5, 1.0], np.float32), (E, N))).to(DEVICE)
    dev = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    if cfg.discrete_actions:
        b = st.behavior
        for name in ("explore_state", "explore_steps", "photo_steps", "antiphoto_steps"):
            setattr(b, name, dev(rng.integers(0, 3, (E, N)).astype(np.int32)))
        for name in ("photo_avoiding", "antiphoto_avoiding"):
            setattr(b, name, dev(rng.random((E, N)) < 0.3))
        for name in ("explore_dir", "photo_dir", "antiphoto_dir"):
            setattr(b, name, dev(np.where(rng.random((E, N)) < 0.5, -1.0, 1.0)
                                 .astype(np.float32)))
    tiles = lanes.state_to_lanes(env, st)
    Ep = tiles["px"].shape[1]
    if cfg.discrete_actions:
        acts = lanes.to_lanes(dev(rng.integers(0, 6, (E, N)).astype(np.int32)), E)
        draws = tuple(dev(rng.integers(1, 5, (N, Ep)).astype(np.int32)) for _ in range(3))
    else:
        wheels = rng.uniform(-1.0, 1.0, (2, N, Ep)).astype(np.float32) * cfg.max_wheel_speed
        acts, draws = (dev(wheels[0]), dev(wheels[1])), ()
    spos, syaw = _arena_poses(rng, cfg, Ep, N)
    spawn = tuple(dev(np.ascontiguousarray(a.T)) for a in (spos[..., 0], spos[..., 1], syaw))
    return env, fused_step.constants(cfg), tiles, acts, draws, spawn


def _k4_ties(torch, k, tiles, acts, draws, spawn, cfg, want_obs):
    """Robot (N, Ep) and arena (1, Ep) masks of decision inputs within
    K4_TIE_ULPS ulps of their thresholds: the obstacle band and turn tests
    on the 8-term proximity sums (against Σ|term|), and the ground colour
    of the pre-reset positions near a zone edge (against 1 m)."""
    from swarmacb_torch.ops import fused_step

    N = tiles["px"].shape[0]
    win = K4_TIE_ULPS * float(np.finfo(np.float32).eps)
    sb = fused_step.sensor_block(tiles["px"], tiles["py"], torch.cos(tiles["yaw"]),
                                 torch.sin(tiles["yaw"]), k, N)
    v = torch.stack(sb["prox_vals"]).double()                      # (8, N, Ep)
    cos_a = torch.tensor(k.cos_a, dtype=torch.float64, device=v.device)[:, None, None]
    sin_a = torch.tensor(k.sin_a, dtype=torch.float64, device=v.device)[:, None, None]
    tx, ty = v * cos_a, v * sin_a
    sx, sy = tx.sum(0), ty.sum(0)
    scx, scy = tx.abs().sum(0), ty.abs().sum(0)
    value = torch.clamp(torch.hypot(sx, sy), max=1.0)
    robot = (((sx + sy.abs() * 2.0 ** -24).abs() <= win * scx) | (sy.abs() <= win * scy)
             | ((value - k.prox_threshold).abs() <= win * (scx + scy)))
    pre = fused_step.fused_env_step_plain(dict(tiles, sc=torch.zeros_like(tiles["sc"])),
                                          acts, draws, spawn, cfg, want_obs=False)[0]
    x, y = pre["px"].double().abs(), pre["py"].double()
    near = torch.zeros_like(x, dtype=torch.bool)
    for b in (k.gate_zone_hw, k.corr_hw):
        near |= (x - b).abs() <= win
    for b in (k.gate_south, k.corr_south, k.ni):
        near |= (y - b).abs() <= win
    return robot, near.any(0, keepdim=True)


def _pose_budget(torch, got, want, k, keep, tag):
    """How far the observation tiles may part when the kernel's new poses
    part from the plain step's (their push-out sums run in another order),
    from each robot's measured gaps δ (position, m) and δy (heading, rad),
    in float64 on the plain step's poses, to first order:
      - RAB: the term of neighbour j is Δ_ij / |Δ_ij|² in the body frame,
        whose Jacobian has norm 1/d², so it moves by at most
        (δ_i + δ_j) / d² + δy_i / d (d less the pair's gap): a pair 2e-4 m
        apart turns an ulp of position into ~1 of RAB projection;
      - proximity: a robot's reading 1 − d/(range + r) moves by
        (δ_i + δ_j) / (range + r); a wall's 1 − t/range by
        (δ_i + t·δy_i) / (range·|sin φ|), φ the angle of ray and wall.
    A switch is a tie, and its robot exempt: a neighbour within the gap of
    the RAB range or of a cone's edge, a ray within it of a wall's end.
    Prints the pairs that did switch (the plain version's own float32
    tests on both sets of poses) and the budget's largest entry with its
    cause. Returns (exempt robots (N, Ep), {tile: (rows·N, Ep) budget})."""
    poses = [tuple(t[n] for n in ("px", "py", "yaw")) for t in (got, want)]
    (kx, ky, kyaw), (px, py, pyaw) = ([a.double() for a in p] for p in poses)
    gap = torch.sqrt((kx - px) ** 2 + (ky - py) ** 2)                       # (N, Ep)
    gap_y = (kyaw - pyaw).abs()
    slack = 8 * float(np.finfo(np.float32).eps)
    N = px.shape[0]

    def pairs(x, y, yaw):
        """The RAB distances and the 8 cone tests' margins as the plain
        version computes them, [i, j] = i sees j."""
        dx, dy = x[None] - x[:, None], y[None] - y[:, None]
        d2 = dx * dx + dy * dy
        c, s_ = torch.cos(yaw), torch.sin(yaw)
        return torch.sqrt(d2 + 1e-8), [
            (k.cos_a[s] * c - k.sin_a[s] * s_)[:, None] * dx
            + (k.cos_a[s] * s_ + k.sin_a[s] * c)[:, None] * dy
            - 0.9659 * (torch.sqrt(d2 + 1e-12) + 1e-8) for s in range(8)]

    other = ~torch.eye(N, dtype=torch.bool, device=px.device)[..., None] & keep
    d, cone = pairs(px, py, pyaw)
    moved = gap[:, None] + gap[None]                                         # [i, j]
    reach = other & (d < k.prox_plus_r + moved)
    tie = other & ((d - k.rab_range).abs() <= moved + slack * k.rab_range)
    for c in cone:
        tie |= reach & (c.abs() <= 2 * moved + gap_y[:, None] * d + slack * (1 + d))
    robot = tie.any(1)                                                      # (N, Ep)

    near = (d - moved).clamp(min=1e-4)
    rab = (other & (d < k.rab_range + moved)) * (moved / near ** 2 + gap_y[:, None] / near)
    rab_i = rab.sum(1)
    prox = []
    robot_part = (reach * moved).amax(1) / k.prox_plus_r
    for s in range(8):
        wdx = k.cos_a[s] * torch.cos(pyaw) - k.sin_a[s] * torch.sin(pyaw)
        wdy = k.cos_a[s] * torch.sin(pyaw) + k.sin_a[s] * torch.cos(pyaw)
        wall = torch.zeros_like(px)
        for ax, ay, sx, sy in k.segments:
            denom = wdx * sy - wdy * sx
            length = float(np.hypot(sx, sy))
            rel_x, rel_y = ax - px, ay - py
            t = (rel_x * sy - rel_y * sx) / denom
            u = (rel_x * wdy - rel_y * wdx) / denom
            sin_phi = denom.abs() / length
            shift = (gap + t.abs() * gap_y) / sin_phi.clamp(min=1e-12)     # along the wall, m
            on = (t >= 0) & (t <= k.prox_range) & (u >= 0) & (u <= 1)
            wall = torch.where(on, torch.maximum(wall, shift / k.prox_range), wall)
            robot |= keep & (t >= 0) & (t <= k.prox_range) & (
                torch.minimum(u.abs(), (1 - u).abs()) * length <= shift + slack)
        prox.append(robot_part + wall)

    (d_k, cone_k), (d_p, cone_p) = (pairs(*p) for p in poses)
    rab_sw = other & ((d_k < k.rab_range) != (d_p < k.rab_range))
    cone_sw = reach & torch.stack([(a > 0) != (b > 0) for a, b in zip(cone_k, cone_p)]).any(0)
    for kind, sw in (("RAB range", rab_sw), ("proximity cone", cone_sw)):
        for i, j, e in sw.nonzero().tolist()[:3]:
            print(f"  {tag}: robot {i} sees robot {j} of arena {e} switch at the {kind}: "
                  f"{float(d[i, j, e]):.9f} m apart by the plain step's poses", flush=True)
    switched = rab_sw | cone_sw
    check(not bool((switched & ~tie).any()),
          f"{tag}: {int(switched.sum())} sensor switches between the two sets of poses, "
          f"each within the tie rule; {int(robot.sum())} of {int(keep.sum()) * N} robots' "
          "observations exempt")
    i, e = divmod(int(rab_i.argmax()), rab_i.shape[1])
    j = int(torch.where(other[i, :, e], d[i, :, e], torch.inf).argmin())
    print(f"  {tag}: largest RAB budget {float(rab_i[i, e]):.3e}, robot {i} of arena {e}: "
          f"robot {j} {float(d[i, j, e]):.3e} m away, pose gaps {float(gap[i, e]):.3e} and "
          f"{float(gap[j, e]):.3e} m", flush=True)
    return robot, {"prox": torch.cat(prox), "rab_proj": rab_i.repeat(4, 1)}


def _k4_counts(torch, k, args, want_obs, E):
    """What one K4 call on ``args`` (``_k4_state``'s) needs that depends on
    the data, over its first E arenas, from the plain version's arithmetic:
    for the sensor pass (on the poses given in the discrete forms, on the
    step's new poses in the continuous form with observations, none
    otherwise) the ordered pairs inside the proximity reach (0 < d_p < range
    + r), those inside the RAB range, and the (robot, wall segment) pairs
    that ``_segments_in_reach`` keeps; and the unordered pairs that touch
    (d < 2r) where the push-out starts (``fused_step.drive``'s positions)."""
    from swarmacb_torch.ops import fused_step

    tiles, acts, draws, spawn, cfg = args
    N = cfg.num_agents
    px, py, yaw = (tiles[n][:, :E] for n in ("px", "py", "yaw"))
    cos_y, sin_y = torch.cos(yaw), torch.sin(yaw)
    if cfg.discrete_actions:
        sb = fused_step.sensor_block(px, py, cos_y, sin_y, k, N)
        left, right, _ = fused_step.behaviours(
            sb, acts[:, :E], [tiles[n][:, :E] for n in fused_step.MACHINE_TILES],
            [d[:, :E] for d in draws], k)
        del sb
        sensed = (px, py)
    else:
        left, right = (a[:, :E] for a in acts)
        sensed = None
        if want_obs:
            new = fused_step.fused_env_step_plain(*args, want_obs=False)[0]
            sensed = (new["px"][:, :E], new["py"][:, :E])
    x1, y1, _ = fused_step.drive(px, py, yaw, cos_y, sin_y, left, right, k)
    off = ~torch.eye(N, dtype=torch.bool, device=px.device)[..., None]
    upper = torch.ones(N, N, dtype=torch.bool, device=px.device).triu(1)[..., None]
    out = dict(prox=0, rab=0, reach=0, touch=0)
    for e0 in range(0, E, 4096):
        sl = slice(e0, e0 + 4096)
        if sensed is not None:
            x, y = (t[:, sl] for t in sensed)
            dx, dy = x[None] - x[:, None], y[None] - y[:, None]
            d2 = dx * dx + dy * dy
            d_p = torch.sqrt(d2 + 1e-12)
            out["prox"] += int(((d_p < k.prox_plus_r) & (d_p >= 1e-4) & off).sum())
            out["rab"] += int(((torch.sqrt(d2 + 1e-8) < k.rab_range) & off).sum())
            del dx, dy, d2, d_p
        cx, cy = (t[:, sl] for t in (x1, y1))
        cdx, cdy = cx[None] - cx[:, None], cy[None] - cy[:, None]
        out["touch"] += int(((torch.sqrt(cdx * cdx + cdy * cdy + 1e-8) < k.two_r) & upper).sum())
    if sensed is not None:
        out["reach"] = _segments_in_reach(*(t.cpu().numpy() for t in sensed), k.segments,
                                          k.prox_range)
    return out


def _k4_work(E, N, n_seg, n_face, sensor_passes, want_obs, obs24, discrete, counts):
    """Bytes and float32 operations of one K4 call, the least the function
    needs on this data, ``counts`` from ``_k4_counts``. Bytes: each input
    tile read once and each output tile written once. Operations
    (transcendentals, square roots and divisions count one each) per
    sensor pass: per ordered pair of robots, the offsets and the squared
    distance (5); per pair inside the proximity reach, its distance, the
    clipped reading and the 8-ray cone test (44); per pair inside the RAB
    range, its distance, the bearing by rsqrt and its four sums (37); per
    robot and wall segment, the offset, the numerator of t and the test
    whether any ray can reach it (7); per segment that passes, the 8-ray
    intersection (178); per robot, the ray directions (48), the light
    sensor (66) and the aggregates (78). Per robot once: the behaviour
    modules (120, discrete), integration and wrap (12), the face push-out
    (9 per face), the gate clamp (16), the ground colours and reward (14).
    The push-out: per unordered pair, the offsets, the squared distance
    and its test (6); per pair that touches, the push into both sums
    (10)."""
    sensor = (5 * E * N * (N - 1) + 44 * counts["prox"] + 37 * counts["rab"]
              + 7 * E * N * n_seg + 178 * counts["reach"] + E * N * (48 + 66 + 78))
    robot = (120 if discrete else 0) + 12 + 9 * n_face + 16 + 14
    flops = (sensor_passes * sensor + E * N * robot + 6 * E * N * (N - 1) // 2
             + 10 * counts["touch"])
    rows_in = 4 + (9 + 4 if discrete else 2) + 3                  # N-row tiles
    rows_out = 4 + (9 if discrete else 0)
    if want_obs:
        rows_out += 21 if obs24 else 1
    n_bytes = 4 * E * (N * (rows_in + rows_out) + 3 + 5)
    return n_bytes, flops


def _k4_free_run(torch, fn, env, k, tiles, rng_seed, steps):
    """``steps`` steps of ``fn`` (the kernel's wrapper or the plain
    version) from ``tiles``, with draws from a generator of ``rng_seed``
    and the same module ids or wheels each step."""
    from swarmacb_torch.env.behaviors import draw_durations

    cfg = env.cfg
    N, Ep = tiles["px"].shape
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(rng_seed)
    cur = dict(tiles)
    for _ in range(steps):
        if cfg.discrete_actions:
            acts = torch.randint(0, 6, (N, Ep), generator=gen, device=DEVICE,
                                 dtype=torch.int32)
            draws = tuple(draw_durations(gen, (N, Ep), DEVICE) for _ in range(3))
        else:
            acts = tuple((torch.rand((N, Ep), generator=gen, device=DEVICE) * 2 - 1)
                         * cfg.max_wheel_speed for _ in range(2))
            draws = ()
        spos, syaw = env._sample_spawn(gen, (N, Ep))
        spawn = (spos[..., 0].contiguous(), spos[..., 1].contiguous(), syaw)
        new = fn(cur, acts, draws, spawn, cfg, want_obs=False)[0]
        cur = dict(cur, **new)
    return cur


def _k4_hold(torch, ops, variant, want_obs, E, N, tag, pose_budget=False):
    """K4 (``ops.fused_env_step``, whichever route N takes) against its plain
    version in one form at (E, N), from ``_k4_state``: two calls the same
    bits, integer and boolean tiles exact but for ties, floats within
    K4_TOL, some arenas reset. With ``pose_budget``, the continuous form's
    observation tiles (of the new poses, which the wide route's push-out
    sums, run in another order, part from the plain step's in the last
    bits) are held to the plain step's within K4_TOL plus
    ``_pose_budget``'s first-order effect of those gaps, a robot at a
    sensor switch exempt, and to the plain sensors of the kernel's own
    poses within K4_TOL; the max |Δ| returned takes the latter.
    Returns (env, constants, args, max |Δ|)."""
    from swarmacb_torch.ops import fused_step

    env, k, tiles, acts, draws, spawn = _k4_state(torch, variant, E, N, SEED + 11)
    cfg = env.cfg
    args = (tiles, acts, draws, spawn, cfg)
    got = ops.fused_env_step(*args, want_obs=want_obs)
    again = ops.fused_env_step(*args, want_obs=want_obs)
    want = fused_step.fused_env_step_plain(*args, want_obs=want_obs)
    torch.cuda.synchronize()
    flat = lambda out: [*out[0].values(), out[1], out[2], *out[3]]  # noqa: E731
    check(all(bool(torch.equal(a, b)) for a, b in zip(flat(got), flat(again))),
          f"{tag}: two calls give the same bits")
    robot_tie, arena_tie = _k4_ties(torch, k, *args, want_obs)
    exempt, stray, off = 0, [], torch.zeros_like(robot_tie)
    ints = [(n, robot_tie) for n in fused_step.MACHINE_TILES if n in got[0]]
    ints += [(n, arena_tie) for n in ("sc", "er", "cg", "prev")]
    for name, tie in ints + [("reward", arena_tie), ("done", arena_tie)]:
        g = got[0][name] if name in got[0] else got[1 if name == "reward" else 2]
        w = want[0][name] if name in want[0] else want[1 if name == "reward" else 2]
        bad = g != w
        exempt += int((bad & tie.expand_as(bad)).sum())
        if bool((bad & ~tie.expand_as(bad)).any()):
            stray.append(name)
        off |= bad.any(0, keepdim=True) if bad.shape[0] == 1 else bad
    check(not stray, f"{tag}: integer and boolean tiles equal to the plain "
                     f"version's ({exempt} tie exemptions within {K4_TIE_ULPS} "
                     f"ulps; mismatches away from a tie: {stray or 'none'})")
    keep = ~off.any(0)
    worst = 0.0
    floats = [(n, got[0][n], want[0][n]) for n in ("px", "py", "yaw")]
    names = (("prox", "light", "ztilde", "rab_proj") if len(got[3]) == 4
             else ("ztilde",))
    floats += list(zip(names, got[3], want[3]))
    # the continuous form's observations are of the new poses (the discrete
    # forms' of the poses given, the same on both sides)
    pose_budget = pose_budget and want_obs and not cfg.discrete_actions
    obs_tie, budget = torch.zeros_like(robot_tie), {}
    if pose_budget:
        obs_tie, budget = _pose_budget(torch, got[0], want[0], k, keep, tag)
    for name, g, w in floats:
        rtol = 2e-5 if name == "rab_proj" else 0.0
        sel = keep.expand_as(g)
        rule = f"{K4_TOL[name]:g} + {rtol:g}·|plain|"
        if name in names and pose_budget:
            # (rows·N, Ep) observation tiles, robot-major within a row
            sel = sel & ~obs_tie.repeat(g.shape[0] // N, 1)
            b = budget.get(name, torch.zeros_like(w, dtype=torch.float64))
            diff = (g.double() - w.double()).abs()
            limit = K4_TOL[name] + rtol * w.double().abs() + b
            err, ok = float(diff[sel].max()), bool((diff <= limit)[sel].all())
            rule += " + the pose gaps' budget" if name in budget else ""
            if name in budget:
                print(f"  {tag} {name}: largest budget {float(b[sel].max()):.3e}, median "
                      f"{float(b[sel].median()):.3e}", flush=True)
        else:
            err, ok = max_err(g[sel], w[sel], K4_TOL[name], rtol)
            worst = max(worst, err)
        check(ok and g.shape == w.shape,
              f"{tag} {name} {tuple(g.shape)}: max|Δ| {err:.3e} (tolerance {rule})")
    if pose_budget:
        # the kernel's sensors on its own poses: the plain sensors of those
        # poses, to K4_TOL
        sb = fused_step.sensor_block(got[0]["px"], got[0]["py"], torch.cos(got[0]["yaw"]),
                                     torch.sin(got[0]["yaw"]), k, N)
        own = fused_step._obs_tiles(sb, k, variant in ("dandelion", "daisy"))
        for name, g, w in zip(names, got[3], own):
            rtol = 2e-5 if name == "rab_proj" else 0.0
            err, ok = max_err(g[:, keep], w[:, keep], K4_TOL[name], rtol)
            worst = max(worst, err)
            check(ok, f"{tag} {name}: max|Δ| {err:.3e} against the plain sensors of the "
                      f"kernel's own poses (tolerance {K4_TOL[name]:g} + {rtol:g}·|plain|)")
    dones = int(got[2].sum())
    moved = int((got[0]["es"] != tiles["es"]).sum()) if "es" in tiles else -1
    check(dones > 0, f"{tag}: {dones} arenas reset, "
                     f"{float(got[1].abs().sum()):.0f} reward counts, {moved} "
                     "exploration latches moved")
    del got, again, want
    return env, k, args, worst


def phase_fused_step(torch, ops, cycles_per_ms):
    """K4 against its plain version in each of its four compiled forms at
    E_MAIN, in the fused rollout's form (daisy, with observations) at
    E_BENCH, and at K4_RAGGED's shapes (held, not timed)."""
    from swarmacb_torch.ops import _cuda, fused_step

    forms = {}
    for variant, want_obs, E, N in (*((v, w, E_MAIN, N_MAIN) for v, w in K4_FORMS),
                                    ("daisy", True, E_BENCH, N_MAIN), *K4_RAGGED):
        tag = f"K4 {variant} E={E} N={N}"
        print(f"== phase 2g: K4 fused_env_step, {variant}"
              f"{'' if want_obs else ', want_obs=False'} (E={E}, N={N})", flush=True)
        if not forms:
            for name, info in ptxas_report(_cuda.build_log("fused_step"),
                                           ("fused_step_kernel",)).items():
                print(f"  ptxas {name}: {info}", flush=True)
        env, k, args, worst = _k4_hold(torch, ops, variant, want_obs, E, N, tag)
        cfg, tiles = env.cfg, args[0]
        forms[(variant, want_obs, E, N)] = dict(max_abs_err=worst)
        if N != N_MAIN:   # a ragged shape: held, not timed
            continue
        ms = device_ms(torch, lambda: ops.fused_env_step(*args, want_obs=want_obs),
                       cycles_per_ms)
        n_bytes, n_flops = _k4_work(
            E, N, len(k.segments), len(k.faces),
            1 if (cfg.discrete_actions or want_obs) else 0, want_obs,
            variant in ("dandelion", "daisy"), cfg.discrete_actions,
            _k4_counts(torch, k, args, want_obs, E))
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        forms[(variant, want_obs, E, N)].update(ms=ms, bound_ms=b_ms, bound_by=b_by)
        work = f"bound {b_ms:.6f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, {n_flops / 1e9:.4f} GFLOP)"
        if E != E_MAIN:   # the plain version is not timed at 32 times the size
            print(f"  K4 {variant} E={E} kernel {ms:.4f} ms, {work}", flush=True)
            continue
        plain = device_ms(torch, lambda: fused_step.fused_env_step_plain(
            *args, want_obs=want_obs), cycles_per_ms)
        forms[(variant, want_obs, E, N)]["plain_ms"] = plain
        print(f"  K4 {variant}{'' if want_obs else ' (no obs)'} kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, {work}; no single PyTorch call computes this function, so "
              "there is no library time", flush=True)
        # information, not a gate: where two float orders take a chaotic
        # trajectory apart
        a = _k4_free_run(torch, ops.fused_env_step, env, k, tiles, SEED + 12, K4_FREE_STEPS)
        b = _k4_free_run(torch, fused_step.fused_env_step_plain, env, k, tiles,
                         SEED + 12, K4_FREE_STEPS)
        gap = max(float((a[n] - b[n]).abs().max()) for n in ("px", "py"))
        n_int = sum(int((a[n] != b[n]).sum()) for n in a
                    if torch.is_tensor(a[n]) and a[n].dtype == torch.int32)
        print(f"  K4 {variant} free run of {K4_FREE_STEPS} steps, kernel against plain: "
              f"largest position gap {gap:.3e} m, {n_int} integer tile entries differ",
              flush=True)
    # the JSON row: the form the main path (the fused daisy rollout) runs,
    # with observations; the error is the largest over every form and shape
    return [dict(name="fused_env_step", route="cuda",
                 source="swarmacb_torch/ops/csrc/fused_step.cu",
                 replaces="swarmacb_tpu/ops/fused_step.py:530", library_ms=None,
                 **{**forms[("daisy", True, E_MAIN, N_MAIN)],
                    "max_abs_err": max(f["max_abs_err"] for f in forms.values())},
                 **_bench_keys(forms[("daisy", True, E_BENCH, N_MAIN)]))]


# ── phase 2i: the env kernels' wide route ────────────────────────────────

N_WIDE = 64                         # robots of the timed wide shapes
# (E, N) of phase 2i: one arena past the tuned kernels' 32 robots, a ragged
# E, the timed shape, a count just past a K4-wide block's 64 robot rows and
# K1-wide's word of 64 neighbours, and one of two passes and two words
WIDE_ENV_SHAPES = ((1, 33), (37, 40), (E_MAIN, N_WIDE), (3, 65), (5, 100))
# thousands of robots for K1 and K2, and K4 past its shared-memory staging
# (its block buffers live in a global scratch past 256 robots): held, not
# timed
WIDE_ENV_GLOBAL = {"K1": (2, 4100), "K2": (2, 4100), "K4": (3, 300)}
WIDE_ENV_KERNELS = {"pairwise_wide": ("pairwise_sensors_wide_kernel",
                                      "robot_collisions_wide_kernel"),
                    "fused_step_wide": ("fused_step_wide_kernel",)}
N_LANES_RUN, LANES_RUN_STEPS = 40, 20  # 2i's daisy step_lanes run at E_MAIN
K1_TOL = {"prox": (1e-6, 0.0), "ztilde": (1e-6, 0.0), "rab_proj": (1e-5, 1e-5),
          "attr_x": (1e-5, 1e-5), "attr_y": (1e-5, 1e-5)}


def _rab_term_scale(torch, pos, cfg):
    """Per robot (E, N), in float64, the sums of the magnitudes of K1's RAB
    terms: Σ_j 1/(d_ij + ε) over the neighbours in range (for rab_proj, a
    unit vector's projection of that sum) and Σ_j α/(1 + d_ij) (for the
    attraction vector). Two float32 sums of n terms in different orders
    differ by up to about n·2⁻²⁴ of the sum of their terms' magnitudes,
    which K1-wide's tolerance takes in place of |plain|: a near pair's 1/d
    terms cancel, and the sum of up to 63 of them can be far below them."""
    out = {"rab_proj": 0.0, "attr_x": 0.0, "attr_y": 0.0}
    parts = []
    for e0 in range(0, pos.shape[0], 1024):
        p = pos[e0:e0 + 1024].double()
        d = torch.sqrt(((p[:, None] - p[:, :, None]) ** 2).sum(-1) + 1e-8)
        eye = torch.eye(p.shape[1], dtype=torch.bool, device=p.device)
        on = (d < cfg.rab_range) & ~eye
        parts.append(((on / (d + 1e-8)).sum(-1), (on * cfg.alpha_parameter / (1 + d)).sum(-1)))
    w = torch.cat([a for a, _ in parts])
    a = torch.cat([b for _, b in parts])
    out.update(rab_proj=w, attr_x=a, attr_y=a)
    return out


def _grid_poses(rng, cfg, E, N, pitch=0.15):
    """Robots on a square grid of ``pitch`` about the arena's centre,
    jittered by up to 0.03, headings uniform: a few neighbours each within
    the sensors' reach, walls in reach of the middle ones."""
    side = int(np.ceil(np.sqrt(N)))
    k = np.arange(N)
    grid = (np.stack([k % side, k // side], -1) - (side - 1) / 2) * pitch
    pos = (grid[None] + rng.uniform(-0.03, 0.03, (E, N, 2))).astype(np.float32)
    return pos, rng.uniform(-np.pi, np.pi, (E, N)).astype(np.float32)


def _routed(torch, ops, fn, wide_name, tuned_name, what):
    """``fn()`` from counts of 0, checking that it launched the wide
    kernel once and the tuned one never."""
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    n_wide, n_tuned = ops.launches[wide_name], ops.launches[tuned_name]
    check(n_wide == 1 and n_tuned == 0,
          f"{what}: the wide route ran ({wide_name} {n_wide}, {tuned_name} {n_tuned})")
    return out


def phase_env_wide(torch, ops, cfg, walls, cycles_per_ms):
    """K1, K2 and K4 at robot counts past the tuned kernels' 32
    (``pairwise_wide.cu``, ``fused_step_wide.cu``), through ``ops``: each
    against its plain version at WIDE_ENV_SHAPES and WIDE_ENV_GLOBAL, two
    calls bit for bit, the wide counter moved and the tuned one not; each
    also at (E_BENCH, N_WIDE) (K4 in daisy's form with observations); each
    timed at (E_MAIN, N_WIDE) beside its plain version and its bound (K2
    also on packed inputs), and at (E_BENCH, N_WIDE) beside its bound; then
    LANES_RUN_STEPS daisy ``step_lanes`` steps at N_LANES_RUN, each one
    K4-wide launch. Returns the JSON rows and that run's launches."""
    from swarmacb_torch.config import DirectionalGateEnvCfg
    from swarmacb_torch.env import DirectionalGateEnv, lanes, physics
    from swarmacb_torch.ops import _cuda, fused_step, pairwise

    t0 = time.perf_counter()
    print(f"== phase 2i: the env kernels' wide route (pairwise_wide.cu, fused_step_wide.cu) at "
          f"(E, N) in {WIDE_ENV_SHAPES}, at {WIDE_ENV_GLOBAL}, and at ({E_BENCH}, {N_WIDE})", flush=True)
    for source, kernels in WIDE_ENV_KERNELS.items():
        for name, info in ptxas_report(_cuda.build_log(source), kernels).items():
            print(f"  ptxas {source} {name}: {info}", flush=True)
    kw = dict(prox_range=cfg.prox_range, robot_radius=cfg.robot_radius,
              rab_range=cfg.rab_range, alpha_rab=cfg.alpha_parameter, wall_segments=walls)
    r = cfg.robot_radius
    err = {"K1": 0.0, "K2": 0.0, "K4": 0.0}
    timed = {}

    def k1_at(E, N, poses=_arena_poses):
        pos_np, yaw_np = poses(np.random.default_rng(SEED), cfg, E, N)
        pos, yaw = (torch.from_numpy(a).to(DEVICE) for a in (pos_np, yaw_np))
        call = lambda: ops.pairwise_sensors(pos, yaw, **kw)  # noqa: E731
        got = _routed(torch, ops, call, "pairwise_sensors_wide", "pairwise_sensors",
                      f"K1 E={E} N={N}")
        again = call()
        want = pairwise.pairwise_sensors_plain(pos, yaw, **kw)
        torch.cuda.synchronize()
        scale = _rab_term_scale(torch, pos, cfg)
        for (name, (atol, rtol)), g, w in zip(K1_TOL.items(), got, want):
            if name in scale:   # a sum of up to N − 1 terms, in another order
                s_ = scale[name].reshape(w.shape[:2] + (1,) * (w.dim() - 2)).expand_as(w)
                diff = (g.double() - w.double()).abs()
                e, ok = float(diff.max()), bool((diff <= atol + rtol * s_).all())
                rule = f"{atol:g} + {rtol:g}·Σ|term|"
            else:
                e, ok = max_err(g, w, atol, rtol)
                rule = f"{atol:g} + {rtol:g}·|plain|"
            err["K1"] = max(err["K1"], e)
            check(ok and g.shape == w.shape, f"K1-wide E={E} N={N} {name} {tuple(g.shape)}: "
                  f"max|Δ| {e:.3e} (tolerance {rule})")
        check(all(bool(torch.equal(a, b)) for a, b in zip(got, again))
              and float(got[0].max()) > 0 and float(got[2].abs().max()) > 0,
              f"K1-wide E={E} N={N}: two calls give the same bits; readings non-trivial")
        del got, again, want
        if N == N_WIDE:
            b_ms, b_by = bound_ms(*_sensor_work(pos_np, yaw_np, cfg, walls.cpu().numpy()))
            t = dict(ms=device_ms(torch, call, cycles_per_ms), bound_ms=b_ms, bound_by=b_by)
            if E == E_MAIN:
                t["plain_ms"] = device_ms(
                    torch, lambda: pairwise.pairwise_sensors_plain(pos, yaw, **kw),
                    cycles_per_ms)
            timed[("K1", E)] = t
            print(f"  K1-wide E={E} N={N}: kernel {t['ms']:.4f} ms"
                  + (f", plain {t['plain_ms']:.4f} ms" if "plain_ms" in t else "")
                  + f", bound {b_ms:.6f} ms ({b_by})", flush=True)

    def k2_at(E, N, kinds=("spread", "packed", "tie")):
        for kind, p_np in _collision_inputs(cfg, E, N).items():
            if kind not in kinds:
                continue
            p = torch.from_numpy(p_np).to(DEVICE)
            call = lambda: ops.resolve_robot_collisions(p, r)  # noqa: E731
            got = _routed(torch, ops, call, "resolve_robot_collisions_wide",
                          "resolve_robot_collisions", f"K2 E={E} N={N} {kind}")
            again = call()
            want = physics.resolve_robot_collisions(p, r)
            torch.cuda.synchronize()
            e, ok = max_err(got, want, 1e-6, 0.0)
            err["K2"] = max(err["K2"], e)
            moved = float((got - p).abs().max())
            check(ok and bool(torch.equal(got, again)) and moved > 1e-4,
                  f"K2-wide E={E} N={N} {kind}: max|Δ| {e:.3e} (tolerance 1e-06), two calls "
                  f"bit-identical, largest push {moved:.3e}")
            del got, again, want
            # timed on spread inputs at both E, and at E_MAIN on packed ones,
            # the mark loops' worst case (most pairs touch)
            if N == N_WIDE and (kind == "spread" or (kind == "packed" and E == E_MAIN)):
                b_ms, b_by = bound_ms(*_collision_work(p_np, r))
                t = dict(ms=device_ms(torch, call, cycles_per_ms), bound_ms=b_ms, bound_by=b_by)
                if E == E_MAIN:
                    t["plain_ms"] = device_ms(
                        torch, lambda: physics.resolve_robot_collisions(p, r), cycles_per_ms)
                timed[("K2" if kind == "spread" else "K2 packed", E)] = t
                print(f"  K2-wide E={E} N={N} {kind}: kernel {t['ms']:.4f} ms"
                      + (f", plain {t['plain_ms']:.4f} ms" if "plain_ms" in t else "")
                      + f", bound {b_ms:.6f} ms ({b_by})", flush=True)

    def k4_at(variant, want_obs, E, N):
        tag = f"K4-wide {variant}{'' if want_obs else ' (no obs)'} E={E} N={N}"
        ops.reset_launches()
        env, k, args, e = _k4_hold(torch, ops, variant, want_obs, E, N, tag, pose_budget=True)
        err["K4"] = max(err["K4"], e)
        check(ops.launches["fused_env_step_wide"] == 2 and ops.launches["fused_env_step"] == 0,
              f"{tag}: the wide route ran (fused_env_step_wide "
              f"{ops.launches['fused_env_step_wide']}, fused_env_step "
              f"{ops.launches['fused_env_step']})")
        if N != N_WIDE or not want_obs or variant != "daisy":
            return
        counts = _k4_counts(torch, k, args, True, E)
        n_bytes, n_flops = _k4_work(E, N, len(k.segments), len(k.faces), 1, True, True,
                                    env.cfg.discrete_actions, counts)
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        t = dict(ms=device_ms(torch, lambda: ops.fused_env_step(*args), cycles_per_ms),
                 bound_ms=b_ms, bound_by=b_by)
        if E == E_MAIN:   # the plain version is not timed at 32 times the size
            t["plain_ms"] = device_ms(torch, lambda: fused_step.fused_env_step_plain(*args),
                                      cycles_per_ms)
        timed[("K4", E)] = t
        print(f"  K4-wide daisy E={E} N={N}: kernel {t['ms']:.4f} ms"
              + (f", plain {t['plain_ms']:.4f} ms" if "plain_ms" in t else "")
              + f", bound {b_ms:.6f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, "
              f"{n_flops / 1e9:.4f} GFLOP; pairs in proximity reach {counts['prox']}, in RAB "
              f"range {counts['rab']}, touching {counts['touch']}; robot-segment pairs in "
              f"reach {counts['reach']} of {E * N * len(k.segments)})", flush=True)

    for E, N in WIDE_ENV_SHAPES:
        k1_at(E, N)
        k2_at(E, N)
        k4_at("daisy", True, E, N)
    for variant, want_obs in K4_FORMS[1:]:
        k4_at(variant, want_obs, *WIDE_ENV_SHAPES[1])
    k1_at(E_BENCH, N_WIDE)
    k2_at(E_BENCH, N_WIDE)
    k4_at("daisy", True, E_BENCH, N_WIDE)
    # thousands of robots: K1 on a grid, whose sums stay short, K2 on spread
    # and tie positions (packed, each push would sum thousands of overlaps)
    k1_at(*WIDE_ENV_GLOBAL["K1"], poses=_grid_poses)
    k2_at(*WIDE_ENV_GLOBAL["K2"], kinds=("spread", "tie"))
    # K2-wide: robots off the finite plane give NaN where the plain version
    # does, and positions that are not 8-byte aligned are refused (the
    # kernel loads a robot as one float2)
    E, N = WIDE_ENV_SHAPES[1]
    p_np = _collision_inputs(cfg, E, N)["tie"]
    p_np[1, 0, 0], p_np[3, 2, 1], p_np[2, N - 1, 0] = np.nan, np.inf, -np.inf
    p = torch.from_numpy(p_np).to(DEVICE)
    got, want = ops.resolve_robot_collisions(p, r), physics.resolve_robot_collisions(p, r)
    fin = ~want.isnan()
    e, ok = max_err(got[fin], want[fin], 1e-6, 0.0)
    err["K2"] = max(err["K2"], e)
    check(bool(torch.equal(got.isnan(), want.isnan())) and ok,
          f"K2-wide E={E} N={N} with a NaN and two infinite coordinates: NaN in the same "
          f"{int(want.isnan().sum())} places as the plain version, elsewhere max|Δ| {e:.3e}")
    odd = torch.empty(2 * E * N + 1, device=DEVICE)[1:].view(E, N, 2)
    try:
        ops.resolve_robot_collisions(odd, r)
        refused = False
    except ValueError:
        refused = True
    check(refused, "K2-wide refuses positions that are not 8-byte aligned")
    k4_at("daisy", True, *WIDE_ENV_GLOBAL["K4"])

    # a daisy run on the fused env path at N_LANES_RUN robots: K4-wide alone
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="daisy", num_envs=E_MAIN,
                                                   num_agents=N_LANES_RUN), device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 21)
    st, _ = env.reset(gen)
    cur = lanes.state_to_lanes(env, st)
    ids = lanes.actions_to_lanes(env, torch.randint(
        0, 6, (E_MAIN, N_LANES_RUN), generator=gen, device=DEVICE, dtype=torch.int32))
    torch.cuda.synchronize()
    ops.reset_launches()
    for _ in range(LANES_RUN_STEPS):
        cur, reward, done, obs = lanes.step_lanes(env, cur, ids)
    torch.cuda.synchronize()
    run = {k: v for k, v in ops.launches.items() if v}
    finite = all(bool(torch.isfinite(t).all()) for t in (cur["px"], cur["py"], *obs))
    check(run == {"fused_env_step_wide": LANES_RUN_STEPS} and finite,
          f"daisy step_lanes, E={E_MAIN} N={N_LANES_RUN}, {LANES_RUN_STEPS} steps: launches "
          f"{run}, positions and observations finite")
    print(f"  phase 2i {time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    for key, name, source, replaces in (
            ("K1", "pairwise_sensors_wide", "pairwise_wide.cu", "pairwise.py:145"),
            ("K2", "resolve_robot_collisions_wide", "pairwise_wide.cu", "pairwise.py:246"),
            ("K4", "fused_env_step_wide", "fused_step_wide.cu", "fused_step.py:530")):
        row = dict(name=name, route="cuda", source=f"swarmacb_torch/ops/csrc/{source}",
                   replaces=f"swarmacb_tpu/ops/{replaces}", library_ms=None,
                   max_abs_err=err[key], **timed[(key, E_MAIN)])
        if (key, E_BENCH) in timed:
            row.update(_bench_keys(timed[(key, E_BENCH)]))
        if (f"{key} packed", E_MAIN) in timed:   # K2 on packed inputs
            packed = timed[(f"{key} packed", E_MAIN)]
            row.update(packed_ms=packed["ms"], packed_bound_ms=packed["bound_ms"])
        rows.append(row)
    return rows, run


# ── phase 3: the slice ───────────────────────────────────────────────────

def _finite(torch, name, t):
    check(bool(torch.isfinite(t).all()), f"{name} {tuple(t.shape)} is finite")


def _critic_launches(fused_attention, forward, backward):
    """Expected launches of the critic's kernels: ``forward`` passes of
    all_baselines and ``backward`` passes of its gradient, on one path."""
    on, off = (("fused_cf_attention", "fused_tail") if fused_attention
               else ("fused_tail", "fused_cf_attention"))
    return {on: forward, f"{on}_bwd": backward, off: 0, f"{off}_bwd": 0}


def dandelion_trainer(label, **overrides):
    """``configs/DirGate_dandelion.yaml`` through the port's loader, cut to
    E_MAIN arenas and a HORIZON-decision rollout, with ``overrides`` of its
    POCAConfig; the env and the trainer on the card, their default."""
    from swarmacb_torch.agents import POCATrainer
    from swarmacb_torch.config import DirectionalGateEnvCfg, load_config
    from swarmacb_torch.env import DirectionalGateEnv

    run, variant, pcfg, env_ov = load_config(ROOT / "configs" / "DirGate_dandelion.yaml")
    options = ", ".join(f"{k}={v}" for k, v in overrides.items() if v)
    print(f"== phase {label}: the slice, {run} ({variant}{', ' + options if options else ''}):"
          f" cut from num_envs={env_ov.get('num_envs')}, time_horizon={pcfg.horizon} to "
          f"num_envs={E_MAIN}, horizon={HORIZON}; hidden {pcfg.hidden_dim}x{pcfg.num_layers}",
          flush=True)
    pcfg = dataclasses.replace(pcfg, horizon=HORIZON, seed=SEED, **overrides)
    env_kw = {k: v for k, v in env_ov.items() if k != "num_envs"}
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=E_MAIN,
                                                   **env_kw))
    trainer = POCATrainer(env, pcfg)
    check(env.device.type == DEVICE and trainer.device.type == DEVICE,
          f"entry points default to the card ({env.device})")
    return trainer


def phase_slice(torch, ops, card, fused_attention=False):
    trainer = dandelion_trainer("3d" if fused_attention else "3",
                                fused_attention=fused_attention)
    env = trainer.env
    pcfg = trainer.cfg
    E, N, T, dp = env.num_envs, env.num_agents, HORIZON, pcfg.decision_period
    gen = torch.Generator(device=DEVICE)

    # warm-up (cuBLAS handles, allocator pools): not counted
    gen.manual_seed(SEED + 100)
    st, obs = env.reset(gen)
    trainer.rollout(st, obs, trainer.init_actor_carry(), length=2)
    torch.cuda.synchronize()

    # the main path: counts from 0 just before, read just after
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    st, obs = env.reset(gen)
    st, obs, _, rollout, bootstrap, aux = trainer.rollout(st, obs, ())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    expect = {"pairwise_sensors": 1 + T * dp, "resolve_robot_collisions": T * dp,
              "fused_env_step": 0, **_critic_launches(fused_attention, T, 0)}
    for name, n in expect.items():
        check(launches[name] == n,
              f"{name} launched {launches[name]} times in the rollout "
              f"(expected {n})")
    shapes = {"obs": (T, E, N, 24), "critic_states": (T, E, N, 5),
              "actions": (T, E, N, 2), "log_probs": (T, E, N, 2),
              "rewards": (T, E), "dones": (T, E), "team_values": (T, E),
              "baselines": (T, E, N)}
    for name, t in rollout.items():
        check(tuple(t.shape) == shapes[name], f"rollout.{name} shape {tuple(t.shape)}")
        _finite(torch, f"rollout.{name}", t)
    _finite(torch, "bootstrap value", bootstrap)
    _finite(torch, "final obs", obs)
    decisions = T * E * N
    print(f"  rollout of {T} decisions x {E} arenas x {N} robots (+ reset and "
          f"bootstrap): {wall:.3f} s, {decisions / wall:,.0f} agent-decisions/s "
          f"on {card}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"  mean team value {float(rollout.team_values.mean()):.4f}, "
          f"mean baseline {float(rollout.baselines.mean()):.4f}, "
          f"rewards {float(rollout.rewards.sum()):.0f}", flush=True)
    return trainer


def _minibatches(trainer) -> list[tuple[int, int]]:
    """(rows, groups per row) of each minibatch of one epoch, in the
    update's order: for the recurrent actor the windows of each length L
    in sorted(L) order, else the T·E groups; the last of each the
    remainder."""
    E = trainer.num_envs
    rows = ({L: len(s) * E for L, s in sorted(trainer._window_groups().items())}
            if trainer.recurrent else {1: trainer.cfg.horizon * E})
    out = []
    for per_row, n in rows.items():
        size = trainer._minibatch_rows(n, per_row)
        out += [(size, per_row)] * (n // size) + ([(n % size, per_row)] if n % size else [])
    return out


def _chunk_passes(trainer):
    """Gradient passes (chunk forward + backward) of one update: per epoch,
    each minibatch's ``_grad_chunks``."""
    return trainer.cfg.num_epochs * sum(trainer._grad_chunks(n, per_row)
                                        for n, per_row in _minibatches(trainer))


def phase_train(torch, ops, card, trainer, label=None):
    """One training iteration on the main path: reset, rollout, update.
    Returns (launches, wall seconds)."""
    env, c = trainer.env, trainer.cfg
    E, N, T, dp = env.num_envs, env.num_agents, c.horizon, c.decision_period
    passes = _chunk_passes(trainer)
    fused = trainer.critic.fused_attention
    label = label or ("3d" if fused else "3c")
    precision = (f", mixed_precision (bf16 {c.mp_stages})" if c.mixed_precision else "")
    print(f"== phase {label}: one training iteration"
          f"{' with fused_attention' if fused else ''}{precision}, E={E}, T={T}: minibatch "
          f"{trainer.group_mb} groups, chunks of {trainer._chunk_rows(trainer.group_mb)}"
          f" groups, {c.num_epochs} epochs = {passes} chunk passes", flush=True)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 1)
    params = [*trainer.actor.parameters(), *trainer.critic.parameters()]
    before = [p.detach().clone() for p in params]
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts from 0 just before, read just after
    ops.reset_launches()
    st, obs = env.reset(gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, obs, _, metrics = trainer.train_iteration(st, obs, ())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    expect = {"pairwise_sensors": 1 + T * dp, "resolve_robot_collisions": T * dp,
              "fused_env_step": 0, **_critic_launches(fused, T + passes, passes)}
    for name, n in expect.items():
        check(launches[name] == n,
              f"{name} launched {launches[name]} times in the training iteration "
              f"(expected {n})")
    for k, v in metrics.items():
        check(bool(np.isfinite(v)), f"metric {k} = {v:.6g} is finite")
    check(all(bool(torch.isfinite(p).all()) for p in params), "every parameter is finite")
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(params, before))
    check(moved > 0, f"the update moved the parameters (largest change {moved:.3e})")
    _finite(torch, "final obs", obs)
    decisions = T * E * N
    print(f"  training iteration of {T} decisions x {E} arenas x {N} robots "
          f"(rollout, bootstrap, update): {wall:.3f} s, "
          f"{decisions / wall:,.0f} training agent-decisions/s on {card}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print("  " + ", ".join(f"{k} {v:.5g}" for k, v in metrics.items()), flush=True)
    return launches, wall


def phase_cyclamen(torch, ops, card):
    """The recurrent slice: one cyclamen training iteration (the LSTM actor,
    BPTT over windows of the YAML's 64 decisions) at the smoke cut, through
    ``train_iteration``, with its wall time split between the rollout and
    the update."""
    from swarmacb_torch.agents import POCATrainer
    from swarmacb_torch.config import DirectionalGateEnvCfg, load_config
    from swarmacb_torch.env import DirectionalGateEnv

    run, variant, pcfg, env_ov = load_config(ROOT / "configs" / "DirGate_cyclamen.yaml")
    yaml_horizon = pcfg.horizon
    pcfg = dataclasses.replace(pcfg, horizon=HORIZON, seed=SEED)
    env_kw = {k: v for k, v in env_ov.items() if k != "num_envs"}
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=E_MAIN,
                                                   **env_kw))
    trainer = POCATrainer(env, pcfg)
    E, N, T, dp = env.num_envs, env.num_agents, HORIZON, pcfg.decision_period
    mbs = _minibatches(trainer)
    passes, steps = _chunk_passes(trainer), pcfg.num_epochs * len(mbs)
    groups = {L: len(s) * E for L, s in sorted(trainer._window_groups().items())}
    print(f"== phase 3g: the recurrent slice, {run} ({variant}): cut from num_envs="
          f"{env_ov.get('num_envs')}, time_horizon={yaml_horizon} to "
          f"num_envs={E}, horizon={T}; hidden {pcfg.hidden_dim}x{pcfg.num_layers}, LSTM "
          f"memory {pcfg.memory_size}, windows of {pcfg.sequence_length}: "
          f"{groups} windows by length; minibatch {trainer.group_mb} groups, chunks of "
          f"{pcfg.accum_chunk_groups} groups; minibatches (windows, length) {mbs}; "
          f"{passes} chunk passes and {steps} Adam steps in {pcfg.num_epochs} epochs",
          flush=True)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 100)
    st, obs = env.reset(gen)
    trainer.rollout(st, obs, trainer.init_actor_carry(), length=2)     # warm-up
    torch.cuda.synchronize()
    params = [*trainer.actor.parameters(), *trainer.critic.parameters()]
    before = [p.detach().clone() for p in params]
    rollout_s = []
    collect = trainer.collect

    def timed_collect(*args, **kwargs):
        t_roll = time.perf_counter()
        out = collect(*args, **kwargs)
        torch.cuda.synchronize()
        rollout_s.append(time.perf_counter() - t_roll)
        return out

    trainer.collect = timed_collect
    gen.manual_seed(SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from 0 just before, read just after
    ops.reset_launches()
    st, obs = env.reset(gen)
    carry = trainer.init_actor_carry()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, obs, carry, metrics = trainer.train_iteration(st, obs, carry)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    del trainer.collect
    expect = {"pairwise_sensors": 1 + T * dp, "resolve_robot_collisions": T * dp,
              "fused_env_step": 0, **_critic_launches(False, T + passes, passes)}
    for name, n in expect.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times in the "
                                   f"cyclamen training iteration (expected {n})")
    for k, v in metrics.items():
        check(bool(np.isfinite(v)), f"metric {k} = {v:.6g} is finite")
    check(all(bool(torch.isfinite(p).all()) for p in params), "every parameter is finite")
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(params, before))
    check(moved > 0, f"the update moved the parameters (largest change {moved:.3e})")
    check(all(tuple(x.shape) == (E * N, pcfg.memory_size) and bool(torch.isfinite(x).all())
              for x in carry), f"the LSTM carry goes on, {tuple(carry[0].shape)} x 2, finite")
    _finite(torch, "final obs", obs)
    update_s = wall - rollout_s[0]
    print(f"  cyclamen training iteration of {T} decisions x {E} arenas x {N} robots: "
          f"{wall:.3f} s ({T * E * N / wall:,.0f} training agent-decisions/s): rollout "
          f"(with reset's bookkeeping and bootstrap) {rollout_s[0]:.3f} s, update "
          f"{update_s:.3f} s ({update_s / passes * 1e3:.1f} ms a chunk pass) on {card}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print("  " + ", ".join(f"{k} {v:.5g}" for k, v in metrics.items()), flush=True)
    return launches


ENV_STEPS = 50                      # timed env steps per path in phase 3e


def _env_rate(torch, env, gen, fused, want_obs=True):
    """Env arena-steps/s of ENV_STEPS steps with fixed random module ids,
    host clock ending in a synchronise: the composed ``env.step`` or the
    fused ``step_lanes``."""
    from swarmacb_torch.env import lanes

    st, _ = env.reset(gen)
    ids = torch.randint(0, 6, (env.num_envs, env.num_agents), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    if fused:
        cur, acts = lanes.state_to_lanes(env, st), lanes.actions_to_lanes(env, ids)
        step = lambda: lanes.step_lanes(env, cur, acts, want_obs=want_obs)[0]  # noqa: E731
    else:
        step = lambda: env.step(cur, ids)[0]  # noqa: E731
        cur = st
    for _ in range(3):
        cur = step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENV_STEPS):
        cur = step()
    torch.cuda.synchronize()
    return env.num_envs * ENV_STEPS / (time.perf_counter() - t0)


def phase_daisy(torch, ops, card):
    """The discrete slice: daisy's composed rollout, then one whole
    training iteration with ``fused_env_step`` (every env step one K4
    launch), then the env rates of both paths."""
    from swarmacb_torch.agents import POCATrainer
    from swarmacb_torch.config import DirectionalGateEnvCfg, load_config
    from swarmacb_torch.env import DirectionalGateEnv

    run, variant, pcfg, env_ov = load_config(ROOT / "configs" / "DirGate_daisy.yaml")
    print(f"== phase 3e: the discrete slice, {run} ({variant}): cut from num_envs="
          f"{env_ov.get('num_envs')}, time_horizon={pcfg.horizon} to num_envs="
          f"{E_MAIN}, horizon={HORIZON}; hidden {pcfg.hidden_dim}x{pcfg.num_layers}",
          flush=True)
    pcfg = dataclasses.replace(pcfg, horizon=HORIZON, seed=SEED)
    env_kw = {k: v for k, v in env_ov.items() if k != "num_envs"}
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=E_MAIN,
                                                   **env_kw))
    E, N, T, dp = env.num_envs, env.num_agents, HORIZON, pcfg.decision_period
    gen = torch.Generator(device=DEVICE)

    # the composed path: each env step runs K1 (pre-step sensors, reused
    # for the observations) and K2
    trainer = POCATrainer(env, pcfg)
    gen.manual_seed(SEED + 100)
    st, obs = env.reset(gen)
    trainer.rollout(st, obs, trainer.init_actor_carry(), length=2)
    torch.cuda.synchronize()
    gen.manual_seed(SEED)
    ops.reset_launches()
    t0 = time.perf_counter()
    st, obs = env.reset(gen)
    st, obs, _, rollout, bootstrap, _ = trainer.rollout(st, obs, ())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    expect = {"pairwise_sensors": 1 + T * dp, "resolve_robot_collisions": T * dp,
              "fused_env_step": 0, **_critic_launches(False, T, 0)}
    for name, n in expect.items():
        check(launches[name] == n, f"daisy composed rollout: {name} launched "
                                   f"{launches[name]} times (expected {n})")
    check(tuple(rollout.actions.shape) == (T, E, N, 1)
          and len(torch.unique(rollout.actions)) == 6,
          f"daisy rollout.actions {tuple(rollout.actions.shape)} takes all 6 modules")
    for name, t in rollout.items():
        _finite(torch, f"daisy rollout.{name}", t)
    _finite(torch, "daisy bootstrap value", bootstrap)
    print(f"  daisy composed rollout of {T} decisions x {E} arenas x {N} robots: "
          f"{wall:.3f} s, {T * E * N / wall:,.0f} agent-decisions/s on {card}", flush=True)
    del trainer, rollout

    # the fused path: one training iteration, every env step one K4 launch
    trainer = POCATrainer(env, dataclasses.replace(pcfg, fused_env_step=True))
    gen.manual_seed(SEED + 100)
    st, obs = env.reset(gen)
    trainer.rollout(st, obs, trainer.init_actor_carry(), length=2)
    torch.cuda.synchronize()
    passes = _chunk_passes(trainer)
    params = [*trainer.actor.parameters(), *trainer.critic.parameters()]
    before = [p.detach().clone() for p in params]
    print(f"== phase 3e: one training iteration of {run} with fused_env_step, E={E}, "
          f"T={T}: {passes} chunk passes", flush=True)
    gen.manual_seed(SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from 0 just before, read just after
    ops.reset_launches()
    st, obs = env.reset(gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, obs, _, metrics = trainer.train_iteration(st, obs, ())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    expect = {"fused_env_step": T * dp, "resolve_robot_collisions": 0,
              "pairwise_sensors": 1,                  # the reset's observations
              **_critic_launches(False, T + passes, passes)}
    for name, n in expect.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times in the "
                                   f"fused daisy training iteration (expected {n})")
    for k, v in metrics.items():
        check(bool(np.isfinite(v)), f"metric {k} = {v:.6g} is finite")
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(params, before))
    check(moved > 0, f"the update moved the parameters (largest change {moved:.3e})")
    _finite(torch, "final obs", obs)
    print(f"  fused daisy training iteration of {T} decisions x {E} arenas x {N} robots "
          f"(rollout, bootstrap, update): {wall:.3f} s, {T * E * N / wall:,.0f} "
          f"training agent-decisions/s on {card}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print("  " + ", ".join(f"{k} {v:.5g}" for k, v in metrics.items()), flush=True)
    del trainer

    # the env rates at the smoke cut's E and at bench.py's
    for n_envs in (E, E_BENCH):
        if n_envs != E:
            env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=n_envs,
                                                           **env_kw))
        gen.manual_seed(SEED + 3)
        rates = {"composed": _env_rate(torch, env, gen, False),
                 "fused": _env_rate(torch, env, gen, True),
                 "fused, want_obs=False": _env_rate(torch, env, gen, True, want_obs=False)}
        print(f"  daisy env arena-steps/s over {ENV_STEPS} steps at E={n_envs} on {card}: "
              + "; ".join(f"{k} {v:,.0f}" for k, v in rates.items()), flush=True)
    return launches


BF16_STEP = 2.0 ** -8               # one bfloat16 step: the bf16 reference's tolerance


def phase_small_reference(torch, fused_attention=False, variant="dandelion",
                          fused_env_step=False, mixed_precision=False, hidden=None):
    """A short rollout and update at a config's full width on the card
    against the same rollout and update on the CPU, whose ops all take
    their plain versions: same weights (drawn on the CPU from the seed),
    same action noise (Gumbel draws for a discrete variant), same turn
    durations and spawns, two arenas reaching the time limit inside the
    run. Both updates start from the CPU's rollout and take the same epoch
    permutations. Feedforward: two minibatches of 8 groups per epoch, each
    in chunks of 3, 3 and 2 groups. Recurrent (cyclamen, memory 128,
    windows of 3 decisions): the windows of 1 decision (4 a minibatch, in
    chunks of 3 and 1), then two minibatches of 2 windows of 3 decisions
    (chunks of one window); the LSTM's carry starts from zeros and is
    stored and zeroed on both sides. With ``mixed_precision`` (phase 3h) the
    critic's q/k/v/o projections take bf16 on both devices: each projection
    is held bit for bit in at least 99.9 % of its elements, and what the
    critic's outputs reach (values, baselines, losses, gradients) within one
    bf16 step, 2^-8, where a summation order that differs between the
    devices flips a rounding; each Adam step of the update is held as
    ``_hold_bf16_steps`` says. ``hidden`` overrides the variant's width
    (``--hidden_dim``): at 1024 the card's critic takes the wide route."""
    from swarmacb_torch.agents import POCAConfig, POCATrainer, buffer
    from swarmacb_torch.config import DirectionalGateEnvCfg
    from swarmacb_torch.env import DirectionalGateEnv

    E, N, T = 4, N_MAIN, 4
    recurrent = variant == "cyclamen"
    # the variant's width, as scripts/train_torch.py defaults it
    hidden, layers = ((128, 1) if variant in ("tulip", "cyclamen") else (HID_MAIN, 2)
                      if hidden is None else (hidden, 2))
    print(f"== phase {'3h' if mixed_precision else '3b'}: card against CPU, {variant}, "
          f"E={E}, T={T}, h={hidden}, fused_attention={fused_attention}, "
          f"fused_env_step={fused_env_step}, mixed_precision={mixed_precision}", flush=True)
    rng = np.random.default_rng(SEED + 2)
    cfg = DirectionalGateEnvCfg(variant=variant, num_envs=E)
    pcfg = POCAConfig(hidden_dim=hidden, num_layers=layers,
                      horizon=T, seed=SEED, mini_batch_size=8, accum_chunk_groups=3,
                      fused_attention=fused_attention, fused_env_step=fused_env_step,
                      recurrent=recurrent, memory_size=128, sequence_length=3,
                      mixed_precision=mixed_precision)
    pos, yaw = _arena_poses(rng, cfg, E, N)
    if cfg.discrete_actions:
        noise = rng.gumbel(size=(T, E * N, cfg.num_actions)).astype(np.float32)
    else:
        noise = rng.normal(size=(T, E * N, 2)).astype(np.float32)
    spawn_pos, spawn_yaw = _arena_poses(rng, cfg, T * E, N)
    if recurrent:
        # one permutation per (epoch, window group): {3: [0], 1: [3]}, E each
        perms = [{L: torch.from_numpy(rng.permutation(E)) for L in (1, 3)}
                 for _ in range(pcfg.num_epochs)]
    else:
        perms = torch.from_numpy(np.stack([rng.permutation(T * E)
                                           for _ in range(pcfg.num_epochs)]))
    durations = ({k: rng.integers(1, 5, (T, E, N)).astype(np.int32)
                  for k in ("explore", "photo", "antiphoto")}
                 if cfg.discrete_actions else None)
    L = cfg.max_episode_length
    step_count = np.array([L - 3, L - 2, 7, 50], np.int32)
    out, trainers, weights = {}, {}, {}
    for device in ("cpu", DEVICE):
        env = DirectionalGateEnv(cfg, device=device)
        trainer = trainers[device] = POCATrainer(env, pcfg)
        # the same weights on both sides, N(0, 1/fan_in) and biases
        # N(0, 0.1²): the init's tiny T-Fixup gains leave the critic's
        # outputs near a constant, which would hide a wrong baseline
        with torch.no_grad():
            for name, p in [*trainer.actor.named_parameters(prefix="actor"),
                            *trainer.critic.named_parameters(prefix="critic")]:
                if name not in weights:
                    std = p.shape[1] ** -0.5 if p.dim() == 2 else 0.1
                    weights[name] = (std * rng.normal(size=tuple(p.shape))
                                     ).astype(np.float32)
                p.copy_(torch.from_numpy(weights[name]))
        st = env.make_state(pos, yaw, torch.Generator(device=device),
                            step_count=step_count)
        obs = env._observations(st)
        dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        out[device] = trainer.rollout(
            st, obs, trainer.init_actor_carry(), injected_noise=dev(noise),
            injected_durations=(None if durations is None else
                                {k: dev(v) for k, v in durations.items()}),
            injected_spawn=(dev(spawn_pos.reshape(T, E, N, 2)),
                            dev(spawn_yaw.reshape(T, E, N))))
    (_, _, carry_c, cpu, boot_c, _), (_, _, carry_g, gpu, boot_g, _) = out["cpu"], out[DEVICE]
    # rewards, done flags and module ids exact; floats through the networks
    # differ by float32 rounding in other summation orders
    critic_tol = BF16_STEP if mixed_precision else 1e-4
    tol = {"obs": 1e-4, "critic_states": 1e-5,
           "actions": 0.0 if cfg.discrete_actions else 1e-4, "log_probs": 1e-4,
           "rewards": 0.0, "dones": 0.0, "team_values": critic_tol, "baselines": critic_tol,
           "memory_h": 1e-4, "memory_c": 1e-4}
    for (name, c), (_, g) in zip(cpu.items(), gpu.items()):
        err, ok = max_err(g.cpu(), c, tol[name], tol[name])
        check(ok, f"card vs CPU rollout.{name}: max|Δ| {err:.3e} "
                  f"(tolerance {tol[name]:g} + {tol[name]:g}·|CPU|)")
    err, ok = max_err(boot_g.cpu(), boot_c, critic_tol, critic_tol)
    check(ok, f"card vs CPU bootstrap value: max|Δ| {err:.3e} (tolerance {critic_tol:g} + "
              f"{critic_tol:g}·|CPU|)")
    if mixed_precision:
        _bf16_projections(torch, trainers, cpu.critic_states)
    check(int(cpu.dones.sum()) == 2, "the folded auto-reset fired in two arenas")
    spread = float(cpu.baselines.std())
    check(spread > 1e-2, f"the baselines vary (std {spread:.3e})")
    if recurrent:
        # arenas 1 and 0 end their episodes at decisions 0 and 1: their
        # stored carry is zero at the next decision, and only theirs
        zero = ~cpu.memory_h.reshape(T, E, -1).any(-1)
        want = torch.zeros(T, E, dtype=torch.bool)
        want[0] = want[1, 1] = want[2, 0] = True
        check(torch.equal(zero, want) and torch.equal(~gpu.memory_h.cpu().reshape(
            T, E, -1).any(-1), want), "the carry is zero at the start and after each "
                                      "done, on both devices, and nowhere else")
        err, ok = max_err(carry_g[0].cpu(), carry_c[0], 1e-4, 1e-4)
        check(ok, f"card vs CPU final LSTM carry h: max|Δ| {err:.3e}")

    # the update, from the CPU's rollout on both sides
    first, after, steps_of = {}, {}, {}
    for device, trainer in trainers.items():
        rollout = type(cpu)(**{k: v.to(device) for k, v in cpu.items()})
        bootstrap = boot_c.to(device)
        c = trainer.cfg
        returns, adv = buffer.compute_advantages(rollout, bootstrap, c.gamma, c.lam)
        adv = buffer.normalize_advantages(adv)
        if recurrent:
            # the first minibatch of the epoch: the windows of 1 decision
            source = trainer._window_batches(rollout, returns, adv)[1]
            idx, loss_fn = perms[0][1].to(device), trainer._recurrent_loss
        else:
            source = trainer._flatten_buffer(rollout, returns, adv)
            idx = perms[0][:trainer.group_mb].to(device)
            loss_fn = trainer._feedforward_loss
        trainer.optimizer.zero_grad(set_to_none=True)
        total, aux = trainer._accumulate_grads({k: v[idx] for k, v in source.items()},
                                               c.clip_eps, c.beta, loss_fn)
        first[device] = ([float(total), *aux.tolist()],
                         {n: p.grad.cpu() for n, p in
                          [*trainer.actor.named_parameters(prefix="actor"),
                           *trainer.critic.named_parameters(prefix="critic")]})
        if mixed_precision:
            steps_of[device] = _record_steps(trainer)
        metrics = trainer._update(rollout, bootstrap, c.lr, c.clip_eps, c.beta,
                                  injected_perms=perms)
        after[device] = (metrics, {n: p.detach().cpu() for n, p in
                                   [*trainer.actor.named_parameters(prefix="actor"),
                                    *trainer.critic.named_parameters(prefix="critic")]})
    gpu_trainer = trainers[DEVICE]
    if recurrent:
        check(gpu_trainer._grad_chunks(E, 1) == 2 and gpu_trainer._grad_chunks(2, 3) == 2,
              "the first minibatch (4 windows of 1) runs in two chunks, the last a tail; "
              "those of 2 windows of 3 in two")
    else:
        check(gpu_trainer._grad_chunks(gpu_trainer.group_mb) == 3,
              "the first minibatch runs in three chunks, the last a tail")
    # the first minibatch before any step: float32 sums in other orders
    # (cuBLAS against the CPU's products, K3b or K5b against autograd)
    (loss_c, grads_c), (loss_g, grads_g) = first["cpu"], first[DEVICE]
    names = ("total", "policy", "value", "baseline", "entropy")
    rel = BF16_STEP if mixed_precision else 1e-5
    for name, a, b in zip(names, loss_g, loss_c):
        ok = abs(a - b) <= rel + rel * abs(b)
        check(ok, f"card vs CPU first-minibatch {name} loss: {a:.7g} vs {b:.7g} "
                  f"(tolerance {rel:g} + {rel:g}·|CPU|)")
    # each gradient against its largest element, floored at 1e-3: some are
    # zero in exact arithmetic (a key bias shifts every score of a softmax
    # row alike) and hold only rounding noise
    ratio = {n: float((grads_g[n] - g).abs().max()) / max(float(g.abs().max()), 1e-3)
             for n, g in grads_c.items()}
    name = max(ratio, key=ratio.get)
    check(ratio[name] <= rel, f"card vs CPU first-minibatch gradients: largest "
                              f"max|Δ| / max(max|CPU|, 1e-3) over the {len(ratio)} "
                              f"parameters {ratio[name]:.3e}, at {name} "
                              f"(tolerance {rel:g})")
    # after 3 epochs of 2 (3 recurrent) Adam steps: a first Adam step moves a
    # coordinate by ≈ lr·sign(g), and a gradient near 0 can take either sign
    # on two devices. In bf16 a gradient near 0 is rounding noise at every
    # step, so its sign may differ at each of them: 2.2·steps·lr
    steps = pcfg.num_epochs * len(_minibatches(gpu_trainer))
    factor, what = ((steps, "Adam steps") if mixed_precision else (pcfg.num_epochs, "epochs"))
    bound = 2.2 * factor * pcfg.lr
    params_c, params_g = after["cpu"][1], after[DEVICE][1]
    drift = max(float((params_g[n] - p).abs().max()) for n, p in params_c.items())
    past = sum(int(((params_g[n] - p).abs() > 2.2 * pcfg.num_epochs * pcfg.lr).sum())
               for n, p in params_c.items())
    total = sum(p.numel() for p in params_c.values())
    check(drift <= bound, f"card vs CPU parameters after the update: max|Δ| "
                          f"{drift:.3e} (tolerance 2.2·{what}·lr = {bound:.3e}); "
                          f"{past:,} of {total:,} coordinates past 2.2·epochs·lr")
    moved = max(float((p - torch.from_numpy(weights[n])).abs().max())
                for n, p in params_c.items())
    check(moved > pcfg.lr, f"the update moved the parameters (largest change "
                           f"{moved:.3e}, more than one step of lr {pcfg.lr:g})")
    for k in after["cpu"][0]:
        a, b = float(after[DEVICE][0][k]), float(after["cpu"][0][k])
        check(abs(a - b) <= 1e-3 + 1e-2 * abs(b),
              f"card vs CPU update metric {k}: {a:.6g} vs {b:.6g} "
              "(tolerance 1e-03 + 1e-02·|CPU|)")
    if mixed_precision:
        # last: it loads the card's parameters into the CPU trainer
        _hold_bf16_steps(torch, trainers, steps_of)


# Each bf16 Adam step, card against CPU (phase 3h), in the way
# tests/test_torch_mixed_precision_steps.py holds the port's steps to the JAX
# trainer's. The losses of each step (policy, value, baseline, entropy) at the
# card's own parameters before it, evaluated on the CPU on the same
# minibatch: both sides then differ only by summation orders, within
# MP_SAME_TOL (absolute + relative), where float32 in place of bf16 in the
# card's q/k/v/o projections parts by more. And each step's losses against
# the CPU's own run of the same steps, within MP_RUN_TOL, where the two runs'
# parameters part only where a gradient near 0 takes another sign on the
# card (one Adam step moves such a coordinate by about lr), and a flipped
# gradient sign parts by more. Both stated before the first call on the card.
MP_SAME_TOL = 5e-5
MP_RUN_TOL = 1e-3
MP_LOSSES = ("policy", "value", "baseline", "entropy")


def _record_steps(trainer) -> dict:
    """Wraps ``trainer._sgd_step`` to keep, for each Adam step, the
    parameters before it (on the CPU), its minibatch, its loss function's
    name and arguments, and the losses it returns (``"steps"``), and the
    seconds the keeping took (``"seconds"``)."""
    record, inner = {"steps": [], "seconds": 0.0}, trainer._sgd_step

    def step(batch, eps, beta, loss_fn, groups_per_row=1):
        t0 = time.perf_counter()
        before = {n: p.detach().cpu().clone() for n, p in
                  [*trainer.actor.named_parameters(prefix="actor"),
                   *trainer.critic.named_parameters(prefix="critic")]}
        t1 = time.perf_counter()
        aux = inner(batch, eps, beta, loss_fn, groups_per_row)
        t2 = time.perf_counter()
        record["steps"].append((before, {k: v.cpu() for k, v in batch.items()},
                                loss_fn.__name__, (eps, beta, groups_per_row),
                                aux.detach().cpu().tolist()))
        record["seconds"] += (t1 - t0) + (time.perf_counter() - t2)
        return aux
    trainer._sgd_step = step
    return record


def _hold_bf16_steps(torch, trainers, steps_of) -> None:
    """Each recorded step of the card against the CPU: its losses against
    the CPU's at the card's parameters before it (``MP_SAME_TOL``), and
    against the CPU run's own step (``MP_RUN_TOL``); prints the largest
    |Δ| / tolerance of each. Loads the card's parameters into the CPU
    trainer."""
    t0 = time.perf_counter()
    cpu = trainers["cpu"]
    card_steps, cpu_steps = steps_of[DEVICE]["steps"], steps_of["cpu"]["steps"]
    check(len(card_steps) == len(cpu_steps) > 1,
          f"the bf16 update took {len(card_steps)} Adam steps on the card and "
          f"{len(cpu_steps)} on the CPU")
    params = dict([*cpu.actor.named_parameters(prefix="actor"),
                   *cpu.critic.named_parameters(prefix="critic")])
    worst = {"same": (0.0, ""), "run": (0.0, "")}
    for k, ((before, batch, fn, args, got), (*_, ran)) in enumerate(zip(card_steps,
                                                                         cpu_steps)):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(before[n])
        cpu.optimizer.zero_grad(set_to_none=True)
        _, here = cpu._accumulate_grads(batch, *args[:2], getattr(cpu, fn), args[2])
        for what, want, tol in (("same", here.tolist(), MP_SAME_TOL), ("run", ran, MP_RUN_TOL)):
            for name, a, b in zip(MP_LOSSES, got, want):
                ratio = abs(a - b) / (tol + tol * abs(b))
                if ratio >= worst[what][0]:
                    worst[what] = (ratio, f"step {k} {name} loss {a:.7g} vs {b:.7g}")
    cpu.optimizer.zero_grad(set_to_none=True)
    for what, tol, against in (("same", MP_SAME_TOL, "the CPU's at the card's parameters"),
                               ("run", MP_RUN_TOL, "the CPU run's own step")):
        ratio, where = worst[what]
        check(ratio <= 1.0, f"card vs CPU, each of {len(card_steps)} bf16 Adam steps' losses "
                            f"against {against}: largest |Δ| / ({tol:g} + {tol:g}·|CPU|) "
                            f"{ratio:.3e}, at {where}")
    print(f"  the per-step hold took {steps_of[DEVICE]['seconds']:.2f} s to keep the card's "
          f"{len(card_steps)} steps and {time.perf_counter() - t0:.2f} s to evaluate them on "
          "the CPU", flush=True)


def _bf16_rn(torch, v):
    """The float64 ``v`` rounded once to bfloat16 (to nearest, ties to
    even), as float32. PyTorch's cast of a float64 goes through float32 and
    may round twice."""
    r = v.float()
    down = r.view(torch.int32).to(torch.int64) & 0xFFFF0000          # toward zero
    up = down + 0x10000                                             # away from zero
    lo, hi = (b.to(torch.int32).view(torch.float32) for b in (down, up))
    d_lo, d_hi = (v - lo.double()).abs(), (v - hi.double()).abs()
    odd = ((down >> 16) & 1).bool()
    return torch.where((d_hi < d_lo) | ((d_hi == d_lo) & odd), hi, lo)


def _bf16_product_hold(torch, layer, x):
    """The bf16 product of ``x`` and ``layer``'s weight as ``_project``
    takes it on ``x``'s device, held on the CPU against the exact sum s of
    the bf16 operands' products (float64; each product is exact in
    float32): (the share of elements rounded as s rounds, the share within
    what any float32 accumulation can give, the product). A float32 sum
    of K terms in any order, rounding or truncating, lies within
    K·2⁻²³·Σ|x_k w_k| of s (each product exact), and its bf16 rounding
    within half a bf16 step of that sum; a product whose sums rounded to
    bf16 on the way parts by more."""
    xb, wb = (t.detach().to(torch.bfloat16) for t in (x, layer.weight))
    product = torch.matmul(xb, wb.t()).float().cpu()
    x64, w64 = xb.double().cpu(), wb.double().cpu()
    exact = x64 @ w64.t()
    slack = x64.shape[-1] * 2.0 ** -23 * (x64.abs() @ w64.abs().t())
    step = torch.ldexp(torch.ones_like(exact),
                       torch.frexp(product.double().abs().clamp_min(2.0 ** -133))[1] - 8)
    within = (product.double() - exact).abs() <= 0.5 * step + slack
    correct = product == _bf16_rn(torch, exact)
    return float(correct.double().mean()), float(within.double().mean()), product


def _bf16_projections(torch, trainers, critic_states):
    """Each bf16 projection of the critic (q, k, v from ``project_qkv``,
    fc_out) on the normalized embeddings of the rollout's critic states, on
    each device: its product within float32 accumulation's bound of the
    exact sum everywhere (``_bf16_product_hold``), and the projection that
    product's bias add in bf16, rounded once from float32. Card against
    CPU, the share of bit-equal elements: at least 99.9 % where the
    products sum the YAML's 512 terms. At 1024 terms the card's tensor-core
    sums round otherwise than the CPU's in 0.12 % of the elements, each
    within the bound; the share is printed there, not held."""
    from swarmacb_torch.models.networks import _project

    out = {}
    for device, trainer in trainers.items():
        rsa = trainer.critic.self_attn
        with torch.no_grad():
            x = rsa.normalize(trainer.critic.obs_entity_enc(critic_states.to(device)))
            projections = (*rsa.project_qkv(x), _project(rsa.fc_out, x, rsa.dtypes["o"]))
        check(all(t.dtype == torch.bfloat16 for t in projections),
              f"the {device} critic's q, k, v and fc_out products are bf16")
        out[device] = [t.float().cpu() for t in projections]
        for name, got in zip("qkvo", out[device]):
            layer = getattr(rsa, "fc_out" if name == "o" else f"fc_{name}")
            correct, within, product = _bf16_product_hold(torch, layer, x)
            bias = layer.bias.detach().cpu().to(torch.bfloat16).float()
            biased = float((got == (product + bias).to(torch.bfloat16).float()
                            ).double().mean())
            check(within == 1.0 and biased == 1.0,
                  f"{device} bf16 projection {name}: its product within float32 "
                  f"accumulation's bound of the exact sum in {within:.4%} of "
                  f"{got.numel():,} elements, rounded as the exact sum in {correct:.4%}; "
                  f"its bias added in bf16 in {biased:.4%} (both 100 % wanted)")
    for name, g, c in zip("qkvo", out[DEVICE], out["cpu"]):
        share = float((g == c).double().mean())
        what = f"card vs CPU bf16 projection {name}: {share:.4%} of {g.numel():,} elements"
        if x.shape[-1] <= HID_MAIN:
            check(share >= 0.999, f"{what} bit-equal (at least 99.9 %)")
        else:
            print(f"  {what} bit-equal at {x.shape[-1]} terms a product", flush=True)


# ── phase 3f: the command lines on the card ──────────────────────────────

CLI_ENVS = 64                       # arenas of phase 3f's train and play runs
# the tags every summary writes; the episode tags (cumulative reward,
# episode length, group reward) follow only where an episode ended, and
# no 1,200-step episode ends inside one 1,000-decision iteration
SUMMARY_TAGS = ("Losses/Policy Loss", "Losses/Value Loss", "Losses/POCA/Baseline Loss",
                "Policy/Entropy", "Policy/Learning Rate", "Policy/Epsilon", "Policy/Beta",
                "Policy/Extrinsic Reward", "Policy/Extrinsic Value Estimate",
                "Policy/Std dim0", "Policy/Std dim1", "Policy/Log Std Mean", "Extra/SPS",
                "Extra/Mean Rollout Reward", "Extra/Rolling Avg Rollout Reward",
                "Extra/Mean Abs Advantage")


def _script(name):
    """A script of ``scripts/`` as a module, to call its ``main(argv)``."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _equal_to_saved(torch, trainer, saved) -> bool:
    """The trainer's actor, critic and Adam state equal a ``state.pt``'s,
    bit for bit."""
    for net in ("actor", "critic"):
        cur = getattr(trainer, net).state_dict()
        if cur.keys() != saved[net].keys() or not all(
                torch.equal(cur[k].cpu(), v) for k, v in saved[net].items()):
            return False
    cur, want = trainer.optimizer.state_dict(), saved["optimizer"]
    return (cur["param_groups"] == want["param_groups"]
            and cur["state"].keys() == want["state"].keys()
            and all(cur["state"][i].keys() == s.keys()
                    and all(torch.equal(cur["state"][i][k].cpu(), v) for k, v in s.items())
                    for i, s in want["state"].items()))


def _summary_tags(trainer, log_dir: Path) -> list[str]:
    """The tag of every record the run's writer wrote (the text one as
    ``hyperparameters``): the JSONL writer's lines, or TensorBoard's event
    files where ``make_writer`` found TensorBoard."""
    from swarmacb_torch.utils import JsonlWriter

    if isinstance(trainer.writer, JsonlWriter):
        return [json.loads(line)["tag"]
                for line in (log_dir / "scalars.jsonl").read_text().splitlines()]
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    events = EventAccumulator(str(log_dir))
    events.Reload()
    tags = events.Tags()
    return ([t for t in tags["scalars"] for _ in events.Scalars(t)]
            + [t.split("/")[0] for t in tags["tensors"] for _ in events.Tensors(t)])


def phase_cli(torch, ops, card):
    """``scripts/train_torch.py`` trains one dandelion iteration at full
    width, saves, resumes from ``--checkpoint latest`` and trains one more;
    ``scripts/play_torch.py`` evaluates the final checkpoint; each through
    its ``main(argv)`` on the card."""
    from swarmacb_torch.agents import Checkpointer

    t_phase = time.perf_counter()
    train_torch, play_torch = _script("train_torch"), _script("play_torch")
    config = str(ROOT / "configs" / "DirGate_dandelion.yaml")
    T = 1000                                     # the YAML's time_horizon
    iteration = T * CLI_ENVS * N_MAIN
    print(f"== phase 3f: the command lines on the card: train_torch.py --config "
          f"{Path(config).name} --num_envs {CLI_ENVS} (one iteration = {iteration:,} "
          f"decisions), resume, play_torch.py", flush=True)

    # F1 closed: --hidden_dim 1024 trains on both critic paths, through the
    # wide route of the critic kernels
    wide = {f"wide_{'fused_attention' if fused else 'tail'}":
            _wide_iteration(torch, ops, card, train_torch, config, fused)
            for fused in (False, True)}

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir, log_dir = Path(tmp) / "ckpt", Path(tmp) / "logs"
        base = ["--config", config, "--num_envs", str(CLI_ENVS),
                "--checkpoint_dir", str(ckpt_dir), "--log_dir", str(log_dir)]

        # 1. train from scratch: counts from 0 just before, read just after
        ops.reset_launches()
        t0 = time.perf_counter()
        trainer = train_torch.main([*base, "--total_timesteps", str(iteration)])
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        launches = dict(ops.launches)
        passes = _chunk_passes(trainer)
        check(trainer.device.type == DEVICE, f"train_torch.py ran on {trainer.device}")
        expect = {"pairwise_sensors": 1 + T, "resolve_robot_collisions": T,
                  "fused_env_step": 0, **_critic_launches(False, T + passes, passes)}
        for name, n in expect.items():
            check(launches[name] == n, f"train_torch.py launched {name} {launches[name]} "
                                       f"times (expected {n})")
        for name in (f"poca_{iteration}", "poca_final"):
            check((ckpt_dir / name / "metadata.json").exists(), f"{name}/metadata.json written")
        tags = _summary_tags(trainer, log_dir)
        missing = [t for t in SUMMARY_TAGS if t not in tags]
        check(bool(tags) and not missing and "hyperparameters" in tags,
              f"the writer ({type(trainer.writer).__name__}) wrote hyperparameters and "
              f"{len(SUMMARY_TAGS) - len(missing)} of the {len(SUMMARY_TAGS)} summary tags"
              + (f"; missing {missing}" if missing else ""))
        del trainer

        # 2. resume from the newest checkpoint and train one more iteration
        saved = torch.load(ckpt_dir / f"poca_{iteration}" / "state.pt", map_location="cpu",
                           weights_only=True)
        trainer, ckpt = train_torch.prepare(
            [*base, "--checkpoint", "latest", "--total_timesteps", str(2 * iteration)])
        check(_equal_to_saved(torch, trainer, saved),
              f"the resumed actor, critic and Adam state equal poca_{iteration}/state.pt "
              "bit for bit")
        adam_steps = {float(s["step"]) for s in saved["optimizer"]["state"].values()}
        iter_s = []
        train_iteration = trainer.train_iteration

        def timed_iteration(*args):
            t_it = time.perf_counter()
            out = train_iteration(*args)
            torch.cuda.synchronize()
            iter_s.append(time.perf_counter() - t_it)
            return out

        trainer.train_iteration = timed_iteration
        ops.reset_launches()
        t0 = time.perf_counter()
        trainer.train(checkpointer=ckpt)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        trainer.writer.close()
        launches = dict(ops.launches)
        check(all(launches[k] > 0 for k in ("pairwise_sensors", "resolve_robot_collisions",
                                            "fused_tail", "fused_tail_bwd")),
              "the resumed run launched K1 {pairwise_sensors}, K2 {resolve_robot_collisions}, "
              "K3f {fused_tail}, K3b {fused_tail_bwd} times".format(**launches))
        steps = {float(s["step"]) for s in trainer.optimizer.state_dict()["state"].values()}
        moments = [s["exp_avg"] for s in trainer.optimizer.state_dict()["state"].values()]
        check((trainer.global_step, trainer.update_count) == (2 * iteration, 2)
              and len(adam_steps) == 1 and steps == {2 * s for s in adam_steps}
              and all(m.device.type == DEVICE for m in moments),
              f"resumed to step {trainer.global_step:,}, update {trainer.update_count}; "
              f"Adam steps {sorted(steps)}, its moments on the card")
        tags = _summary_tags(trainer, log_dir)
        check(tags.count("Losses/Policy Loss") == 2, "the resumed run wrote its summaries")

        # the checkpointer alone, on this trainer
        t0 = time.perf_counter()
        path = ckpt.save(trainer)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ckpt.restore(path, trainer)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3

        # 3. play the final checkpoint: counts from 0 just before, read just after
        final = ckpt_dir / "poca_final"
        ops.reset_launches()
        stats = play_torch.main(["--checkpoint", str(final), "--num_envs", str(CLI_ENVS),
                                 "--num_episodes", str(CLI_ENVS), "--episode_length", "10",
                                 "--deterministic"])
        launches = dict(ops.launches)
        n = stats["env_steps"]
        expect = {"pairwise_sensors": 1 + n, "resolve_robot_collisions": n,
                  "fused_tail": 0, "fused_tail_bwd": 0}
        for name, want in expect.items():
            check(launches[name] == want, f"play_torch.py launched {name} {launches[name]} "
                                          f"times (expected {want})")
        mean_len = float(stats["lengths"].mean())
        check(mean_len == 99.0 and len(stats["returns"]) == CLI_ENVS
              and bool(np.isfinite(stats["returns"]).all()),
              f"play_torch.py: {len(stats['returns'])} episodes, mean len {mean_len:.1f} "
              "(expected 99.0)")

        # 4. the card's checkpoint restores on the CPU, bit for bit
        on_cpu = Checkpointer.restore_params(final, device="cpu")
        same = all(torch.equal(on_cpu[net][k], v.cpu())
                   for net in ("actor", "critic")
                   for k, v in getattr(trainer, net).state_dict().items())
        check(same and all(v.device.type == "cpu" for sd in on_cpu.values()
                           for v in sd.values()),
              "restore_params(poca_final, device='cpu') equals the card's state dicts bit "
              "for bit")
    print(f"  on {card}: train_torch.py from scratch {wall1:.3f} s (build, one iteration, two "
          f"saves); the resumed iteration {iter_s[0]:.3f} s, "
          f"{iteration / iter_s[0]:,.0f} training agent-decisions/s; save "
          f"{save_ms:.1f} ms, restore {restore_ms:.1f} ms; play_torch.py {n} env steps x "
          f"{CLI_ENVS} arenas in {stats['seconds']:.3f} s, "
          f"{n * CLI_ENVS / stats['seconds']:,.0f} arena-steps/s; resumed train() "
          f"{wall2:.3f} s; phase 3f {time.perf_counter() - t_phase:.1f} s", flush=True)
    return wide


WIDE_ENVS = 16                      # arenas of phase 3f's --hidden_dim 1024 iterations


def _wide_iteration(torch, ops, card, train_torch, config, fused):
    """One iteration of ``train_torch.py --hidden_dim 1024`` at E = WIDE_ENVS
    and the YAML's T = 1000, on one critic path: the wide route's counters
    from the iteration (K1 and K2 beside them), and its wall time."""
    T = 1000
    iteration = T * WIDE_ENVS * N_MAIN
    flag = "on" if fused else "off"
    with tempfile.TemporaryDirectory() as tmp:
        trainer, ckpt = train_torch.prepare(
            ["--config", config, "--hidden_dim", str(HID_WIDE), "--num_envs", str(WIDE_ENVS),
             "--total_timesteps", str(iteration), "--fused_attention", flag,
             "--checkpoint_dir", f"{tmp}/ckpt", "--log_dir", f"{tmp}/logs",
             "--no-tensorboard"])
        iter_s = []
        train_iteration = trainer.train_iteration

        def timed_iteration(*args):
            t_it = time.perf_counter()
            out = train_iteration(*args)
            torch.cuda.synchronize()
            iter_s.append(time.perf_counter() - t_it)
            return out

        trainer.train_iteration = timed_iteration
        # the main path: counts from 0 just before, read just after
        ops.reset_launches()
        trainer.train(checkpointer=ckpt)
        torch.cuda.synchronize()
        launches = dict(ops.launches)
    passes = _chunk_passes(trainer)
    on, off = (("fused_cf_attention", "fused_tail") if fused
               else ("fused_tail", "fused_cf_attention"))
    expect = {"pairwise_sensors": 1 + T, "resolve_robot_collisions": T, "fused_env_step": 0,
              f"{on}_wide": T + passes, f"{on}_wide_bwd": passes, f"{off}_wide": 0,
              f"{off}_wide_bwd": 0, "fused_tail": 0, "fused_tail_bwd": 0,
              "fused_cf_attention": 0, "fused_cf_attention_bwd": 0}
    for name, n in expect.items():
        check(launches[name] == n, f"train_torch.py --hidden_dim {HID_WIDE} --fused_attention "
                                   f"{flag} launched {name} {launches[name]} times "
                                   f"(expected {n})")
    params = [*trainer.actor.parameters(), *trainer.critic.parameters()]
    check(trainer.cfg.hidden_dim == HID_WIDE and trainer.critic.fused_attention == fused
          and trainer.update_count == 1 and all(bool(torch.isfinite(p).all()) for p in params),
          f"one update at hidden {trainer.cfg.hidden_dim}x{trainer.cfg.num_layers}, "
          f"fused_attention={trainer.critic.fused_attention}: every parameter finite")
    print(f"  on {card}: train_torch.py --hidden_dim {HID_WIDE} --fused_attention {flag} "
          f"--num_envs {WIDE_ENVS}: the iteration ({passes} chunk passes) {iter_s[0]:.3f} s, "
          f"{iteration / iter_s[0]:,.0f} training agent-decisions/s", flush=True)
    del trainer
    return launches


# ── phase 3h: mixed precision ────────────────────────────────────────────

def phase_mixed_precision(torch, ops, card, f32_walls):
    """One dandelion training iteration at the smoke cut with
    ``mixed_precision=True`` at the stages ``--mp_stages auto`` gives
    dandelion, on both critic paths, beside phases 3c and 3d of this run;
    then the small reference on both paths, at the YAML's width and at
    ``HID_WIDE``."""
    t_phase = time.perf_counter()
    stages = _script("train_torch").VALIDATED_MP_STAGES["dandelion"]
    check(stages == "qkvo", f"--mp_stages auto gives dandelion {stages!r}")
    for fused in (False, True):
        trainer = dandelion_trainer("3h", fused_attention=fused, mixed_precision=True,
                                    mp_stages=stages)
        check(trainer.critic.self_attn.dtypes == dict.fromkeys("qkvo", torch.bfloat16)
              and all(p.dtype == torch.float32 for p in trainer.critic.parameters()),
              "the critic's q/k/v/o projections take bf16; its parameters stay float32")
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(SEED + 100)
        st, obs = trainer.env.reset(gen)
        trainer.rollout(st, obs, (), length=2)                     # warm-up
        torch.cuda.synchronize()
        _, wall = phase_train(torch, ops, card, trainer, label="3h")
        path = "fused_attention" if fused else "tail"
        print(f"  mixed precision, {path} path: {wall:.3f} s an iteration against "
              f"{f32_walls[path]:.3f} s in float32 (phase {'3d' if fused else '3c'}, this "
              f"run): {f32_walls[path] / wall:.3f}x", flush=True)
        del trainer
    # at the YAML's width, then at --hidden_dim 1024, where the card's
    # critic takes the wide K3 and K5 under the bf16 projections
    for hidden in (None, HID_WIDE):
        for fused in (False, True):
            phase_small_reference(torch, fused_attention=fused, mixed_precision=True,
                                  hidden=hidden)
    print(f"  phase 3h {time.perf_counter() - t_phase:.1f} s", flush=True)


# ── phase 3i: seed-parallel training ─────────────────────────────────────

SEED_SPEC, SEED_ENVS = "0-3", 16    # the JAX package's seed-parallel operating point


def phase_seeds(torch, ops, card):
    """``scripts/train_torch.py --config configs/DirGate_dandelion.yaml
    --seeds 0-3 --num_envs 16`` (T = 1000 kept): one iteration of each lane
    through ``prepare`` and ``train`` (what its ``main`` runs), each lane's
    launches counted; lane 0 against a serial run of seed 0 at the lane's
    chunk cap; ``play_torch.py`` on lane 2's ``poca_final``; a lane poisoned
    with NaN parameters (small size) quarantined while the other finishes."""
    from swarmacb_torch.agents import (Checkpointer, POCAConfig, POCATrainer,
                                       SeedParallelTrainer)
    from swarmacb_torch.config import DirectionalGateEnvCfg
    from swarmacb_torch.env import DirectionalGateEnv

    t_phase = time.perf_counter()
    train_torch, play_torch = _script("train_torch"), _script("play_torch")
    config = str(ROOT / "configs" / "DirGate_dandelion.yaml")
    seeds = train_torch._parse_seeds(SEED_SPEC)
    T, E, N = train_torch.load_config(config)[2].horizon, SEED_ENVS, N_MAIN
    iteration = T * E * N
    print(f"== phase 3i: seed-parallel, train_torch.py --config {Path(config).name} "
          f"--seeds {SEED_SPEC} --num_envs {E} (one iteration = {iteration:,} decisions a "
          f"lane), play_torch.py, a poisoned lane", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, logs = Path(tmp) / "ckpt", Path(tmp) / "logs"
        trainer, cks = train_torch.prepare(
            ["--config", config, "--seeds", SEED_SPEC, "--num_envs", str(E),
             "--total_timesteps", str(iteration), "--checkpoint_dir", str(ckpt),
             "--log_dir", str(logs)])
        S = len(seeds)
        cap = trainer.cfg.accum_chunk_groups
        check(isinstance(trainer, SeedParallelTrainer) and trainer.seeds == seeds
              and all(lane.device.type == DEVICE for lane in trainer.lanes),
              f"{S} lanes (seeds {trainer.seeds}) on the card")
        check(cap == 1024 // S, f"each lane's chunk cap is {cap} groups (1024 // {S})")
        # each lane's launches: counted around its own train_iteration
        per_lane = []
        for lane in trainer.lanes:
            def counted(*args, _step=lane.train_iteration):
                before = dict(ops.launches)
                out = _step(*args)
                torch.cuda.synchronize()
                per_lane.append({k: ops.launches[k] - before[k] for k in before})
                return out
            lane.train_iteration = counted
        iter_s = []
        step = trainer.train_iteration

        def timed(*args):
            t_it = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            iter_s.append(time.perf_counter() - t_it)
            return out

        trainer.train_iteration = timed
        # the main path: counts from 0 just before, read just after
        ops.reset_launches()
        t0 = time.perf_counter()
        try:
            trainer.train(checkpointers=cks)
        finally:
            for w in trainer.writers or ():
                w.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        passes = _chunk_passes(trainer.lanes[0])
        lane_expect = {"pairwise_sensors": T, "resolve_robot_collisions": T,
                       "fused_env_step": 0, **_critic_launches(False, T + passes, passes)}
        for i, counts in enumerate(per_lane):
            bad = {k: counts[k] for k, n in lane_expect.items() if counts[k] != n}
            check(not bad, f"lane {i} (seed {seeds[i]}) launched K1 {counts['pairwise_sensors']}, "
                           f"K2 {counts['resolve_robot_collisions']}, K3f {counts['fused_tail']}, "
                           f"K3b {counts['fused_tail_bwd']} times (expected {T}, {T}, "
                           f"{T + passes}, {passes}: {passes} chunk passes)")
        # the resets' observations: one K1 a lane, outside the iterations
        expect = {k: S * n + (S if k == "pairwise_sensors" else 0)
                  for k, n in lane_expect.items()}
        for name, n in expect.items():
            check(launches[name] == n, f"the seed-parallel run launched {name} "
                                       f"{launches[name]} times (expected {n})")
        check(len(per_lane) == S and trainer.alive.all()
              and (trainer.global_step, trainer.update_count) == (iteration, 1),
              f"every lane trained one iteration (step {trainer.global_step:,})")
        for s, lane in zip(seeds, trainer.lanes):
            d = Path(f"{ckpt}_seed{s}")
            ok = all((d / n / "metadata.json").exists() for n in (f"poca_{iteration}",
                                                                  "poca_final"))
            tags = _summary_tags(lane, Path(f"{logs}_seed{s}"))
            check(ok and "Losses/Policy Loss" in tags and "hyperparameters" in tags,
                  f"seed {s}: {d.name}/poca_{iteration} and poca_final, {len(tags)} summary "
                  f"records in logs_seed{s}")
        check(not ckpt.exists() and not logs.exists(), "no directory without a seed suffix")

        # lane 0 against the serial trainer of seed 0 at the lane's cap
        serial = POCATrainer(trainer.env, dataclasses.replace(trainer.cfg, seed=seeds[0]))
        t0 = time.perf_counter()
        serial.train(progress=False)
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t0
        lane0 = trainer.lanes[0]
        diffs = [float((a - b).abs().max()) for net in ("actor", "critic")
                 for a, b in zip(getattr(serial, net).state_dict().values(),
                                 getattr(lane0, net).state_dict().values())]
        same = max(diffs) == 0.0
        check(same or max(diffs) <= 1e-5,
              f"lane 0's parameters against a serial run of seed {seeds[0]} at chunk cap "
              f"{cap}: {'bit for bit' if same else f'max|Δ| {max(diffs):.3e} (tolerance 1e-5)'}")
        del serial

        # play lane 2's final checkpoint: counts from 0 just before, read just after
        final = Path(f"{ckpt}_seed{seeds[2]}") / "poca_final"
        ops.reset_launches()
        stats = play_torch.main(["--checkpoint", str(final), "--num_envs", str(E),
                                 "--num_episodes", str(E), "--episode_length", "10",
                                 "--deterministic"])
        n = stats["env_steps"]
        check(float(stats["lengths"].mean()) == 99.0
              and ops.launches["pairwise_sensors"] == 1 + n
              and ops.launches["resolve_robot_collisions"] == n,
              f"play_torch.py restores seed {seeds[2]}'s poca_final and plays {E} episodes "
              f"of mean length {float(stats['lengths'].mean()):.1f}, K1 "
              f"{ops.launches['pairwise_sensors']}, K2 {ops.launches['resolve_robot_collisions']}")
        del trainer

        # a lane poisoned with NaN parameters, at a small size (E = 4, T = 8)
        small = POCAConfig(horizon=8, total_timesteps=2 * 8 * 4 * N, mini_batch_size=16)
        poisoned = SeedParallelTrainer(DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=4)),
                                       small, [0, 1])
        with torch.no_grad():
            for p in [*poisoned.lanes[0].actor.parameters(),
                      *poisoned.lanes[0].critic.parameters()]:
                p.fill_(float("nan"))
        pcks = [Checkpointer(Path(tmp) / f"poisoned_seed{s}") for s in (0, 1)]
        poisoned.train(checkpointers=pcks, progress=False)
        check(list(poisoned.alive) == [False, True]
              and [p.name for p in pcks[0].dir.iterdir()] == [f"poca_diverged_{8 * 4 * N}"]
              and (pcks[1].dir / "poca_final" / "metadata.json").exists()
              and poisoned.lanes[1].update_count == 2,
              "the NaN lane is quarantined (poca_diverged_*) after its first iteration; the "
              "other trains on to poca_final")
    agg = S * iteration / iter_s[0]
    print(f"  on {card}: the seed-parallel iteration ({S} lanes x {T} decisions x {E} arenas "
          f"x {N} robots) {iter_s[0]:.3f} s, {agg:,.0f} aggregate training "
          f"agent-decisions/s ({agg / S:,.0f} a seed); train() {wall:.3f} s with the saves; "
          f"the serial seed-{seeds[0]} run {serial_s:.3f} s; play_torch.py {n} env steps x "
          f"{E} arenas in {stats['seconds']:.3f} s; phase 3i "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ── phase 3j: data-parallel training ─────────────────────────────────────

DP_WORLD = 2                        # gloo ranks that share the card in 3j (b)
DP_ROLLOUT_T = 20                   # 3j (b)'s rollout, held against one process
# 3j (b)'s rollout fields held exactly, and those whose arenas lie on axis 0
DP_EXACT = ("rewards", "dones")
DP_ARENA_FIRST = ("bootstrap", "final_obs")


def _dp_trainer(mesh, num_envs, horizon):
    """``configs/DirGate_dandelion.yaml`` cut to ``num_envs`` arenas and
    ``horizon`` decisions: one process on the card, or the rank ``mesh``
    of a data-parallel run over them."""
    from swarmacb_torch.agents import POCATrainer
    from swarmacb_torch.config import DirectionalGateEnvCfg, load_config
    from swarmacb_torch.env import DirectionalGateEnv

    _, variant, pcfg, env_ov = load_config(ROOT / "configs" / "DirGate_dandelion.yaml")
    pcfg = dataclasses.replace(pcfg, horizon=horizon, seed=SEED)
    env_kw = {k: v for k, v in env_ov.items() if k != "num_envs"}
    lo, hi = (0, num_envs) if mesh is None else mesh.shard_range(num_envs)
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=hi - lo, **env_kw),
                             device=DEVICE if mesh is None else mesh.device,
                             shard=None if mesh is None else (lo, num_envs))
    return POCATrainer(env, pcfg, mesh=mesh)


def _dp_rollout(trainer) -> dict:
    """A rollout of the trainer's horizon from a reset on its generator:
    its fields, the bootstrap and the final observations, on the CPU."""
    st, obs = trainer.env.reset(trainer.generator)
    st, obs, _, rollout, bootstrap, _ = trainer.rollout(st, obs, ())
    out = {k: v.cpu() for k, v in rollout.items()}
    out.update(bootstrap=bootstrap.cpu(), final_obs=obs.cpu())
    return out


def _dp_rank(rank, init_method, out_dir, device, num_envs, horizon, rollout_t):
    """One gloo rank of phase 3j (b) on ``device`` (``cuda:0``): one
    training iteration of its E / 2 arenas (launches, all-reduces and wall
    time counted), its parameter digest, then a short rollout of a fresh
    trainer."""
    import torch
    from swarmacb_torch import ops
    from swarmacb_torch.parallel import digest, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(world=DP_WORLD, rank=rank, device=device, backend="gloo",
                     init_method=init_method)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()

    try:
        trainer = _dp_trainer(mesh, num_envs, horizon)
        st, obs = trainer.env.reset(trainer.generator)
        trainer.rollout(st, obs, (), length=2)                     # warm-up
        sync()
        out = {"passes": _chunk_passes(trainer), "shard": trainer.env.shard,
               "backend": mesh.backend, "group_mb": trainer.group_mb,
               "rows": trainer._minibatch_rows(trainer.cfg.horizon * trainer.num_envs)}
        # the main path: counts from 0 just before, read just after
        mesh.timed = True
        mesh.comm.update(calls=0, bytes=0, seconds=0.0)
        ops.reset_launches()
        st, obs = trainer.env.reset(trainer.generator)
        sync()
        t0 = time.perf_counter()
        st, obs, _, metrics = trainer.train_iteration(st, obs, ())
        sync()
        out.update(wall=time.perf_counter() - t0, launches=dict(ops.launches),
                   comm=dict(mesh.comm), metrics=metrics,
                   digest=digest([*trainer.actor.parameters(), *trainer.critic.parameters()]))
        mesh.timed = False
        del trainer
        out["rollout"] = _dp_rollout(_dp_trainer(mesh, num_envs, rollout_t))
    finally:
        mesh.close()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def _dp_state_equal(torch, a: dict, b: dict) -> float:
    """max |Δ| between two ``state.pt``s (actor, critic, Adam), 0.0 when
    they are equal bit for bit; inf when their keys differ."""
    worst = 0.0
    pairs = [(a[net], b[net]) for net in ("actor", "critic")]
    pairs += [(s, b["optimizer"]["state"].get(i, {}))
              for i, s in a["optimizer"]["state"].items()]
    for x, y in pairs:
        if x.keys() != y.keys():
            return float("inf")
        for k, v in x.items():
            if not torch.equal(v, y[k]):
                worst = max(worst, float((v.double() - y[k].double()).abs().max()))
    return worst


def phase_data_parallel(torch, ops, card):
    """(a) ``train_torch.py --distributed`` under ``torchrun`` over NCCL at
    world = 1 against the plain command (one iteration at phase 3f's cut,
    E = 64, T = 1000): their ``poca_final`` equal bit for bit; (b) two
    gloo ranks that share the card (``parallel.make_mesh(backend="gloo",
    device="cuda:0")``), 512 arenas each at the smoke cut: one training
    iteration, each rank's launches, the ranks' parameters bit for bit,
    the all-reduces beside ``scripts/comm_account_torch.py``, and a
    20-decision rollout of both ranks against one process of 1,024 arenas."""
    t_phase = time.perf_counter()
    print(f"== phase 3j: data-parallel training: (a) train_torch.py --distributed under "
          f"torchrun (NCCL, world 1) against the plain command, --num_envs {CLI_ENVS}, one "
          f"iteration; (b) {DP_WORLD} gloo ranks sharing the card, E={E_MAIN}, T={HORIZON}",
          flush=True)
    wall_a = _torchrun_world_one(torch)
    wall_b = _gloo_ranks(torch, card)
    print(f"  (a) {wall_a:.1f} s, (b) {wall_b:.1f} s; phase 3j "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def _torchrun_world_one(torch) -> float:
    """Phase 3j (a); returns its wall seconds."""
    config = str(ROOT / "configs" / "DirGate_dandelion.yaml")
    T = 1000                                     # the YAML's time_horizon
    iteration = T * CLI_ENVS * N_MAIN
    with tempfile.TemporaryDirectory() as tmp:
        base = [str(ROOT / "scripts" / "train_torch.py"), "--config", config, "--num_envs",
                str(CLI_ENVS), "--total_timesteps", str(iteration), "--no-tensorboard",
                "--device", DEVICE]
        cmds = {"torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node", "1", *base, "--distributed"],
                "plain": [sys.executable, *base]}
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [*cmd, "--checkpoint_dir", f"{tmp}/{name}/ckpt", "--log_dir", f"{tmp}/{name}/logs"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, cmd in cmds.items()}
        outs = {}
        for name, proc in procs.items():
            try:
                outs[name] = proc.communicate(timeout=300)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                outs[name] = proc.communicate()[0]
            for line in outs[name].splitlines():
                if line.startswith(("[train] data-parallel", "[train] rank", "[POCA] step")):
                    print(f"  {name}: {line}", flush=True)
            check(proc.returncode == 0, f"{name}: {' '.join(cmds[name][:6])} ... exited with "
                                        f"{proc.returncode}" + ("" if proc.returncode == 0
                                                                else f"\n{outs[name][-3000:]}"))
        wall_a = time.perf_counter() - t0
        check("[train] data-parallel over 1 rank(s) (nccl)" in outs["torchrun"],
              "torchrun's rank reports the nccl backend")
        states = [torch.load(Path(tmp) / name / "ckpt" / "poca_final" / "state.pt",
                             map_location="cpu", weights_only=True) for name in cmds]
        worst = _dp_state_equal(torch, *states)
        check(worst == 0.0, "the NCCL world-1 run's poca_final equals the plain run's "
                            + ("bit for bit" if worst == 0.0 else f"(max |Δ| {worst:.3e})"))
    return wall_a


def _gloo_ranks(torch, card) -> float:
    """Phase 3j (b); returns its wall seconds."""
    passes_expected = 300
    print(f"  (b) expected a rank: K1 {1 + HORIZON}, K2 {HORIZON}, K3f "
          f"{HORIZON + passes_expected}, K3b {passes_expected}, K4 0, K5 0 "
          f"({passes_expected} chunk passes: 3 epochs x 10 minibatches of 10,240 groups in "
          "chunks of 1,024)", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _dp_rank, nprocs=DP_WORLD, join=False, start_method="spawn",
            args=(f"file://{tmp}/rendezvous", tmp, "cuda:0" if DEVICE == "cuda" else DEVICE,
                  E_MAIN, HORIZON, DP_ROLLOUT_T))
        deadline = time.monotonic() + 400
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError("the gloo ranks did not finish within 400 s")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(DP_WORLD)]
    wall_b = time.perf_counter() - t0
    for r, out in enumerate(ranks):
        n = out["passes"]
        expect = {"pairwise_sensors": 1 + HORIZON, "resolve_robot_collisions": HORIZON,
                  "fused_env_step": 0, **_critic_launches(False, HORIZON + n, n)}
        got = {k: out["launches"][k] for k in expect}
        lo, total = out["shard"]
        check(got == expect and n == passes_expected and out["backend"] == "gloo",
              f"rank {r} ({out['backend']}, arenas {lo}..{lo + E_MAIN // DP_WORLD} of "
              f"{total}, minibatches of {out['rows']} rows) "
              f"launched K1 {got['pairwise_sensors']}, K2 {got['resolve_robot_collisions']}, "
              f"K3f {got['fused_tail']}, K3b {got['fused_tail_bwd']}, K4 "
              f"{got['fused_env_step']}, K5 {got['fused_cf_attention']} (expected "
              f"{list(expect.values())})")
        for k in ("policy_loss", "value_loss", "baseline_loss", "entropy"):
            check(bool(np.isfinite(out["metrics"][k])), f"rank {r} {k} = "
                                                        f"{out['metrics'][k]:.6g} is finite")
    check(ranks[0]["digest"] == ranks[1]["digest"],
          f"the ranks' parameters are bit-identical after the iteration "
          f"(digest {ranks[0]['digest'][:16]}...)")
    check(all(ranks[0]["metrics"][k] == ranks[1]["metrics"][k]
              for k in ("policy_loss", "value_loss", "baseline_loss", "entropy",
                        "mean_abs_advantage", "mean_team_value")),
          "the ranks report the same losses and averaged statistics")

    acct = _script("comm_account_torch").account("dandelion", E_MAIN, horizon=HORIZON)
    comm = ranks[0]["comm"]
    steps = acct[f"ranks_{DP_WORLD}"]["sgd_steps"]
    wire = acct[f"ranks_{DP_WORLD}"]["wire_MB_per_update"] * 2**20
    check(comm["calls"] == acct[f"ranks_{DP_WORLD}"]["allreduce_calls"]
          and abs(comm["bytes"] * 2 * (DP_WORLD - 1) / DP_WORLD - wire) <= 1e-9 * wire,
          f"rank 0 made {comm['calls']} all-reduces of {comm['bytes'] / 2**20:.3f} MB in the "
          f"update; comm_account_torch.py: {steps} SGD steps + 4 scalars, "
          f"{acct['params']:,} parameters, {wire / 2**20:.3f} MB on the wire per GPU "
          f"at p = {DP_WORLD}")

    single = _dp_rollout(_dp_trainer(None, E_MAIN, DP_ROLLOUT_T))
    for name, want in single.items():
        got = torch.cat([out["rollout"][name] for out in ranks],
                        dim=0 if name in DP_ARENA_FIRST else 1)
        diff = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        tol = (0.0 if name in DP_EXACT else
               1e-5 if name in ("obs", "final_obs", "baselines", "team_values", "bootstrap")
               else 1e-6)
        check(got.shape == want.shape and diff <= tol,
              f"rollout.{name} of the two ranks against one process of {E_MAIN} arenas, "
              f"T = {DP_ROLLOUT_T}: max |Δ| {diff:.3e} (tolerance {tol:g})")
    seconds = [out["comm"]["seconds"] for out in ranks]
    walls = [out["wall"] for out in ranks]
    print(f"  on {card}: (b) the iteration "
          f"{walls[0]:.3f} s and {walls[1]:.3f} s on ranks 0 and 1 ({DP_WORLD} ranks sharing "
          f"the card, {HORIZON * E_MAIN * N_MAIN / max(walls):,.0f} training agent-decisions/s "
          f"together); all-reduce per update: {comm['calls']} calls, "
          f"{comm['bytes'] / 2**20:.3f} MB a rank, {seconds[0]:.3f} s and {seconds[1]:.3f} s in "
          f"all_reduce on ranks 0 and 1 (gloo through the host, "
          f"{comm['bytes'] / max(seconds[0], 1e-9) / 1e9:.3f} GB/s a rank)", flush=True)
    return wall_b


# ── phase 3k: card-vs-CPU drift over whole episodes ──────────────────────

def phase_drift(torch, card):
    """``scripts/measure_drift_torch.py``'s six cases on the card against
    the CPU: 1200 steps of E = 4 arenas, dandelion, daisy and lily on the
    composed env step (K1, K2) and the fused one (K4), each held to the JAX
    package's criteria."""
    from swarmacb_torch.utils import drift

    t0 = time.perf_counter()
    cases = len(drift.VARIANTS) * len(drift.PATHS)
    print(f"== phase 3k: card-vs-CPU drift over whole episodes (measure_drift_torch.py): "
          f"E={drift.E}, N={drift.N}, {drift.STEPS} steps, {', '.join(drift.VARIANTS)} on "
          f"{' and '.join(drift.PATHS)}, the CPU runs in {cases} processes", flush=True)
    out = drift.measure(DEVICE, workers=cases, log=lambda line: print(f"  {line}", flush=True))
    for case, m in out.items():
        missed = drift.misses(m, drift.STEPS)
        check(not missed, f"{case}: pos@100 {m['pos_drift_100_steps_m']:.3e} m, onset step "
                          f"{m['divergence_onset_step']}, reward agreement "
                          f"{m['reward_step_agreement']:.4%}, |Σreward Δ| "
                          f"{m['episode_reward_sum_diff']:g}"
                          + (f"; missed: {'; '.join(missed)}" if missed else
                             " (criteria: <= 1e-4 m, >= 200, >= 99 %, <= 2)"))
    print("  drift: " + json.dumps({"card": card, "cases": out}), flush=True)
    print(f"  phase 3k {time.perf_counter() - t0:.1f} s", flush=True)


# ── phase 3l: manual control on the card ─────────────────────────────────

MC_FRAMES, MC_HZ, MC_SIM_HZ = 100, 10.0, 60.0   # --hz 10 --sim-hz 60: 6 sub-steps
MC_SMOKE_FRAMES = 20
# Poses card against CPU, a frame from one state: positions to the CPU
# test's 2e-6 m; headings to 4 float32 ulps of π a sub-step, since each
# sub-step wraps the heading through atan2(sin, cos) (physics.py), which
# CUDA's libdevice (sinf, cosf within 2 ulps, atan2f 3) and the CPU's
# libm round apart, where the CPU test's two sides share the CPU's.
MC_POS_TOL = 2e-6
MC_YAW_ULPS = 4
MC_SENSOR_TOL = {"prox_vals": 2e-6, "ztilde": 2e-6, "rab_proj": 5e-5, "rab_x": 5e-5,
                 "rab_y": 5e-5, "light_vals": 2e-5, "light_value": 2e-5, "prox_value": 2e-5}
MC_FIELDS = ("explore_state", "explore_steps", "explore_dir", "photo_avoiding",
             "photo_steps", "photo_dir", "antiphoto_avoiding", "antiphoto_steps",
             "antiphoto_dir")


def _mc_ties(torch, cache, path, cfg, k):
    """Whether a frame holds a tie, within K4_TIE_ULPS ulps: a robot's
    obstacle or turn test on its proximity sums (against Σ|term|, where
    that is not zero: a sum of no readings is exactly zero on both
    devices), or a robot near a ground-zone edge at any sub-step (against
    1 m)."""
    win = K4_TIE_ULPS * float(np.finfo(np.float32).eps)
    v = cache["prox_vals"].double().cpu()
    cos_a = torch.tensor(k.cos_a, dtype=torch.float64)
    sin_a = torch.tensor(k.sin_a, dtype=torch.float64)
    tx, ty = v * cos_a, v * sin_a
    sx, sy = tx.sum(-1), ty.sum(-1)
    scx, scy = tx.abs().sum(-1), ty.abs().sum(-1)
    value = torch.clamp(torch.hypot(sx, sy), max=1.0)
    if bool((((sx.abs() <= win * scx) & (scx > 0)) | ((sy.abs() <= win * scy) & (scy > 0))
             | ((value - cfg.prox_threshold).abs() <= win * (scx + scy))).any()):
        return True
    for p in path:
        x, y = p[..., 0].double().abs().cpu(), p[..., 1].double().cpu()
        for b in (k.gate_zone_hw, k.corr_hw):
            if bool(((x - b).abs() <= win).any()):
                return True
        for b in (k.gate_south, k.corr_south, k.ni):
            if bool(((y - b).abs() <= win).any()):
                return True
    return False


def phase_manual_control(torch, ops, card):
    """``scripts/manual_control_torch.py``'s core on the card: MC_FRAMES
    frames at ``--sim-hz 60`` (6 sub-steps) at N = 20 (the tuned K1 and K2)
    and N = 40 (their wide route), from the card's reset with one log of
    wheels, module ids and turn durations; each frame also stepped on the
    CPU from the card's state (teacher-forced): positions to 2e-6, headings
    to MC_YAW_ULPS ulps of π a sub-step, K⁺, K⁻ and the behaviour machines
    exactly but for a frame with a tie, the HUD's sensor values to K1's
    plain-version tolerances. Counts
    the launches (K1 once and K2 six times a frame) and prints the median
    frame time beside the 100 ms that ``--hz 10`` allows; then runs the
    script headless if pygame imports. Returns the N = 40 run's launches."""
    from swarmacb_torch.ops import fused_step

    t0 = time.perf_counter()
    mc = _script("manual_control_torch")
    substeps = mc.substeps_for(MC_HZ, MC_SIM_HZ)
    print(f"== phase 3l: manual control (manual_control_torch.py's core) on the card, "
          f"{MC_FRAMES} frames at --hz {MC_HZ:g} --sim-hz {MC_SIM_HZ:g} ({substeps} sub-steps), "
          f"N = 20 and 40, against the CPU frame by frame", flush=True)
    out = {}
    for N in (20, 40):
        env, _, st = mc.build(N, DEVICE, SEED)
        cpu_env = mc.build(N, "cpu", SEED)[0]
        k = fused_step.constants(env.cfg)
        dt_sub = env.cfg.dt / substeps
        ms = env.cfg.max_wheel_speed
        rng = np.random.default_rng(SEED + N)
        log = [((float(w[0]), float(w[1])), (f // 17) % 6,
                {n: rng.integers(1, 5, (1, N)).astype(np.int32) for n in mc.DURATIONS})
               for f, w in enumerate(rng.uniform(-ms, ms, (MC_FRAMES, 2)).astype(np.float32))]
        kp_tot = km_tot = torch.zeros((), device=DEVICE)
        worst = {"pos": 0.0, "yaw": 0.0, **{n: 0.0 for n in MC_SENSOR_TOL}}
        yaw_tol = substeps * MC_YAW_ULPS * float(np.spacing(np.float32(np.pi)))
        bad, ties, frame_ms = [], 0, []
        ops.reset_launches()
        for f, (wheels, mod, dur) in enumerate(log):
            host = dataclasses.replace(
                st, pos=st.pos.cpu(), yaw=st.yaw.cpu(), prev_ground=st.prev_ground.cpu(),
                behavior=type(st.behavior)(**{n: getattr(st.behavior, n).cpu()
                                              for n in MC_FIELDS}),
                generator=torch.Generator())
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, cache, kp, km = mc.mixed_step(
                env, st, wheels, mod, {n: torch.from_numpy(v).to(DEVICE) for n, v in dur.items()},
                substeps, dt_sub)
            kp_tot, km_tot = kp_tot + kp, km_tot + km
            hud = mc.read_hud(st, cache, kp_tot, km_tot)    # the frame's one copy
            frame_ms.append((time.perf_counter() - t) * 1e3)
            path = []   # the CPU step launches nothing
            want, wcache, wkp, wkm = mc.mixed_step(
                cpu_env, host, wheels, mod, {n: torch.from_numpy(v) for n, v in dur.items()},
                substeps, dt_sub, path=path)
            dpos = float((st.pos.cpu() - want.pos).abs().max())
            dyaw = float((st.yaw.cpu() - want.yaw).abs().max())
            exact = (float(kp) == float(wkp) and float(km) == float(wkm)
                     and all(bool(torch.equal(getattr(st.behavior, n).cpu(),
                                              getattr(want.behavior, n))) for n in MC_FIELDS))
            worst["pos"], worst["yaw"] = max(worst["pos"], dpos), max(worst["yaw"], dyaw)
            if dpos > MC_POS_TOL or dyaw > yaw_tol or not exact:   # exempt only at a tie
                if _mc_ties(torch, wcache, path, env.cfg, k):
                    ties += 1
                else:
                    bad.append(f)
            for n, tol in MC_SENSOR_TOL.items():
                e = float((cache[n].cpu() - wcache[n]).abs().max())
                worst[n] = max(worst[n], e)
                if e > tol:
                    bad.append(f)
        launches = {n: v for n, v in ops.launches.items() if v}
        expect = ({"pairwise_sensors": MC_FRAMES, "resolve_robot_collisions": MC_FRAMES * substeps}
                  if N <= 32 else {"pairwise_sensors_wide": MC_FRAMES,
                                   "resolve_robot_collisions_wide": MC_FRAMES * substeps})
        check(launches == expect, f"manual control N={N}: launches {launches} (expected "
                                  f"{expect}: K1 once and K2 {substeps} times a frame)")
        check(not bad, f"manual control N={N}: {MC_FRAMES} frames against the CPU, positions "
              f"max|Δ| {worst['pos']:.3e} m (tolerance {MC_POS_TOL:g}), headings "
              f"{worst['yaw']:.3e} rad (tolerance {yaw_tol:.3e}), K+ K- and machines exact, "
              f"sensors {', '.join(f'{n} {worst[n]:.2e}' for n in MC_SENSOR_TOL)} "
              f"({ties} frames off at a tie, exempted; frames off: {sorted(set(bad))[:5]})")
        check(bool(np.isfinite(hud["pos"]).all()), f"manual control N={N}: K+ {hud['k_plus']:.0f}, "
              f"K- {hud['k_minus']:.0f} after {MC_FRAMES} frames, positions finite")
        med = statistics.median(frame_ms)
        print(f"  manual control N={N}: median frame {med:.3f} ms (min {min(frame_ms):.3f}, max "
              f"{max(frame_ms):.3f}; the core and the HUD's one copy) against the "
              f"{1e3 / MC_HZ:.0f} ms that --hz {MC_HZ:g} allows; on {card}", flush=True)
        out[N] = launches
    if importlib.util.find_spec("pygame") is None:
        print("  pygame does not import on this machine: the headless run of "
              "manual_control_torch.py is not made (the core above is the check)", flush=True)
    else:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "manual_control_torch.py"), "--smoke-frames",
             str(MC_SMOKE_FRAMES), "--sim-hz", str(MC_SIM_HZ), "--num_agents", "40"],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={**os.environ, "SDL_VIDEODRIVER": "dummy"})
        line = next((ln for ln in proc.stdout.splitlines() if "smoke OK" in ln), "")
        check(proc.returncode == 0 and bool(line),
              f"manual_control_torch.py --smoke-frames {MC_SMOKE_FRAMES} headless on the card: "
              f"rc {proc.returncode}, {line or proc.stderr[-300:]}")
    print(f"  phase 3l {time.perf_counter() - t0:.1f} s", flush=True)
    return out[40]


# ── phase 3m: the E sweep on the card ────────────────────────────────────

SWEEP_ENVS, SWEEP_HORIZON, SWEEP_ITERS = (16, 256), 200, 1


def phase_sweep(torch, ops, card):
    """``scripts/sps_sweep_torch.py`` cut short: dandelion at E in
    SWEEP_ENVS, T = SWEEP_HORIZON, SWEEP_ITERS timed iteration, on the
    card: each line's decisions/s against horizon·E·N over ``iter_s``, a
    finite positive phase split, and the kernels it launched (K1, K2, K3f
    and K3b; three iterations: the first, the timed one, the split one)."""
    t0 = time.perf_counter()
    sweep = _script("sps_sweep_torch")
    print(f"== phase 3m: the E sweep (sps_sweep_torch.py), dandelion, E in {SWEEP_ENVS}, "
          f"T={SWEEP_HORIZON}, {SWEEP_ITERS} timed iteration", flush=True)
    for E in SWEEP_ENVS:
        ops.reset_launches()
        r = sweep.measure("dandelion", E, SWEEP_ITERS, SWEEP_HORIZON, False, True,
                          device=DEVICE)
        torch.cuda.synchronize()
        launches = {n: v for n, v in ops.launches.items() if v}
        print("  sweep: " + json.dumps(r), flush=True)
        its = 2 + SWEEP_ITERS
        decisions = r["horizon"] * E * N_MAIN * r["iters"]
        ps = r["phase_split_s"]
        check(abs(r["decisions_per_sec"] - decisions / r["iter_s"])
              <= decisions / r["iter_s"] ** 2 * 5e-4 + 0.5
              and all(np.isfinite(ps[n]) and ps[n] > 0 for n in
                      ("rollout", "prep", "mb_steps_total", "blocked_iter"))
              and r["card"] == card,
              f"sweep E={E}: {r['decisions_per_sec']:,} training agent-decisions/s "
              f"(iter {r['iter_s']} s), phases rollout {ps['rollout']} s, prep {ps['prep']} s, "
              f"minibatch steps {ps['mb_steps_total']} s ({ps['n_mb_steps']}), blocked "
              f"iteration {ps['blocked_iter']} s, on {r['card']}")
        check(launches.get("pairwise_sensors") == its * SWEEP_HORIZON + 1
              and launches.get("resolve_robot_collisions") == its * SWEEP_HORIZON
              and launches.get("fused_tail", 0) > 0 and launches.get("fused_tail_bwd", 0) > 0
              and set(launches) == {"pairwise_sensors", "resolve_robot_collisions",
                                    "fused_tail", "fused_tail_bwd"},
              f"sweep E={E}: launches {launches} over {its} iterations")
    print(f"  phase 3m {time.perf_counter() - t0:.1f} s", flush=True)


# ── main ─────────────────────────────────────────────────────────────────

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        import swarmacb_torch
    except ModuleNotFoundError as exc:
        print(f"chip_smoke: the port's package is missing: {exc}", file=sys.stderr)
        return 1
    if Path(swarmacb_torch.__file__).resolve().parents[1] != ROOT:
        print("chip_smoke: swarmacb_torch is not the checkout's own package",
              file=sys.stderr)
        return 1
    from swarmacb_torch import ops
    from swarmacb_torch.config import DirectionalGateEnvCfg
    from swarmacb_torch.env import DirectionalGateEnv

    t_start = time.perf_counter()
    card = phase_card(torch, ops)
    cycles_per_ms = _sleep_cycles_per_ms(torch)
    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=E_MAIN))
    rows = phase_pairwise(torch, ops, env.cfg, env.wall_segments, cycles_per_ms)
    rows += phase_tail(torch, ops, cycles_per_ms)
    rows += phase_tail_backward(torch, ops, card, cycles_per_ms)
    rows += phase_cf_forward(torch, ops, card, cycles_per_ms)
    rows += phase_cf_backward(torch, ops, card, cycles_per_ms)
    phase_critic_paths(torch, cycles_per_ms)
    rows += phase_fused_step(torch, ops, cycles_per_ms)
    rows += phase_wide(torch, ops, card, cycles_per_ms)
    wide_env_rows, lanes_run = phase_env_wide(torch, ops, env.cfg, env.wall_segments,
                                              cycles_per_ms)
    rows += wide_env_rows
    # each path with its counts set to 0 just before and read just after
    launches, walls = {"daisy_lanes_n40": lanes_run}, {}
    for fused in (False, True):
        trainer = phase_slice(torch, ops, card, fused_attention=fused)
        path = "fused_attention" if fused else "tail"
        launches[path], walls[path] = phase_train(torch, ops, card, trainer)
        del trainer
    launches["daisy_fused_env_step"] = phase_daisy(torch, ops, card)
    launches["cyclamen"] = phase_cyclamen(torch, ops, card)
    for fused in (False, True):
        phase_small_reference(torch, fused_attention=fused)
    for fused_env_step in (False, True):
        phase_small_reference(torch, variant="daisy", fused_env_step=fused_env_step)
    phase_small_reference(torch, variant="tulip")
    for fused in (False, True):
        phase_small_reference(torch, fused_attention=fused, hidden=HID_WIDE)
    for fused_env_step in (False, True):
        phase_small_reference(torch, variant="cyclamen", fused_env_step=fused_env_step)
    for label, phase in (("3f", lambda: launches.update(phase_cli(torch, ops, card))),
                         ("3h", lambda: phase_mixed_precision(torch, ops, card, walls)),
                         ("3i", lambda: phase_seeds(torch, ops, card)),
                         ("3j", lambda: phase_data_parallel(torch, ops, card)),
                         ("3k", lambda: phase_drift(torch, card)),
                         ("3l", lambda: launches.update(
                             manual_control_n40=phase_manual_control(torch, ops, card))),
                         ("3m", lambda: phase_sweep(torch, ops, card))):
        try:
            phase()
        except (Exception, SystemExit) as exc:   # reported as this phase's failure
            traceback.print_exc()
            check(False, f"phase {label} raised {exc!r}")

    # each kernel's launches in the main-path run that exercises it
    path_of = {"fused_cf_attention": "fused_attention",
               "fused_cf_attention_bwd": "fused_attention",
               "fused_env_step": "daisy_fused_env_step",
               "fused_tail_wide": "wide_tail", "fused_tail_wide_bwd": "wide_tail",
               "fused_cf_attention_wide": "wide_fused_attention",
               "fused_cf_attention_wide_bwd": "wide_fused_attention",
               "fused_env_step_wide": "daisy_lanes_n40",
               "pairwise_sensors_wide": "manual_control_n40",
               "resolve_robot_collisions_wide": "manual_control_n40"}
    for row in rows:
        # phase 3f's --hidden_dim 1024 iterations for the wide route: 0 if 3f failed
        row["launches"] = launches.get(path_of.get(row["name"], "tail"), {}).get(row["name"], 0)
    print(f"== done in {time.perf_counter() - t_start:.1f} s; "
          f"{len(failures)} failure(s)", flush=True)
    for f in failures:
        print(f"  FAILED: {f}", flush=True)
    status = "ok" if not failures else "failed"
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys}, "status": status,
                                   **{k: r[k] for k in ("f32_bound_ms", "route_bound_ms",
                                                        f"e{E_BENCH}_ms",
                                                        f"e{E_BENCH}_bound_ms", "packed_ms",
                                                        "packed_bound_ms")
                                      if k in r}}
                                  for r in rows]}), flush=True)
    if failures:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
