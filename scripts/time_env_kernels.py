#!/usr/bin/env python3
"""The env kernels K1 (``pairwise_sensors``), K2
(``resolve_robot_collisions``) and K4 (``fused_env_step``) and the env
step of one checkout, timed on one NVIDIA GPU, to set two versions of the
port side by side.

    python3 scripts/time_env_kernels.py [--E 1024 32768] [--root DIR] [--label L] [--wide N]
                                        [--k2-forms]

``--root`` times the package of another checkout (for instance the parent
commit, unpacked with ``git archive``) through its public entry points,
with this script's timing (``chip_smoke.device_ms``: the median device time
of 25 calls between CUDA events, the stream kept busy so that no host gap
enters an interval), so that parent and change can run in one call on one
card. For each E (daisy, N = 20):

  - K1 through its wrapper, as the env calls it, and
    ``pairwise.sensor_constants`` alone, the packed constants that a
    wrapper without a cache builds in every call;
  - K2 through its wrapper on ``chip_smoke``'s spread and packed inputs
    made from the seed, and on the positions it receives in two composed
    dandelion rollouts from the spawn (``chip_smoke.drive_dandelion``):
    an untrained actor's wheel commands for HORIZON steps, and every robot
    driving for the gate for GATE_STEPS steps, timed on every STRIDE-th
    step's positions; a SHA-256 of the outputs' bytes beside each, so that
    two versions can be compared bit for bit. Where the package has
    ``pairwise.collision_skip_d2``, it also counts, for every step of the
    rollouts, the share of pairs that K2 evaluates in full and, per warp,
    the most such pairs of one lane and the count of j at which any lane
    has one (``chip_smoke.near_pair_counts``);
  - K4 on daisy tiles, with observations (the fused rollout's form) and
    without;
  - the device time of one fused ``step_lanes`` (draws included), and the
    daisy arena-steps/s of it and of the composed ``env.step``
    (``chip_smoke._env_rate``): where a step's wall time is well above its
    device time, the host sets the rate. The composed step is not timed on
    the device here: its ~500 launches a step, queued 25 steps deep, pace
    the events by the host's launches; ``scripts/profile_torch_rollout.py``
    traces its device time.

With ``--wide N`` it times instead K1, K2 and K4 alone at N robots an
arena, where N > 32 takes their wide route (``pairwise_wide.cu``,
``fused_step_wide.cu``): K1 on ``chip_smoke``'s spread poses, K2 on its
spread and packed inputs, K4 on ``chip_smoke._k4_state``'s daisy tiles
with observations (the fused rollout's form), each with a SHA-256 of its
outputs' bytes. With ``--wide N --k2-forms`` it times K2-wide in each of
the forms of ``K2_FORMS`` too, builds of this checkout's
``pairwise_wide.cu`` with another block size, or with the block's arenas
staged in shared memory in place of the reads from global memory (a text
patch of the source, for N up to the block's robots), on the same inputs,
with ptxas's report and a digest of each.

Prints the card's name and power limit, the launch floor (an empty
kernel, ``torch.cuda._sleep(0)``, under the same timing), ptxas's
registers and spills for the kernels timed, and a JSON line.
``chip_smoke.py`` holds the kernels against their plain versions and times
them beside their bounds.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


GATE_STEPS = 300   # the gate crowd forms within ~100 steps and holds
STRIDE = 20        # K2 is timed on every STRIDE-th step's positions

# K2-wide's forms for ``--k2-forms``: (robots a block, the block's arenas
# staged in shared memory); the source's own is the first
K2_FORMS = ((128, False), (64, False), (256, False), (128, True))
K2_ROBOTS_LINE = "constexpr int kCollisionRobots = 128;"
# the staged form, where whole arenas fit a block: one coalesced load a
# thread, a barrier, then the neighbours read from shared memory
K2_STAGED_PATCH = (
    ("  if (!(a < A && e0 + a < E && i < N)) return;  // a lane past the block's robots\n"
     "  const float2* arena = reinterpret_cast<const float2*>(pos) + (e0 + a) * N;\n",
     "  __shared__ float2 s_p[kCollisionRobots];\n"
     "  if (threadIdx.x < min(static_cast<long long>(A), E - e0) * N)\n"
     "    s_p[threadIdx.x] = reinterpret_cast<const float2*>(pos)[e0 * N + threadIdx.x];\n"
     "  __syncthreads();\n"
     "  if (!(a < A && e0 + a < E && i < N)) return;  // a lane past the block's robots\n"
     "  const float2* arena = s_p + a * N;\n"),
)


def time_k2(torch, cs, ops, cyc, robot_radius, inputs):
    """K2 through its wrapper on each of ``inputs``: device ms (one each)
    and a SHA-256 of all the outputs' bytes."""
    digest = hashlib.sha256()
    times = []
    for p in inputs:
        k2 = lambda p=p: ops.resolve_robot_collisions(p, robot_radius)  # noqa: E731
        digest.update(k2().cpu().numpy().tobytes())
        times.append(cs.device_ms(torch, k2, cyc))
    return dict(ms=times, sha256=digest.hexdigest()[:16])


def _digest(tensors):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in tensors)).hexdigest()[:16]


def time_wide(torch, cs, ops, cyc, E_list, N, out):
    """K1, K2 and K4 through their wrappers at (E, N) for each E of
    ``E_list`` (daisy's env otherwise): device ms and a SHA-256 of the
    outputs."""
    import numpy as np

    from swarmacb_torch.config import DirectionalGateEnvCfg
    from swarmacb_torch.env import DirectionalGateEnv

    for E in E_list:
        res = out["E"][E] = {}
        env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="daisy", num_envs=E,
                                                       num_agents=N), device="cuda")
        cfg = env.cfg
        pos_np, yaw_np = cs._arena_poses(np.random.default_rng(cs.SEED), cfg, E, N)
        pos, yaw = torch.from_numpy(pos_np).cuda(), torch.from_numpy(yaw_np).cuda()
        kw = dict(prox_range=cfg.prox_range, robot_radius=cfg.robot_radius,
                  rab_range=cfg.rab_range, alpha_rab=cfg.alpha_parameter,
                  wall_segments=env.wall_segments)
        k1 = lambda: ops.pairwise_sensors(pos, yaw, **kw)  # noqa: E731
        res["k1"] = dict(ms=cs.device_ms(torch, k1, cyc), sha256=_digest(k1()))
        print(f"  E={E} N={N} K1 through its wrapper {res['k1']['ms']:.4f} ms, output "
              f"sha256 {res['k1']['sha256']}", flush=True)
        packed = cs._packed_poses(np.random.default_rng(cs.SEED + 1), cfg, E, N)
        for kind, p_np in (("spread", pos_np), ("packed", packed)):
            row = res[f"k2_{kind}"] = time_k2(torch, cs, ops, cyc, cfg.robot_radius,
                                              [torch.from_numpy(p_np).cuda()])
            print(f"  E={E} N={N} K2 through its wrapper, {kind} inputs: {row['ms'][0]:.4f} "
                  f"ms, output sha256 {row['sha256']}", flush=True)
        kenv, _, tiles, acts, draws, spawn = cs._k4_state(torch, "daisy", E, N, cs.SEED + 11)
        k4 = lambda: ops.fused_env_step(tiles, acts, draws, spawn, kenv.cfg)  # noqa: E731
        new, reward, done, obs = k4()
        res["k4"] = dict(ms=cs.device_ms(torch, k4, cyc),
                         sha256=_digest([*new.values(), reward, done, *obs]))
        print(f"  E={E} N={N} K4 daisy through its wrapper {res['k4']['ms']:.4f} ms, output "
              f"sha256 {res['k4']['sha256']}", flush=True)
        del env, pos, yaw, kenv, tiles, acts, draws, spawn, new, obs
        torch.cuda.empty_cache()


def k2_form_libraries(cs, forms):
    """Build and load ``pairwise_wide.cu`` in each of ``forms`` (one nvcc
    each, all at once, with the package's flags); returns {form: (library,
    ptxas report of robot_collisions_wide_kernel)}."""
    import ctypes

    from swarmacb_torch.ops import _cuda

    src = (_cuda.CSRC / "pairwise_wide.cu").read_text(encoding="utf-8")
    assert src.count(K2_ROBOTS_LINE) == 1, "the source's block size line moved"
    out_dir = _cuda.BUILD_DIR / "k2_forms"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _cuda._nvcc(), {}
    for robots, staged in forms:
        text = src.replace(K2_ROBOTS_LINE, f"constexpr int kCollisionRobots = {robots};")
        if staged:
            for old, new in K2_STAGED_PATCH:
                assert text.count(old) == 1, f"the source moved: {old!r}"
                text = text.replace(old, new)
        tag = f"k2_{robots}_{'staged' if staged else 'global'}"
        cu = out_dir / f"{tag}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{tag}.so"
        cmd = [nvcc, *_cuda._COMMON_FLAGS, *_cuda.SOURCES["pairwise_wide"], "-o", str(lib),
               str(cu)]
        procs[(robots, staged)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for form, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc, K2-wide form {form}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _cuda.SIGNATURES["pairwise_wide"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[form] = (lib, cs.ptxas_report(log, ("robot_collisions_wide_kernel",)))
    return libs


def time_k2_forms(torch, cs, ops, cyc, E_list, N, out):
    """K2-wide in each of K2_FORMS, through its wrapper with the form's
    library in the package's place, on spread and packed inputs at (E, N)
    for each E: device ms and a SHA-256 of the outputs."""
    import numpy as np

    from swarmacb_torch.config import DirectionalGateEnvCfg
    from swarmacb_torch.ops import _cuda

    libs = k2_form_libraries(cs, K2_FORMS)
    own = _cuda.library("pairwise_wide")
    cfg = DirectionalGateEnvCfg(num_agents=N)
    rows = out["k2_forms"] = []
    try:
        for (robots, staged), (lib, report) in libs.items():
            if staged and N > robots:   # the staged form holds whole arenas only
                continue
            _cuda._libs["pairwise_wide"] = lib
            form = f"{robots} robots a block, {'arenas staged' if staged else 'global reads'}"
            print(f"  K2-wide form: {form}; ptxas {report}", flush=True)
            for E in E_list:
                spread = cs._arena_poses(np.random.default_rng(cs.SEED), cfg, E, N)[0]
                packed = cs._packed_poses(np.random.default_rng(cs.SEED + 1), cfg, E, N)
                for kind, p_np in (("spread", spread), ("packed", packed)):
                    row = time_k2(torch, cs, ops, cyc, cfg.robot_radius,
                                  [torch.from_numpy(p_np).cuda()])
                    rows.append(dict(robots=robots, staged=staged, E=E, kind=kind,
                                     ms=row["ms"][0], sha256=row["sha256"], ptxas=report))
                    print(f"    E={E} N={N} {kind}: {row['ms'][0]:.4f} ms, output sha256 "
                          f"{row['sha256']}", flush=True)
    finally:
        _cuda._libs["pairwise_wide"] = own


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--E", type=int, nargs="+", default=[1024, 32768])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose swarmacb_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--wide", type=int, default=0, metavar="N",
                    help="time only K1, K2 and K4, at N robots an arena")
    ap.add_argument("--k2-forms", action="store_true",
                    help="with --wide: also time K2-wide in each form of K2_FORMS")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_env_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    # this checkout's helpers, whichever package is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import swarmacb_torch
    from swarmacb_torch import ops
    from swarmacb_torch.config import DirectionalGateEnvCfg, load_config
    from swarmacb_torch.env import DirectionalGateEnv, lanes
    from swarmacb_torch.ops import _cuda, pairwise

    if Path(swarmacb_torch.__file__).resolve().parents[1] != root:
        print(f"time_env_kernels: swarmacb_torch is not {root}'s", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{card}; timing {root} {args.label}", flush=True)
    sources = ((("pairwise_wide", ("pairwise_sensors_wide_kernel",
                                   "robot_collisions_wide_kernel")),
                ("fused_step_wide", ("fused_step_wide_kernel",))) if args.wide else
               (("pairwise", ("pairwise_sensors_kernel", "robot_collisions_kernel")),
                ("fused_step", ("fused_step_kernel",))))
    _cuda.build([name for name, _ in sources])
    for name, kernels in sources:
        for k, info in cs.ptxas_report(_cuda.build_log(name), kernels).items():
            print(f"  ptxas {k}: {info}", flush=True)
    cyc = cs._sleep_cycles_per_ms(torch)
    floor = cs.device_ms(torch, lambda: torch.cuda._sleep(0), cyc)
    print(f"  launch floor: an empty kernel {floor:.4f} ms", flush=True)
    if args.wide:
        out = dict(card=card, root=str(root), label=args.label, floor_ms=floor, N=args.wide,
                   E={})
        time_wide(torch, cs, ops, cyc, args.E, args.wide, out)
        if args.k2_forms:
            time_k2_forms(torch, cs, ops, cyc, args.E, args.wide, out)
        print(json.dumps(out), flush=True)
        return 0

    run, variant, pcfg, env_ov = load_config(HERE / "configs" / "DirGate_daisy.yaml")
    env_kw = {k: v for k, v in env_ov.items() if k != "num_envs"}
    out = dict(card=card, root=str(root), label=args.label, floor_ms=floor, E={})
    for E in args.E:
        res = out["E"][E] = {}
        env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=E,
                                                       **env_kw), device="cuda")
        cfg, N = env.cfg, env.num_agents
        rng = np.random.default_rng(cs.SEED)
        pos_np, yaw_np = cs._arena_poses(rng, cfg, E, N)
        pos = torch.from_numpy(pos_np).cuda()
        yaw = torch.from_numpy(yaw_np).cuda()
        kw = dict(prox_range=cfg.prox_range, robot_radius=cfg.robot_radius,
                  rab_range=cfg.rab_range, alpha_rab=cfg.alpha_parameter,
                  wall_segments=env.wall_segments)
        res["k1_ms"] = cs.device_ms(torch, lambda: ops.pairwise_sensors(pos, yaw, **kw), cyc)
        res["constants_ms"] = cs.device_ms(
            torch, lambda: pairwise.sensor_constants(env.wall_segments), cyc)
        print(f"  E={E} K1 through its wrapper {res['k1_ms']:.4f} ms; the packed constants "
              f"alone {res['constants_ms']:.4f} ms", flush=True)

        spread = cs._arena_poses(np.random.default_rng(cs.SEED), cfg, E, N)[0]
        packed = cs._packed_poses(np.random.default_rng(cs.SEED + 1), cfg, E, N)
        for kind, p_np in (("spread", spread), ("packed", packed)):
            res[f"k2_{kind}"] = time_k2(torch, cs, ops, cyc, cfg.robot_radius,
                                        [torch.from_numpy(p_np).cuda()])
            print(f"  E={E} K2 through its wrapper, {kind} inputs: "
                  f"{res[f'k2_{kind}']['ms'][0]:.4f} ms, output sha256 "
                  f"{res[f'k2_{kind}']['sha256']}", flush=True)
        skip_d2 = getattr(pairwise, "collision_skip_d2", None)   # not in older checkouts
        for policy, steps in (("random", cs.HORIZON), ("gate", GATE_STEPS)):
            kept, counts = [], []

            def on_k2_input(step, pos):
                if skip_d2 is not None:
                    counts.append(cs.near_pair_counts(torch, pos, skip_d2(cfg.robot_radius)))
                if (step + 1) % STRIDE == 0:
                    kept.append(pos)

            cs.drive_dandelion(torch, E, steps, policy, cs.SEED + 5, on_k2_input)
            row = res[f"k2_rollout_{policy}"] = time_k2(torch, cs, ops, cyc,
                                                        cfg.robot_radius, kept)
            row["steps"] = list(range(STRIDE, steps + 1, STRIDE))
            print(f"  E={E} K2 through its wrapper, {policy} rollout (dandelion, steps "
                  f"{STRIDE}..{steps} by {STRIDE}): mean {statistics.mean(row['ms']):.4f} ms "
                  f"[{', '.join(f'{ms:.4f}' for ms in row['ms'])}], output sha256 "
                  f"{row['sha256']}", flush=True)
            if counts:
                row["near"] = [counts[k - 1] for k in row["steps"]]
                share = [c["share"] for c in counts]
                print(f"    pairs evaluated in full, over its {steps} steps: mean "
                      f"{statistics.mean(share):.4%}, most {max(share):.4%}; per warp, "
                      f"the most of one lane: mean "
                      f"{statistics.mean(c['lane_max'][0] for c in counts):.3f}, most "
                      f"{max(c['lane_max'][1] for c in counts)}; j with any lane's: mean "
                      f"{statistics.mean(c['union'][0] for c in counts):.3f}, most "
                      f"{max(c['union'][1] for c in counts)}", flush=True)
                for k, c in zip(row["steps"], row["near"]):
                    print(f"    step {k}: {c['share']:.4%} evaluated; the most of one lane "
                          f"(mean, max over warps) {c['lane_max'][0]:.3f}, "
                          f"{c['lane_max'][1]}; j with any lane's {c['union'][0]:.3f}, "
                          f"{c['union'][1]}", flush=True)
            del kept

        for want_obs in (True, False):
            kenv, k, tiles, acts, draws, spawn = cs._k4_state(torch, "daisy", E, N,
                                                              cs.SEED + 11)
            k4 = lambda: ops.fused_env_step(  # noqa: E731
                tiles, acts, draws, spawn, kenv.cfg, want_obs=want_obs)
            ms = res[f"k4_{'obs' if want_obs else 'no_obs'}_ms"] = cs.device_ms(torch, k4, cyc)
            print(f"  E={E} K4 daisy{'' if want_obs else ' (no obs)'}: {ms:.4f} ms",
                  flush=True)
            del kenv, tiles, acts, draws, spawn

        # device ms of one fused step (the draws included): set beside the
        # rates below, it says how much of a step the host takes
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED + 3)
        st, _ = env.reset(gen)
        ids = torch.randint(0, 6, (E, N), generator=gen, device="cuda", dtype=torch.int32)
        cur, acts = lanes.state_to_lanes(env, st), lanes.actions_to_lanes(env, ids)
        res["fused_step_device_ms"] = cs.device_ms(
            torch, lambda: lanes.step_lanes(env, cur, acts), cyc)
        print(f"  E={E} device ms of one fused env step: "
              f"{res['fused_step_device_ms']:.4f}", flush=True)
        del st, cur, acts
        gen.manual_seed(cs.SEED + 3)
        rates = {"composed": cs._env_rate(torch, env, gen, False),
                 "fused": cs._env_rate(torch, env, gen, True),
                 "fused_no_obs": cs._env_rate(torch, env, gen, True, want_obs=False)}
        res["arena_steps_per_s"] = rates
        print(f"  E={E} daisy env arena-steps/s: "
              + "; ".join(f"{k} {v:,.0f}" for k, v in rates.items()), flush=True)
        del env, pos, yaw
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
