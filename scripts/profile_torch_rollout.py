#!/usr/bin/env python3
"""Where the time of the port's acting path goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_rollout.py [--num_envs 1024] [--decisions 20]
                                             [--config configs/DirGate_dandelion.yaml]
                                             [--trace build/rollout_trace.json]

Loads ``--config`` (dandelion by default) through the port's loader (hidden
512x2, N = 20 robots), cuts it to ``--num_envs`` arenas, warms the rollout up,
then collects ``--decisions`` decisions twice, first with no tracing and then
under ``torch.profiler``, and prints

  - the wall time per decision and the agent-decisions/s of the untraced
    window, and the wall time of the traced one (the difference is the
    profiler's cost),
  - the device's busy share of the traced window (kernel and copy time over
    its wall time),
  - device time, host time and kernels by stage: env step, critic state,
    actor, critic value, all counterfactual baselines, and the rest of the
    loop (a stage's kernels are those inside its span on the device's
    timeline),
  - the kernels that took the most device time,

with the card's name and power limit, and a JSON line of the same numbers.
It needs a CUDA device and refuses to run without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAGES = ("env.step", "env.critic_state", "actor", "critic.critic_pass",
          "critic.all_baselines")


def _staged(torch, name, fn):
    def run(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num_envs", type=int, default=1024)
    ap.add_argument("--decisions", type=int, default=20)
    ap.add_argument("--config", default="configs/DirGate_dandelion.yaml")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default=None,
                    help="write the profiler's chrome trace to this path")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_rollout: no CUDA device is available", file=sys.stderr)
        return 1
    from swarmacb_torch.agents import POCATrainer
    from swarmacb_torch.config import DirectionalGateEnvCfg, load_config
    from swarmacb_torch.env import DirectionalGateEnv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)

    _, variant, pcfg, env_ov = load_config(ROOT / args.config)
    pcfg = dataclasses.replace(pcfg, seed=args.seed)
    env_kw = {k: v for k, v in env_ov.items() if k != "num_envs"}
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant,
                                                   num_envs=args.num_envs, **env_kw))
    trainer = POCATrainer(env, pcfg)
    env.step = _staged(torch, "env.step", env.step)
    env.critic_state = _staged(torch, "env.critic_state", env.critic_state)
    trainer._apply_actor = _staged(torch, "actor", trainer._apply_actor)
    critic = trainer.critic
    critic.critic_pass = _staged(torch, "critic.critic_pass", critic.critic_pass)
    critic.all_baselines = _staged(torch, "critic.all_baselines", critic.all_baselines)

    gen = torch.Generator(device=env.device)
    gen.manual_seed(args.seed)
    state, obs = env.reset(gen)
    carry = trainer.init_actor_carry()
    state, obs, carry, *_ = trainer.rollout(state, obs, carry, length=5)  # warm-up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    state, obs, carry, *_ = trainer.rollout(state, obs, carry, length=args.decisions,
                                            want_bootstrap=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.rollout(state, obs, carry, length=args.decisions, want_bootstrap=False)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)

    # One stream: a kernel belongs to the stage whose span on the device's
    # timeline holds it; kernels outside every span (sampling, log-probs,
    # rollout storage) are "other".
    events = prof.events()
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in events if ev.device_type == DeviceType.CUDA
                   and ev.is_user_annotation and ev.name in STAGES)
    kernels = defaultdict(lambda: [0, 0.0])       # name → [count, device µs]
    stages = defaultdict(lambda: [0.0, 0.0, 0])   # name → [device µs, host µs, kernels]
    for ev in events:
        if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation:
            us = ev.time_range.elapsed_us()
            kernels[ev.name][0] += 1
            kernels[ev.name][1] += us
            stage = next((name for start, end, name in spans
                          if start <= ev.time_range.start and ev.time_range.end <= end),
                         "other")
            stages[stage][0] += us
            stages[stage][2] += 1
        elif ev.device_type == DeviceType.CPU and ev.name in STAGES:
            stages[ev.name][1] += ev.cpu_time_total
    busy_us = sum(us for _, us in kernels.values())

    n = args.decisions
    decisions = n * env.num_envs * env.num_agents
    print(f"window: {n} decisions x {env.num_envs} arenas x {env.num_agents} robots, "
          f"{wall_s * 1e3 / n:.3f} ms wall per decision untraced "
          f"({decisions / wall_s:,.0f} agent-decisions/s), {traced_s * 1e3 / n:.3f} "
          f"ms traced, device busy {busy_us / (traced_s * 1e6):.1%} of the traced "
          f"window, on {card}", flush=True)
    print("stage                    device ms/decision   host ms/decision   kernels/decision")
    for name in (*STAGES, "other"):
        dev_us, cpu_us, count = stages[name]
        print(f"  {name:<22} {dev_us / 1e3 / n:>12.4f} {cpu_us / 1e3 / n:>18.4f} "
              f"{count / n:>18.1f}")
    print(f"top kernels by device time (of {busy_us / 1e3 / n:.4f} ms per decision):")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:args.top]
    for name, (count, us) in top:
        print(f"  {us / 1e3 / n:>9.4f} ms/decision {us / busy_us:>6.1%} "
              f"x{count / n:>5.1f}  {name[:110]}")
    print(json.dumps({
        "card": card, "num_envs": env.num_envs, "decisions": n,
        "wall_ms_per_decision": wall_s * 1e3 / n,
        "traced_wall_ms_per_decision": traced_s * 1e3 / n,
        "agent_decisions_per_s": decisions / wall_s,
        "device_busy_share_traced": busy_us / (traced_s * 1e6),
        "kernels_per_decision": sum(c for c, _ in kernels.values()) / n,
        "stage_device_ms_per_decision": {k: v[0] / 1e3 / n for k, v in stages.items()},
        "stage_host_ms_per_decision": {k: v[1] / 1e3 / n for k, v in stages.items()},
        "stage_kernels_per_decision": {k: v[2] / n for k, v in stages.items()},
        "top_kernels_ms_per_decision": {k[:110]: v[1] / 1e3 / n for k, v in top},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
