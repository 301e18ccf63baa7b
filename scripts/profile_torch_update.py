#!/usr/bin/env python3
"""Where the time of the port's POCA update goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_update.py [--config configs/DirGate_dandelion.yaml]
                                            [--num_envs 1024] [--horizon 200]
                                            [--minibatches 2]
                                            [--fused_attention]
                                            [--mixed_precision [--mp_stages qkvo]]
                                            [--trace build/update_trace.json]

Loads ``--config`` through the port's loader (dandelion by default: hidden
512x2, N = 20 robots, the YAML's buffer and batch sizes), cuts it to
``--num_envs`` arenas and a ``--horizon``-decision rollout as
``chip_smoke.py`` does (``--fused_attention`` takes the critic's fused
branch; ``--mixed_precision`` gives the attention projections named in
``--mp_stages`` bf16 operands), collects one rollout (timed), takes one warm-up
minibatch step, then ``--minibatches`` minibatch steps with no tracing and
one more under ``torch.profiler``. A minibatch step is the chunked
gradient accumulation (``POCATrainer._accumulate_grads``, one forward and
one backward per chunk) and one Adam step. For the recurrent actor
(cyclamen) the minibatches are those of the longest BPTT windows, and the
predicted iteration counts every chunk pass of the update at their rate,
so it is an upper bound. Prints

  - the rollout's wall time, the wall time per minibatch step untraced and
    traced, and from them the iteration's predicted wall time and the
    update's share of it (``num_epochs`` x minibatches per epoch steps);
  - the device's busy share of the traced step;
  - device time by stage: the loss's forward (actor, critic value, all
    counterfactual baselines, and the rest: losses and glue), and the
    backward with the Adam step (every kernel outside the forward's spans:
    autograd runs the backward on its own thread);
  - the matrix products' share of the device time (cuBLAS's kernels, whose
    names hold "gemm", "xmma" or "nvjet"), float32 and bf16 apart, and the
    bf16 ones by name;
  - the kernels that took the most device time,

with the card's name and power limit, and a JSON line of the same numbers.
It needs a CUDA device and refuses to run without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAGES = ("forward", "forward.actor", "forward.critic_pass",
          "forward.all_baselines")
GEMM = re.compile(r"gemm|xmma|nvjet", re.IGNORECASE)


def gemm_kind(name: str):
    """"bf16" or "f32" for a matrix-product kernel of cuBLAS, else None.
    cuBLAS's nvjet kernels run on the tensor cores, which, with TF32 off,
    only the bf16 products reach."""
    if not GEMM.search(name):
        return None
    lower = name.lower()
    return "bf16" if "bf16" in lower or "nvjet" in lower else "f32"


def _staged(torch, name, fn):
    def run(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/DirGate_dandelion.yaml")
    ap.add_argument("--num_envs", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=200)
    ap.add_argument("--minibatches", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--fused_attention", action="store_true",
                    help="the critic's fused counterfactual attention")
    ap.add_argument("--mixed_precision", action="store_true",
                    help="bf16 operands for the critic's attention projections")
    ap.add_argument("--mp_stages", default="qkvo",
                    help="the projections that take bf16: a subset of 'qkvo'")
    ap.add_argument("--trace", default=None,
                    help="write the profiler's chrome trace to this path")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_update: no CUDA device is available", file=sys.stderr)
        return 1
    from swarmacb_torch.agents import POCATrainer, buffer
    from swarmacb_torch.config import DirectionalGateEnvCfg, load_config
    from swarmacb_torch.env import DirectionalGateEnv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)

    _, variant, pcfg, env_ov = load_config(ROOT / args.config)
    pcfg = dataclasses.replace(pcfg, horizon=args.horizon, seed=args.seed,
                               fused_attention=args.fused_attention or pcfg.fused_attention,
                               mixed_precision=args.mixed_precision, mp_stages=args.mp_stages)
    env_kw = {k: v for k, v in env_ov.items() if k != "num_envs"}
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant,
                                                   num_envs=args.num_envs, **env_kw))
    trainer = POCATrainer(env, pcfg)
    c = pcfg

    gen = torch.Generator(device=env.device)
    gen.manual_seed(args.seed)
    state, obs = env.reset(gen)
    trainer.rollout(state, obs, trainer.init_actor_carry(), length=2)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, _, rollout, bootstrap, _ = trainer.rollout(state, obs, trainer.init_actor_carry())
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0

    returns, adv = buffer.compute_advantages(rollout, bootstrap, c.gamma, c.lam)
    adv = buffer.normalize_advantages(adv)
    if trainer.recurrent:
        # {L: the windows of L decisions}; profiled: the longest
        sources = trainer._window_batches(rollout, returns, adv)
        per_row, loss = max(sources), "_recurrent_loss"
    else:
        sources = {1: trainer._flatten_buffer(rollout, returns, adv)}
        per_row, loss = 1, "_feedforward_loss"
    passes = 0
    for L, w in sources.items():
        n = w["obs"].shape[0]
        size = trainer._minibatch_rows(n, L)
        passes += sum(trainer._grad_chunks(r, L)
                      for r in [size] * (n // size) + ([n % size] if n % size else []))
    passes *= c.num_epochs
    source = sources[per_row]
    rows = source["obs"].shape[0]
    mb = trainer._minibatch_rows(rows, per_row)
    per_epoch = -(-rows // mb)
    chunks = trainer._grad_chunks(mb, per_row)
    perm = torch.randperm(rows, generator=trainer.generator, device=env.device)
    batches = [{k: v[perm[i * mb:(i + 1) * mb]] for k, v in source.items()}
               for i in range(min(per_epoch, args.minibatches + 2))]

    def step(i):
        # the loss looked up at each call, so that the profiled step runs
        # the staged one below
        trainer._sgd_step(batches[i % len(batches)], c.clip_eps, c.beta,
                          getattr(trainer, loss), per_row)

    step(0)                                                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.minibatches):
        step(i + 1)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / args.minibatches

    setattr(trainer, loss, _staged(torch, "forward", getattr(trainer, loss)))
    trainer._apply_actor = _staged(torch, "forward.actor", trainer._apply_actor)
    actor = trainer.actor
    if trainer.recurrent:
        actor.forward_sequence = _staged(torch, "forward.actor", actor.forward_sequence)
    critic = trainer.critic
    critic.critic_pass = _staged(torch, "forward.critic_pass", critic.critic_pass)
    critic.all_baselines = _staged(torch, "forward.all_baselines",
                                   critic.all_baselines)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(args.minibatches + 1)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)

    # One stream: a kernel belongs to the innermost stage whose span on the
    # device's timeline holds it; kernels outside every span are the
    # backward's (autograd's engine thread launches them) and Adam's.
    events = prof.events()
    spans = sorted(((ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in events if ev.device_type == DeviceType.CUDA
                    and ev.is_user_annotation and ev.name in STAGES),
                   key=lambda s: s[1] - s[0])
    kernels = defaultdict(lambda: [0, 0.0])       # name → [count, device µs]
    stages = defaultdict(float)                   # name → device µs
    for ev in events:
        if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation:
            us = ev.time_range.elapsed_us()
            kernels[ev.name][0] += 1
            kernels[ev.name][1] += us
            stage = next((name for start, end, name in spans
                          if start <= ev.time_range.start and ev.time_range.end <= end),
                         "backward and Adam")
            stages[stage] += us
    busy_us = sum(us for _, us in kernels.values())
    gemm_us = {"f32": 0.0, "bf16": 0.0}
    for name, (_, us) in kernels.items():
        kind = gemm_kind(name)
        if kind is not None:
            gemm_us[kind] += us

    update_s = passes * step_s / chunks
    iteration_s = rollout_s + update_s
    print(f"rollout of {c.horizon} decisions x {env.num_envs} arenas: {rollout_s:.3f} s; "
          f"minibatch step ({mb} rows of {per_row} groups, {chunks} chunks of "
          f"{trainer._chunk_rows(mb, per_row)} rows): {step_s * 1e3:.1f} ms untraced, "
          f"{traced_s * 1e3:.1f} ms traced; {passes} chunk passes per update -> "
          f"iteration {iteration_s:.2f} s, update {update_s / iteration_s:.1%} "
          f"of it; device busy {busy_us / (traced_s * 1e6):.1%} of the traced step; "
          f"critic fused_attention={bool(c.fused_attention)}, mixed_precision="
          f"{c.mixed_precision} (mp_stages {c.mp_stages!r}); on {card}", flush=True)
    print("matrix products (cuBLAS) per minibatch step: " + ", ".join(
        f"{k} {v / 1e3:.3f} ms ({v / busy_us:.1%} of device time)" for k, v in gemm_us.items()))
    for name, (count, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
        if gemm_kind(name) == "bf16":
            print(f"  bf16 {us / 1e3:>9.3f} ms x{count:<5d} {name[:100]}")
    print("stage (device ms per minibatch step; \"forward\" is the forward's "
          "kernels outside its forward.* parts)")
    for name in (*STAGES, "backward and Adam"):
        print(f"  {name:<24} {stages[name] / 1e3:>10.3f}")
    print(f"top kernels by device time (of {busy_us / 1e3:.3f} ms per step):")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:args.top]
    for name, (count, us) in top:
        print(f"  {us / 1e3:>9.3f} ms {us / busy_us:>6.1%} x{count:<5d} {name[:100]}")
    print(json.dumps({
        "card": card, "config": args.config, "num_envs": env.num_envs,
        "fused_attention": bool(c.fused_attention), "mixed_precision": c.mixed_precision,
        "mp_stages": c.mp_stages,
        "horizon": c.horizon, "minibatch_rows": mb, "groups_per_row": per_row,
        "chunks_per_minibatch": chunks, "chunk_passes_per_update": passes,
        "rollout_s": rollout_s,
        "minibatch_step_ms": step_s * 1e3, "traced_step_ms": traced_s * 1e3,
        "iteration_s_predicted": iteration_s,
        "update_share": update_s / iteration_s,
        "device_busy_share_traced": busy_us / (traced_s * 1e6),
        "stage_device_ms": {k: v / 1e3 for k, v in stages.items()},
        "gemm_device_ms": {k: v / 1e3 for k, v in gemm_us.items()},
        "gemm_share": {k: v / busy_us for k, v in gemm_us.items()},
        "top_kernels_ms": {k[:100]: v[1] / 1e3 for k, v in top},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
