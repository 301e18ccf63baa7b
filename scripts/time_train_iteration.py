#!/usr/bin/env python3
"""Wall time of one training iteration of a config at the smoke cut, on
one NVIDIA GPU, with the rollout and the update timed apart.

    python3 scripts/time_train_iteration.py [--root DIR]
                                            [--config configs/DirGate_dandelion.yaml]
                                            [--num_envs 1024] [--horizon 200]
                                            [--hidden_dim H]
                                            [--fused_attention {config,on,off}]
                                            [--mixed_precision] [--mp_stages auto]

Loads ``--config`` through the port's loader, cuts it to ``--num_envs``
arenas and a ``--horizon``-decision rollout as ``chip_smoke.py`` does
(``--hidden_dim`` sets the networks' width, as ``train_torch.py``'s flag:
1024 sends the critic tail to the wide route; ``--fused_attention`` as
``train_torch.py``'s flag: "on" puts the fused attention, K5f and K5b, in
place of the tail, "config" defers to the YAML; ``--mixed_precision``
and ``--mp_stages`` as ``train_torch.py``'s flags: bf16 operands for the
critic's projections named, or with "auto" the variant's validated ones),
takes a 2-decision warm-up rollout, then times one
``POCATrainer.train_iteration`` (host clock, ending in
``torch.cuda.synchronize()``) and prints the kernels it launched. ``--root`` times the package of another
checkout (unpack the parent with ``git archive <commit> | tar -x -C
runs/parent``); set two versions side by side in one call as parent,
change, change, parent, one process each. Prints one line with the card's
name and power limit. It needs a CUDA device and refuses to run without
one.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose swarmacb_torch is timed")
    ap.add_argument("--config", default="configs/DirGate_dandelion.yaml")
    ap.add_argument("--num_envs", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=200)
    ap.add_argument("--hidden_dim", type=int, default=None)
    ap.add_argument("--fused_attention", default="config", choices=["config", "on", "off"])
    ap.add_argument("--mixed_precision", action="store_true")
    ap.add_argument("--mp_stages", default=None,
                    help="a subset of 'qkvo', or 'auto' (default: the config's)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("time_train_iteration: no CUDA device is available", file=sys.stderr)
        return 1
    import swarmacb_torch
    from swarmacb_torch import ops
    from swarmacb_torch.agents import POCATrainer
    from swarmacb_torch.config import DirectionalGateEnvCfg, load_config
    from swarmacb_torch.env import DirectionalGateEnv

    if Path(swarmacb_torch.__file__).resolve().parents[1] != root:
        print(f"time_train_iteration: swarmacb_torch is not {root}'s", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()

    _, variant, pcfg, env_ov = load_config(root / args.config)
    pcfg = dataclasses.replace(pcfg, horizon=args.horizon, seed=0,
                               hidden_dim=args.hidden_dim or pcfg.hidden_dim)
    if args.fused_attention != "config":
        pcfg = dataclasses.replace(pcfg, fused_attention=args.fused_attention == "on")
    if args.mixed_precision:
        pcfg = dataclasses.replace(pcfg, mixed_precision=True)
        # bf16 products sum in float32 and round once, as train_torch.py sets it
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if args.mp_stages is not None:
        stages = args.mp_stages
        if stages == "auto":
            spec = importlib.util.spec_from_file_location(
                "train_torch", root / "scripts" / "train_torch.py")
            train_torch = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(train_torch)
            stages = train_torch.VALIDATED_MP_STAGES[variant]
        pcfg = dataclasses.replace(pcfg, mp_stages=stages)
    env_kw = {k: v for k, v in env_ov.items() if k != "num_envs"}
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant,
                                                   num_envs=args.num_envs, **env_kw))
    trainer = POCATrainer(env, pcfg)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(100)
    state, obs = env.reset(gen)
    trainer.rollout(state, obs, trainer.init_actor_carry(), length=2)      # warm-up
    torch.cuda.synchronize()

    rollout_s = []
    collect = trainer.collect

    def timed_collect(*a, **k):
        t0 = time.perf_counter()
        out = collect(*a, **k)
        torch.cuda.synchronize()
        rollout_s.append(time.perf_counter() - t0)
        return out

    trainer.collect = timed_collect
    gen.manual_seed(1)
    state, obs = env.reset(gen)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    trainer.train_iteration(state, obs, trainer.init_actor_carry())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ", ".join(f"{k} {v}" for k, v in ops.launches.items() if v)
    print(f"{root} {args.config} E={args.num_envs} T={args.horizon} "
          f"hidden={pcfg.hidden_dim} fused_attention={pcfg.fused_attention} "
          f"precision={f'bf16 {pcfg.mp_stages}' if pcfg.mixed_precision else 'float32'}: "
          f"launches {counts}; iteration {wall:.3f} s, "
          f"rollout {rollout_s[0]:.3f} s, update {wall - rollout_s[0]:.3f} s; on {card}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
