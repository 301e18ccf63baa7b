#!/usr/bin/env python3
"""Training-throughput sweep over the arena count E for the PyTorch port:
the counterpart of ``scripts/sps_sweep.py``.

Measures end-to-end training agent-decisions/s (rollout plus the whole
3-epoch POCA update) through the port's trainer at a YAML's settings
(``configs/DirGate_<variant>.yaml``: horizon 1000, 3 epochs, the
ML-Agents minibatch derivation), so that the operating point of a long run
is a measured choice.

For each E it prints one JSON line:
  - ``first_iteration_s``: the first iteration, the kernel build and
    warm-up included (the JAX script's ``compile_plus_first_s``);
  - ``iter_s`` and ``decisions_per_sec`` over ``--iters`` timed
    iterations (host clock ending in ``torch.cuda.synchronize()``;
    decisions = horizon·E·N a iteration);
  - ``phase_split_s`` from one more iteration, synchronised after each
    phase: the rollout, the prep (the bootstrap value, λ-returns and
    advantages, up to the first minibatch) and the minibatch steps (Adam
    steps, each one ``_sgd_step``), beside ``blocked_iter``, that
    iteration's wall time (the synchronisations add to it);
  - the card's name and power limit (``nvidia-smi``).
The JAX script's ``path`` key is dropped: the port has one update path
(the split update is not ported; it bounds an XLA program's wall time).

Usage:
    python scripts/sps_sweep_torch.py --variant dandelion --envs 16,64,256,1024
    python scripts/sps_sweep_torch.py --variant daisy --envs 64 --fused_env_step on

It runs on the card; without one it exits with a message unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from swarmacb_torch.agents import POCATrainer  # noqa: E402
from swarmacb_torch.agents import trainer as trainer_module  # noqa: E402
from swarmacb_torch.config import load_config  # noqa: E402
from swarmacb_torch.config.poca_cfg import check_mp_stages  # noqa: E402
from swarmacb_torch.device import resolve_device  # noqa: E402
from swarmacb_torch.env import make_env  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _phase_split(trainer, device, env_state, obs, carry) -> dict:
    """One iteration with a synchronisation after each phase: the rollout
    (``collect`` less its bootstrap value), the prep (the bootstrap value,
    then everything up to the first minibatch step) and the minibatch
    steps. Returns the seconds of each, the count of minibatch steps and
    the iteration's wall time."""
    acc = {"rollout": 0.0, "prep": 0.0, "mb_steps": 0.0, "n_mb": 0}
    mark = {}
    collect, bootstrap, sgd_step = trainer.collect, trainer._bootstrap_fn, trainer._sgd_step

    def timed_collect(*a, **k):
        _sync(device)
        t = time.perf_counter()
        out = collect(*a, **k)
        _sync(device)
        mark["rollout_end"] = time.perf_counter()
        acc["rollout"] += mark["rollout_end"] - t
        return out

    def timed_bootstrap(*a, **k):
        _sync(device)
        t = time.perf_counter()
        out = bootstrap(*a, **k)
        _sync(device)
        dt = time.perf_counter() - t
        acc["rollout"] -= dt      # collect's time holds it
        acc["prep"] += dt
        return out

    def timed_sgd_step(*a, **k):
        _sync(device)
        t = time.perf_counter()
        if "rollout_end" in mark:   # the first step ends the prep
            acc["prep"] += t - mark.pop("rollout_end")
        out = sgd_step(*a, **k)
        _sync(device)
        acc["mb_steps"] += time.perf_counter() - t
        acc["n_mb"] += 1
        return out

    trainer.collect, trainer._bootstrap_fn, trainer._sgd_step = (
        timed_collect, timed_bootstrap, timed_sgd_step)
    try:
        _sync(device)
        t0 = time.perf_counter()
        trainer.train_iteration(env_state, obs, carry)
        _sync(device)
        blocked = time.perf_counter() - t0
    finally:
        del trainer.collect, trainer._bootstrap_fn, trainer._sgd_step
    return {"rollout": acc["rollout"], "prep": acc["prep"], "mb_steps_total": acc["mb_steps"],
            "n_mb_steps": acc["n_mb"], "phase_sum": acc["rollout"] + acc["prep"] + acc["mb_steps"],
            "blocked_iter": blocked}


def measure(variant: str, E: int, iters: int, horizon: int | None, mixed_precision: bool,
            phase_split: bool, accum_chunk_groups: int | None = None,
            mp_stages: str | None = None, fused_env_step: bool | None = None,
            device="cuda") -> dict:
    device = resolve_device(device)
    _, variant, cfg, _ = load_config(ROOT / "configs" / f"DirGate_{variant}.yaml")
    if horizon is not None:
        cfg.horizon = horizon
    cfg.mixed_precision = mixed_precision
    if mp_stages is not None:
        cfg.mp_stages = check_mp_stages(mp_stages)
    if accum_chunk_groups is not None:
        cfg.accum_chunk_groups = accum_chunk_groups
    if fused_env_step is not None:
        cfg.fused_env_step = fused_env_step
    if mixed_precision and device.type == "cuda":
        # bf16 products sum in float32 and round once, as train_torch.py sets it
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    env = make_env("SwarmACB-DirectionalGate-v0", variant=variant, num_envs=E, device=device)
    trainer = POCATrainer(env, cfg)
    decisions_per_iter = cfg.horizon * E * env.num_agents
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    env_state, obs = env.reset(gen)
    carry = trainer.init_actor_carry()

    _sync(device)
    t0 = time.perf_counter()
    env_state, obs, carry, _ = trainer.train_iteration(env_state, obs, carry)
    _sync(device)
    first_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(iters):
        env_state, obs, carry, _ = trainer.train_iteration(env_state, obs, carry)
    _sync(device)
    dt = time.perf_counter() - t0

    out = {
        "variant": variant, "E": E, "horizon": cfg.horizon,
        "group_mb": trainer.group_mb,
        "chunk_rows": trainer._chunk_rows(trainer.group_mb),
        "mixed_precision": mixed_precision,
        "mp_stages": cfg.mp_stages if mixed_precision else None,
        "fused_env_step": trainer.use_lanes,
        "first_iteration_s": round(first_s, 3),
        "iters": iters,
        "iter_s": round(dt / iters, 3),
        "decisions_per_sec": round(decisions_per_iter * iters / dt),
    }
    if phase_split:
        out["phase_split_s"] = {k: (v if k == "n_mb_steps" else round(v, 3)) for k, v in
                                _phase_split(trainer, device, env_state, obs, carry).items()}
    out["card"] = card_name(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variant", default="dandelion")
    p.add_argument("--envs", default="16,64,256,1024")
    p.add_argument("--iters", type=int, default=2)
    p.add_argument("--horizon", type=int, default=None,
                   help="Override horizon (default: the YAML's 1000). "
                        "Useful to bound measurement time at very large E "
                        "— per-decision cost is linear in T.")
    p.add_argument("--mixed_precision", action="store_true")
    p.add_argument("--mp_stages", type=str, default=None,
                   help="Subset of 'qkvo' for --mixed_precision "
                        "(POCAConfig.mp_stages)")
    p.add_argument("--no-phase-split", action="store_true")
    p.add_argument("--fused_env_step", choices=("config", "on", "off"),
                   default="config",
                   help="fused single-kernel env step in the rollout "
                        "(POCAConfig.fused_env_step)")
    p.add_argument("--accum_chunk_groups", type=int, default=None,
                   help="Override POCAConfig.accum_chunk_groups (the "
                        "gradient-accumulation chunk size in groups)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; refused without a card) or cpu")
    args = p.parse_args(argv)
    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        print(f"sps_sweep_torch: {exc}", file=sys.stderr)
        return 1

    for E in [int(e) for e in args.envs.split(",")]:
        r = measure(args.variant, E, args.iters, args.horizon,
                    args.mixed_precision, not args.no_phase_split,
                    args.accum_chunk_groups, args.mp_stages,
                    None if args.fused_env_step == "config"
                    else args.fused_env_step == "on", device=args.device)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
