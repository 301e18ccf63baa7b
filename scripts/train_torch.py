#!/usr/bin/env python3
"""Train POCA with the PyTorch port (``swarmacb_torch``), on the card.

The port's counterpart of ``scripts/train.py``: the same YAML configs and
flags, loaded through the port's own loader. ``--device`` (default: the
card) takes the place of ``--platform``; ``--device cpu`` runs every op's
plain version. ``--use_pallas`` and ``--fused_tail`` are accepted and
ignored, since the port picks its kernels by the device of the tensors.

Several devices (``swarmacb_torch.parallel``): ``--data_parallel n`` starts
n ranks on this host (rank r on ``cuda:r``; with ``--device cpu``, n gloo
ranks on the CPU), each holding num_envs / n arenas and the same weights,
the gradients averaged over the ranks after every minibatch. ``auto`` means
every visible GPU, so one GPU (or the CPU) trains in this process as
before. ``--distributed`` joins a process group that ``torchrun`` started
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), NCCL on the card. Rank 0 alone prints the per-iteration
line and writes summaries and checkpoints; each rank prints its parameter
digest at the end. With ``--seeds``, ``--data_parallel n`` spreads the seed
lanes over n devices of this process instead.

Usage:
    python scripts/train_torch.py --config configs/DirGate_dandelion.yaml

    # cyclamen: the LSTM actor, BPTT over 64-decision windows
    python scripts/train_torch.py --config configs/DirGate_cyclamen.yaml

    # resume from the newest checkpoint in the config's checkpoint_dir
    python scripts/train_torch.py --config configs/DirGate_dandelion.yaml \
        --checkpoint latest

    # bf16 operands for the critic's attention projections, at the stages
    # validated for the variant
    python scripts/train_torch.py --config configs/DirGate_dandelion.yaml \
        --mixed_precision --mp_stages auto

    # ten seeds in one process, lanes stepped in lockstep; per-seed
    # <log_dir>_seed<s> and <checkpoint_dir>_seed<s>; resume all with
    # --checkpoint latest
    python scripts/train_torch.py --config configs/DirGate_dandelion.yaml \
        --seeds 0-9 --num_envs 16

    # a small run on the CPU
    python scripts/train_torch.py --config configs/DirGate_dandelion.yaml \
        --device cpu --num_envs 2 --hidden_dim 16 --total_timesteps 40000

    # data-parallel over the 4 GPUs of one host, or over 2 hosts of 4 GPUs
    python scripts/train_torch.py --config configs/DirGate_dandelion.yaml \
        --num_envs 1024 --data_parallel 4
    torchrun --nnodes 2 --nproc_per_node 4 --rdzv_endpoint HOST:29500 \
        scripts/train_torch.py --config configs/DirGate_dandelion.yaml \
        --num_envs 1024 --distributed
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import sys
import tempfile
from typing import NamedTuple, Optional

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from swarmacb_torch.agents import (Checkpointer, POCAConfig, POCATrainer,  # noqa: E402
                                   SeedParallelTrainer)
from swarmacb_torch.config import DirectionalGateEnvCfg  # noqa: E402
from swarmacb_torch.config.poca_cfg import check_mp_stages  # noqa: E402
from swarmacb_torch.config.loader import load_config, print_config  # noqa: E402
from swarmacb_torch.device import resolve_device  # noqa: E402
from swarmacb_torch.env import make_env  # noqa: E402
from swarmacb_torch.parallel import digest, make_mesh  # noqa: E402
from swarmacb_torch.utils import make_writer, print_line  # noqa: E402

# --mp_stages auto: the bf16 stages each variant was checked with over a
# full training run (scripts/train.py); a variant outside the table has
# none, and 'auto' refuses it rather than guess
VALIDATED_MP_STAGES = {"dandelion": "qkvo", "lily": "qk", "cyclamen": "qk",
                       "tulip": "qkvo", "daisy": "qkvo"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SwarmACB POCA training (PyTorch port)")
    p.add_argument("--config", type=str, default=None,
                   help="Path to ML-Agents-style YAML config file")
    p.add_argument("--task", type=str, default="SwarmACB-DirectionalGate-v0")
    p.add_argument("--variant", type=str, default=None,
                   choices=["dandelion", "daisy", "lily", "tulip", "cyclamen"])
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Checkpoint directory to resume from, or 'latest' to "
                        "resume from the newest checkpoint in --checkpoint_dir")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="Trace iterations 2-4 with torch.profiler into "
                        "DIR/trace.json (chrome://tracing, Perfetto)")
    p.add_argument("--total_timesteps", type=int, default=None)
    p.add_argument("--checkpoint_interval", type=int, default=None,
                   help="Agent-decisions between checkpoint saves")
    p.add_argument("--decision_period", type=int, default=None)
    p.add_argument("--hidden_dim", type=int, default=None)
    p.add_argument("--num_layers", type=int, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--seeds", type=str, default=None,
                   help="Train several seeds in one process, e.g. '0-9' or "
                        "'0,2,5': per-seed <log_dir>_seed<s> and "
                        "<checkpoint_dir>_seed<s>")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 operands for the critic's attention projections")
    p.add_argument("--mp_stages", type=str, default=None,
                   help="Which projections take bf16 under --mixed_precision: "
                        "a subset of 'qkvo', or 'auto' for the variant's "
                        "validated stages")
    p.add_argument("--use_pallas", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="Ignored: the env kernels run on the card, their "
                        "plain versions on the CPU")
    p.add_argument("--fused_tail", type=str, default="config",
                   choices=["config", "on", "off"],
                   help="Ignored: the critic tail's kernels run on the card, "
                        "their plain version on the CPU")
    p.add_argument("--fused_attention", type=str, default="config",
                   choices=["config", "on", "off"],
                   help="Fused counterfactual attention in place of the "
                        "critic's tail. 'config' defers to "
                        "POCAConfig.fused_attention (None there = off)")
    p.add_argument("--fused_env_step", type=str, default="config",
                   choices=["config", "on", "off"],
                   help="One fused kernel per env step in the training "
                        "rollout (env/lanes.py). 'config' defers to "
                        "POCAConfig.fused_env_step (None there = off)")
    p.add_argument("--distributed", action="store_true",
                   help="Join the process group torchrun started (RANK, "
                        "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    p.add_argument("--data_parallel", type=str, default="auto",
                   help="'auto' (every visible GPU; one process when there is "
                        "one), 'off' (one device), or a number of ranks: on "
                        "this host without --distributed, else the world "
                        "torchrun started")
    p.add_argument("--no-tensorboard", action="store_true")
    return p


def note_ignored(args) -> None:
    """Say which accepted options the port ignores."""
    if args.use_pallas != "auto" or args.fused_tail != "config":
        print("[train] NOTE: --use_pallas and --fused_tail are ignored: the "
              "port runs its kernels on the card and their plain versions on "
              "the CPU")


def _parse_seeds(spec: str) -> list[int]:
    """'0-9' / '0,2,5' / mixes of both → sorted unique seed list. A spec
    that names no seed or holds a reversed range stops the run."""
    out: list[int] = []
    try:
        for part in spec.split(","):
            part = part.strip()
            if "-" in part[1:]:
                lo, hi = (int(x) for x in part.split("-", 1))
                if lo > hi:
                    raise SystemExit(f"[train] --seeds {spec!r}: reversed range {part!r}")
                out.extend(range(lo, hi + 1))
            elif part:
                out.append(int(part))
    except ValueError as exc:
        raise SystemExit(f"[train] --seeds {spec!r}: {exc}") from exc
    if not out:
        raise SystemExit(f"[train] --seeds {spec!r} names no seed")
    return sorted(set(out))


def resolve_config(args):
    """(run_name, variant, POCAConfig, env overrides): the YAML (or the
    variant's defaults), then the CLI overrides, which always win
    (scripts/train.py)."""
    if args.config:
        run_name, variant, cfg, env_overrides = load_config(args.config)
    else:
        variant = args.variant or "dandelion"
        run_name = f"poca_{variant}_{args.task}"
        hd, nl = (128, 1) if variant in ("tulip", "cyclamen") else (512, 2)
        cfg = POCAConfig(
            hidden_dim=args.hidden_dim or hd,
            num_layers=args.num_layers or nl,
            decision_period=args.decision_period or 1,
            recurrent=(variant == "cyclamen"),
        )
        cfg.log_dir = f"runs/{run_name}"
        cfg.checkpoint_dir = f"checkpoints/poca_{variant}"
        env_overrides = {}

    if args.variant is not None:
        variant = args.variant
        cfg.recurrent = (variant == "cyclamen")
    for name in ("total_timesteps", "checkpoint_interval", "hidden_dim",
                 "num_layers", "decision_period", "log_dir", "checkpoint_dir",
                 "seed"):
        if getattr(args, name) is not None:
            setattr(cfg, name, getattr(args, name))
    if args.mixed_precision:
        cfg.mixed_precision = True
    if args.mp_stages == "auto":
        if variant not in VALIDATED_MP_STAGES:
            raise SystemExit(f"[train] --mp_stages auto: no validated bf16 stages for "
                             f"'{variant}'; pass an explicit subset of 'qkvo'")
        cfg.mp_stages = VALIDATED_MP_STAGES[variant]
    elif args.mp_stages is not None:
        try:
            cfg.mp_stages = check_mp_stages(args.mp_stages)
        except ValueError as exc:
            raise SystemExit(f"[train] --mp_stages: {exc}") from exc
    if args.fused_attention != "config":
        cfg.fused_attention = args.fused_attention == "on"
    if args.fused_env_step != "config":
        cfg.fused_env_step = args.fused_env_step == "on"
    if args.num_envs is not None:
        env_overrides["num_envs"] = args.num_envs
    return run_name, variant, cfg, env_overrides


def resolve_world(args, device, seeds) -> int:
    """The number of data-parallel ranks, or with ``--seeds`` of devices
    for the seed lanes (scripts/train.py:251-276). ``--distributed`` takes
    torchrun's WORLD_SIZE, which an explicit ``--data_parallel`` must
    equal; otherwise ``auto`` is every visible GPU (1 on the CPU) and an
    explicit count on the card may not exceed the visible GPUs."""
    dp = args.data_parallel
    if args.distributed:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if dp not in ("auto", str(world)):
            raise SystemExit(f"[train] --data_parallel {dp} under --distributed: torchrun "
                             f"started {world} rank(s)")
        if seeds is not None and world > 1:
            raise SystemExit("[train] --seeds with --distributed over several processes: "
                             "a seed mesh is one process over its devices")
        return world
    if dp == "off":
        return 1
    if dp == "auto":
        return torch.cuda.device_count() if device.type == "cuda" else 1
    try:
        n = int(dp)
    except ValueError:
        raise SystemExit(f"[train] --data_parallel {dp!r}: 'auto', 'off' or a count") from None
    if n < 1:
        raise SystemExit(f"[train] --data_parallel {n}: at least one rank")
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"[train] --data_parallel {n}: {torch.cuda.device_count()} GPU(s) "
                         "are visible")
    return n


class Plan(NamedTuple):
    """The run a command line asks for, checked before anything is built."""
    args: argparse.Namespace
    run_name: str
    variant: str
    cfg: POCAConfig
    env_overrides: dict
    env_cfg: DirectionalGateEnvCfg
    device: torch.device
    seeds: Optional[list]
    world: int


def plan(argv=None) -> Plan:
    """Parse and check a command line: the config, the device, and the
    ranks (E % n, or S % n with ``--seeds``)."""
    args = build_parser().parse_args(argv)
    seeds = None if args.seeds is None else _parse_seeds(args.seeds)
    if seeds is not None and args.checkpoint not in (None, "latest"):
        raise SystemExit("[train] --seeds resumes only via --checkpoint latest "
                         "(per-seed directories)")
    run_name, variant, cfg, env_overrides = resolve_config(args)
    device = resolve_device(args.device)
    env_cfg = DirectionalGateEnvCfg(variant=variant).replace(**env_overrides)
    world = resolve_world(args, device, seeds)
    if seeds is not None and len(seeds) % world:
        raise SystemExit(f"[train] {len(seeds)} seeds not divisible by {world} devices; "
                         "adjust --seeds or --data_parallel")
    if seeds is None and env_cfg.num_envs % world:
        raise SystemExit(f"[train] num_envs={env_cfg.num_envs} not divisible by {world} "
                         "ranks; adjust --num_envs or --data_parallel")
    return Plan(args, run_name, variant, cfg, env_overrides, env_cfg, device, seeds, world)


def prepare(argv=None, rank=None, init_method=None):
    """Everything up to the training loop: config, checks, env, trainer,
    writer, checkpointer and the resume. Returns (POCATrainer,
    Checkpointer), or with ``--seeds`` (SeedParallelTrainer, a
    Checkpointer per seed). Under ``--distributed``, or as ``rank`` of a
    run this script spawned (meeting at ``init_method``), the trainer is
    that rank of the data-parallel run."""
    p = plan(argv)
    args, cfg, device = p.args, p.cfg, p.device
    mesh = None
    if p.seeds is None and (args.distributed or rank is not None):
        mesh = make_mesh(world=p.world, rank=rank,
                         device=device if rank is None else _rank_device(device, rank),
                         init_method=init_method)
        device = mesh.device
    if mesh is None or mesh.is_main:
        note_ignored(args)
        print_config(p.run_name, p.variant, cfg, p.env_overrides)
    if cfg.mixed_precision and device.type == "cuda":
        # bf16 products sum in float32 and round once, as the JAX package's
        # do (models/networks.py, _project)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if p.seeds is not None:
        env = make_env(args.task, cfg=p.env_cfg, device=device)
        devices = None if p.world == 1 else [_rank_device(device, i) for i in range(p.world)]
        return _prepare_seeds(args, cfg, env, p.seeds, devices)

    E = p.env_cfg.num_envs
    if mesh is None:
        env = make_env(args.task, cfg=p.env_cfg, device=device)
    else:
        lo, hi = mesh.shard_range(E)
        env = make_env(args.task, cfg=p.env_cfg.replace(num_envs=hi - lo), device=device,
                       shard=(lo, E))
        if mesh.is_main:
            print(f"[train] data-parallel over {mesh.world} rank(s) ({mesh.backend}): "
                  f"{hi - lo} arenas a rank", flush=True)
    writer = None
    if not args.no_tensorboard and (mesh is None or mesh.is_main):
        writer = make_writer(cfg.log_dir)
    trainer = POCATrainer(env, cfg, writer=writer, mesh=mesh)
    if writer is not None:
        hp_text = "\n".join(f"{k}: {v}" for k, v in vars(cfg).items())
        writer.add_text("hyperparameters", hp_text, 0)

    ckpt = Checkpointer(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)
    if args.checkpoint == "latest":
        latest = ckpt.latest()
        if latest is not None:
            ckpt.restore(latest, trainer)
        else:
            print(f"[train] no checkpoint in {cfg.checkpoint_dir}; starting fresh")
    elif args.checkpoint:
        ckpt.restore(args.checkpoint, trainer)
    if args.profile:
        trainer.profile_dir = args.profile
    return trainer, ckpt


def _rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device on this host: ``cuda:rank``, or the CPU."""
    return torch.device("cuda", rank) if device.type == "cuda" else device


def _prepare_seeds(args, cfg, env, seeds, devices=None):
    """The seed-parallel trainer (scripts/train.py's seed branch): a writer
    and a checkpointer per seed under ``<log_dir>_seed<s>`` and
    ``<checkpoint_dir>_seed<s>``, each lane resumed from the newest step all
    seeds share with ``--checkpoint latest``; ``devices`` spreads the lanes
    over several devices."""
    log_base = cfg.log_dir.rstrip("/")
    ckpt_base = cfg.checkpoint_dir.rstrip("/")
    writers = None
    if not args.no_tensorboard:
        writers = [make_writer(f"{log_base}_seed{s}") for s in seeds]
    cks = [Checkpointer(f"{ckpt_base}_seed{s}", keep=cfg.keep_checkpoints) for s in seeds]
    trainer = SeedParallelTrainer(env, cfg, seeds, writers=writers, mesh=devices)
    where = env.device if devices is None else f"{len(devices)} devices ({devices[0]}, ...)"
    print(f"[train] seed-parallel: {len(seeds)} lanes ({seeds}) x E={env.num_envs} "
          f"arenas, stepped in lockstep on {where}")
    if writers is not None:
        hp_text = "\n".join(f"{k}: {v}" for k, v in vars(cfg).items())
        for w in writers:
            w.add_text("hyperparameters", hp_text, 0)
    if args.checkpoint == "latest" and not trainer.try_resume(cks):
        print("[train] no common checkpoint step across seed dirs; starting fresh")
    if args.profile:
        print("[train] NOTE: --profile is not wired for seed-parallel runs; "
              "profile a serial run of one seed instead")
    return trainer, cks


def run(argv=None, rank=None, init_method=None):
    """``prepare`` and train; returns the trainer. A rank of a
    data-parallel run prints its parameter digest and leaves the process
    group at the end."""
    trainer, ckpt = prepare(argv, rank=rank, init_method=init_method)
    seeded = isinstance(trainer, SeedParallelTrainer)
    writers = (trainer.writers or []) if seeded else [trainer.writer]
    mesh = None if seeded else trainer.mesh
    try:
        if seeded:
            trainer.train(checkpointers=ckpt)
        else:
            trainer.train(checkpointer=ckpt)
        if mesh is not None:
            params = [*trainer.actor.parameters(), *trainer.critic.parameters()]
            print_line(f"[train] rank {mesh.rank}/{mesh.world} ({mesh.backend}, {mesh.device}): "
                       f"step {trainer.global_step:,}, parameter digest {digest(params)}")
    finally:
        for w in writers:
            if w is not None:
                w.close()
        if mesh is not None:
            mesh.close()
    return trainer


def _rank_main(rank: int, argv: list, world: int, on_cpu: bool, init_method: str) -> None:
    """The entry point of a rank that ``main`` spawned."""
    if on_cpu:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    run(argv, rank=rank, init_method=init_method)


def main(argv=None):
    """Train; returns the trainer (the SeedParallelTrainer with ``--seeds``).
    ``--data_parallel n`` (n > 1, without ``--distributed`` or ``--seeds``)
    spawns n ranks, trains in them and returns None; run this file as a
    script for that, since the ranks import it as their main module."""
    argv = list(sys.argv[1:] if argv is None else argv)
    p = plan(argv)
    if p.args.distributed or p.seeds is not None or p.world == 1:
        return run(argv)
    store = tempfile.mkdtemp(prefix="train_torch_ranks_")
    try:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=p.world, join=True,
            args=(argv, p.world, p.device.type == "cpu", f"file://{store}/rendezvous"))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return None


if __name__ == "__main__":
    main()
