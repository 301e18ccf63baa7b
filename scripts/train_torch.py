#!/usr/bin/env python3
"""Train POCA with the PyTorch port (``swarmacb_torch``), on the card.

The port's counterpart of ``scripts/train.py``: the same YAML configs and
flags, loaded through the port's own loader. ``--device`` (default: the
card) takes the place of ``--platform``; ``--device cpu`` runs every op's
plain version. ``--use_pallas`` and ``--fused_tail`` are accepted and
ignored, since the port picks its kernels by the device of the tensors.
Options the port does not have yet (``--distributed``, ``--data_parallel``
over several devices) stop the run before the env is built.

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
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from swarmacb_torch.agents import (Checkpointer, POCAConfig, POCATrainer,  # noqa: E402
                                   SeedParallelTrainer)
from swarmacb_torch.agents.trainer import check_card_widths  # noqa: E402
from swarmacb_torch.config import DirectionalGateEnvCfg  # noqa: E402
from swarmacb_torch.config.poca_cfg import check_mp_stages  # noqa: E402
from swarmacb_torch.config.loader import load_config, print_config  # noqa: E402
from swarmacb_torch.device import resolve_device  # noqa: E402
from swarmacb_torch.env import make_env  # noqa: E402
from swarmacb_torch.utils import make_writer  # noqa: E402

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
                   help="Multi-host training: not ported yet")
    p.add_argument("--data_parallel", type=str, default="auto",
                   help="'auto', 'off' or '1': one device (more are not "
                        "ported yet)")
    p.add_argument("--no-tensorboard", action="store_true")
    return p


def refuse_unported(args) -> None:
    """Stop, before anything is built, on options the port lacks."""
    if args.distributed or args.data_parallel not in ("auto", "off", "1"):
        raise SystemExit("[train] --distributed and --data_parallel over "
                         "several devices are not ported yet (ROADMAP.md §1 "
                         "item 13)")
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


def prepare(argv=None):
    """Everything up to the training loop: config, checks, env, trainer,
    writer, checkpointer and the resume. Returns (POCATrainer,
    Checkpointer), or with ``--seeds`` (SeedParallelTrainer, a
    Checkpointer per seed)."""
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    seeds = None if args.seeds is None else _parse_seeds(args.seeds)
    if seeds is not None and args.checkpoint not in (None, "latest"):
        raise SystemExit("[train] --seeds resumes only via --checkpoint latest "
                         "(per-seed directories)")
    run_name, variant, cfg, env_overrides = resolve_config(args)
    print_config(run_name, variant, cfg, env_overrides)

    device = resolve_device(args.device)
    env_cfg = DirectionalGateEnvCfg(variant=variant).replace(**env_overrides)
    try:
        check_card_widths(device, env_cfg.num_agents, cfg)
    except ValueError as exc:
        raise SystemExit(f"[train] {exc}") from exc
    if cfg.mixed_precision and device.type == "cuda":
        # bf16 products sum in float32 and round once, as the JAX package's
        # do (models/networks.py, _project)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    env = make_env(args.task, cfg=env_cfg, device=device)
    if seeds is not None:
        return _prepare_seeds(args, cfg, env, seeds)

    writer = None if args.no_tensorboard else make_writer(cfg.log_dir)
    trainer = POCATrainer(env, cfg, writer=writer)
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


def _prepare_seeds(args, cfg, env, seeds):
    """The seed-parallel trainer (scripts/train.py's seed branch): a writer
    and a checkpointer per seed under ``<log_dir>_seed<s>`` and
    ``<checkpoint_dir>_seed<s>``, each lane resumed from the newest step all
    seeds share with ``--checkpoint latest``."""
    log_base = cfg.log_dir.rstrip("/")
    ckpt_base = cfg.checkpoint_dir.rstrip("/")
    writers = None
    if not args.no_tensorboard:
        writers = [make_writer(f"{log_base}_seed{s}") for s in seeds]
    cks = [Checkpointer(f"{ckpt_base}_seed{s}", keep=cfg.keep_checkpoints) for s in seeds]
    trainer = SeedParallelTrainer(env, cfg, seeds, writers=writers)
    print(f"[train] seed-parallel: {len(seeds)} lanes ({seeds}) x E={env.num_envs} "
          f"arenas, stepped in lockstep on {env.device}")
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


def main(argv=None):
    """Train; returns the trainer (the SeedParallelTrainer with ``--seeds``)."""
    trainer, ckpt = prepare(argv)
    seeded = isinstance(trainer, SeedParallelTrainer)
    writers = (trainer.writers or []) if seeded else [trainer.writer]
    try:
        if seeded:
            trainer.train(checkpointers=ckpt)
        else:
            trainer.train(checkpointer=ckpt)
    finally:
        for w in writers:
            if w is not None:
                w.close()
    return trainer


if __name__ == "__main__":
    main()
