#!/usr/bin/env python3
"""What a data-parallel update of the port puts on the wire: the
counterpart of ``scripts/comm_account.py``.

A rank of ``swarmacb_torch``'s data-parallel learner exchanges only these
per update (``POCATrainer``, ``parallel.Mesh.all_reduce_mean_``):
  - one all-reduce a minibatch (SGD step) of one flat float32 buffer, every
    parameter's gradient and the four losses; the gradient chunks are
    summed locally first, so chunking adds none;
  - two of one scalar for the advantage moments, and one each for the mean
    |advantage| and the mean team value.
The rollout, the env and the minibatch indices never leave the rank.

For each variant this builds the port's trainer on the CPU from the YAML
(weights only, no step is taken), counts its parameters exactly, and
prints for p ranks the SGD steps of one update and the bytes that a ring
all-reduce puts on the wire per GPU, 2(p − 1)/p of each buffer. It
assumes no interconnect rate: ``chip_smoke.py`` phase 3j prints these
counts beside the all-reduce time it measures on the card.

Usage: python scripts/comm_account_torch.py [--variants dandelion,tulip,cyclamen]
           [--num_envs 1024] [--horizon T]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from swarmacb_torch.agents import POCATrainer  # noqa: E402
from swarmacb_torch.config import DirectionalGateEnvCfg, load_config  # noqa: E402
from swarmacb_torch.env import DirectionalGateEnv  # noqa: E402

RANKS = (2, 4, 8)
SCALARS = 4                 # advantage mean and squared sum, mean |advantage|, team value


def sgd_steps(trainer: POCATrainer, world: int) -> int:
    """SGD steps of one update on each of ``world`` ranks: per epoch, the
    minibatches of each rank's T·E / world rows (for the recurrent actor,
    of each window group's windows), a rank's minibatch being
    ``(group_mb // world) // L`` rows of L groups, at least one
    (``POCATrainer._minibatch_rows``)."""
    E = trainer.num_envs_global // world
    if trainer.recurrent:
        rows = {L: len(starts) * E for L, starts in trainer._window_groups().items()}
    else:
        rows = {1: trainer.cfg.horizon * E}
    per_epoch = sum(-(-n // min(max(1, (trainer.group_mb // world) // L), n))
                    for L, n in rows.items())
    return trainer.cfg.num_epochs * per_epoch


def account(variant: str, num_envs: int, horizon=None) -> dict:
    path = pathlib.Path(__file__).resolve().parents[1] / "configs" / f"DirGate_{variant}.yaml"
    _, variant, cfg, env_ov = load_config(str(path))
    if horizon is not None:
        cfg = dataclasses.replace(cfg, horizon=horizon)
    env_kw = {k: v for k, v in env_ov.items() if k != "num_envs"}
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=num_envs,
                                                   **env_kw), device="cpu")
    trainer = POCATrainer(env, cfg)
    params = sum(p.numel() for p in trainer.optimizer.param_groups[0]["params"])
    buffer_bytes = 4 * (params + 4)          # the gradients and the four losses
    out = {"variant": variant, "num_envs": num_envs, "horizon": cfg.horizon,
           "params": params, "allreduce_MB": buffer_bytes / 2**20,
           "sgd_steps_per_update": sgd_steps(trainer, 1)}
    for p in RANKS:
        steps = sgd_steps(trainer, p)
        wire = 2 * (p - 1) / p * (buffer_bytes * steps + 4 * SCALARS)
        out[f"ranks_{p}"] = {"sgd_steps": steps, "allreduce_calls": steps + SCALARS,
                             "wire_MB_per_update": wire / 2**20}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="dandelion,tulip,cyclamen")
    ap.add_argument("--num_envs", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=None,
                    help="Decisions a rollout (default: the YAML's time_horizon)")
    args = ap.parse_args(argv)
    rows = [account(v, args.num_envs, args.horizon) for v in args.variants.split(",")]
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
