"""Data-parallel ranks for the port's CPU tests, and what they compute.

The tests start ``world`` ranks of ``rank_main`` with ``start_ranks``:
each rank is a spawned process on one thread that joins a gloo process
group through a ``file://`` store, computes, and writes what it found to
``<out>/rank<r>.pt``, which ``join_ranks`` reads. The ranks import the
port and never JAX: what the JAX package computes reaches them through a
``.npz`` that the test writes while they start.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from swarmacb_torch.agents import POCAConfig, POCATrainer, Rollout
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import DirectionalGateEnv
from swarmacb_torch.parallel import digest, make_mesh

# the rollouts held against one process: (variant, fused_env_step)
ROLLOUT_CASES = (("dandelion", False), ("dandelion", True), ("daisy", False), ("daisy", True))
ROLLOUT_ENVS, ROLLOUT_T = 8, 4


def _entry(rank, fn, world, init_method, args):
    torch.set_num_threads(1)
    mesh = make_mesh(world=world, device="cpu", rank=rank, init_method=init_method)
    try:
        out = fn(mesh, *args)
    finally:
        mesh.close()
    torch.save(out, Path(args[0]) / f"rank{rank}.pt")


def start_ranks(fn, world: int, out_dir, *args):
    """Start ``world`` ranks of ``fn(mesh, out_dir, *args)`` without
    waiting; ``join_ranks`` waits for them."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    init = f"file://{out_dir / 'rendezvous'}"
    return torch.multiprocessing.start_processes(
        _entry, args=(fn, world, init, (str(out_dir), *args)), nprocs=world, join=False,
        start_method="spawn")


def join_ranks(ctx, out_dir, timeout: float) -> list:
    """Wait at most ``timeout`` seconds for the ranks (a rank that failed
    raises here, and the others are ended); a hang kills them all and
    raises. Returns each rank's output."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not finish within {timeout} s")
    return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False)
            for r in range(len(ctx.processes))]


# ── the rollout ──────────────────────────────────────────────────────────

def rollout_trainer(variant, fused_env_step, mesh=None):
    """A trainer at h = 16 over ``ROLLOUT_ENVS`` arenas, or the rank's
    share of them."""
    E = ROLLOUT_ENVS
    lo, hi = (0, E) if mesh is None else mesh.shard_range(E)
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=hi - lo),
                             device="cpu", shard=None if mesh is None else (lo, E))
    cfg = POCAConfig(hidden_dim=16, num_layers=1, horizon=ROLLOUT_T, seed=0,
                     fused_env_step=fused_env_step)
    return POCATrainer(env, cfg, mesh=mesh)


def rollout_fields(trainer) -> dict:
    """The rollout from a fresh reset: every field, the bootstrap, the
    aux, the final observations and integer env state, as numpy."""
    env_state, obs = trainer.env.reset(trainer.generator)
    env_state, obs, _, rollout, bootstrap, aux = trainer.rollout(
        env_state, obs, trainer.init_actor_carry())
    out = {k: v.numpy() for k, v in rollout.items()}
    out.update(bootstrap=bootstrap.numpy(), step_rewards=aux[0].numpy(),
               aux_dones=aux[1].numpy(), completed=aux[2].numpy(), final_obs=obs.numpy(),
               step_count=env_state.step_count.numpy(),
               explore_state=env_state.behavior.explore_state.numpy(),
               photo_steps=env_state.behavior.photo_steps.numpy())
    return out


def rank_main(mesh, out_dir, npz_path, cfg_kw, num_envs):
    """What a rank of the tests computes: the rollouts, one cyclamen
    iteration, the cross-rank advantage normalization, then, once the test
    has written ``npz_path``, the update against the JAX one."""
    out = {"rollouts": {case: rollout_fields(rollout_trainer(*case, mesh=mesh))
                        for case in ROLLOUT_CASES},
           "cyclamen": cyclamen_iteration(mesh),
           "normalized": normalized_advantages(mesh, num_envs)}
    deadline = time.monotonic() + 120
    while not Path(npz_path).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{npz_path} was not written")
        time.sleep(0.05)
    out.update(update_rank(mesh, npz_path, cfg_kw, num_envs))
    return out


# ── the update, the advantages and cyclamen ──────────────────────────────

def advantages(num_envs):
    """The random (T = 4, E, N = 20) advantages that
    ``normalized_advantages`` normalizes."""
    rng = np.random.default_rng(9)
    return (rng.normal(size=(4, num_envs, 20)) * 2 + 0.5).astype(np.float32)


def normalized_advantages(mesh, num_envs):
    """This rank's columns of ``advantages``, normalized over the ranks."""
    lo, hi = mesh.shard_range(num_envs)
    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=hi - lo), device="cpu",
                             shard=(lo, num_envs))
    trainer = POCATrainer(env, POCAConfig(hidden_dim=8, num_layers=1), mesh=mesh)
    return trainer._normalize_advantages(
        torch.from_numpy(advantages(num_envs)[:, lo:hi])).numpy()


def update_rank(mesh, npz_path, cfg_kw, num_envs):
    """One update on this rank's columns of the synthetic rollout, from the
    JAX weights, with JAX's permutations of this rank's shard."""
    data = dict(np.load(npz_path))
    lo, hi = mesh.shard_range(num_envs)
    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=hi - lo), device="cpu",
                             shard=(lo, num_envs))
    trainer = POCATrainer(env, POCAConfig(**cfg_kw), mesh=mesh)
    for net in ("actor", "critic"):
        module = getattr(trainer, net)
        module.load_state_dict({k: torch.from_numpy(data[f"{net}.{k}"])
                                for k in module.state_dict()})
    fields = {f.name: torch.from_numpy(data[f"rollout.{f.name}"][:, lo:hi])
              for f in dataclasses.fields(Rollout) if f"rollout.{f.name}" in data}
    c = trainer.cfg
    mesh.comm.update(calls=0, bytes=0)
    metrics = trainer._update(Rollout(**fields), torch.from_numpy(data["bootstrap"][lo:hi]),
                              c.lr, c.clip_eps, c.beta,
                              injected_perms=torch.from_numpy(data[f"perms{mesh.rank}"]))
    comm = dict(mesh.comm)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": {f"{net}.{k}": v.clone() for net in ("actor", "critic")
                      for k, v in getattr(trainer, net).state_dict().items()},
           "comm": comm, "group_mb": trainer.group_mb,
           "minibatch_rows": trainer._minibatch_rows(c.horizon * (hi - lo))}
    return out


CYC_ENVS, CYC_T, CYC_L = 4, 6, 4


def cyclamen_iteration(mesh) -> dict:
    """One tiny cyclamen training iteration on this rank's arenas: windows
    of 4 and 2 decisions (two window groups)."""
    lo, hi = mesh.shard_range(CYC_ENVS)
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="cyclamen", num_envs=hi - lo),
                             device="cpu", shard=(lo, CYC_ENVS))
    cfg = POCAConfig(hidden_dim=16, num_layers=1, horizon=CYC_T, seed=1, recurrent=True,
                     memory_size=8, sequence_length=CYC_L, buffer_size_hint=0,
                     mini_batch_size=8, accum_chunk_groups=4)
    trainer = POCATrainer(env, cfg, mesh=mesh)
    env_state, obs = env.reset(trainer.generator)
    *_, metrics = trainer.train_iteration(env_state, obs, trainer.init_actor_carry())
    params = [*trainer.actor.parameters(), *trainer.critic.parameters()]
    windows = {L: trainer._minibatch_rows(len(starts) * (hi - lo), L)
               for L, starts in trainer._window_groups().items()}
    return {"metrics": metrics, "digest": digest(params), "group_mb": trainer.group_mb,
            "windows": windows, "finite": all(bool(torch.isfinite(p).all()) for p in params)}
