"""Seed-parallel POCA training: several seeds in one process, on one card
or spread over the devices of that process.

Counterpart of ``swarmacb_tpu/agents/seed_parallel.py``, the reference's
10-seed SLURM array run (``#SBATCH --array=0-9``) as one program.

Design: S lanes stepped in lockstep on one device, each lane a
``POCATrainer`` of its own seed with its own generator, weights, Adam, env
state, observations and actor carry; all lanes share the env, which holds
no state of its own (a lane's generator rides in its env state). A lane
runs at the JAX lane's gradient-chunk cap, ``max(1, accum_chunk_groups //
S)`` (the JAX package shrinks the cap so that S vmapped lanes hold one
lane's activations), so lane i is the serial trainer of seed sᵢ with that
cap, bit for bit. The lanes run one after another within an iteration:
the critic kernels take one fc_out bias a call and the env draws from one
generator a call, so one batched launch across lanes would need a bias per
group in the kernels and a generator per lane in the env (ROADMAP.md §2).

Everything host-side is per seed and serial-compatible: one summary
writer and one ``Checkpointer`` per seed, whose checkpoints are the lane's
own serial checkpoints (``play_torch.py`` and ``eval_checkpoints_torch.py``
read them), per-seed episode accounting (each lane's), and a per-seed
divergence guard: a lane with a non-finite loss is quarantined and no
longer stepped while the others train on.

A seed mesh (``mesh=``, a list of devices) spreads the lanes over the
devices of this one process, S / devices lanes a device, each lane with an
env of its own on its device; the lanes share nothing, so no collective
runs (JAX seed_parallel.py:70-93). A lane's cap then counts the lanes of
its device, the JAX ``lanes_per_dev`` rule.

Intended divergences from the JAX trainer (ROADMAP.md §3): the summary and
checkpoint cadence resumes from the restored step, and ``try_resume``
falls back to a ``poca_final`` step all seeds share (``ADVICE.md``); the
split-update refusal has no counterpart, since the split update is not
ported; a dead lane is skipped, not stepped on with NaN.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

from ..config.poca_cfg import POCAConfig
from ..device import resolve_device
from ..env.directional_gate import DirectionalGateEnv
from .checkpoint import METADATA_FILE
from .trainer import POCATrainer

LOSS_KEYS = ("policy_loss", "value_loss", "baseline_loss")
# metrics that do not depend on the lane: the schedules, which depend only
# on the lockstep global step
SHARED_KEYS = ("lr", "eps", "beta")


def lane_chunk_cap(accum_chunk_groups: int, lanes: int) -> int:
    """A lane's gradient-chunk cap: the JAX package's per-lane share of
    ``accum_chunk_groups`` (0, no chunking, stays 0)."""
    if accum_chunk_groups <= 0:
        return accum_chunk_groups
    return max(1, accum_chunk_groups // max(1, lanes))


class SeedParallelTrainer:
    """Train ``len(seeds)`` independent POCA seeds in lockstep on one
    device, one ``POCATrainer`` lane a seed."""

    def __init__(self, env: DirectionalGateEnv, cfg: Optional[POCAConfig],
                 seeds: Sequence[int], writers: Optional[Sequence] = None, mesh=None):
        """``writers``: one summary writer per seed (an entry may be None),
        or None. ``mesh``: a list of devices of this process to spread the
        lanes over (lane i on device i // (S / devices)); S % devices ≠ 0,
        and a run of more than one process, are refused (JAX
        seed_parallel.py:70-78)."""
        cfg = cfg or POCAConfig()
        self.seeds = [int(s) for s in seeds]
        if not self.seeds:
            raise ValueError("no seeds")
        if len(set(self.seeds)) != len(self.seeds):
            raise ValueError(f"duplicate seeds: {self.seeds}")
        self.S = len(self.seeds)
        self.writers = list(writers) if writers is not None else None
        if self.writers is not None and len(self.writers) != self.S:
            raise ValueError("need one writer per seed (or None)")
        devices = [env.device] if mesh is None else [resolve_device(d) for d in mesh]
        if mesh is not None:
            if dist.is_initialized() and dist.get_world_size() > 1:
                raise ValueError("a seed mesh is one process over its devices; this run "
                                 f"has {dist.get_world_size()} processes")
            if not devices or self.S % len(devices):
                raise ValueError(f"{self.S} seeds not divisible over {len(devices)} devices")
        self.devices = devices
        per_device = self.S // len(devices)
        envs = {}                      # one env a device: the env carries its device
        for d in devices:
            envs.setdefault(d, env if env.device == d else
                            DirectionalGateEnv(env.cfg, device=d))
        chunk = lane_chunk_cap(cfg.accum_chunk_groups, per_device)
        self.lanes = [
            POCATrainer(envs[devices[i // per_device]],
                        dataclasses.replace(cfg, seed=s, accum_chunk_groups=chunk),
                        writer=None if self.writers is None else self.writers[i])
            for i, s in enumerate(self.seeds)]
        base = self.lanes[0]
        self.env = env
        self.cfg = base.cfg
        self.num_envs = base.num_envs
        self.num_agents = base.num_agents
        self.recurrent = base.recurrent
        self.discrete = base.discrete
        self.global_step = 0          # per-seed decisions, as in a serial run
        self.update_count = 0
        self.alive = np.ones(self.S, dtype=bool)

    # ── per-seed views (checkpoint contract) ───────────────────────

    def _seed_view(self, i: int) -> POCATrainer:
        """Lane ``i`` itself: a serial trainer, so a ``Checkpointer`` saves
        and restores it as it does a serial run."""
        return self.lanes[i]

    def try_resume(self, checkpointers) -> bool:
        """Resume every lane from the newest ``poca_<step>`` that all seed
        directories share (lanes advance in lockstep, so after a clean
        interruption that step exists), else from ``poca_final`` where
        every seed has one at one step. Returns False (start fresh) when
        there is neither."""
        dirs = [ck.dir for ck in checkpointers]
        steps = [{int(p.name.removeprefix("poca_")) for p in d.glob("poca_*")
                  if p.name.removeprefix("poca_").isdigit()
                  and (p / METADATA_FILE).exists()} for d in dirs]
        common = set.intersection(*steps) if steps else set()
        if common:
            paths = [d / f"poca_{max(common)}" for d in dirs]
        else:
            paths = [d / "poca_final" for d in dirs]
            if not all((p / METADATA_FILE).exists() for p in paths) or len(
                    {ck.load_metadata(p)["global_step"]
                     for ck, p in zip(checkpointers, paths)}) != 1:
                return False
        for ck, lane, path in zip(checkpointers, self.lanes, paths):
            ck.restore(path, lane)
        self.global_step = self.lanes[0].global_step
        self.update_count = self.lanes[0].update_count
        print(f"[POCA] seed-parallel resume: {self.S} lanes at step "
              f"{self.global_step:,} ({paths[0].name})")
        return True

    # ── setup ──────────────────────────────────────────────────────

    def _reset_all(self):
        """Each lane's env reset from its own generator and its actor's
        initial carry, as ``POCATrainer.train`` starts: lists of S."""
        env_states, obs = zip(*(lane.env.reset(lane.generator) for lane in self.lanes))
        carries = [lane.init_actor_carry() for lane in self.lanes]
        return list(env_states), list(obs), carries

    # ── iteration ──────────────────────────────────────────────────

    def train_iteration(self, env_states, obs, actor_carries):
        """One rollout + update for every live lane. Returns (env_states,
        obs, carries, host_metrics): each metric an (S,) numpy array (NaN
        for a dead lane), and the schedules' lr, eps and beta scalars."""
        env_states, obs, actor_carries = list(env_states), list(obs), list(actor_carries)
        hosts = [None] * self.S
        for i in np.nonzero(self.alive)[0]:
            env_states[i], obs[i], actor_carries[i], hosts[i] = \
                self.lanes[i].train_iteration(env_states[i], obs[i], actor_carries[i])
        self.update_count += 1
        self.global_step += self.cfg.horizon * self.num_envs * self.num_agents
        live = next(h for h in hosts if h is not None)
        host = {k: np.array([np.nan if h is None else h[k] for h in hosts])
                for k in live if k not in SHARED_KEYS}
        host.update({k: live[k] for k in SHARED_KEYS})
        return env_states, obs, actor_carries, host

    # ── outer loop ─────────────────────────────────────────────────

    def train(self, checkpointers: Optional[Sequence] = None, progress=True):
        """The lockstep training loop with summaries, checkpoints and the
        per-seed divergence guard (``POCATrainer.train``). Returns
        (env_states, obs) of the last iteration."""
        c = self.cfg
        if checkpointers is not None and len(checkpointers) != self.S:
            raise ValueError("need one checkpointer per seed (or None)")
        env_states, obs, carries = self._reset_all()
        next_summary = (self.global_step // c.summary_freq + 1) * c.summary_freq
        next_checkpoint = ((self.global_step // c.checkpoint_interval + 1)
                           * c.checkpoint_interval)
        start = time.time()
        decisions = c.horizon * self.num_envs * self.num_agents
        while self.global_step < c.total_timesteps:
            t_iter = time.time()
            env_states, obs, carries, m = self.train_iteration(env_states, obs, carries)
            iter_dt = time.time() - t_iter
            elapsed = time.time() - start
            sps = self.global_step / elapsed if elapsed > 0 else 0.0
            sps_inst = decisions / iter_dt if iter_dt > 0 else 0.0
            live = self.alive.copy()

            if progress:
                mean = {k: float(np.mean(m[k][live])) for k in (*LOSS_KEYS, "entropy")}
                print(f"[POCA] step={self.global_step:,} upd={self.update_count} "
                      f"S={int(live.sum())}/{self.S} "
                      f"pg={mean['policy_loss']:.3f} vf={mean['value_loss']:.3f} "
                      f"bl={mean['baseline_loss']:.3f} ent={mean['entropy']:.3f} "
                      f"per-seed SPS={sps:,.0f} (inst {sps_inst:,.0f}, "
                      f"aggregate {sps_inst * int(live.sum()):,.0f})", flush=True)

            # quarantine a lane with a non-finite loss and train on with
            # the rest; stop only when every lane is dead
            finite = np.logical_and.reduce([np.isfinite(m[k]) for k in LOSS_KEYS])
            for i in np.nonzero(live & ~finite)[0]:
                self.alive[i] = False
                msg = (f"[POCA] seed {self.seeds[i]}: non-finite loss at "
                       f"step {self.global_step:,} — lane diverged")
                if checkpointers is not None:
                    path = checkpointers[i].save(self._seed_view(i), quarantine=True)
                    msg += f"; params quarantined at {path}"
                print(msg, flush=True)
            if not self.alive.any():
                raise FloatingPointError("all seed lanes diverged (non-finite losses)")

            if self.writers is not None and self.global_step >= next_summary:
                next_summary += c.summary_freq
                self._write_summaries(m, sps)

            if checkpointers is not None and self.global_step >= next_checkpoint:
                next_checkpoint += c.checkpoint_interval
                for i in np.nonzero(self.alive)[0]:
                    checkpointers[i].save(self._seed_view(i))

        if checkpointers is not None:
            for i in np.nonzero(self.alive)[0]:
                checkpointers[i].save(self._seed_view(i), final=True)
        if self.writers is not None:
            for w in self.writers:
                if w is not None:
                    w.flush()
        return env_states, obs

    def _write_summaries(self, m, sps):
        """Each live lane's serial tag set into its own writer, its metrics
        taken from the (S,) arrays of ``m``."""
        for i in np.nonzero(self.alive)[0]:
            if self.writers[i] is None:
                continue
            lane_m = {k: v if k in SHARED_KEYS else float(v[i]) for k, v in m.items()}
            self.lanes[i]._write_summaries(lane_m, sps)
