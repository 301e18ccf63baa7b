"""POCA trainer — counterpart of ``swarmacb_tpu/agents/trainer.py``
(feedforward and recurrent actors, one device or data-parallel ranks).

Acting: one decision (``_rollout_fn`` in the JAX package, trainer.py:269-366)
samples the actor (Gaussian wheels for dandelion, a categorical over the 6
behaviour modules for the discrete variants), runs the critic's team value
and all N counterfactual baselines on the 5-D critic state, then steps the
env ``decision_period`` times with the same action, under
``torch.no_grad()``. With ``fused_env_step`` the env state stays in the
arena-on-lanes layout for the whole rollout and each env step is one call
of ``ops.fused_env_step`` (``_rollout_fn_lanes``, trainer.py:368-473).
Learning: λ-returns, advantage normalisation, then ``num_epochs`` epochs of
minibatch POCA updates with one Adam over actor and critic
(``_update_fn`` / ``_update_feedforward``, trainer.py:677-752).

The recurrent actor (cyclamen, ``cfg.recurrent``) threads an LSTM carry
through the rollout, stores each decision's carry from before the step as
``memory_h`` / ``memory_c`` and zeroes an arena's carry once its episode
ended, and across iterations through ``train_iteration``. Its update is
BPTT over fixed-stride windows of ``sequence_length`` decisions grouped by
length, each starting from the stored carry, with the carry zeroed inside
a window after a done (``_update_recurrent``, trainer.py:960-1054). A
feedforward actor's carry is the empty tuple.
With ``mixed_precision`` the critic's attention projections named in
``mp_stages`` take bfloat16 operands (JAX trainer.py:133-134); the
parameters, the gradients and Adam stay float32.

With a ``mesh`` (``swarmacb_torch.parallel``) the trainer is one rank of a
data-parallel run, the JAX mesh program's semantics (trainer.py:651-683,
721-722, 756-784, 1168-1191): its env is a shard of E / world arenas that
draws its columns of the global draws, so the ranks' rollout is the
one-process rollout; every rank holds the same weights (checked once), the
advantage moments are taken over all ranks, each minibatch's gradient and
losses are averaged over the ranks before Adam steps (one all-reduce of
one flat buffer), each rank takes ``group_mb // world`` groups of its own
permutation (the ``world`` permutations drawn in step from the shared
generator, rank r keeping the r-th), and the schedules and ``global_step``
count all ranks' decisions. Episode statistics stay on each rank; rank 0
alone writes summaries and checkpoints.
Algorithm parity with ML-Agents POCA:

  - counterfactual baselines from the critic every step (poca_trainer.py:449-455)
  - continuous env-action preprocessing clamp(−3,3)/3, raw actions stored
    (poca_trainer.py:457-467)
  - decision_period sub-stepping with reward accumulation (poca_trainer.py:469-482)
  - host-side episode accounting across auto-resets (poca_trainer.py:498-515)
  - λ-return advantage = return − baseline (poca_buffer.py:125-154)
  - advantage normalization before epochs (poca_trainer.py:676-683)
  - per-dim ratio PPO clip + trust-region value/baseline losses
    (poca_trainer.py:139-173)
  - loss = policy + 0.5·(value + 0.5·baseline) − β·entropy, single Adam over
    actor+critic, eps 1e-8, NO grad clipping (poca_trainer.py:271-274,703-712)
  - group-minibatch derivation from buffer_size_hint (poca_trainer.py:663-674)
  - linear schedules with ML-Agents floors (poca_trainer.py:281-287)

The JAX package scans the horizon and the epochs inside jitted programs;
here they are Python loops of eager PyTorch calls on the env's device, whose
hot spots are the hand-written CUDA kernels in ``swarmacb_torch.ops`` (the
critic tail's forward and backward among them, or with
``fused_attention=True`` the fused counterfactual attention's). The JAX package's split
update (``split_update_groups``) exists only to bound one XLA program's wall
time; its math is the path below, so it is not ported.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config.poca_cfg import POCAConfig, check_mp_stages
from ..env.directional_gate import DirectionalGateEnv
from ..env import lanes as laneslib
from ..models.networks import (Actor, DiscreteActor, POCACritic,
                               RecurrentDiscreteActor)
from ..numerics import sqrt_rn
from ..utils.logging import print_line
from . import buffer as buf
from . import losses
from .buffer import Rollout


class POCATrainer:
    """End-to-end POCA training on a batched env.

    Runs on the env's device. Weights are drawn on the CPU from
    ``cfg.seed`` (so a CPU and a CUDA trainer of one seed hold the same
    weights) and then moved; action noise, resets and the epochs'
    minibatch permutations come from ``self.generator``, a generator on the
    device seeded with ``cfg.seed``.
    """

    STATE_DIM = 5  # critic consumes the 5-D polar state (poca_trainer.py:224-227)

    def __init__(self, env: DirectionalGateEnv, cfg: Optional[POCAConfig] = None,
                 writer=None, mesh=None):
        """``mesh``: a ``parallel.Mesh`` whose rank this trainer is; ``env``
        must then be the rank's shard (``mesh.shard_range``)."""
        self.env = env
        self.cfg = cfg or POCAConfig()
        c = self.cfg
        check_mp_stages(c.mp_stages)
        self.device = env.device
        self.mesh = mesh
        self.world = 1 if mesh is None else mesh.world
        self.rank = 0 if mesh is None else mesh.rank
        self.is_main = self.rank == 0
        self.num_envs = env.num_envs                  # this rank's arenas
        self.num_envs_global = env.shard[1]
        if mesh is not None and (env.shard[0], env.shard[0] + env.num_envs) != \
                mesh.shard_range(self.num_envs_global):
            raise ValueError(f"the env holds arenas {env.shard[0]}.."
                             f"{env.shard[0] + env.num_envs} of {self.num_envs_global}; "
                             f"rank {mesh.rank} of {mesh.world} holds "
                             f"{mesh.shard_range(self.num_envs_global)}")
        if mesh is None and self.num_envs_global != self.num_envs:
            raise ValueError("an env that is one rank's shard needs the mesh")
        self.num_agents = env.num_agents
        self.obs_dim = env.obs_dim
        self.discrete = env.cfg.discrete_actions
        self.num_actions = env.cfg.num_actions
        self.recurrent = bool(c.recurrent)
        if self.recurrent and not self.discrete:
            raise ValueError("Recurrent POCA actor is only implemented for discrete actions")
        if self.discrete:
            self.act_dim = 1                      # storage dim
            self.act_dim_critic = self.num_actions
        else:
            self.act_dim = env.cfg.act_dim
            self.act_dim_critic = self.act_dim
        self.use_lanes = bool(c.fused_env_step)

        # ── networks (built without drawing from the global RNG) ───
        with torch.device("meta"):
            if self.recurrent:
                self.actor = RecurrentDiscreteActor(
                    self.obs_dim, self.num_actions, hidden=c.hidden_dim,
                    num_layers=c.num_layers, memory=c.memory_size)
            elif self.discrete:
                self.actor = DiscreteActor(self.obs_dim, self.num_actions,
                                           hidden=c.hidden_dim,
                                           num_layers=c.num_layers)
            else:
                self.actor = Actor(self.obs_dim, self.act_dim,
                                   hidden=c.hidden_dim, num_layers=c.num_layers)
            self.critic = POCACritic(
                state_dim=self.STATE_DIM, act_dim=self.act_dim_critic,
                num_agents=self.num_agents, hidden=c.hidden_dim,
                num_heads=c.critic_num_heads, num_layers=c.num_layers,
                # None (auto) means off, as in the JAX trainer
                fused_attention=bool(c.fused_attention),
                compute_dtype=torch.bfloat16 if c.mixed_precision else None,
                mp_stages=c.mp_stages,
            )
        self.init_params_for_seed(c.seed)
        if mesh is not None:
            mesh.check_replicated([*self.actor.parameters(), *self.critic.parameters()],
                                  "the initial weights")

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(c.seed)

        # single Adam over actor+critic (poca_trainer.py:271-274); PyTorch's
        # lr·m̂/(√v̂ + ε) is optax.adam's update
        self.optimizer = torch.optim.Adam(
            [*self.actor.parameters(), *self.critic.parameters()],
            lr=c.lr, eps=c.adam_eps)

        # schedules (poca_trainer.py:281-291)
        self.lr_schedule = losses.make_schedule(c.lr_schedule, c.lr,
                                                losses.LR_MIN, c.total_timesteps)
        self.eps_schedule = losses.make_schedule(c.eps_schedule, c.clip_eps,
                                                 losses.EPS_MIN, c.total_timesteps)
        self.beta_schedule = losses.make_schedule(c.beta_schedule, c.beta,
                                                  losses.BETA_MIN, c.total_timesteps)

        # minibatch derivation (poca_trainer.py:663-674), over all ranks
        T_E = c.horizon * self.num_envs_global
        if c.buffer_size_hint > 0 and c.mini_batch_size > 0:
            bpe = max(1, c.buffer_size_hint // c.mini_batch_size)
            self.group_mb = max(1, T_E // bpe)
        else:
            self.group_mb = min(c.mini_batch_size, T_E)

        self.global_step = 0
        self.update_count = 0
        self.writer = writer
        # set to a directory to trace iterations 2-4 with torch.profiler
        # (scripts/train_torch.py --profile)
        self.profile_dir: Optional[str] = None

        # host-side episode accounting (poca_trainer.py:322-330)
        self._episode_reward_acc = np.zeros(self.num_envs)
        self._episode_step_count = np.zeros(self.num_envs)
        self.completed_episode_returns: list[float] = []
        self.completed_episode_lengths: list[float] = []
        self.completed_group_rewards: list[float] = []
        self._rollout_reward_history: list[float] = []
        self._max_history = 100

    # ──────────────────────────────────────────────────────────────
    #  helpers
    # ──────────────────────────────────────────────────────────────

    def init_params_for_seed(self, seed: int):
        """Fresh weights for ``seed``: drawn on the CPU from one generator,
        then moved to the device."""
        g = torch.Generator()
        g.manual_seed(seed)
        for net in (self.actor, self.critic):
            net.to_empty(device="cpu")
            net.init_weights(g)
            net.to(self.device)

    def _encode_actions_for_critic(self, actions):
        """One-hot discrete actions for the critic's entity embedding;
        continuous actions enter as they are (poca_trainer.py:353-366)."""
        if self.discrete:
            idx = actions[..., 0].to(torch.int64)
            return torch.nn.functional.one_hot(idx, self.num_actions).to(
                torch.float32)
        return actions

    def init_actor_carry(self):
        """The actor's carry at the start of a run: zeros ((E·N, M),
        (E·N, M)) for the LSTM actor, () for a feedforward one."""
        if not self.recurrent:
            return ()
        return self.actor.initial_state(self.num_envs * self.num_agents,
                                        device=self.device)

    def _apply_actor(self, flat_obs, carry):
        """(dist params, new carry): the LSTM's logits and carry, or a
        feedforward actor's (mu, std) or logits with the carry unchanged."""
        if self.recurrent:
            return self.actor.step(flat_obs, carry)
        return self.actor(flat_obs), carry

    def _act(self, obs, carry, noise):
        """Sample one decision. Returns (actions (E, N, act_dim) as stored,
        per-dim log-probs (E, N, act_dim), env actions, the actor's new
        carry): module ids (E, N) int32 for the discrete variants,
        clamp(−3, 3)/3 wheels (E, N, 2) for dandelion (ML-Agents env
        preprocessing; the rollout keeps RAW actions,
        poca_trainer.py:457-467)."""
        E, N = self.num_envs, self.num_agents
        dist, carry = self._apply_actor(obs.reshape(E * N, self.obs_dim), carry)
        gen, dev = self.generator, self.device
        if self.discrete:
            if noise is None:
                noise = DiscreteActor.gumbel(self.env.draw(
                    lambda s: torch.rand(s, generator=gen, device=dev, dtype=dist.dtype),
                    dist.shape, dim=0, per=N))
            act_flat = DiscreteActor.sample(dist, noise=noise)
            logp_flat = DiscreteActor.log_prob(dist, act_flat)
            actions = act_flat.reshape(E, N, 1).to(torch.float32)
            return (actions, logp_flat.reshape(E, N, 1),
                    act_flat.reshape(E, N).to(torch.int32), carry)
        mu, std = dist
        if noise is None:
            noise = self.env.draw(
                lambda s: torch.randn(s, generator=gen, device=dev, dtype=mu.dtype),
                mu.shape, dim=0, per=N)
        act_flat = Actor.sample(mu, std, noise=noise)
        logp_flat = Actor.log_prob(mu, std, act_flat)
        actions = act_flat.reshape(E, N, self.act_dim)
        return (actions, logp_flat.reshape(E, N, self.act_dim),
                torch.clamp(actions, -3.0, 3.0) / 3.0, carry)

    # ──────────────────────────────────────────────────────────────
    #  rollout
    # ──────────────────────────────────────────────────────────────

    @torch.no_grad()
    def rollout(self, env_state, obs, actor_carry, length: Optional[int] = None,
                injected_noise=None, injected_durations=None,
                injected_spawn=None, want_bootstrap=True):
        """Collect ``length`` (default horizon) decisions.

        Args:
            env_state, obs: the env's current state and observations.
            actor_carry: the actor's carry (``init_actor_carry``; () for a
                feedforward actor).
            injected_noise: optional (T, E·N, act_dim) standard-normal draws
                (dandelion) or (T, E·N, num_actions) Gumbel draws (discrete)
                replacing the actor's sampling noise.
            injected_durations: optional {explore, photo, antiphoto} of
                (S, E, N) int32 turn durations, S = T·decision_period, one
                per env step (discrete variants).
            injected_spawn: optional (pos (S, E, N, 2), yaw (S, E, N)), one
                auto-reset spawn per env step.

        Returns (env_state, obs, actor_carry, rollout, bootstrap_value or
        None, aux) with aux = (step rewards, dones, completed_group_reward),
        each (T, E).
        """
        env = self.env
        E, N = self.num_envs, self.num_agents
        dp = self.cfg.decision_period
        T = self.cfg.horizon if length is None else length
        lanes = laneslib.state_to_lanes(env, env_state) if self.use_lanes else None
        steps, aux = [], []
        for t in range(T):
            noise = None if injected_noise is None else injected_noise[t]
            actions, log_probs, env_actions, new_carry = self._act(
                obs, actor_carry, noise)
            if lanes is not None:
                lane_actions = laneslib.actions_to_lanes(env, env_actions)
                critic_state = laneslib.critic_state_from_lanes(env, lanes)
            else:
                critic_state = env.critic_state(env_state)             # (E,N,5)
            team_val = self.critic.critic_pass(critic_state)[:, 0]     # (E,)
            baselines = self.critic.all_baselines(
                critic_state, self._encode_actions_for_critic(actions))  # (E,N)

            # decision_period sub-steps with the same action
            # (poca_trainer.py:469-482)
            acc_reward = torch.zeros(E, device=self.device)
            last_done = torch.zeros(E, device=self.device)
            next_obs = obs
            for sub in range(dp):
                k = t * dp + sub
                dur = (None if injected_durations is None
                       else {n: v[k] for n, v in injected_durations.items()})
                spawn = (None if injected_spawn is None
                         else (injected_spawn[0][k], injected_spawn[1][k]))
                if lanes is not None:
                    # observations only on the last sub-step (trainer.py:434-442)
                    want = sub == dp - 1
                    lanes, reward, done, obs_tiles = laneslib.step_lanes(
                        env, lanes, lane_actions, want_obs=want,
                        injected_durations=dur,
                        injected_spawn=spawn)
                    if want:
                        next_obs = laneslib.obs_from_tiles(env, obs_tiles,
                                                           lanes["prev"])
                    completed = lanes["cg"]
                else:
                    env_state, ts = env.step(env_state, env_actions,
                                             injected_durations=dur,
                                             injected_spawn=spawn)
                    reward, done, next_obs = ts.reward, ts.done, ts.obs
                    completed = env_state.completed_group_reward
                acc_reward = acc_reward + reward
                last_done = torch.maximum(last_done, done.to(torch.float32))

            if lanes is not None:
                completed = laneslib.from_lanes(completed, E, squeeze=True)
            step = dict(
                obs=obs, critic_states=critic_state, actions=actions,
                log_probs=log_probs,
                rewards=acc_reward * self.cfg.reward_strength,
                dones=last_done, team_values=team_val, baselines=baselines)
            if self.recurrent:
                # the carry from before this decision; then an arena whose
                # episode ended starts the next one from zeros
                M = self.cfg.memory_size
                step["memory_h"] = actor_carry[0].reshape(E, N, M)
                step["memory_c"] = actor_carry[1].reshape(E, N, M)
                keep = (1.0 - last_done)[:, None].expand(E, N).reshape(E * N, 1)
                new_carry = (new_carry[0] * keep, new_carry[1] * keep)
            steps.append(step)
            aux.append((acc_reward, last_done, completed))
            obs, actor_carry = next_obs, new_carry

        if lanes is not None:
            env_state = laneslib.lanes_to_state(env, lanes)
        rollout = Rollout.stack(steps)
        aux = tuple(torch.stack(x) for x in zip(*aux))
        bootstrap = self._bootstrap_fn(env_state) if want_bootstrap else None
        return env_state, obs, actor_carry, rollout, bootstrap, aux

    @torch.no_grad()
    def _bootstrap_fn(self, env_state):
        """V(s_T) for the λ-return bootstrap (poca_trainer.py:528-530)."""
        return self.critic.critic_pass(self.env.critic_state(env_state))[:, 0]

    def collect(self, env_state, obs, actor_carry, **kwargs):
        """``rollout`` plus the host-side bookkeeping of one iteration:
        episode statistics and the global decision count."""
        env_state, obs, actor_carry, rollout, bootstrap, aux = self.rollout(
            env_state, obs, actor_carry, **kwargs)
        self._accumulate_episode_stats({"rewards": rollout.rewards,
                                        "dones": rollout.dones,
                                        "completed_group": aux[2]})
        self.global_step += (rollout.rewards.shape[0] * self.num_envs_global
                             * self.num_agents)
        return env_state, obs, actor_carry, rollout, bootstrap, aux

    def _accumulate_episode_stats(self, stats):
        """Episode returns/lengths across auto-resets (poca_trainer.py:498-515)."""
        rewards = stats["rewards"].cpu().numpy()            # (T, E)
        dones = stats["dones"].cpu().numpy()
        completed = stats["completed_group"].cpu().numpy()
        dp = self.cfg.decision_period
        for t in range(rewards.shape[0]):
            self._episode_reward_acc += rewards[t]
            self._episode_step_count += dp
            done_mask = dones[t] > 0.5
            if done_mask.any():
                self.completed_episode_returns.extend(
                    self._episode_reward_acc[done_mask].tolist())
                self.completed_episode_lengths.extend(
                    self._episode_step_count[done_mask].tolist())
                self.completed_group_rewards.extend(
                    completed[t][done_mask].tolist())
                self._episode_reward_acc[done_mask] = 0.0
                self._episode_step_count[done_mask] = 0.0

    # ──────────────────────────────────────────────────────────────
    #  losses
    # ──────────────────────────────────────────────────────────────

    def _critic_losses(self, cs, actions, returns, old_tv, old_bl, eps):
        """(value loss, baseline loss) of the critic on G groups: critic
        states (G, N, 5), stored actions (G, N, act_dim), returns, old team
        values (G,) and old baselines (G, N)."""
        new_tv = self.critic.critic_pass(cs)[:, 0]
        new_bl = self.critic.all_baselines(
            cs, self._encode_actions_for_critic(actions))
        value_loss = losses.trust_region_value_loss(new_tv, old_tv, returns, eps)
        ret_exp = returns[:, None].expand(new_bl.shape)
        baseline_loss = losses.trust_region_value_loss(
            new_bl.reshape(-1), old_bl.reshape(-1), ret_exp.reshape(-1), eps)
        return value_loss, baseline_loss

    def _feedforward_loss(self, batch, eps, beta):
        """poca_trainer.py:534-575. Returns (total, (policy, value,
        baseline, entropy))."""
        obs = batch["obs"]                  # (MB, N, obs)
        MB, N = obs.shape[:2]
        dist, _ = self._apply_actor(obs.reshape(MB * N, self.obs_dim), ())
        actions = batch["actions"]
        if self.discrete:
            act_flat = actions.reshape(MB * N, 1)[:, 0]
            logp = DiscreteActor.log_prob(dist, act_flat)[:, None]     # (MB·N,1)
            ent = DiscreteActor.entropy(dist)
        else:
            mu, std = dist
            logp = Actor.log_prob(mu, std, actions.reshape(MB * N, self.act_dim))
            ent = Actor.entropy(std)
        policy_loss = losses.trust_region_policy_loss(
            batch["advantages"].reshape(-1, 1), logp,
            batch["old_log_probs"].reshape(MB * N, -1), eps)
        mean_entropy = ent.mean()
        value_loss, baseline_loss = self._critic_losses(
            batch["critic_states"], actions, batch["returns"],
            batch["old_team_values"], batch["old_baselines"], eps)
        total = losses.poca_total_loss(policy_loss, value_loss, baseline_loss,
                                       mean_entropy, beta)
        return total, (policy_loss, value_loss, baseline_loss, mean_entropy)

    def _recurrent_loss(self, batch, eps, beta):
        """poca_trainer.py:577-642: BPTT over B windows of L decisions
        (batch tensors (B, L, …)), each from its stored carry, the carry
        zeroed after a done. Returns (total, (policy, value, baseline,
        entropy))."""
        obs = batch["obs"]                  # (B, L, N, obs)
        B, L, N = obs.shape[:3]
        M = self.cfg.memory_size
        obs_seq = obs.permute(0, 2, 1, 3).reshape(B * N, L, self.obs_dim)
        act_seq = batch["actions"].permute(0, 2, 1, 3).reshape(B * N, L)
        carry = (batch["memory_h"].reshape(B * N, M),
                 batch["memory_c"].reshape(B * N, M))
        dones_bn = batch["dones"][:, None, :].expand(B, N, L).reshape(B * N, L)
        logits_seq, _ = self.actor.forward_sequence(obs_seq, carry, dones_bn)
        logits = logits_seq.reshape(B * N * L, self.num_actions)
        logp = DiscreteActor.log_prob(logits, act_seq.reshape(B * N * L))
        ent = DiscreteActor.entropy(logits)
        # back to the (B, L, N) layout of the advantages and old log-probs
        new_logp = logp.reshape(B, N, L).permute(0, 2, 1)
        policy_loss = losses.trust_region_policy_loss(
            batch["advantages"].reshape(-1, 1), new_logp.reshape(-1, 1),
            batch["old_log_probs"].reshape(-1, 1), eps)
        mean_entropy = ent.mean()
        # the critic over the B·L groups
        value_loss, baseline_loss = self._critic_losses(
            batch["critic_states"].reshape(B * L, N, self.STATE_DIM),
            batch["actions"].reshape(B * L, N, self.act_dim),
            batch["returns"].reshape(B * L), batch["old_team_values"].reshape(B * L),
            batch["old_baselines"].reshape(B * L, N), eps)
        total = losses.poca_total_loss(policy_loss, value_loss, baseline_loss,
                                       mean_entropy, beta)
        return total, (policy_loss, value_loss, baseline_loss, mean_entropy)

    # ──────────────────────────────────────────────────────────────
    #  update
    # ──────────────────────────────────────────────────────────────

    def _chunk_rows(self, batch_rows: int, groups_per_row: int = 1) -> int:
        """Rows per gradient-accumulation chunk of a minibatch of
        ``batch_rows`` rows of ``groups_per_row`` arena timesteps each (1
        for feedforward, the BPTT window length for a recurrent batch), so
        that a chunk holds at most ``accum_chunk_groups`` groups;
        ``batch_rows`` (no chunking) when the whole batch fits under the
        cap."""
        cap = self.cfg.accum_chunk_groups
        if cap <= 0 or batch_rows * groups_per_row <= cap:
            return batch_rows
        return max(1, cap // groups_per_row)

    def _grad_chunks(self, batch_rows: int, groups_per_row: int = 1) -> int:
        """Number of gradient-accumulation passes (incl. a possible
        shorter tail chunk) the minibatch will be split into."""
        rows = self._chunk_rows(batch_rows, groups_per_row)
        return -(-batch_rows // rows)

    def _accumulate_grads(self, batch, eps, beta, loss_fn, groups_per_row: int = 1):
        """Leaves the gradient of ``loss_fn`` (``_feedforward_loss`` or
        ``_recurrent_loss``) over the minibatch in every parameter's
        ``.grad``, which must be None or zero at the call, and returns
        (total loss, aux (4,)) of the whole minibatch.

        Exact chunked accumulation: the full chunks' gradients are summed,
        then weighted by their share of rows, and the tail chunk's (B mod
        rows) is added with its own weight (every loss term is a per-element
        mean with a fixed element count per row, so Σᵢ wᵢ·meanᵢ with
        wᵢ = rowsᵢ/B equals the full-batch mean, and likewise its gradient).
        The weights apply after each backward, in the JAX package's order
        (trainer.py ``_sgd_step``), so that a bf16 product's gradient rounds
        as it does there. Each chunk's backward runs before the next chunk's
        forward, so activation memory is bounded by one chunk."""
        B = batch["obs"].shape[0]
        rows = self._chunk_rows(B, groups_per_row)
        n_full, rem = divmod(B, rows)
        params = list(self.optimizer.param_groups[0]["params"])
        total_sum = torch.zeros((), device=self.device)
        aux_sum = torch.zeros(4, device=self.device)
        for k in range(n_full):
            chunk = {n: v[k * rows:(k + 1) * rows] for n, v in batch.items()}
            total, aux = loss_fn(chunk, eps, beta)
            total.backward()
            total_sum = total_sum + total.detach()
            aux_sum = aux_sum + torch.stack(aux).detach()
        with torch.no_grad():
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(rows / B)
        total_v, aux_v = total_sum * (rows / B), aux_sum * (rows / B)
        if rem:
            tail = {n: v[n_full * rows:] for n, v in batch.items()}
            total, aux = loss_fn(tail, eps, beta)
            grads = torch.autograd.grad(total, params, allow_unused=True)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    if g is not None:
                        p.grad = g * (rem / B) if p.grad is None else p.grad + g * (rem / B)
            total_v = total_v + total.detach() * (rem / B)
            aux_v = aux_v + torch.stack(aux).detach() * (rem / B)
        return total_v, aux_v

    def _sgd_step(self, batch, eps, beta, loss_fn, groups_per_row: int = 1):
        """One Adam step on one minibatch; returns its aux (4,). Under a
        mesh the gradients and the aux are first averaged over the ranks
        (JAX ``_sgd_step``'s ``pmean``): each rank's loss is the mean over
        its share of the minibatch, so the mean is the global minibatch's
        gradient."""
        self.optimizer.zero_grad(set_to_none=True)
        _, aux = self._accumulate_grads(batch, eps, beta, loss_fn, groups_per_row)
        if self.mesh is not None:
            grads = [p.grad for p in self.optimizer.param_groups[0]["params"]
                     if p.grad is not None]
            self.mesh.all_reduce_mean_([*grads, aux])
        self.optimizer.step()
        return aux

    def _pmean(self, x):
        """A tensor's mean over the ranks (itself without a mesh)."""
        if self.mesh is not None:
            x = x.clone()
            self.mesh.all_reduce_mean_([x])
        return x

    def _normalize_advantages(self, advantages):
        """Mean 0 and std 1 over the whole buffer with Bessel's correction
        (``buffer.normalize_advantages``); over several ranks the moments
        are taken over all of them (JAX trainer.py:664-675): the mean, then
        the squared sum, var = sq·world / (n_global − 1)."""
        if self.world == 1:
            return buf.normalize_advantages(advantages)
        n_global = advantages.numel() * self.world
        mean = self._pmean(advantages.mean())
        sq = self._pmean(((advantages - mean) ** 2).sum())
        var = sq * self.world / (n_global - 1)
        return (advantages - mean) / (sqrt_rn(var) + 1e-10)

    @staticmethod
    def _flatten_buffer(rollout: Rollout, returns, advantages) -> dict:
        """(T, E, …) buffer → flat (T·E, …) minibatch source tensors."""
        return {
            "obs": buf.flatten_time_env(rollout.obs),
            "critic_states": buf.flatten_time_env(rollout.critic_states),
            "actions": buf.flatten_time_env(rollout.actions),
            "old_log_probs": buf.flatten_time_env(rollout.log_probs),
            "advantages": buf.flatten_time_env(advantages),
            "returns": returns.reshape(-1),
            "old_team_values": buf.flatten_time_env(rollout.team_values),
            "old_baselines": buf.flatten_time_env(rollout.baselines),
        }

    def _window_groups(self) -> dict[int, list[int]]:
        """The BPTT window layout (poca_buffer.py:190-208): windows of
        ``sequence_length`` decisions at a fixed stride from t = 0, the last
        one shorter where the horizon is not a multiple, grouped by length:
        {length: [start, …]}."""
        T = self.cfg.horizon
        L = max(1, min(self.cfg.sequence_length, T))
        groups: dict[int, list[int]] = {}
        for s in range(0, T, L):
            groups.setdefault(min(L, T - s), []).append(s)
        return groups

    def _window_batches(self, rollout: Rollout, returns, advantages) -> dict:
        """{L: batch} of the BPTT windows of each length
        (poca_buffer.py:190-246): each tensor (n_starts·E, L, …), a window
        per (start, arena), and the stored carry at each window's start as
        its initial memory (n_starts·E, N, M)."""
        def windows_for(starts, length):
            def win(x):
                # (T, E, …) → (n_s, L, E, …) → (n_s, E, L, …) → (n_s·E, L, …)
                pieces = torch.stack([x[s:s + length] for s in starts])
                return pieces.movedim(2, 1).reshape((-1, length) + tuple(x.shape[2:]))

            return {
                "obs": win(rollout.obs),
                "critic_states": win(rollout.critic_states),
                "actions": win(rollout.actions),
                "old_log_probs": win(rollout.log_probs),
                "advantages": win(advantages),
                "dones": win(rollout.dones),
                "returns": win(returns),
                "old_team_values": win(rollout.team_values),
                "old_baselines": win(rollout.baselines),
                "memory_h": torch.cat([rollout.memory_h[s] for s in starts]),
                "memory_c": torch.cat([rollout.memory_c[s] for s in starts]),
            }

        return {L: windows_for(starts, L)
                for L, starts in self._window_groups().items()}

    def _minibatch_steps(self, source: dict, perm, size: int, eps, beta,
                         loss_fn, groups_per_row: int = 1):
        """One Adam step per ``size`` rows of ``perm`` over ``source``, the
        last minibatch the remainder; returns (aux sum (4,), steps)."""
        aux_sum = torch.zeros(4, device=self.device)
        n = perm.shape[0]
        for lo in range(0, n, size):
            idx = perm[lo:lo + size]
            aux_sum = aux_sum + self._sgd_step(
                {k: v[idx] for k, v in source.items()}, eps, beta, loss_fn,
                groups_per_row)
        return aux_sum, -(-n // size)

    def _minibatch_rows(self, rows: int, groups_per_row: int = 1) -> int:
        """Rows of a minibatch drawn from ``rows`` rows of ``groups_per_row``
        groups each: this rank's share of ``group_mb`` groups, at least one
        row (trainer.py:721-722, 1015-1016)."""
        return min(max(1, (self.group_mb // self.world) // groups_per_row), rows)

    def _permutation(self, n: int, injected):
        """This rank's permutation of ``n`` rows: ``world`` permutations
        drawn from the shared generator, which stays in step on every rank,
        and the rank's own kept (one rank draws one)."""
        if injected is not None:
            return injected.to(self.device)
        perms = [torch.randperm(n, generator=self.generator, device=self.device)
                 for _ in range(self.world)]
        return perms[self.rank]

    def _update(self, rollout: Rollout, bootstrap, lr, eps, beta,
                injected_perms=None):
        """``num_epochs`` POCA epochs over the buffer → metrics (tensors).

        ``injected_perms`` replaces the epochs' minibatch permutations
        (otherwise drawn with ``torch.randperm`` from ``self.generator``):
        for a feedforward actor a (num_epochs, T·E) index tensor; for the
        recurrent actor one permutation of each window group's windows per
        epoch, ``injected_perms[epoch][L]``."""
        c = self.cfg
        returns, advantages = buf.compute_advantages(rollout, bootstrap,
                                                     c.gamma, c.lam)
        advantages = self._normalize_advantages(advantages)
        for group in self.optimizer.param_groups:
            group["lr"] = lr

        aux_sum = torch.zeros(4, device=self.device)
        n_batches = 0
        if self.recurrent:
            group_batches = self._window_batches(rollout, returns, advantages)
            for epoch in range(c.num_epochs):
                # the groups in sorted(L) order, one permutation each
                # (trainer.py:1013-1020)
                for L, source in sorted(group_batches.items()):
                    W = source["obs"].shape[0]
                    perm = self._permutation(
                        W, None if injected_perms is None else injected_perms[epoch][L])
                    a, n = self._minibatch_steps(source, perm, self._minibatch_rows(W, L),
                                                 eps, beta, self._recurrent_loss, L)
                    aux_sum, n_batches = aux_sum + a, n_batches + n
        else:
            T_E = rollout.rewards.shape[0] * rollout.rewards.shape[1]
            flat = self._flatten_buffer(rollout, returns, advantages)
            for epoch in range(c.num_epochs):
                perm = self._permutation(
                    T_E, None if injected_perms is None else injected_perms[epoch])
                a, n = self._minibatch_steps(flat, perm, self._minibatch_rows(T_E),
                                             eps, beta, self._feedforward_loss)
                aux_sum, n_batches = aux_sum + a, n_batches + n
        metrics = aux_sum / n_batches
        return {"policy_loss": metrics[0], "value_loss": metrics[1],
                "baseline_loss": metrics[2], "entropy": metrics[3],
                "mean_abs_advantage": self._pmean(advantages.abs().mean())}

    # ──────────────────────────────────────────────────────────────
    #  outer loop
    # ──────────────────────────────────────────────────────────────

    def _schedules(self):
        # the reference evaluates schedules AFTER the rollout advanced
        # global_step (poca_trainer.py:372-382,525)
        s = self.global_step + self.cfg.horizon * self.num_envs_global * self.num_agents
        return (float(self.lr_schedule(s)), float(self.eps_schedule(s)),
                float(self.beta_schedule(s)))

    def train_iteration(self, env_state, obs, actor_carry):
        """One rollout + update; returns (env_state, obs, actor_carry,
        host_metrics)."""
        lr, eps, beta = self._schedules()
        env_state, obs, actor_carry, rollout, bootstrap, _ = self.collect(
            env_state, obs, actor_carry)
        metrics = self._update(rollout, bootstrap, lr, eps, beta)
        self.update_count += 1

        host = {k: float(v) for k, v in metrics.items()}
        host["lr"], host["eps"], host["beta"] = lr, eps, beta
        rewards = rollout.rewards.cpu().numpy()
        host["mean_rollout_reward"] = float(rewards.sum(0).mean())
        host["mean_step_reward"] = float(rewards.mean())
        host["mean_team_value"] = float(self._pmean(rollout.team_values.mean()))
        self._rollout_reward_history.append(host["mean_rollout_reward"])
        if len(self._rollout_reward_history) > self._max_history:
            self._rollout_reward_history.pop(0)
        return env_state, obs, actor_carry, host

    def _profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def _stop_profiler(self, prof, profile_dir):
        prof.stop()
        path = Path(profile_dir)
        path.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path / "trace.json"))
        print(f"[POCA] profiler trace → {path / 'trace.json'}", flush=True)

    def train(self, checkpointer=None, progress=True):
        """Training loop to ``total_timesteps`` with summaries and
        checkpoints (poca_trainer.py:811-975). Returns (env_state, obs)
        after the last iteration.

        The summary and checkpoint cadence continues from the trainer's
        step, so a resumed run saves at the next multiple of the interval;
        the JAX loop restarts both at one interval (ROADMAP.md §3, intended
        divergences). On a fresh run both give the same steps. Under a mesh
        only rank 0 writes summaries and checkpoints; the losses are
        averaged over the ranks, so every rank stops at the same non-finite
        one, and no rank waits for another there."""
        c = self.cfg
        env_state, obs = self.env.reset(self.generator)
        actor_carry = self.init_actor_carry()
        next_summary = (self.global_step // c.summary_freq + 1) * c.summary_freq
        next_checkpoint = ((self.global_step // c.checkpoint_interval + 1)
                           * c.checkpoint_interval)
        start = time.time()
        decisions = c.horizon * self.num_envs_global * self.num_agents
        # optional trace of iterations 2-4 (skip the warm-up of the first)
        profile_dir, prof = self.profile_dir, None
        iteration = 0
        while self.global_step < c.total_timesteps:
            if profile_dir is not None and iteration == 1:
                prof = self._profiler()
                prof.start()
            t_iter = time.time()
            env_state, obs, actor_carry, m = self.train_iteration(
                env_state, obs, actor_carry)
            iter_dt = time.time() - t_iter
            iteration += 1
            if prof is not None and iteration == 4:
                self._stop_profiler(prof, profile_dir)
                profile_dir = prof = None
            elapsed = time.time() - start
            sps = self.global_step / elapsed if elapsed > 0 else 0.0
            sps_inst = decisions / iter_dt if iter_dt > 0 else 0.0
            if progress and self.is_main:
                print_line(f"[POCA] step={self.global_step:,} upd={self.update_count} "
                           f"pg={m['policy_loss']:.3f} vf={m['value_loss']:.3f} "
                           f"bl={m['baseline_loss']:.3f} ent={m['entropy']:.3f} "
                           f"SPS={sps:,.0f} (inst {sps_inst:,.0f})")
            # a NaN loss means diverged training: stop at the iteration it
            # appears instead of burning the rest of the budget
            bad = [k for k in ("policy_loss", "value_loss", "baseline_loss")
                   if not np.isfinite(m[k])]
            if bad:
                msg = f"non-finite {bad} at step {self.global_step:,} — diverged"
                if checkpointer is not None and self.is_main:
                    # kept for post-mortem, never resumed from
                    path = checkpointer.save(self, quarantine=True)
                    msg += (f"; diverged params quarantined at {path}, "
                            "resume from the last periodic checkpoint")
                if prof is not None:
                    self._stop_profiler(prof, profile_dir)
                raise FloatingPointError(msg)

            if self.writer is not None and self.is_main and self.global_step >= next_summary:
                next_summary += c.summary_freq
                self._write_summaries(m, sps)

            if (checkpointer is not None and self.is_main
                    and self.global_step >= next_checkpoint):
                next_checkpoint += c.checkpoint_interval
                checkpointer.save(self)

        if prof is not None:
            # the run ended before iteration 4: write what was traced
            self._stop_profiler(prof, profile_dir)
        if checkpointer is not None and self.is_main:
            checkpointer.save(self, final=True)
        if self.writer is not None and self.is_main:
            self.writer.flush()
        return env_state, obs

    def _write_summaries(self, m, sps):
        """ML-Agents TensorBoard tags (poca_trainer.py:861-958), in the JAX
        package's order."""
        w, s = self.writer, self.global_step
        w.add_scalar("Losses/Policy Loss", m["policy_loss"], s)
        w.add_scalar("Losses/Value Loss", m["value_loss"], s)
        w.add_scalar("Losses/POCA/Baseline Loss", m["baseline_loss"], s)
        w.add_scalar("Policy/Entropy", m["entropy"], s)
        w.add_scalar("Policy/Learning Rate", m["lr"], s)
        w.add_scalar("Policy/Epsilon", m["eps"], s)
        w.add_scalar("Policy/Beta", m["beta"], s)
        w.add_scalar("Policy/Extrinsic Reward", m["mean_step_reward"], s)
        w.add_scalar("Policy/Extrinsic Value Estimate", m["mean_team_value"], s)
        if not self.discrete:
            log_std = self.actor.log_std.detach().cpu().numpy()      # (1, act_dim)
            for d in range(log_std.shape[-1]):
                w.add_scalar(f"Policy/Std dim{d}", float(np.exp(log_std[0, d])), s)
            w.add_scalar("Policy/Log Std Mean", float(log_std.mean()), s)
        if self.completed_episode_returns:
            ep = self.completed_episode_returns
            w.add_scalar("Environment/Cumulative Reward", sum(ep) / len(ep), s)
            self.completed_episode_returns.clear()
        if self.completed_episode_lengths:
            el = self.completed_episode_lengths
            w.add_scalar("Environment/Episode Length", sum(el) / len(el), s)
            self.completed_episode_lengths.clear()
        w.add_scalar("Extra/SPS", sps, s)
        w.add_scalar("Extra/Mean Rollout Reward", m["mean_rollout_reward"], s)
        hist = self._rollout_reward_history
        w.add_scalar("Extra/Rolling Avg Rollout Reward", sum(hist) / len(hist), s)
        w.add_scalar("Extra/Mean Abs Advantage", m["mean_abs_advantage"], s)
        if self.completed_group_rewards:
            gr = self.completed_group_rewards
            w.add_scalar("Extra/Group Reward Mean", sum(gr) / len(gr), s)
            self.completed_group_rewards.clear()

    # ── checkpoint metadata (play_torch.py rebuild contract,
    #    poca_trainer.py:981-999) ─────────────────────────────────
    def checkpoint_metadata(self) -> dict:
        c = self.cfg
        recurrent = self.recurrent
        return {
            "hidden_dim": c.hidden_dim,
            "num_layers": c.num_layers,
            "recurrent": recurrent,
            "memory_size": c.memory_size if recurrent else 0,
            "sequence_length": c.sequence_length if recurrent else 0,
            "discrete": self.discrete,
            "num_actions": self.num_actions if self.discrete else 0,
            "act_dim": self.act_dim,
            "state_dim": self.STATE_DIM,
            "obs_dim": self.obs_dim,
            "variant": self.env.cfg.variant,
        }
