"""POCA trainer, acting half — counterpart of the rollout side of
``swarmacb_tpu/agents/trainer.py``.

One decision (``_rollout_fn`` in the JAX package, trainer.py:269-366):
sample the Gaussian actor, run the critic's team value and all N
counterfactual baselines on the 5-D critic state, then step the env
``decision_period`` times with the same action. Forward only, under
``torch.no_grad()``. Algorithm parity with ML-Agents POCA:

  - counterfactual baselines from the critic every step (poca_trainer.py:449-455)
  - continuous env-action preprocessing clamp(−3,3)/3, raw actions stored
    (poca_trainer.py:457-467)
  - decision_period sub-stepping with reward accumulation (poca_trainer.py:469-482)
  - host-side episode accounting across auto-resets (poca_trainer.py:498-515)

The JAX package scans the horizon inside one jitted program; here it is a
Python loop of eager PyTorch calls on the env's device, whose hot spots are
the hand-written CUDA kernels in ``swarmacb_torch.ops``. The learning half
(λ-returns, the POCA losses, Adam, the update with the tail's backward
kernel) is not ported yet (ROADMAP.md §1 item 6).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config.poca_cfg import POCAConfig
from ..env.directional_gate import DirectionalGateEnv
from ..models.networks import Actor, POCACritic
from .buffer import Rollout


def _not_ported(cfg: POCAConfig) -> Optional[str]:
    if cfg.recurrent:
        return "recurrent=True (LSTM actor): ROADMAP.md §1 item 9"
    if cfg.mixed_precision:
        return "mixed_precision=True: ROADMAP.md §1 item 10"
    if cfg.fused_attention:
        return "fused_attention=True: ROADMAP.md §2 K5f/K5b"
    if cfg.fused_env_step:
        return "fused_env_step=True: ROADMAP.md §1 item 14 and §2 K4"
    return None


class POCATrainer:
    """Networks, sampling and the rollout of POCA on a batched env.

    Runs on the env's device. Weights are drawn on the CPU from
    ``cfg.seed`` (so a CPU and a CUDA trainer of one seed hold the same
    weights) and then moved; action noise comes from ``self.generator``,
    a generator on the device seeded with ``cfg.seed``.
    """

    STATE_DIM = 5  # critic consumes the 5-D polar state (poca_trainer.py:224-227)

    def __init__(self, env: DirectionalGateEnv, cfg: Optional[POCAConfig] = None):
        self.env = env
        self.cfg = cfg or POCAConfig()
        c = self.cfg
        missing = _not_ported(c)
        if missing is not None:
            raise NotImplementedError(f"not ported yet — {missing}")
        self.device = env.device
        self.num_envs = env.num_envs
        self.num_agents = env.num_agents
        self.obs_dim = env.obs_dim
        self.act_dim = env.cfg.act_dim

        # ── networks (built without drawing from the global RNG) ───
        with torch.device("meta"):
            self.actor = Actor(self.obs_dim, self.act_dim, hidden=c.hidden_dim,
                               num_layers=c.num_layers)
            self.critic = POCACritic(
                state_dim=self.STATE_DIM, act_dim=self.act_dim,
                num_agents=self.num_agents, hidden=c.hidden_dim,
                num_heads=c.critic_num_heads, num_layers=c.num_layers,
            )
        self.init_params_for_seed(c.seed)

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(c.seed)
        self.global_step = 0

        # host-side episode accounting (poca_trainer.py:322-330)
        self._episode_reward_acc = np.zeros(self.num_envs)
        self._episode_step_count = np.zeros(self.num_envs)
        self.completed_episode_returns: list[float] = []
        self.completed_episode_lengths: list[float] = []
        self.completed_group_rewards: list[float] = []

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
        """Continuous actions enter the critic's entity embedding as they
        are (poca_trainer.py:353-366; one-hot encoding is for the discrete
        variants)."""
        return actions

    def _apply_actor(self, flat_obs):
        """Feedforward Gaussian actor: (mu, std)."""
        return self.actor(flat_obs)

    # ──────────────────────────────────────────────────────────────
    #  rollout
    # ──────────────────────────────────────────────────────────────

    @torch.no_grad()
    def rollout(self, env_state, obs, length: Optional[int] = None,
                injected_noise=None, injected_spawn=None, want_bootstrap=True):
        """Collect ``length`` (default horizon) decisions.

        Args:
            env_state, obs: the env's current state and observations.
            injected_noise: optional (T, E·N, act_dim) standard-normal draws
                replacing the actor's sampling noise.
            injected_spawn: optional (pos (S, E, N, 2), yaw (S, E, N)) with
                S = T·decision_period, one auto-reset spawn per env step
                (``DirectionalGateEnv.step``'s ``injected_spawn``).

        Returns (env_state, obs, rollout, bootstrap_value or None, aux) with
        aux = (step rewards, dones, completed_group_reward), each (T, E).
        """
        env = self.env
        E, N = self.num_envs, self.num_agents
        dp = self.cfg.decision_period
        T = self.cfg.horizon if length is None else length
        steps, aux = [], []
        for t in range(T):
            mu, std = self._apply_actor(obs.reshape(E * N, self.obs_dim))
            noise = None if injected_noise is None else injected_noise[t]
            act_flat = Actor.sample(mu, std, noise=noise, generator=self.generator)
            logp_flat = Actor.log_prob(mu, std, act_flat)
            actions = act_flat.reshape(E, N, self.act_dim)
            log_probs = logp_flat.reshape(E, N, self.act_dim)
            # ML-Agents env preprocessing clamp(−3,3)/3; the rollout keeps
            # RAW actions (poca_trainer.py:457-467)
            env_actions = torch.clamp(actions, -3.0, 3.0) / 3.0

            critic_state = env.critic_state(env_state)                 # (E,N,5)
            team_val = self.critic.critic_pass(critic_state)[:, 0]     # (E,)
            baselines = self.critic.all_baselines(
                critic_state, self._encode_actions_for_critic(actions))  # (E,N)

            # decision_period sub-steps with the same action
            # (poca_trainer.py:469-482)
            acc_reward = torch.zeros(E, device=self.device)
            last_done = torch.zeros(E, device=self.device)
            next_obs = obs
            for sub in range(dp):
                spawn = None
                if injected_spawn is not None:
                    k = t * dp + sub
                    spawn = (injected_spawn[0][k], injected_spawn[1][k])
                env_state, ts = env.step(env_state, env_actions,
                                         injected_spawn=spawn)
                acc_reward = acc_reward + ts.reward
                last_done = torch.maximum(last_done, ts.done.to(torch.float32))
                next_obs = ts.obs

            steps.append(dict(
                obs=obs, critic_states=critic_state, actions=actions,
                log_probs=log_probs,
                rewards=acc_reward * self.cfg.reward_strength,
                dones=last_done, team_values=team_val, baselines=baselines))
            aux.append((acc_reward, last_done, env_state.completed_group_reward))
            obs = next_obs

        rollout = Rollout.stack(steps)
        aux = tuple(torch.stack(x) for x in zip(*aux))
        bootstrap = self._bootstrap_fn(env_state) if want_bootstrap else None
        return env_state, obs, rollout, bootstrap, aux

    @torch.no_grad()
    def _bootstrap_fn(self, env_state):
        """V(s_T) for the λ-return bootstrap (poca_trainer.py:528-530)."""
        return self.critic.critic_pass(self.env.critic_state(env_state))[:, 0]

    def collect(self, env_state, obs, **kwargs):
        """``rollout`` plus the host-side bookkeeping of one iteration:
        episode statistics and the global decision count."""
        env_state, obs, rollout, bootstrap, aux = self.rollout(
            env_state, obs, **kwargs)
        self._accumulate_episode_stats({"rewards": rollout.rewards,
                                        "dones": rollout.dones,
                                        "completed_group": aux[2]})
        self.global_step += rollout.rewards.shape[0] * self.num_envs * self.num_agents
        return env_state, obs, rollout, bootstrap, aux

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
