"""The acting slice as a whole: a T = 4 port rollout on the CPU against a
reference loop built from the JAX package's public pieces.

N = 20 robots, E = 3 arenas, hidden 32, with the same converted weights,
the same injected action noise and spawns, and two arenas near the end of
their episode so that the folded auto-reset fires inside the rollout. The
reference loop mirrors swarmacb_tpu/agents/trainer.py:283-357:
``env.step(..., injected_spawn=...)``, ``actor.apply``, ``Actor.log_prob``,
``critic.apply(... critic_pass / all_baselines)`` and ``env.critic_state``.

Rewards, dones and completed group rewards must match exactly; floats to
2e-5 absolute (1e-4 for observations, whose RAB sums over up to 19
neighbours scale float32 rounding by 1/d).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxCfg
from swarmacb_tpu.env import sensors as jsensors
from swarmacb_tpu.env.behaviors import BehaviorState as JaxBehaviorState
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv
from swarmacb_tpu.env.state import EnvState as JaxEnvState
from swarmacb_tpu.models.networks import Actor as FlaxActor
from swarmacb_tpu.models.networks import POCACritic as FlaxCritic

from swarmacb_torch.agents import POCATrainer
from swarmacb_torch.config import DirectionalGateEnvCfg, POCAConfig
from swarmacb_torch.convert import load_flax_params
from swarmacb_torch.env import DirectionalGateEnv

E, N, HID, T = 3, 20, 32, 4


def _initial(seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0, 1, (E, N))) * 1.1
    th = rng.uniform(0, 2 * np.pi, (E, N))
    pos = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (E, N)).astype(np.float32)
    prev = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (E, N))
    L = JaxCfg().max_episode_length
    step_count = np.array([L - 3, L - 2, 5], np.int32)
    ep_rew = np.array([2.0, -1.0, 0.0], np.float32)
    noise = rng.normal(size=(T, E * N, 2)).astype(np.float32)
    sr = np.sqrt(rng.uniform(0, 1, (T, E, N))) * 1.0
    sth = rng.uniform(0, 2 * np.pi, (T, E, N))
    spawn_pos = np.stack([sr * np.cos(sth), sr * np.sin(sth)], -1).astype(np.float32)
    spawn_yaw = rng.uniform(-np.pi, np.pi, (T, E, N)).astype(np.float32)
    return pos, yaw, prev, step_count, ep_rew, noise, spawn_pos, spawn_yaw


def _jax_reference(params, init):
    pos, yaw, prev, step_count, ep_rew, noise, spawn_pos, spawn_yaw = init
    jenv = JaxEnv(JaxCfg(num_envs=E))
    actor = FlaxActor(act_dim=2, hidden=HID, num_layers=2)
    critic = FlaxCritic(state_dim=5, act_dim=2, num_agents=N, hidden=HID,
                        num_heads=4, num_layers=2)
    pa, pc = params["actor"], params["critic"]
    act_fn = jax.jit(lambda o: actor.apply({"params": pa}, o))
    value_fn = jax.jit(lambda s: critic.apply({"params": pc}, s,
                                              method=critic.critic_pass))
    base_fn = jax.jit(lambda s, a: critic.apply({"params": pc}, s, a,
                                                method=critic.all_baselines))
    step_fn = jax.jit(jenv.step)
    state = JaxEnvState(
        pos=jnp.asarray(pos), yaw=jnp.asarray(yaw), prev_ground=jnp.asarray(prev),
        step_count=jnp.asarray(step_count), episode_reward=jnp.asarray(ep_rew),
        completed_group_reward=jnp.zeros(E), behavior=JaxBehaviorState.init(E, N),
        key=jax.random.PRNGKey(0))
    obs = jax.jit(jenv._observations)(state)
    out = {k: [] for k in ("obs", "critic_states", "actions", "log_probs",
                           "rewards", "dones", "team_values", "baselines",
                           "completed")}
    for t in range(T):
        mu, std = act_fn(obs.reshape(E * N, -1))
        act = mu + std * noise[t]
        logp = FlaxActor.log_prob(mu, std, act)
        actions = act.reshape(E, N, 2)
        env_actions = jnp.clip(actions, -3.0, 3.0) / 3.0
        cs = jenv.critic_state(state)
        tv = value_fn(cs)[:, 0]
        bl = base_fn(cs, actions)
        state, ts = step_fn(state, env_actions,
                            injected_spawn=(jnp.asarray(spawn_pos[t]),
                                            jnp.asarray(spawn_yaw[t])))
        for k, v in (("obs", obs), ("critic_states", cs), ("actions", actions),
                     ("log_probs", logp.reshape(E, N, 2)), ("rewards", ts.reward),
                     ("dones", ts.done.astype(jnp.float32)), ("team_values", tv),
                     ("baselines", bl), ("completed", state.completed_group_reward)):
            out[k].append(np.asarray(v))
        obs = ts.obs
    out = {k: np.stack(v) for k, v in out.items()}
    out["bootstrap"] = np.asarray(value_fn(jenv.critic_state(state))[:, 0])
    out["final_obs"] = np.asarray(obs)
    out["final_pos"] = np.asarray(state.pos)
    return out


@pytest.fixture(scope="module")
def both_runs():
    init = _initial()
    pos, yaw, prev, step_count, ep_rew, noise, spawn_pos, spawn_yaw = init
    actor = FlaxActor(act_dim=2, hidden=HID, num_layers=2)
    critic = FlaxCritic(state_dim=5, act_dim=2, num_agents=N, hidden=HID,
                        num_heads=4, num_layers=2)
    ka, kc = jax.random.split(jax.random.PRNGKey(7))
    params = {
        "actor": actor.init(ka, jnp.zeros((2, 24)))["params"],
        "critic": critic.init(kc, jnp.zeros((2, N, 5)), jnp.zeros((2, N, 2)))["params"],
    }
    ref = _jax_reference(params, init)

    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=E), device="cpu")
    trainer = POCATrainer(env, POCAConfig(hidden_dim=HID, horizon=T))
    load_flax_params(trainer, params)
    state = env.make_state(pos, yaw, torch.Generator(), step_count=step_count,
                           episode_reward=ep_rew)
    state.prev_ground = torch.from_numpy(prev)
    obs = env._observations(state)
    result = trainer.collect(
        state, obs, trainer.init_actor_carry(), injected_noise=torch.from_numpy(noise),
        injected_spawn=(torch.from_numpy(spawn_pos), torch.from_numpy(spawn_yaw)))
    return ref, trainer, result


def test_rollout_resets_inside_the_run(both_runs):
    ref, _, _ = both_runs
    assert ref["dones"][:, 0].tolist() == [0, 1, 0, 0]
    assert ref["dones"][:, 1].tolist() == [1, 0, 0, 0]
    assert ref["dones"][:, 2].sum() == 0
    assert np.abs(ref["rewards"]).sum() > 0, "no colour transition — weak test"


@pytest.mark.parametrize("field,atol", [
    ("obs", 1e-4), ("critic_states", 2e-5), ("actions", 2e-5),
    ("log_probs", 2e-5), ("rewards", 0), ("dones", 0), ("team_values", 2e-5),
    ("baselines", 2e-5)])
def test_rollout_field_matches_jax(both_runs, field, atol):
    ref, _, (_, _, _, rollout, _, _) = both_runs
    got = getattr(rollout, field).numpy()
    assert got.shape == ref[field].shape
    if atol == 0:
        np.testing.assert_array_equal(got, ref[field])
    else:
        np.testing.assert_allclose(got, ref[field], rtol=0, atol=atol)


def test_bootstrap_and_final_state_match_jax(both_runs):
    ref, _, (state, obs, _, _, bootstrap, _) = both_runs
    np.testing.assert_allclose(bootstrap.numpy(), ref["bootstrap"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(obs.numpy(), ref["final_obs"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(state.pos.numpy(), ref["final_pos"], rtol=0, atol=1e-5)


def test_aux_and_episode_stats_match_jax(both_runs):
    ref, trainer, (_, _, _, _, _, aux) = both_runs
    rewards, dones, completed = (a.numpy() for a in aux)
    np.testing.assert_array_equal(rewards, ref["rewards"])
    np.testing.assert_array_equal(dones, ref["dones"])
    np.testing.assert_array_equal(completed, ref["completed"])
    # host-side accounting: arena 1 ends at t=0, arena 0 at t=1
    want_group = [float(ref["completed"][0, 1]), float(ref["completed"][1, 0])]
    assert trainer.completed_group_rewards == want_group
    assert trainer.completed_episode_lengths == [1.0, 2.0]
    want_returns = [float(ref["rewards"][0, 1]),
                    float(ref["rewards"][0, 0] + ref["rewards"][1, 0])]
    assert trainer.completed_episode_returns == want_returns
    assert trainer.global_step == T * E * N
