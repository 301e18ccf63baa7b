"""A T = 4 rollout at N = 40 robots an arena (past the tuned env kernels'
32, ``ops.pairwise.route``) on each env path, on the CPU, against a loop of
the JAX package's public pieces: dandelion on the composed env step
(``tests/test_torch_rollout.py``'s reference loop) and daisy on
``step_lanes`` with the Pallas K4 in interpret mode
(``tests/test_torch_discrete_rollout.py``'s), E = 2, hidden 32, the same
converted weights, injected action noise (Gumbel for daisy), turn
durations and spawns, one arena near the end of its episode so that the
folded reset fires. Module ids, rewards and dones exact; floats to 2e-5
(observations 1e-4), as those files hold N = 20.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxCfg
from swarmacb_tpu.env import lanes as jlanes
from swarmacb_tpu.env.behaviors import BehaviorState as JaxBehaviorState
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv
from swarmacb_tpu.env.state import EnvState as JaxEnvState
from swarmacb_tpu.models.networks import Actor as FlaxActor
from swarmacb_tpu.models.networks import DiscreteActor as FlaxDiscreteActor
from swarmacb_tpu.models.networks import POCACritic as FlaxCritic

from swarmacb_torch import ops
from swarmacb_torch.agents import POCATrainer
from swarmacb_torch.config import DirectionalGateEnvCfg, POCAConfig
from swarmacb_torch.convert import load_flax_params
from swarmacb_torch.env import DirectionalGateEnv

T_, J = torch.from_numpy, jnp.asarray

E, N, HID, T = 2, 40, 32, 4
KEYS = ("explore", "photo", "antiphoto")
FIELDS = ("obs", "critic_states", "actions", "log_probs", "rewards", "dones",
          "team_values", "baselines")


def _initial(discrete, seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0, 1, (E, N))) * 0.9
    th = rng.uniform(0, 2 * np.pi, (E, N))
    pos = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (E, N)).astype(np.float32)
    prev = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (E, N))
    L = JaxCfg().max_episode_length
    init = dict(pos=pos, yaw=yaw, prev=prev, step_count=np.array([L - 3, 5], np.int32),
                ep_rew=np.array([2.0, -1.0], np.float32))
    if discrete:
        init["noise"] = rng.gumbel(size=(T, E * N, 6)).astype(np.float32)
        init["dur"] = {n: rng.integers(1, 5, (T, E, N)).astype(np.int32) for n in KEYS}
    else:
        init["noise"] = rng.normal(size=(T, E * N, 2)).astype(np.float32)
    sr, sth = np.sqrt(rng.uniform(0, 1, (T, E, N))), rng.uniform(0, 2 * np.pi, (T, E, N))
    init["spawn_pos"] = np.stack([sr * np.cos(sth), sr * np.sin(sth)], -1).astype(np.float32)
    init["spawn_yaw"] = rng.uniform(-np.pi, np.pi, (T, E, N)).astype(np.float32)
    return init


def _jax_rollout(variant, params, init):
    discrete = variant != "dandelion"
    jenv = JaxEnv(JaxCfg(variant=variant, num_envs=E, num_agents=N))
    A = 6 if discrete else 2
    actor = (FlaxDiscreteActor(num_actions=A, hidden=HID, num_layers=2) if discrete
             else FlaxActor(act_dim=2, hidden=HID, num_layers=2))
    critic = FlaxCritic(state_dim=5, act_dim=A, num_agents=N, hidden=HID, num_heads=4,
                        num_layers=2)
    pa, pc = params["actor"], params["critic"]
    act_fn = jax.jit(lambda o: actor.apply({"params": pa}, o))
    value_fn = jax.jit(lambda s: critic.apply({"params": pc}, s, method=critic.critic_pass))
    base_fn = jax.jit(lambda s, a: critic.apply({"params": pc}, s, a,
                                                method=critic.all_baselines))
    step_fn = jax.jit(lambda s, a, sp: jenv.step(s, a, injected_spawn=sp))
    lanes_fn = jax.jit(lambda l, a, d, sp: jlanes.step_lanes(
        jenv, l, a, injected_durations=d, injected_spawn=sp))
    state = JaxEnvState(
        pos=J(init["pos"]), yaw=J(init["yaw"]), prev_ground=J(init["prev"]),
        step_count=J(init["step_count"]), episode_reward=J(init["ep_rew"]),
        completed_group_reward=jnp.zeros(E), behavior=JaxBehaviorState.init(E, N),
        key=jax.random.PRNGKey(0))
    obs = jax.jit(jenv._observations)(state)
    lanes_state = jlanes.state_to_lanes(jenv, state)
    out = {k: [] for k in FIELDS}
    for t in range(T):
        sp = (J(init["spawn_pos"][t]), J(init["spawn_yaw"][t]))
        if discrete:
            logits = act_fn(obs.reshape(E * N, -1))
            act = jnp.argmax(logits + init["noise"][t], axis=-1)
            logp = FlaxDiscreteActor.log_prob(logits, act).reshape(E, N, 1)
            actions = act.reshape(E, N, 1).astype(jnp.float32)
            critic_act = jax.nn.one_hot(act.reshape(E, N), A, dtype=jnp.float32)
            cs = jlanes.critic_state_from_lanes(jenv, lanes_state)
        else:
            mu, std = act_fn(obs.reshape(E * N, -1))
            raw = mu + std * init["noise"][t]
            logp = FlaxActor.log_prob(mu, std, raw).reshape(E, N, 2)
            actions = critic_act = raw.reshape(E, N, 2)
            cs = jenv.critic_state(state)
        tv, bl = value_fn(cs)[:, 0], base_fn(cs, critic_act)
        if discrete:
            d = {n: J(init["dur"][n][t]) for n in KEYS}
            lanes_state, reward, done, tiles = lanes_fn(
                lanes_state, jlanes.to_lanes(act.reshape(E, N).astype(jnp.int32), E), d, sp)
            next_obs = jlanes.obs_from_tiles(jenv, tiles, lanes_state["prev"])
        else:
            state, ts = step_fn(state, jnp.clip(actions, -3.0, 3.0) / 3.0, sp)
            reward, done, next_obs = ts.reward, ts.done, ts.obs
        for k_, v in zip(FIELDS, (obs, cs, actions, logp, reward, done.astype(jnp.float32),
                                  tv, bl)):
            out[k_].append(np.asarray(v))
        obs = next_obs
    return {k_: np.stack(v) for k_, v in out.items()}


@pytest.fixture(scope="module", params=["dandelion", "daisy"])
def rollouts_at_40(request):
    variant = request.param
    discrete = variant == "daisy"
    A = 6 if discrete else 2
    init = _initial(discrete)
    actor = (FlaxDiscreteActor(num_actions=A, hidden=HID, num_layers=2) if discrete
             else FlaxActor(act_dim=2, hidden=HID, num_layers=2))
    critic = FlaxCritic(state_dim=5, act_dim=A, num_agents=N, hidden=HID, num_heads=4,
                        num_layers=2)
    ka, kc = jax.random.split(jax.random.PRNGKey(7))
    params = {"actor": actor.init(ka, jnp.zeros((2, 24)))["params"],
              "critic": critic.init(kc, jnp.zeros((2, N, 5)), jnp.zeros((2, N, A)))["params"]}
    ref = _jax_rollout(variant, params, init)
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=E, num_agents=N),
                             device="cpu")
    trainer = POCATrainer(env, POCAConfig(hidden_dim=HID, horizon=T, fused_env_step=discrete))
    load_flax_params(trainer, params)
    state = env.make_state(init["pos"], init["yaw"], torch.Generator(),
                           step_count=init["step_count"], episode_reward=init["ep_rew"])
    state.prev_ground = T_(init["prev"])
    kw = dict(injected_noise=T_(init["noise"]),
              injected_spawn=(T_(init["spawn_pos"]), T_(init["spawn_yaw"])))
    if discrete:
        kw["injected_durations"] = {n: T_(v) for n, v in init["dur"].items()}
    before = dict(ops.launches)
    result = trainer.collect(state, env._observations(state), trainer.init_actor_carry(), **kw)
    assert ops.launches == before, "the CPU rollout launched a kernel"
    return variant, ref, result[3]


@pytest.mark.parametrize("field,atol", [
    ("obs", 1e-4), ("critic_states", 2e-5), ("actions", None), ("log_probs", 2e-5),
    ("rewards", 0), ("dones", 0), ("team_values", 2e-5), ("baselines", 2e-5)])
def test_rollout_at_40_robots_matches_jax(rollouts_at_40, field, atol):
    variant, ref, rollout = rollouts_at_40
    got = getattr(rollout, field).numpy()
    assert got.shape == ref[field].shape
    if atol is None:   # module ids exact; wheel commands as floats
        atol = 0 if variant == "daisy" else 2e-5
    if atol == 0:
        np.testing.assert_array_equal(got, ref[field])
    else:
        np.testing.assert_allclose(got, ref[field], rtol=0, atol=atol)
    if field == "dones":
        assert got[:, 0].tolist() == [0, 1, 0, 0], "the folded reset did not fire"
