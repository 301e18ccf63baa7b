"""The discrete slice as a whole: a T = 4 daisy rollout of the port on the
CPU against a reference loop built from the JAX package's public pieces,
on both env paths.

N = 20 robots, E = 3 arenas, hidden 32, the same converted weights, the
same injected Gumbel noise (the categorical is sampled as
argmax(logits + g), the form ``jax.random.categorical`` takes), turn
durations and spawns, and two arenas near the end of their episode so that
the folded auto-reset fires inside the rollout. The reference loop mirrors
swarmacb_tpu/agents/trainer.py:283-357 (composed ``env.step``) and
:385-463 (``step_lanes`` with the Pallas kernel in interpret mode,
``obs_from_tiles``, ``critic_state_from_lanes``): ``DiscreteActor.apply``
and ``log_prob``, the critic on one-hot actions.

Actions, rewards and dones must match exactly; floats to 2e-5 absolute
(1e-4 for observations, whose RAB sums over up to 19 neighbours scale
float32 rounding by 1/d), as tests/test_torch_rollout.py holds dandelion.
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
from swarmacb_tpu.models.networks import DiscreteActor as FlaxDiscreteActor
from swarmacb_tpu.models.networks import POCACritic as FlaxCritic

from swarmacb_torch.agents import POCATrainer
from swarmacb_torch.config import DirectionalGateEnvCfg, POCAConfig
from swarmacb_torch.convert import load_flax_params
from swarmacb_torch.env import DirectionalGateEnv
from swarmacb_torch.models import DiscreteActor

E, N, HID, T, A = 3, 20, 32, 4, 6
KEYS = ("explore", "photo", "antiphoto")


def _initial(seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0, 1, (E, N))) * 0.8
    th = rng.uniform(0, 2 * np.pi, (E, N))
    pos = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (E, N)).astype(np.float32)
    prev = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (E, N))
    L = JaxCfg().max_episode_length
    step_count = np.array([L - 3, L - 2, 5], np.int32)
    ep_rew = np.array([2.0, -1.0, 0.0], np.float32)
    gumbel = rng.gumbel(size=(T, E * N, A)).astype(np.float32)
    dur = {k: rng.integers(1, 5, (T, E, N)).astype(np.int32) for k in KEYS}
    sr = np.sqrt(rng.uniform(0, 1, (T, E, N)))
    sth = rng.uniform(0, 2 * np.pi, (T, E, N))
    spawn_pos = np.stack([sr * np.cos(sth), sr * np.sin(sth)], -1).astype(np.float32)
    spawn_yaw = rng.uniform(-np.pi, np.pi, (T, E, N)).astype(np.float32)
    return pos, yaw, prev, step_count, ep_rew, gumbel, dur, spawn_pos, spawn_yaw


def _jax_reference(params, init, fused):
    pos, yaw, prev, step_count, ep_rew, gumbel, dur, spawn_pos, spawn_yaw = init
    jenv = JaxEnv(JaxCfg(variant="daisy", num_envs=E))
    actor = FlaxDiscreteActor(num_actions=A, hidden=HID, num_layers=2)
    critic = FlaxCritic(state_dim=5, act_dim=A, num_agents=N, hidden=HID,
                        num_heads=4, num_layers=2)
    pa, pc = params["actor"], params["critic"]
    act_fn = jax.jit(lambda o: actor.apply({"params": pa}, o))
    value_fn = jax.jit(lambda s: critic.apply({"params": pc}, s,
                                              method=critic.critic_pass))
    base_fn = jax.jit(lambda s, a: critic.apply({"params": pc}, s, a,
                                                method=critic.all_baselines))
    step_fn = jax.jit(lambda s, a, d, sp: jenv.step(s, a, injected_durations=d,
                                                    injected_spawn=sp))
    lanes_fn = jax.jit(lambda l, a, d, sp: jlanes.step_lanes(
        jenv, l, a, injected_durations=d, injected_spawn=sp))
    state = JaxEnvState(
        pos=jnp.asarray(pos), yaw=jnp.asarray(yaw), prev_ground=jnp.asarray(prev),
        step_count=jnp.asarray(step_count), episode_reward=jnp.asarray(ep_rew),
        completed_group_reward=jnp.zeros(E), behavior=JaxBehaviorState.init(E, N),
        key=jax.random.PRNGKey(0))
    obs = jax.jit(jenv._observations)(state)
    lanes = jlanes.state_to_lanes(jenv, state)
    out = {k: [] for k in ("obs", "critic_states", "actions", "log_probs",
                           "rewards", "dones", "team_values", "baselines",
                           "completed")}
    for t in range(T):
        logits = act_fn(obs.reshape(E * N, -1))
        act = jnp.argmax(logits + gumbel[t], axis=-1)
        logp = FlaxDiscreteActor.log_prob(logits, act)
        actions = act.reshape(E, N, 1).astype(jnp.float32)
        onehot = jax.nn.one_hot(act.reshape(E, N), A, dtype=jnp.float32)
        cs = (jlanes.critic_state_from_lanes(jenv, lanes) if fused
              else jenv.critic_state(state))
        tv = value_fn(cs)[:, 0]
        bl = base_fn(cs, onehot)
        d = {k: jnp.asarray(v[t]) for k, v in dur.items()}
        sp = (jnp.asarray(spawn_pos[t]), jnp.asarray(spawn_yaw[t]))
        if fused:
            lanes, reward, done, tiles = lanes_fn(
                lanes, jlanes.to_lanes(act.reshape(E, N).astype(jnp.int32), E), d, sp)
            next_obs = jlanes.obs_from_tiles(jenv, tiles, lanes["prev"])
            completed = jlanes.from_lanes(lanes["cg"], E, squeeze=True)
        else:
            state, ts = step_fn(state, act.reshape(E, N).astype(jnp.int32), d, sp)
            reward, done, next_obs = ts.reward, ts.done, ts.obs
            completed = state.completed_group_reward
        for k, v in (("obs", obs), ("critic_states", cs), ("actions", actions),
                     ("log_probs", logp.reshape(E, N, 1)), ("rewards", reward),
                     ("dones", done.astype(jnp.float32)), ("team_values", tv),
                     ("baselines", bl), ("completed", completed)):
            out[k].append(np.asarray(v))
        obs = next_obs
    if fused:
        state = jlanes.lanes_to_state(jenv, lanes)
    out = {k: np.stack(v) for k, v in out.items()}
    out["bootstrap"] = np.asarray(value_fn(jenv.critic_state(state))[:, 0])
    out["final_obs"] = np.asarray(obs)
    out["final_pos"] = np.asarray(state.pos)
    out["final_explore_state"] = np.asarray(state.behavior.explore_state)
    return out


@pytest.fixture(scope="module", params=["composed", "fused"])
def both_runs(request):
    fused = request.param == "fused"
    init = _initial()
    pos, yaw, prev, step_count, ep_rew, gumbel, dur, spawn_pos, spawn_yaw = init
    actor = FlaxDiscreteActor(num_actions=A, hidden=HID, num_layers=2)
    critic = FlaxCritic(state_dim=5, act_dim=A, num_agents=N, hidden=HID,
                        num_heads=4, num_layers=2)
    ka, kc = jax.random.split(jax.random.PRNGKey(7))
    params = {
        "actor": actor.init(ka, jnp.zeros((2, 24)))["params"],
        "critic": critic.init(kc, jnp.zeros((2, N, 5)), jnp.zeros((2, N, A)))["params"],
    }
    ref = _jax_reference(params, init, fused)

    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="daisy", num_envs=E),
                             device="cpu")
    trainer = POCATrainer(env, POCAConfig(hidden_dim=HID, horizon=T,
                                          fused_env_step=fused))
    load_flax_params(trainer, params)
    state = env.make_state(pos, yaw, torch.Generator(), step_count=step_count,
                           episode_reward=ep_rew)
    state.prev_ground = torch.from_numpy(prev)
    obs = env._observations(state)
    T_ = torch.from_numpy
    result = trainer.collect(
        state, obs, trainer.init_actor_carry(), injected_noise=T_(gumbel),
        injected_durations={k: T_(v) for k, v in dur.items()},
        injected_spawn=(T_(spawn_pos), T_(spawn_yaw)))
    return ref, trainer, result


def test_rollout_resets_and_switches_modules(both_runs):
    ref, _, _ = both_runs
    assert ref["dones"][:, 0].tolist() == [0, 1, 0, 0]
    assert ref["dones"][:, 1].tolist() == [1, 0, 0, 0]
    assert len(np.unique(ref["actions"])) == A, "not every module was chosen"


@pytest.mark.parametrize("field,atol", [
    ("obs", 1e-4), ("critic_states", 2e-5), ("actions", 0), ("log_probs", 2e-5),
    ("rewards", 0), ("dones", 0), ("team_values", 2e-5), ("baselines", 2e-5)])
def test_discrete_rollout_field_matches_jax(both_runs, field, atol):
    ref, _, (_, _, _, rollout, _, _) = both_runs
    got = getattr(rollout, field).numpy()
    assert got.shape == ref[field].shape
    if atol == 0:
        np.testing.assert_array_equal(got, ref[field])
    else:
        np.testing.assert_allclose(got, ref[field], rtol=0, atol=atol)


def test_discrete_final_state_and_aux_match_jax(both_runs):
    ref, trainer, (state, obs, _, _, bootstrap, aux) = both_runs
    np.testing.assert_allclose(bootstrap.numpy(), ref["bootstrap"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(obs.numpy(), ref["final_obs"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(state.pos.numpy(), ref["final_pos"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(state.behavior.explore_state.numpy(),
                                  ref["final_explore_state"])
    np.testing.assert_array_equal(aux[2].numpy(), ref["completed"])
    assert trainer.completed_episode_lengths == [1.0, 2.0]
    assert trainer.global_step == T * E * N


def test_discrete_actor_sampling_and_log_prob():
    """Gumbel-argmax from the generator: every module is drawn, with the
    categorical's frequencies; log_prob and entropy as log_softmax gives."""
    torch.manual_seed(0)
    logits = torch.tensor([[0.0, 1.0, -1.0, 0.5, 2.0, -0.5]]).expand(60000, A)
    g = torch.Generator().manual_seed(1)
    draws = DiscreteActor.sample(logits, generator=g)
    freq = torch.bincount(draws, minlength=A).double() / draws.numel()
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits[0], -1).numpy(),
                               atol=0.01)
    lp = DiscreteActor.log_prob(logits[:A], torch.arange(A))
    np.testing.assert_allclose(lp.numpy(), torch.log_softmax(logits[0], -1).numpy(),
                               rtol=1e-6)
    p = torch.softmax(logits[0], -1)
    np.testing.assert_allclose(float(DiscreteActor.entropy(logits[:1])[0]),
                               float(-(p * p.log()).sum()), rtol=1e-6)
