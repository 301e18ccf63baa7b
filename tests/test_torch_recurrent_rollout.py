"""The recurrent slice's acting half: a T = 6 cyclamen rollout of the port
on the CPU against a reference loop built from the JAX package's public
pieces, on both env paths.

N = 20 robots, E = 3 arenas, hidden 32 with one layer, LSTM memory 16, the
same converted weights, a non-zero starting carry, the same injected
Gumbel noise (the categorical is sampled as argmax(logits + g), the form
``jax.random.categorical`` takes), turn durations and spawns, and two
arenas reaching their time limit inside the run (at t = 2 and t = 4), so
that the folded auto-reset fires and their carry is zeroed. The reference
loop mirrors swarmacb_tpu/agents/trainer.py:283-357 (composed
``env.step``) and :385-463 (``step_lanes`` with the Pallas kernel in
interpret mode): ``RecurrentDiscreteActor.step``, the carry from before
each decision stored as ``memory_h`` / ``memory_c``, then multiplied by
1 − done of its arena.

Actions are exact under the tie rule of tests/torch_parity.py (a mismatch
is accepted only where the two largest logits + g lie within 16 ulps);
rewards and dones exact; ``memory_h``, ``memory_c`` and the log-probs
within 1e-5; the carry is exactly zero where an episode ended, and only
there.
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
from swarmacb_tpu.models.networks import RecurrentDiscreteActor as FlaxRecurrentActor

from swarmacb_torch.agents import POCATrainer
from swarmacb_torch.config import DirectionalGateEnvCfg, POCAConfig
from swarmacb_torch.convert import load_flax_params
from swarmacb_torch.env import DirectionalGateEnv
from torch_parity import EPS32, ULPS, TieRule

E, N, HID, MEM, T, A = 3, 20, 32, 16, 6, 6
KEYS = ("explore", "photo", "antiphoto")


def _initial(seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0, 1, (E, N))) * 0.8
    th = rng.uniform(0, 2 * np.pi, (E, N))
    pos = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (E, N)).astype(np.float32)
    prev = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (E, N))
    L = JaxCfg().max_episode_length
    step_count = np.array([L - 4, 5, L - 6], np.int32)
    ep_rew = np.array([2.0, -1.0, 0.0], np.float32)
    h0 = (0.5 * rng.normal(size=(E * N, MEM))).astype(np.float32)
    c0 = rng.normal(size=(E * N, MEM)).astype(np.float32)
    gumbel = rng.gumbel(size=(T, E * N, A)).astype(np.float32)
    dur = {k: rng.integers(1, 5, (T, E, N)).astype(np.int32) for k in KEYS}
    sr = np.sqrt(rng.uniform(0, 1, (T, E, N)))
    sth = rng.uniform(0, 2 * np.pi, (T, E, N))
    spawn_pos = np.stack([sr * np.cos(sth), sr * np.sin(sth)], -1).astype(np.float32)
    spawn_yaw = rng.uniform(-np.pi, np.pi, (T, E, N)).astype(np.float32)
    return dict(pos=pos, yaw=yaw, prev=prev, step_count=step_count, ep_rew=ep_rew,
                h0=h0, c0=c0, gumbel=gumbel, dur=dur, spawn_pos=spawn_pos,
                spawn_yaw=spawn_yaw)


def _modules():
    return (FlaxRecurrentActor(num_actions=A, hidden=HID, num_layers=1, memory=MEM),
            FlaxCritic(state_dim=5, act_dim=A, num_agents=N, hidden=HID, num_heads=4,
                       num_layers=1))


def _jax_reference(params, init, fused):
    jenv = JaxEnv(JaxCfg(variant="cyclamen", num_envs=E))
    actor, critic = _modules()
    pa, pc = params["actor"], params["critic"]
    act_fn = jax.jit(lambda o, c: actor.apply({"params": pa}, o, c, method=actor.step))
    value_fn = jax.jit(lambda s: critic.apply({"params": pc}, s,
                                              method=critic.critic_pass))
    base_fn = jax.jit(lambda s, a: critic.apply({"params": pc}, s, a,
                                                method=critic.all_baselines))
    step_fn = jax.jit(lambda s, a, d, sp: jenv.step(s, a, injected_durations=d,
                                                    injected_spawn=sp))
    lanes_fn = jax.jit(lambda l, a, d, sp: jlanes.step_lanes(
        jenv, l, a, injected_durations=d, injected_spawn=sp))
    state = JaxEnvState(
        pos=jnp.asarray(init["pos"]), yaw=jnp.asarray(init["yaw"]),
        prev_ground=jnp.asarray(init["prev"]), step_count=jnp.asarray(init["step_count"]),
        episode_reward=jnp.asarray(init["ep_rew"]), completed_group_reward=jnp.zeros(E),
        behavior=JaxBehaviorState.init(E, N), key=jax.random.PRNGKey(0))
    obs = jax.jit(jenv._observations)(state)
    lanes = jlanes.state_to_lanes(jenv, state)
    carry = (jnp.asarray(init["h0"]), jnp.asarray(init["c0"]))
    out = {k: [] for k in ("obs", "actions", "log_probs", "rewards", "dones",
                           "team_values", "baselines", "memory_h", "memory_c", "scores")}
    for t in range(T):
        stored = (carry[0].reshape(E, N, MEM), carry[1].reshape(E, N, MEM))
        logits, new_carry = act_fn(obs.reshape(E * N, -1), carry)
        scores = logits + init["gumbel"][t]
        act = jnp.argmax(scores, axis=-1)
        logp = FlaxDiscreteActor.log_prob(logits, act)
        onehot = jax.nn.one_hot(act.reshape(E, N), A, dtype=jnp.float32)
        cs = (jlanes.critic_state_from_lanes(jenv, lanes) if fused
              else jenv.critic_state(state))
        d = {k: jnp.asarray(v[t]) for k, v in init["dur"].items()}
        sp = (jnp.asarray(init["spawn_pos"][t]), jnp.asarray(init["spawn_yaw"][t]))
        if fused:
            lanes, reward, done, tiles = lanes_fn(
                lanes, jlanes.to_lanes(act.reshape(E, N).astype(jnp.int32), E), d, sp)
            next_obs = jlanes.obs_from_tiles(jenv, tiles, lanes["prev"])
        else:
            state, ts = step_fn(state, act.reshape(E, N).astype(jnp.int32), d, sp)
            reward, done, next_obs = ts.reward, ts.done, ts.obs
        last_done = done.astype(jnp.float32)
        keep = (1.0 - last_done)[:, None].repeat(N, 1).reshape(E * N, 1)
        carry = (new_carry[0] * keep, new_carry[1] * keep)
        for k, v in (("obs", obs), ("actions", act.reshape(E, N, 1).astype(jnp.float32)),
                     ("log_probs", logp.reshape(E, N, 1)), ("rewards", reward),
                     ("dones", last_done), ("team_values", value_fn(cs)[:, 0]),
                     ("baselines", base_fn(cs, onehot)), ("memory_h", stored[0]),
                     ("memory_c", stored[1]), ("scores", scores)):
            out[k].append(np.asarray(v))
        obs = next_obs
    out = {k: np.stack(v) for k, v in out.items()}
    out["final_h"], out["final_c"] = np.asarray(carry[0]), np.asarray(carry[1])
    return out


@pytest.fixture(scope="module", params=["composed", "fused"])
def both_runs(request):
    fused = request.param == "fused"
    init = _initial()
    actor, critic = _modules()
    ka, kc = jax.random.split(jax.random.PRNGKey(7))
    carry0 = (jnp.zeros((2, MEM)), jnp.zeros((2, MEM)))
    params = {
        "actor": actor.init(ka, jnp.zeros((2, 4)), carry0, method=actor.step)["params"],
        "critic": critic.init(kc, jnp.zeros((2, N, 5)), jnp.zeros((2, N, A)))["params"],
    }
    ref = _jax_reference(params, init, fused)

    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="cyclamen", num_envs=E),
                             device="cpu")
    trainer = POCATrainer(env, POCAConfig(hidden_dim=HID, num_layers=1, horizon=T,
                                          recurrent=True, memory_size=MEM,
                                          fused_env_step=fused))
    load_flax_params(trainer, params)
    state = env.make_state(init["pos"], init["yaw"], torch.Generator(),
                           step_count=init["step_count"], episode_reward=init["ep_rew"])
    state.prev_ground = torch.from_numpy(init["prev"])
    obs = env._observations(state)
    T_ = torch.from_numpy
    result = trainer.collect(
        state, obs, (T_(init["h0"]), T_(init["c0"])), injected_noise=T_(init["gumbel"]),
        injected_durations={k: T_(v) for k, v in init["dur"].items()},
        injected_spawn=(T_(init["spawn_pos"]), T_(init["spawn_yaw"])))
    return ref, trainer, result


def test_episodes_end_inside_the_run(both_runs):
    ref, trainer, _ = both_runs
    assert ref["dones"][:, 0].tolist() == [0, 0, 1, 0, 0, 0]
    assert ref["dones"][:, 2].tolist() == [0, 0, 0, 0, 1, 0]
    assert ref["dones"][:, 1].sum() == 0
    assert trainer.completed_episode_lengths == [3.0, 5.0]


def test_actions_match_jax_under_the_tie_rule(both_runs):
    ref, _, (_, _, _, rollout, _, _) = both_runs
    top2 = np.sort(ref["scores"], -1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]
           <= ULPS * EPS32 * np.maximum(np.abs(top2[..., 1]), 1.0)).reshape(T, E, N)
    rule = TieRule()
    rule.equal(rollout.actions.numpy(), ref["actions"], tie, "actions")
    rule.report("recurrent rollout actions")
    assert len(np.unique(ref["actions"])) == A, "not every module was chosen"


@pytest.mark.parametrize("field,atol", [
    ("memory_h", 1e-5), ("memory_c", 1e-5), ("log_probs", 1e-5), ("rewards", 0),
    ("dones", 0), ("obs", 1e-4), ("team_values", 2e-5), ("baselines", 2e-5)])
def test_recurrent_rollout_field_matches_jax(both_runs, field, atol):
    ref, _, (_, _, _, rollout, _, _) = both_runs
    got = getattr(rollout, field).numpy()
    assert got.shape == ref[field].shape
    if atol == 0:
        np.testing.assert_array_equal(got, ref[field])
    else:
        np.testing.assert_allclose(got, ref[field], rtol=0, atol=atol)


def test_carry_is_zero_exactly_after_a_done(both_runs):
    """The stored carry of arena e at t + 1, and the carry returned after
    the last decision, are zero across the arena exactly where arena e's
    episode ended at t. (A single robot's carry can come out zero on its
    own: with the initial zero biases, an all-zero observation from a
    zero carry gives i·g = 0.)"""
    ref, _, (_, _, carry, rollout, _, _) = both_runs
    final = np.stack([carry[0].numpy(), carry[1].numpy()]).reshape(2, E, N, MEM)
    for name, got in (("memory_h", rollout.memory_h.numpy()),
                      ("memory_c", rollout.memory_c.numpy())):
        got = np.concatenate([got, final[None, 0 if name == "memory_h" else 1]])
        zero = ~got.reshape(T + 1, E, N * MEM).any(-1)                 # (T+1, E)
        want = np.concatenate([np.zeros((1, E), bool), ref["dones"] > 0.5])
        np.testing.assert_array_equal(zero, want, err_msg=name)
    np.testing.assert_allclose(carry[0].numpy(), ref["final_h"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(carry[1].numpy(), ref["final_c"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(rollout.memory_h[0].reshape(E * N, MEM).numpy(),
                                  _initial()["h0"])
