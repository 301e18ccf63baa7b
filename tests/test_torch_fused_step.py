"""The plain version of K4 (``ops.fused_env_step`` on CPU tiles) and the
lanes module against the JAX package, on the CPU.

- Against JAX ``fused_env_step`` in Pallas interpret mode, through
  ``step_lanes`` on both sides with the same injected turn durations and
  spawns: daisy, lily and dandelion, with and without observation tiles,
  E = 3 arenas of N = 20 robots (one 128-lane tile), a 0.6 s episode so
  that the folded reset fires. Teacher-forced: the JAX lanes state runs
  free and every step starts both sides from it. Integer tiles must match
  exactly under the tie rule of ``torch_parity`` (band form of the
  obstacle test), which should then almost never fire; floats to 2e-6
  (positions, yaw, readings) and 2e-5 (RAB projections, sums over up to 19
  neighbours of terms up to 1/(2r)) per step. Each JAX stepper is jitted
  once per variant and form.
- A 20-step free run of the plain K4 against the JAX package's COMPOSED
  ``env.step`` at atol 5e-5, as tests/test_fused_step.py holds the JAX
  kernel (E = 3, N = 6): integer state exact.
- The lanes round trip and ``obs_from_tiles`` against the JAX ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxCfg
from swarmacb_tpu.env import lanes as jlanes
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv
from torch_parity import TieRule, colour_ties, prox_ties

from swarmacb_torch import ops
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import DirectionalGateEnv
from swarmacb_torch.env import lanes
from swarmacb_torch.ops import fused_step

E, N, STEPS = 3, 20, 8
EPISODE_S = 0.6


def _envs(variant, **kw):
    kw = dict(variant=variant, num_envs=kw.pop("num_envs", E), **kw)
    return JaxEnv(JaxCfg(**kw)), DirectionalGateEnv(DirectionalGateEnvCfg(**kw),
                                                    device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_lanes(jl):
    return {k: _t(v) for k, v in jl.items() if k != "key"} | {"generator": torch.Generator()}


def _draws(rng, cfg, E_, N_):
    if cfg.discrete_actions:
        acts = rng.integers(0, 6, (E_, N_)).astype(np.int32)
        dur = {k: rng.integers(1, 5, (E_, N_)).astype(np.int32)
               for k in ("explore", "photo", "antiphoto")}
    else:
        acts = rng.uniform(-1.5, 1.5, (E_, N_, 2)).astype(np.float32)
        dur = None
    r = np.sqrt(rng.uniform(0, 1, (E_, N_))) * 0.9
    th = rng.uniform(0, 2 * np.pi, (E_, N_))
    spos = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    syaw = rng.uniform(-3.1, 3.1, (E_, N_)).astype(np.float32)
    return acts, dur, spos, syaw


def _lane_acts(mod, acts, E_):
    """Env actions in lanes form, for the JAX (mod=jlanes) or the port."""
    if acts.ndim == 2:
        return mod.to_lanes(acts, E_)
    return mod.to_lanes(acts[..., 0], E_), mod.to_lanes(acts[..., 1], E_)


@pytest.mark.parametrize("want_obs", [True, False], ids=["obs", "no_obs"])
@pytest.mark.parametrize("variant", ["daisy", "lily", "dandelion"])
def test_plain_k4_matches_jax_fused_env_step(variant, want_obs):
    jenv, env = _envs(variant, episode_length_s=EPISODE_S)
    cfg = env.cfg
    k = fused_step.constants(cfg)
    jstep = jax.jit(lambda l, a, d, sp: jlanes.step_lanes(
        jenv, l, a, want_obs=want_obs, injected_durations=d, injected_spawn=sp))
    rng = np.random.default_rng(3)
    state, _ = jenv.reset(jax.random.PRNGKey(2))
    # crowd the robots so that sensors and push-outs fire
    state = state.replace(pos=state.pos * 0.6)
    jl = jlanes.state_to_lanes(jenv, state)
    jl["sc"] = jnp.asarray(np.array([[0, 2, 4] + [0] * 125], np.int32))

    rule = TieRule()
    dones = 0
    for t in range(STEPS):
        acts, dur, spos, syaw = _draws(rng, cfg, E, N)
        pl = _port_lanes(jl)
        tdur = None if dur is None else {n: _t(v) for n, v in dur.items()}
        tspawn = (_t(spos), _t(syaw))
        new, reward, done, obs = lanes.step_lanes(
            env, pl, _lane_acts(lanes, _t(acts), E), want_obs=want_obs,
            injected_durations=tdur, injected_spawn=tspawn)
        jnew, jreward, jdone, jobs = jstep(
            jl, _lane_acts(jlanes, jnp.asarray(acts), E),
            None if dur is None else {n: jnp.asarray(v) for n, v in dur.items()},
            (jnp.asarray(spos), jnp.asarray(syaw)))
        # decision inputs: the sensors of the step's input poses, and the
        # positions before any reset (the same step far from the time limit)
        sb = fused_step.sensor_block(pl["px"], pl["py"], torch.cos(pl["yaw"]),
                                     torch.sin(pl["yaw"]), k, N)
        prox = torch.stack(sb["prox_vals"], -1)[:, :E].transpose(0, 1).numpy()
        robot_tie = prox_ties(prox, k.cos_a, k.sin_a, cfg.prox_threshold, band=True)
        robot_tie = np.pad(robot_tie.T, ((0, 0), (0, 128 - E)))      # (N, Ep)
        pre = lanes.step_lanes(env, dict(pl, sc=torch.zeros_like(pl["sc"])),
                               _lane_acts(lanes, _t(acts), E), want_obs=False,
                               injected_durations=tdur, injected_spawn=tspawn)[0]
        pre_pos = torch.stack([lanes.from_lanes(pre["px"], E),
                               lanes.from_lanes(pre["py"], E)], -1).numpy()
        arena_tie = np.pad(colour_ties(pre_pos, cfg), (0, 128 - E))[None, :]

        off = np.zeros((N, 128), bool)
        for name in fused_step.MACHINE_TILES if cfg.discrete_actions else ():
            off |= rule.equal(new[name], jnew[name], robot_tie, f"{name} step {t}")
        for name in ("sc", "er", "cg"):
            off |= rule.equal(new[name], jnew[name], arena_tie, f"{name} step {t}")
        off |= rule.equal(new["prev"], jnew["prev"], arena_tie, f"prev step {t}")
        bad = rule.equal(reward, jreward, arena_tie[0, :E], f"reward step {t}")
        off |= np.pad(bad, (0, 128 - E))[None, :]
        rule.equal(done, jdone, np.zeros(E, bool), f"done step {t}")
        keep = ~off.any(0)
        for name in ("px", "py", "yaw"):
            np.testing.assert_allclose(new[name].numpy()[:, keep],
                                       np.asarray(jnew[name])[:, keep], rtol=0,
                                       atol=2e-6, err_msg=f"{name} step {t}")
        assert len(obs) == len(jobs) == (0 if not want_obs else
                                         4 if variant != "lily" else 1)
        for j, (g, w) in enumerate(zip(obs, jobs)):
            rows_per = g.shape[0] // N
            kk = np.tile(keep, (g.shape[0], 1))
            atol = 2e-5 if (rows_per == 4) else 2e-6
            np.testing.assert_allclose(g.numpy()[kk], np.asarray(w)[kk], rtol=0,
                                       atol=atol, err_msg=f"obs tile {j} step {t}")
        dones += int(done.sum())
        jl = jnew

    rule.report(f"plain K4 {variant} want_obs={want_obs}")
    assert rule.exempt <= 2, "too many tie exemptions"
    assert dones >= E, "the folded reset never fired — weak test"


@pytest.mark.parametrize("variant", ["daisy", "lily", "dandelion"])
def test_plain_k4_free_run_matches_jax_composed_step(variant):
    """20 steps of the plain K4 against the JAX package's composed step,
    both running free from one reset (tests/test_fused_step.py:27-101)."""
    E_, N_ = 3, 6
    jenv, env = _envs(variant, num_envs=E_, num_agents=N_)
    state, _ = jenv.reset(jax.random.PRNGKey(0))
    jstep = jax.jit(lambda s, a, d, sp: jenv.step(s, a, injected_durations=d,
                                                  injected_spawn=sp))
    pl = _port_lanes(jlanes.state_to_lanes(jenv, state))
    rng = np.random.default_rng(1)
    for t in range(20):
        acts, dur, spos, syaw = _draws(rng, env.cfg, E_, N_)
        state, ts = jstep(state, jnp.asarray(acts),
                          None if dur is None else {n: jnp.asarray(v) for n, v in dur.items()},
                          (jnp.asarray(spos), jnp.asarray(syaw)))
        pl, reward, done, obs = lanes.step_lanes(
            env, pl, _lane_acts(lanes, _t(acts), E_),
            injected_durations=None if dur is None else {n: _t(v) for n, v in dur.items()},
            injected_spawn=(_t(spos), _t(syaw)))
        got = lanes.lanes_to_state(env, pl)
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(state.pos), rtol=0,
                                   atol=5e-5, err_msg=f"pos step {t}")
        np.testing.assert_allclose(got.yaw.numpy(), np.asarray(state.yaw), rtol=0,
                                   atol=5e-5, err_msg=f"yaw step {t}")
        np.testing.assert_array_equal(reward.numpy(), np.asarray(ts.reward))
        np.testing.assert_array_equal(done.numpy(), np.asarray(ts.done))
        np.testing.assert_array_equal(got.step_count.numpy(), np.asarray(state.step_count))
        for f in ("explore_state", "explore_steps", "explore_dir", "photo_avoiding",
                  "photo_steps", "photo_dir", "antiphoto_avoiding",
                  "antiphoto_steps", "antiphoto_dir"):
            np.testing.assert_array_equal(getattr(got.behavior, f).numpy(),
                                          np.asarray(getattr(state.behavior, f)),
                                          err_msg=f"{f} step {t}")
        np.testing.assert_allclose(lanes.obs_from_tiles(env, obs, pl["prev"]).numpy(),
                                   np.asarray(ts.obs), rtol=0, atol=5e-5,
                                   err_msg=f"obs step {t}")


@pytest.mark.parametrize("variant", ["daisy", "dandelion"])
def test_lanes_round_trip_and_tiles_match_jax(variant):
    jenv, env = _envs(variant, num_envs=5)
    state, _ = jenv.reset(jax.random.PRNGKey(4))
    rng = np.random.default_rng(0)
    behavior = {f: jnp.asarray(rng.integers(0, 3, (5, N)).astype(np.asarray(v).dtype))
                for f, v in vars(state.behavior).items()}
    state = state.replace(behavior=state.behavior.replace(**behavior),
                          step_count=jnp.arange(5, dtype=jnp.int32))
    jl = jlanes.state_to_lanes(jenv, state)
    port_state = lanes.lanes_to_state(env, _port_lanes(jl))
    tl = lanes.state_to_lanes(env, port_state)
    assert set(tl) - {"generator"} == set(jl) - {"key"}
    for name, v in jl.items():
        if name != "key":
            assert tl[name].dtype == _t(v).dtype, name
            np.testing.assert_array_equal(tl[name].numpy(), np.asarray(v), err_msg=name)
            assert tl[name].shape == (v.shape[0], 128)
    back = lanes.lanes_to_state(env, tl)
    np.testing.assert_array_equal(back.pos.numpy(), np.asarray(state.pos))
    assert back.behavior.photo_avoiding.dtype == torch.bool
    if env.cfg.discrete_actions:
        np.testing.assert_array_equal(back.behavior.photo_avoiding.numpy(),
                                      np.asarray(state.behavior.photo_avoiding))
    else:        # dandelion carries no machines in lanes form
        assert not back.behavior.photo_avoiding.any()


@pytest.mark.parametrize("variant", ["daisy", "lily"])
def test_obs_from_tiles_matches_jax(variant):
    jenv, env = _envs(variant, num_envs=5)
    rng = np.random.default_rng(6)
    rows = (8, 8, 1, 4) if variant == "daisy" else (1,)
    tiles = [rng.normal(size=(r * N, 128)).astype(np.float32) for r in rows]
    prev = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (N, 128))
    got = lanes.obs_from_tiles(env, [_t(x) for x in tiles], _t(prev))
    want = jlanes.obs_from_tiles(jenv, [jnp.asarray(x) for x in tiles], jnp.asarray(prev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pad_arenas_stay_finite_and_apart():
    """Zero-filled pad arenas give finite tiles, and what a pad holds never
    reaches a real arena."""
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="daisy", num_envs=3),
                             device="cpu")
    g = torch.Generator().manual_seed(0)
    st, _ = env.reset(g)
    pl = lanes.state_to_lanes(env, st)
    acts = lanes.actions_to_lanes(env, torch.randint(0, 6, (3, N), generator=g))
    g.manual_seed(5)
    a = lanes.step_lanes(env, dict(pl), acts)
    noisy = {n: (v.clone() if torch.is_tensor(v) else v) for n, v in pl.items()}
    noisy["px"][:, 3:] = 7.0
    noisy["yaw"][:, 3:] = 1.0
    g.manual_seed(5)
    b = lanes.step_lanes(env, noisy, acts)
    for name, v in a[0].items():
        if torch.is_tensor(v):
            assert bool(torch.isfinite(v.float()).all()), name
            assert torch.equal(v[:, :3], b[0][name][:, :3]), name
    for x, y in zip(a[3], b[3]):
        assert bool(torch.isfinite(x).all())
        assert torch.equal(lanes.from_lanes(x, 3), lanes.from_lanes(y, 3))


def test_cpu_fused_env_step_launches_nothing():
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="lily", num_envs=2),
                             device="cpu")
    st, _ = env.reset(torch.Generator().manual_seed(0))
    ops.reset_launches()
    lanes.step_lanes(env, lanes.state_to_lanes(env, st),
                     lanes.actions_to_lanes(env, torch.zeros((2, N), dtype=torch.int32)))
    assert not any(ops.launches.values())
