"""The port's composed discrete env step against the JAX package, on the CPU.

daisy (24-dim observations) and lily (4-dim), E = 4 arenas of N = 20
robots, with injected turn durations and spawns and a 0.8 s episode (8
steps), so that the folded auto-reset fires inside the window. The
comparison is teacher-forced: the JAX env runs free, and every step starts
both sides from the JAX state, so one flipped tie cannot cascade into a
different trajectory.

Integer and boolean results (the nine machine tiles, reward, episode
reward, completed group reward, done, step count, previous ground colour)
must match exactly under the tie rule of ``torch_parity``; the number of
exemptions is printed and must stay small. Arenas with an exemption in a
step skip that step's float comparisons. Positions and yaw to 1e-5,
observations to 1e-4, as ``tests/test_torch_env.py`` and
``tests/test_torch_rollout.py`` hold the dandelion step.
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
from torch_parity import TieRule, colour_ties, prox_ties

from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import DirectionalGateEnv
from swarmacb_torch.env.geometry import EPUCK_SENSOR_ANGLES
from swarmacb_torch.env.state import BehaviorState, EnvState

E, N, STEPS = 4, 20, 12
EPISODE_S = 0.8
FIELDS = ("explore_state", "explore_steps", "explore_dir", "photo_avoiding",
          "photo_steps", "photo_dir", "antiphoto_avoiding", "antiphoto_steps",
          "antiphoto_dir")
COS_A, SIN_A = np.cos(EPUCK_SENSOR_ANGLES), np.sin(EPUCK_SENSOR_ANGLES)


def _poses(rng, radius):
    r = np.sqrt(rng.uniform(0, 1, (E, N))) * radius
    th = rng.uniform(0, 2 * np.pi, (E, N))
    pos = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    return pos, rng.uniform(-np.pi, np.pi, (E, N)).astype(np.float32)


def _port_state(js, step_count=None):
    """The port's EnvState holding the JAX state's values."""
    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    sc = js.step_count if step_count is None else step_count
    return EnvState(
        pos=T(js.pos), yaw=T(js.yaw), prev_ground=T(js.prev_ground),
        step_count=T(sc), episode_reward=T(js.episode_reward),
        completed_group_reward=T(js.completed_group_reward),
        behavior=BehaviorState(**{f: T(getattr(js.behavior, f)) for f in FIELDS}),
        generator=torch.Generator())


def _inputs(rng):
    mod = rng.integers(0, 6, (E, N)).astype(np.int32)
    dur = {k: rng.integers(1, 5, (E, N)).astype(np.int32)
           for k in ("explore", "photo", "antiphoto")}
    spos, syaw = _poses(rng, 1.0)
    return mod, dur, spos, syaw


@pytest.mark.parametrize("variant", ["daisy", "lily"])
def test_composed_discrete_step_matches_jax_teacher_forced(variant):
    kw = dict(variant=variant, num_envs=E, episode_length_s=EPISODE_S)
    jcfg, cfg = JaxCfg(**kw), DirectionalGateEnvCfg(**kw)
    jenv, env = JaxEnv(jcfg), DirectionalGateEnv(cfg, device="cpu")
    jstep = jax.jit(lambda s, a, d, sp: jenv.step(s, a, injected_durations=d,
                                                  injected_spawn=sp))
    jprox = jax.jit(lambda p, y: jenv._compute_sensor_block(p, y)["prox_vals"])

    rng = np.random.default_rng(0 if variant == "daisy" else 1)
    pos, yaw = _poses(rng, 1.15)
    js = JaxEnvState(
        pos=jnp.asarray(pos), yaw=jnp.asarray(yaw),
        prev_ground=jsensors.ground_color(jnp.asarray(pos), jcfg),
        step_count=jnp.asarray(np.array([0, 2, 4, 6], np.int32)),
        episode_reward=jnp.zeros(E), completed_group_reward=jnp.zeros(E),
        behavior=JaxBehaviorState.init(E, N), key=jax.random.PRNGKey(0))

    rule = TieRule()
    dones = changed = 0
    for t in range(STEPS):
        mod, dur, spos, syaw = _inputs(rng)
        tdur = {k: torch.from_numpy(v) for k, v in dur.items()}
        tspawn = (torch.from_numpy(spos), torch.from_numpy(syaw))
        state, ts = env.step(_port_state(js), torch.from_numpy(mod),
                             injected_durations=tdur, injected_spawn=tspawn)
        jn, jts = jstep(js, jnp.asarray(mod), {k: jnp.asarray(v) for k, v in dur.items()},
                        (jnp.asarray(spos), jnp.asarray(syaw)))
        # the post-collision positions before any reset: the same step from
        # a state whose counters are far from the time limit
        pre = env.step(_port_state(js, np.zeros(E, np.int32)), torch.from_numpy(mod),
                       injected_durations=tdur, injected_spawn=tspawn)[0].pos
        robot_tie = prox_ties(np.asarray(jprox(js.pos, js.yaw)), COS_A, SIN_A,
                              cfg.prox_threshold)
        arena_tie = colour_ties(pre.numpy(), cfg)

        off = np.zeros((E, N), bool)
        for f in FIELDS:
            off |= rule.equal(getattr(state.behavior, f), getattr(jn.behavior, f),
                              robot_tie, f"{f} step {t}")
        for name in ("reward", "done"):
            off_a = rule.equal(getattr(ts, name), getattr(jts, name), arena_tie,
                               f"{name} step {t}")
            off |= off_a[:, None]
        for name in ("episode_reward", "completed_group_reward", "step_count"):
            off |= rule.equal(getattr(state, name), getattr(jn, name), arena_tie,
                              f"{name} step {t}")[:, None]
        off |= rule.equal(state.prev_ground, jn.prev_ground, arena_tie,
                          f"prev_ground step {t}")
        keep = ~off.any(-1)
        for name, got, want, atol in (("pos", state.pos, jn.pos, 1e-5),
                                      ("yaw", state.yaw, jn.yaw, 1e-5),
                                      ("obs", ts.obs, jts.obs, 1e-4)):
            np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                                       rtol=0, atol=atol, err_msg=f"{name} step {t}")
        dones += int(np.asarray(jts.done).sum())
        changed += int((np.asarray(jn.behavior.explore_state)
                        != np.asarray(js.behavior.explore_state)).sum())
        js = jn

    rule.report(f"composed {variant} step")
    assert rule.exempt <= 4, "too many tie exemptions"
    assert dones >= E, "the folded auto-reset never fired — weak test"
    assert changed > 0, "no exploration machine changed state — weak test"
    obs_dim = 24 if variant == "daisy" else 4
    assert ts.obs.shape == (E, N, obs_dim)


def test_discrete_observations_reuse_the_pre_step_sensors():
    """The stale-sensor contract: a discrete step's observations are the
    sensors of the PRE-step poses, even across a reset; only the ground
    channel is read from the new poses."""
    cfg = DirectionalGateEnvCfg(variant="daisy", num_envs=E, episode_length_s=EPISODE_S)
    env = DirectionalGateEnv(cfg, device="cpu")
    rng = np.random.default_rng(4)
    pos, yaw = _poses(rng, 1.1)
    state = env.make_state(pos, yaw, torch.Generator(),
                           step_count=np.full(E, cfg.max_episode_length - 2, np.int32))
    before = env._observations(state)
    mod, dur, spos, syaw = _inputs(rng)
    new, ts = env.step(state, torch.from_numpy(mod),
                       injected_durations={k: torch.from_numpy(v) for k, v in dur.items()},
                       injected_spawn=(torch.from_numpy(spos), torch.from_numpy(syaw)))
    assert bool(ts.done.all())
    assert torch.equal(new.pos, torch.from_numpy(spos))
    sensor_ch = [*range(16), *range(19, 24)]
    assert torch.equal(ts.obs[..., sensor_ch], before[..., sensor_ch])
    fresh = env._observations(new)
    assert torch.equal(ts.obs[..., 16:19], fresh[..., 16:19])
    assert not torch.equal(ts.obs, fresh)
