"""The PyTorch port's env against the JAX package, on the CPU.

Same inputs (numpy, from a seed) through each JAX function and its port.
Float tolerance 2e-5 absolute (as tests/test_ops.py): both sides compute in
float32 with the same formulas, and differ only by libm ulps and reduction
order. The port's kernels are reached here through their plain versions
(a CPU tensor selects them); the plain versions are held against the
Pallas kernels in interpret mode. Integer and boolean env state, rewards
and done flags must match exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxCfg
from swarmacb_tpu.env import physics as jphysics
from swarmacb_tpu.env import sensors as jsensors
from swarmacb_tpu.env.behaviors import BehaviorState as JaxBehaviorState
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv
from swarmacb_tpu.env.state import EnvState as JaxEnvState
from swarmacb_tpu.ops import pairwise as jpairwise

from swarmacb_torch import ops
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import DirectionalGateEnv, EnvState, physics, sensors
from swarmacb_torch.env.state import BehaviorState

ATOL = 2e-5
CFG = DirectionalGateEnvCfg(num_envs=4)
JCFG = JaxCfg(num_envs=4)
ENV = DirectionalGateEnv(CFG, device="cpu")
JENV = JaxEnv(JCFG)


def _poses(E=5, N=20, seed=0, radius=1.1):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0, 1, (E, N))) * radius
    th = rng.uniform(0, 2 * np.pi, (E, N))
    pos = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (E, N)).astype(np.float32)
    return pos, yaw


def _close(got, want, atol=ATOL, exact=False):
    got = np.asarray(got.detach().cpu().numpy() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


T = torch.from_numpy
J = jnp.asarray


# ── physics ───────────────────────────────────────────────────────────

def _gate_positions(seed, E=5, N=20):
    """Robots scattered around the gate's side walls."""
    rng = np.random.default_rng(seed + 100)
    c = CFG
    return np.stack([rng.uniform(-0.4, 0.4, (E, N)),
                     rng.uniform(c.gate_south_y - 0.05,
                                 c.gate_south_y + c.side_wall_length + 0.05,
                                 (E, N))], -1).astype(np.float32)


def _physics_case(name, seed):
    rng = np.random.default_rng(seed)
    pos, yaw = _poses(seed=seed, radius=1.3)
    left = rng.uniform(-0.12, 0.12, yaw.shape).astype(np.float32)
    right = rng.uniform(-0.12, 0.12, yaw.shape).astype(np.float32)
    c = CFG
    if name == "differential_drive":
        return (physics.differential_drive(T(left), T(right), T(yaw), c.wheelbase, c.dt),
                jphysics.differential_drive(J(left), J(right), J(yaw), c.wheelbase, c.dt))
    if name == "integrate_and_wrap":
        return (physics.integrate_and_wrap(T(pos), T(yaw), T(left), T(right), c.wheelbase, c.dt),
                jphysics.integrate_and_wrap(J(pos), J(yaw), J(left), J(right), c.wheelbase, c.dt))
    if name == "resolve_wall_collisions":
        return (physics.resolve_wall_collisions(T(pos), ENV.face_normals, ENV.face_points,
                                                c.robot_radius),
                jphysics.resolve_wall_collisions(J(pos), JENV.face_normals, JENV.face_points,
                                                 c.robot_radius))
    if name == "resolve_gate_wall_collisions":
        gpos = _gate_positions(seed)
        args = (c.robot_radius, c.corridor_width / 2.0, c.gate_south_y, c.side_wall_length)
        return (physics.resolve_gate_wall_collisions(T(gpos), *args),
                jphysics.resolve_gate_wall_collisions(J(gpos), *args))
    if name == "resolve_robot_collisions":
        cpos = rng.uniform(-0.2, 0.2, pos.shape).astype(np.float32)
        return (physics.resolve_robot_collisions(T(cpos), c.robot_radius),
                jphysics.resolve_robot_collisions(J(cpos), c.robot_radius))
    raise KeyError(name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["differential_drive", "integrate_and_wrap",
                                  "resolve_wall_collisions",
                                  "resolve_gate_wall_collisions",
                                  "resolve_robot_collisions"])
def test_physics_matches_jax(name, seed):
    got, want = _physics_case(name, seed)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_gate_clamp_moves_robots():
    """The gate-wall case above must actually clamp someone (strong test)."""
    got, _ = _physics_case("resolve_gate_wall_collisions", 0)
    assert (np.abs(got.numpy() - _gate_positions(0)) > 1e-6).any()


# ── sensors ───────────────────────────────────────────────────────────

def _sensor_case(name, seed):
    pos, yaw = _poses(seed=seed)
    c = CFG
    tdx, tdy = sensors.sensor_world_dirs(T(yaw))
    jdx, jdy = jsensors.sensor_world_dirs(J(yaw))
    if name == "sensor_world_dirs":
        return (tdx, tdy), (jdx, jdy)
    if name == "raycast_segments":
        return (sensors.raycast_segments(T(pos), tdx, tdy, ENV.wall_segments, c.prox_range),
                jsensors.raycast_segments(J(pos), jdx, jdy, JENV.wall_segments, c.prox_range))
    if name == "detect_robots_proximity":
        return (sensors.detect_robots_proximity(T(pos), tdx, tdy, c.prox_range, c.robot_radius),
                jsensors.detect_robots_proximity(J(pos), jdx, jdy, c.prox_range, c.robot_radius))
    if name == "compute_proximity":
        return (sensors.compute_proximity(T(pos), T(yaw), ENV.wall_segments, c.prox_range,
                                          c.robot_radius),
                jsensors.compute_proximity(J(pos), J(yaw), JENV.wall_segments, c.prox_range,
                                           c.robot_radius))
    if name == "compute_light":
        return (sensors.compute_light(T(pos), T(yaw), ENV.light_pos, c.light_threshold),
                jsensors.compute_light(J(pos), J(yaw), JENV.light_pos, c.light_threshold))
    if name == "compute_rab":
        return (sensors.compute_rab(T(pos), T(yaw), c.rab_range, c.alpha_parameter),
                jsensors.compute_rab(J(pos), J(yaw), c.rab_range, c.alpha_parameter))
    if name == "ground_obs":
        return (sensors.ground_obs(T(pos), c), jsensors.ground_obs(J(pos), JCFG))
    if name == "critic_state_5d":
        return (sensors.critic_state_5d(T(pos), T(yaw), ENV.arena_center,
                                        c.arena_circumradius, ENV.light_dir),
                jsensors.critic_state_5d(J(pos), J(yaw), JENV.arena_center,
                                         c.arena_circumradius, JENV.light_dir))
    raise KeyError(name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["sensor_world_dirs", "raycast_segments",
                                  "detect_robots_proximity", "compute_proximity",
                                  "compute_light", "compute_rab", "ground_obs",
                                  "critic_state_5d"])
def test_sensors_match_jax(name, seed):
    got, want = _sensor_case(name, seed)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_ground_color_exact_on_zone_grid():
    """Zone boundaries (strict/inclusive bounds) decide reward: exact match
    on a grid that straddles the gate and corridor edges."""
    c = CFG
    xs = np.linspace(-0.3, 0.3, 41, dtype=np.float32)
    ys = np.linspace(c.gate_south_y - 0.05, c.north_inradius + 0.02, 97,
                     dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    pos = np.stack([gx, gy], -1).astype(np.float32)
    got = sensors.ground_color(T(pos), c)
    want = jsensors.ground_color(J(pos), JCFG)
    _close(got, want, exact=True)
    assert set(np.unique(got.numpy())) == {0.0, 0.5, 1.0}


def test_aggregate_and_collect_obs_match_jax():
    rng = np.random.default_rng(3)
    prox = rng.uniform(0, 1, (4, 20, 8)).astype(np.float32)
    for g, w in zip(sensors.aggregate_prox(T(prox)), jsensors.aggregate_prox(J(prox))):
        _close(g, w)
    light = rng.uniform(0, 1, (4, 20, 8)).astype(np.float32)
    ground = rng.uniform(0, 1, (4, 20, 3)).astype(np.float32)
    zt = rng.uniform(0, 1, (4, 20)).astype(np.float32)
    proj = rng.normal(size=(4, 20, 4)).astype(np.float32)
    _close(sensors.collect_obs_dandelion(T(prox), T(light), T(ground), T(zt), T(proj)),
           jsensors.collect_obs_dandelion(J(prox), J(light), J(ground), J(zt), J(proj)),
           exact=True)
    _close(sensors.collect_obs_lily(T(ground), T(zt)),
           jsensors.collect_obs_lily(J(ground), J(zt)), exact=True)


# ── plain versions of the kernels against the Pallas kernels ─────────

@pytest.mark.parametrize("E,N,seed,radius", [(3, 20, 0, 1.1), (5, 7, 1, 0.4),
                                              (2, 32, 2, 0.5)])
def test_plain_pairwise_sensors_matches_pallas(E, N, seed, radius):
    pos, yaw = _poses(E=E, N=N, seed=seed, radius=radius)
    c = CFG
    got = ops.pairwise_sensors(
        T(pos), T(yaw), prox_range=c.prox_range, robot_radius=c.robot_radius,
        rab_range=c.rab_range, alpha_rab=c.alpha_parameter,
        wall_segments=ENV.wall_segments)
    want = jax.jit(functools.partial(
        jpairwise.pairwise_sensors, prox_range=c.prox_range,
        robot_radius=c.robot_radius, rab_range=c.rab_range,
        alpha_rab=c.alpha_parameter, wall_segments=JENV.wall_segments,
        interpret=True))(J(pos), J(yaw))
    assert float(got[0].max()) > 0, "poses never see a wall or robot — weak test"
    # prox and ztilde as tests/test_ops.py holds them; rab_proj and the
    # attraction vector carry the kernel's rsqrt bearing (vs atan2 here)
    for g, w, tol in zip(got, want, (2e-6, 2e-6, 5e-5, 5e-5, 5e-5)):
        _close(g, w, atol=tol)


@pytest.mark.parametrize("E,N,seed", [(5, 20, 2), (3, 32, 4), (4, 7, 5)])
def test_plain_robot_collisions_matches_pallas(E, N, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.2, 0.2, (E, N, 2)).astype(np.float32)
    got = ops.resolve_robot_collisions(T(pos), CFG.robot_radius)
    want = jpairwise.resolve_robot_collisions(J(pos), CFG.robot_radius,
                                              interpret=True)
    assert np.abs(got.numpy() - pos).max() > 1e-4, "no overlaps — weak test"
    _close(got, want, atol=2e-6)


def test_angle_tables_are_made_once_per_device():
    """The sensor angle tables are the float32 roundings of the angles'
    cosines and sines, within one ulp of the JAX package's tables, and every
    later call returns the same tensors, so no env step copies them to the
    device again."""
    from swarmacb_torch.env.geometry import EPUCK_SENSOR_ANGLES, RAB_PROJ_ANGLES
    from swarmacb_tpu.env import sensors as jsens

    dev = torch.device("cpu")
    first = sensors.angle_tables(dev)
    rounded = [f(a.astype(np.float64)).astype(np.float32)
               for a in (EPUCK_SENSOR_ANGLES, RAB_PROJ_ANGLES) for f in (np.cos, np.sin)]
    jax_tables = (jsens._COS_A, jsens._SIN_A, jsens._RAB_COS, jsens._RAB_SIN)
    for got, want, jt in zip(first, rounded, jax_tables):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        ulps = np.abs(got.numpy().view(np.int32) - np.asarray(jt).view(np.int32))
        assert ulps.max() <= 1
    again = sensors.angle_tables(dev)
    assert all(a is b for a, b in zip(first, again))


def test_sensor_constants_are_built_once_per_segments():
    """The sensor kernel's packed constants are built at a segments tensor's
    first call and returned unchanged after: cos/sin of the sensor and RAB
    angles, then (ax, ay, bx − ax, by − ay) per segment. Changing the
    segments in place rebuilds them."""
    from swarmacb_torch.ops import pairwise

    seg = ENV.wall_segments.clone()
    consts = pairwise.cached_sensor_constants(seg)
    assert pairwise.cached_sensor_constants(seg) is consts
    assert consts.shape == (24 + 4 * seg.shape[0],)
    assert torch.equal(consts[:24], torch.cat(sensors.angle_tables(seg.device)))
    packed = consts[24:].reshape(-1, 4)
    assert torch.equal(packed[:, :2], seg[:, :2])
    assert torch.equal(packed[:, 2:], seg[:, 2:] - seg[:, :2])
    seg[0, 2] += 1.0
    moved = pairwise.cached_sensor_constants(seg)
    assert moved is not consts
    assert torch.equal(moved, pairwise.sensor_constants(seg))
    key = id(seg)
    del seg
    assert key not in pairwise._CONSTS


def test_cpu_wrappers_launch_nothing():
    """A CPU tensor selects the plain version: no kernel launch is counted."""
    ops.reset_launches()
    pos, yaw = _poses(E=2)
    ops.pairwise_sensors(T(pos), T(yaw), prox_range=0.1, robot_radius=0.035,
                         rab_range=0.2, alpha_rab=5.0,
                         wall_segments=ENV.wall_segments)
    ops.resolve_robot_collisions(T(pos), 0.035)
    assert all(v == 0 for v in ops.launches.values())


# ── the composed env ──────────────────────────────────────────────────

def _jax_state(pos, yaw, prev_ground, step_count, ep_rew, completed):
    E, N = yaw.shape
    return JaxEnvState(pos=J(pos), yaw=J(yaw), prev_ground=J(prev_ground),
                       step_count=J(step_count), episode_reward=J(ep_rew),
                       completed_group_reward=J(completed),
                       behavior=JaxBehaviorState.init(E, N),
                       key=jax.random.PRNGKey(0))


def _torch_state(pos, yaw, prev_ground, step_count, ep_rew, completed):
    E, N = yaw.shape
    return EnvState(pos=T(pos), yaw=T(yaw), prev_ground=T(prev_ground),
                    step_count=T(step_count), episode_reward=T(ep_rew),
                    completed_group_reward=T(completed),
                    behavior=BehaviorState.init(E, N, "cpu"),
                    generator=torch.Generator())


@pytest.mark.parametrize("seed", [0, 1])
def test_env_step_with_folded_reset_matches_jax(seed):
    """One step from an identical state; two of the four arenas sit one tick
    before the time limit, so the folded auto-reset fires there."""
    rng = np.random.default_rng(seed)
    E, N = CFG.num_envs, CFG.num_agents
    pos, yaw = _poses(E=E, N=N, seed=seed + 10, radius=1.2)
    # random previous colours so that colour transitions (rewards) happen
    prev_ground = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (E, N))
    L = CFG.max_episode_length
    step_count = np.array([L - 2, 5, L - 2, L - 3], np.int32)
    ep_rew = rng.integers(-3, 4, E).astype(np.float32)
    completed = rng.integers(-3, 4, E).astype(np.float32)
    actions = rng.uniform(-1.5, 1.5, (E, N, 2)).astype(np.float32)
    spawn_pos, spawn_yaw = _poses(E=E, N=N, seed=seed + 20, radius=1.0)

    ts_state, ts = ENV.step(_torch_state(pos, yaw, prev_ground, step_count, ep_rew,
                                         completed),
                            T(actions), injected_spawn=(T(spawn_pos), T(spawn_yaw)))
    js_state, js = jax.jit(JENV.step)(_jax_state(pos, yaw, prev_ground, step_count, ep_rew,
                                        completed),
                             J(actions), injected_spawn=(J(spawn_pos), J(spawn_yaw)))

    _close(ts.done, js.done, exact=True)
    assert ts.done.tolist() == [True, False, True, False]
    _close(ts.reward, js.reward, exact=True)
    assert float(ts.reward.abs().sum()) > 0, "no colour transition — weak test"
    for name in ("step_count", "episode_reward", "completed_group_reward",
                 "prev_ground"):
        _close(getattr(ts_state, name), getattr(js_state, name), exact=True)
    _close(ts_state.pos, js_state.pos, atol=1e-5)
    _close(ts_state.yaw, js_state.yaw, atol=1e-5)
    _close(ts.obs, js.obs, atol=5e-5)
    # the reset arenas took the injected spawn
    np.testing.assert_array_equal(ts_state.pos[0].numpy(), spawn_pos[0])
    for f in ("explore_state", "photo_avoiding", "antiphoto_dir"):
        _close(getattr(ts_state.behavior, f), getattr(js_state.behavior, f),
               exact=True)


def test_reset_observations_match_jax():
    """Observations and critic state of a given state, both packages."""
    pos, yaw = _poses(E=4, seed=7)
    st = ENV.make_state(pos, yaw, torch.Generator())
    jst = _jax_state(pos, yaw, np.asarray(jsensors.ground_color(J(pos), JCFG)),
                     np.zeros(4, np.int32), np.zeros(4, np.float32),
                     np.zeros(4, np.float32))
    _close(st.prev_ground, jst.prev_ground, exact=True)
    _close(ENV._observations(st), jax.jit(JENV._observations)(jst), atol=5e-5)
    _close(ENV.critic_state(st), jax.jit(JENV.critic_state)(jst))


def test_reset_draws_from_generator():
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(3)
    g2.manual_seed(3)
    s1, o1 = ENV.reset(g1)
    s2, o2 = ENV.reset(g2)
    assert torch.equal(s1.pos, s2.pos) and torch.equal(o1, o2)
    r = torch.linalg.vector_norm(s1.pos, dim=-1)
    assert float(r.max()) <= CFG.inradius - 2 * CFG.robot_radius + 1e-6
    assert o1.shape == (CFG.num_envs, CFG.num_agents, 24)
