"""``scripts/manual_control_torch.py`` against the JAX package, on the CPU.

The JAX script's mixed step is a closure inside its ``main``
(scripts/manual_control.py:75-111) and cannot be imported, so the reference
here rebuilds it from the same JAX library calls composed the same way:
``env._compute_sensor_block``, ``behaviors.dispatch`` (with
``injected_durations``, swarmacb_tpu/env/behaviors.py:218), robot 0's
wheels set, then a ``lax.scan`` over the physics sub-steps
(``integrate_and_wrap``, wall and gate push-out, ``resolve_robot_collisions``,
``ground_color`` and the K⁺/K⁻ counts). The scan also returns each
sub-step's positions, for the tie rule below.

Each case runs 30 frames of one module id (0–5) for the other robots at 1
and 6 sub-steps (``--sim-hz 0`` and ``60``), N = 20 and 40, from one JAX
reset whose robots 1–6 stand across the corridor's south edge, with
robot 0's wheels and the turn durations drawn from a seed and injected on
both sides. Teacher-forced: every frame starts both sides from the JAX
state, so a flipped tie cannot cascade. Positions and headings to 2e-6 (m,
rad); K⁺, K⁻ and the behaviour machines exactly under the tie rule of
``torch_parity`` (a ground-colour tie at any sub-step's positions, an
obstacle or turn tie on the frame's proximity sums); the HUD's sensor
values to K1's plain-version tolerances (``tests/test_torch_env.py``:
readings and ztilde 2e-6, the RAB terms 5e-5, the aggregates 2e-5).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxCfg
from swarmacb_tpu.env import behaviors as jbehaviors
from swarmacb_tpu.env import physics as jphysics
from swarmacb_tpu.env import sensors as jsensors
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv
from torch_parity import TieRule, colour_ties, prox_ties
from torch_scripts import load_script
from torch_threads import one_torch_thread  # noqa: F401

from swarmacb_torch import ops
from swarmacb_torch.env.geometry import EPUCK_SENSOR_ANGLES
from swarmacb_torch.env.state import BehaviorState

FRAMES = 30
FIELDS = ("explore_state", "explore_steps", "explore_dir", "photo_avoiding",
          "photo_steps", "photo_dir", "antiphoto_avoiding", "antiphoto_steps",
          "antiphoto_dir")
SENSOR_TOL = {"prox_vals": 2e-6, "ztilde": 2e-6, "rab_proj": 5e-5, "rab_x": 5e-5,
              "rab_y": 5e-5, "light_vals": 2e-5, "light_value": 2e-5,
              "prox_value": 2e-5}
COS_A, SIN_A = np.cos(EPUCK_SENSOR_ANGLES), np.sin(EPUCK_SENSOR_ANGLES)


@pytest.fixture(scope="module")
def mc():
    return load_script("manual_control_torch")


@functools.lru_cache(maxsize=None)
def _jax_side(N, substeps):
    """The JAX env and the JAX script's mixed step (manual_control.py:75-111)
    with the durations injected, jitted once per (N, substeps)."""
    cfg = JaxCfg(variant="daisy", num_envs=1, num_agents=N)
    env = JaxEnv(cfg)
    ms = cfg.max_wheel_speed
    dt_sub = cfg.dt / substeps

    def mixed_step(state, wheels0, module_id, durations):
        cache = env._compute_sensor_block(state.pos, state.yaw)
        module_ids = jnp.full((1, N), module_id, dtype=jnp.int32)
        left, right, bstate = jbehaviors.dispatch(
            module_ids, state.behavior,
            cache["prox_value"], cache["prox_angle"],
            cache["light_value"], cache["light_angle"],
            cache["rab_x"], cache["rab_y"],
            None, ms, cfg.alpha_parameter, cfg.prox_threshold,
            injected_durations=durations)
        left = left.at[0, 0].set(wheels0[0])
        right = right.at[0, 0].set(wheels0[1])

        def _substep(carry, _):
            pos, yaw, prev, kp, km = carry
            pos, yaw = jphysics.integrate_and_wrap(pos, yaw, left, right,
                                                   cfg.wheelbase, dt_sub)
            pos = jphysics.resolve_wall_collisions(
                pos, env.face_normals, env.face_points, cfg.robot_radius)
            pos = jphysics.resolve_gate_wall_collisions(
                pos, cfg.robot_radius, cfg.corridor_width / 2.0,
                cfg.gate_south_y, cfg.side_wall_length)
            pos = jphysics.resolve_robot_collisions(pos, cfg.robot_radius)
            curr = jsensors.ground_color(pos, cfg)
            kp += ((prev < 0.25) & (curr > 0.75)).astype(jnp.float32).sum()
            km += ((prev > 0.75) & (curr < 0.25)).astype(jnp.float32).sum()
            return (pos, yaw, curr, kp, km), pos

        carry0 = (state.pos, state.yaw, state.prev_ground,
                  jnp.float32(0.0), jnp.float32(0.0))
        (pos, yaw, prev, kp, km), path = jax.lax.scan(_substep, carry0, None,
                                                      length=substeps)
        state = state.replace(pos=pos, yaw=yaw, prev_ground=prev, behavior=bstate)
        return state, cache, kp, km, path

    return cfg, env, jax.jit(mixed_step)


def _start(cfg, env, seed):
    """A JAX reset with robots 1–6 across the corridor's south edge, facing
    north and south in turn, so that exploring robots change colour."""
    state, _ = env.reset(jax.random.PRNGKey(seed))
    pos, yaw = np.array(state.pos), np.array(state.yaw)
    for k in range(1, 7):
        pos[0, k] = (-0.15 + 0.06 * (k - 1), cfg.corridor_south_y + (-0.02 if k % 2 else 0.02))
        yaw[0, k] = np.pi / 2 if k % 2 else -np.pi / 2
    pos, yaw = jnp.asarray(pos), jnp.asarray(yaw)
    return state.replace(pos=pos, yaw=yaw, prev_ground=jsensors.ground_color(pos, cfg))


def _port_state(mc_env, js):
    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    st = mc_env.make_state(T(js.pos), T(js.yaw), torch.Generator())
    st.prev_ground = T(js.prev_ground)
    st.behavior = BehaviorState(**{f: T(getattr(js.behavior, f)) for f in FIELDS})
    return st


@pytest.mark.parametrize("N", [20, 40])
@pytest.mark.parametrize("substeps", [1, 6], ids=["sim_hz_0", "sim_hz_60"])
@pytest.mark.parametrize("module_id", range(6))
def test_mixed_step_matches_the_jax_composition(mc, module_id, substeps, N):
    jcfg, jenv, jstep = _jax_side(N, substeps)
    env = mc.build(N, "cpu", 0)[0]
    assert mc.substeps_for(10.0, 60.0 if substeps == 6 else 0.0) == substeps
    dt_sub = env.cfg.dt / substeps
    ms = env.cfg.max_wheel_speed
    rng = np.random.default_rng(100 * module_id + 10 * substeps + N)
    js = _start(jcfg, jenv, module_id)
    rule, k_total, launches = TieRule(), 0.0, dict(ops.launches)
    for frame in range(FRAMES):
        wheels = rng.uniform(-ms, ms, 2).astype(np.float32)
        dur = {n: rng.integers(1, 5, (1, N)).astype(np.int32) for n in mc.DURATIONS}
        st = _port_state(env, js)
        got, cache, kp, km = mc.mixed_step(
            env, st, (float(wheels[0]), float(wheels[1])), module_id,
            {n: torch.from_numpy(v) for n, v in dur.items()}, substeps, dt_sub)
        js, jcache, jkp, jkm, path = jstep(js, jnp.asarray(wheels), module_id,
                                           {n: jnp.asarray(v) for n, v in dur.items()})
        what = f"module {module_id}, {substeps} sub-steps, N={N}, frame {frame}"
        np.testing.assert_allclose(got.pos.numpy(), np.array(js.pos), rtol=0, atol=2e-6,
                                   err_msg=what)
        np.testing.assert_allclose(got.yaw.numpy(), np.array(js.yaw), rtol=0, atol=2e-6,
                                   err_msg=what)
        # the colour of any sub-step's positions near a zone edge
        colour_tie = colour_ties(np.array(path)[:, 0], jcfg).any()
        rule.equal(np.array([float(kp), float(km)]), np.array([float(jkp), float(jkm)]),
                   np.array(colour_tie), f"K+ K- {what}")
        rule.equal(got.prev_ground.numpy(), np.array(js.prev_ground),
                   colour_ties(np.array(js.pos), jcfg)[:, None], f"ground {what}")
        ties = prox_ties(np.array(jcache["prox_vals"]), COS_A, SIN_A, jcfg.prox_threshold)
        for f in FIELDS:
            rule.equal(getattr(got.behavior, f).numpy(), np.array(getattr(js.behavior, f)),
                       ties, f"{f} {what}")
        for name, tol in SENSOR_TOL.items():
            np.testing.assert_allclose(cache[name].numpy(), np.array(jcache[name]), rtol=0,
                                       atol=tol, err_msg=f"{name} {what}")
        hud = mc.read_hud(got, cache, kp, km)
        np.testing.assert_array_equal(hud["prox_vals"], cache["prox_vals"][0, 0].numpy())
        np.testing.assert_array_equal(hud["pos"], got.pos[0].numpy())
        assert hud["k_plus"] == float(kp) and hud["ground"] == float(got.prev_ground[0, 0])
        k_total += float(jkp) + float(jkm)
    assert ops.launches == launches, "the CPU run launched a kernel"
    if module_id == 0:
        assert k_total > 0, "no robot changed colour — weak test"
    assert rule.exempt <= 2, f"{rule.exempt} tie exemptions"


def test_script_runs_headless_and_refuses_without_a_card(mc, monkeypatch, capsys):
    monkeypatch.setitem(os.environ, "SDL_VIDEODRIVER", "dummy")
    mc.main(["--device", "cpu", "--smoke-frames", "5", "--num_agents", "40",
             "--sim-hz", "60", "--hz", "1000"])
    out = capsys.readouterr().out
    assert "[manual_control] smoke OK: 5 frames, K+=" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mc.main(["--smoke-frames", "1"])


def test_core_imports_no_pygame(mc):
    """The simulation core loads without pygame (the card's machine may lack
    it); only ``main`` imports it."""
    import ast

    tree = ast.parse(open(mc.__file__, encoding="utf-8").read())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = {a.name for n in top for a in n.names} | {n.module for n in top
                                                      if isinstance(n, ast.ImportFrom)}
    assert not any(str(m).startswith("pygame") for m in names)
    assert all(callable(getattr(mc, f)) for f in ("build", "draw_durations", "mixed_step",
                                                  "read_hud", "substeps_for"))
