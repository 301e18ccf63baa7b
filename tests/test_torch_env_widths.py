"""The env at every robot count the JAX package takes, on the CPU.

On the card ``ops.pairwise_sensors``, ``ops.resolve_robot_collisions`` and
``ops.fused_env_step`` take the route that ``route(N)`` names by N alone:
the tuned kernels up to 32 robots an arena, the wide kernels
(``csrc/pairwise_wide.cu``, ``csrc/fused_step_wide.cu``) past that. Both
routes share the plain versions, which the CPU takes at any N. Here:

- ``route`` at N in {1, 20, 32, 33, 64}, and the wrappers at N = 40 still
  refusing a device that is neither the CPU nor a card;
- the plain K1 and K2 at N = 33 and 40 against the Pallas kernels in
  interpret mode, at ``tests/test_torch_env.py``'s tolerances;
- the plain K4 at E = 2, N = 36 against the JAX ``fused_env_step`` in
  interpret mode through ``step_lanes`` (daisy and dandelion, 3 steps,
  teacher-forced, with the folded reset firing), at
  ``tests/test_torch_fused_step.py``'s tolerances and tie rule, the RAB
  projections (sums over up to 35 neighbours) at ``chip_smoke.py``'s K4
  rule, 2e-5 + 2e-5·|JAX|;
and, in ``tests/test_torch_env_widths_rollout.py``, a rollout at N = 40 on
each env path against the JAX package.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxCfg
from swarmacb_tpu.env import lanes as jlanes
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv
from swarmacb_tpu.ops import pairwise as jpairwise
from torch_parity import TieRule, colour_ties, prox_ties

from swarmacb_torch import ops
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import DirectionalGateEnv, lanes
from swarmacb_torch.ops import fused_step, pairwise

T_, J = torch.from_numpy, jnp.asarray


@pytest.mark.parametrize("N,want", [(1, "tuned"), (20, "tuned"), (32, "tuned"),
                                    (33, "wide"), (64, "wide")])
def test_route_by_robot_count(N, want):
    assert pairwise.route(N) == want
    assert fused_step.route is pairwise.route


def test_wrappers_at_40_robots_refuse_a_device_they_cannot_launch_on():
    pos = torch.zeros((2, 40, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.pairwise_sensors(pos, torch.zeros((2, 40), device="meta"), prox_range=0.1,
                             robot_radius=0.035, rab_range=0.2, alpha_rab=5.0,
                             wall_segments=torch.zeros((14, 4), device="meta"))
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.resolve_robot_collisions(pos, 0.035)
    tile = torch.zeros((40, 128), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.fused_env_step({"px": tile}, (tile, tile), (), (tile, tile, tile),
                           DirectionalGateEnvCfg(num_envs=1, num_agents=40))


def _poses(E, N, seed, radius):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0, 1, (E, N))) * radius
    th = rng.uniform(0, 2 * np.pi, (E, N))
    pos = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    return pos, rng.uniform(-np.pi, np.pi, (E, N)).astype(np.float32)


@pytest.mark.parametrize("N,seed,radius", [(33, 0, 1.1), (40, 1, 0.6)])
def test_plain_pairwise_sensors_matches_pallas_past_32(N, seed, radius):
    cfg = DirectionalGateEnvCfg(num_envs=3, num_agents=N)
    env, jenv = DirectionalGateEnv(cfg, device="cpu"), JaxEnv(JaxCfg(num_envs=3, num_agents=N))
    pos, yaw = _poses(3, N, seed, radius)
    got = ops.pairwise_sensors(
        T_(pos), T_(yaw), prox_range=cfg.prox_range, robot_radius=cfg.robot_radius,
        rab_range=cfg.rab_range, alpha_rab=cfg.alpha_parameter,
        wall_segments=env.wall_segments)
    want = jax.jit(functools.partial(
        jpairwise.pairwise_sensors, prox_range=cfg.prox_range,
        robot_radius=cfg.robot_radius, rab_range=cfg.rab_range,
        alpha_rab=cfg.alpha_parameter, wall_segments=jenv.wall_segments,
        interpret=True))(J(pos), J(yaw))
    assert float(got[0].max()) > 0 and float(got[2].abs().max()) > 0, "weak test"
    for g, w, tol in zip(got, want, (2e-6, 2e-6, 5e-5, 5e-5, 5e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)


@pytest.mark.parametrize("N,seed", [(33, 2), (40, 3)])
def test_plain_robot_collisions_matches_pallas_past_32(N, seed):
    pos = np.random.default_rng(seed).uniform(-0.25, 0.25, (4, N, 2)).astype(np.float32)
    r = DirectionalGateEnvCfg().robot_radius
    got = ops.resolve_robot_collisions(T_(pos), r)
    want = jpairwise.resolve_robot_collisions(J(pos), r, interpret=True)
    assert np.abs(got.numpy() - pos).max() > 1e-4, "no overlaps — weak test"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


@pytest.mark.parametrize("variant", ["daisy", "dandelion"])
def test_plain_k4_matches_jax_fused_env_step_past_32(variant):
    E, N, steps = 2, 36, 3
    kw = dict(variant=variant, num_envs=E, num_agents=N, episode_length_s=0.4)
    jenv, env = JaxEnv(JaxCfg(**kw)), DirectionalGateEnv(DirectionalGateEnvCfg(**kw),
                                                         device="cpu")
    cfg, k = env.cfg, fused_step.constants(env.cfg)
    jstep = jax.jit(lambda l, a, d, sp: jlanes.step_lanes(
        jenv, l, a, injected_durations=d, injected_spawn=sp))
    state, _ = jenv.reset(jax.random.PRNGKey(5))
    jl = jlanes.state_to_lanes(jenv, state.replace(pos=state.pos * 0.7))
    jl["sc"] = J(np.array([[0, 1] + [0] * 126], np.int32))
    rng = np.random.default_rng(6)
    rule, dones = TieRule(), 0
    for t in range(steps):
        if cfg.discrete_actions:
            acts = rng.integers(0, 6, (E, N)).astype(np.int32)
            dur = {n: rng.integers(1, 5, (E, N)).astype(np.int32)
                   for n in ("explore", "photo", "antiphoto")}
        else:
            acts, dur = rng.uniform(-1.5, 1.5, (E, N, 2)).astype(np.float32), None
        spos, syaw = _poses(E, N, 10 + t, 0.9)
        pl = {n: T_(np.array(v)) for n, v in jl.items() if n != "key"}
        pl["generator"] = torch.Generator()
        lane_acts = ((lanes.to_lanes(T_(acts), E),) if acts.ndim == 2 else
                     (lanes.to_lanes(T_(acts[..., 0]), E), lanes.to_lanes(T_(acts[..., 1]), E)))
        jacts = ((jlanes.to_lanes(J(acts), E),) if acts.ndim == 2 else
                 (jlanes.to_lanes(J(acts[..., 0]), E), jlanes.to_lanes(J(acts[..., 1]), E)))
        tdur = None if dur is None else {n: T_(v) for n, v in dur.items()}
        new, reward, done, obs = lanes.step_lanes(
            env, pl, lane_acts[0] if len(lane_acts) == 1 else lane_acts,
            injected_durations=tdur, injected_spawn=(T_(spos), T_(syaw)))
        jnew, jreward, jdone, jobs = jstep(
            jl, jacts[0] if len(jacts) == 1 else jacts,
            None if dur is None else {n: J(v) for n, v in dur.items()}, (J(spos), J(syaw)))
        sb = fused_step.sensor_block(pl["px"], pl["py"], torch.cos(pl["yaw"]),
                                     torch.sin(pl["yaw"]), k, N)
        prox = torch.stack(sb["prox_vals"], -1)[:, :E].transpose(0, 1).numpy()
        robot_tie = np.pad(prox_ties(prox, k.cos_a, k.sin_a, cfg.prox_threshold,
                                     band=True).T, ((0, 0), (0, 128 - E)))
        pre = lanes.step_lanes(env, dict(pl, sc=torch.zeros_like(pl["sc"])),
                               lane_acts[0] if len(lane_acts) == 1 else lane_acts,
                               want_obs=False, injected_durations=tdur,
                               injected_spawn=(T_(spos), T_(syaw)))[0]
        pre_pos = torch.stack([lanes.from_lanes(pre["px"], E),
                               lanes.from_lanes(pre["py"], E)], -1).numpy()
        arena_tie = np.pad(colour_ties(pre_pos, cfg), (0, 128 - E))[None, :]
        off = np.zeros((N, 128), bool)
        for name in fused_step.MACHINE_TILES if cfg.discrete_actions else ():
            off |= rule.equal(new[name], jnew[name], robot_tie, f"{name} step {t}")
        for name in ("sc", "er", "cg", "prev"):
            off |= rule.equal(new[name], jnew[name], arena_tie, f"{name} step {t}")
        off |= np.pad(rule.equal(reward, jreward, arena_tie[0, :E], f"reward step {t}"),
                      (0, 128 - E))[None, :]
        rule.equal(done, jdone, np.zeros(E, bool), f"done step {t}")
        keep = ~off.any(0)
        for name in ("px", "py", "yaw"):
            np.testing.assert_allclose(new[name].numpy()[:, keep], np.asarray(jnew[name])[:, keep],
                                       rtol=0, atol=2e-6, err_msg=f"{name} step {t}")
        assert len(obs) == len(jobs) == 4
        for j, (g, w) in enumerate(zip(obs, jobs)):
            kk = np.tile(keep, (g.shape[0], 1))
            rab = g.shape[0] == 4 * N
            np.testing.assert_allclose(g.numpy()[kk], np.asarray(w)[kk], rtol=2e-5 if rab else 0,
                                       atol=2e-5 if rab else 2e-6,
                                       err_msg=f"obs tile {j} step {t}")
        dones += int(done.sum())
        jl = jnew
    assert rule.exempt <= 2, f"{rule.exempt} tie exemptions"
    assert dones >= E, "the folded reset never fired — weak test"


def test_the_wide_step_rebuilds_when_the_tuned_source_it_includes_changes(tmp_path, monkeypatch):
    """``fused_step_wide.cu`` includes ``fused_step.cu`` for its device
    functions, so the library's name (its build hash) covers that source
    too; a source that includes neither keeps its name."""
    import shutil

    from swarmacb_torch.ops import _cuda

    for f in _cuda.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = {n: _cuda._target(n, "nvcc")[0] for n in ("fused_step_wide", "pairwise_wide")}
    with open(tmp_path / "fused_step.cu", "a", encoding="utf-8") as f:
        f.write("// edited\n")
    assert _cuda._target("fused_step_wide", "nvcc")[0] != before["fused_step_wide"]
    assert _cuda._target("pairwise_wide", "nvcc")[0] == before["pairwise_wide"]
