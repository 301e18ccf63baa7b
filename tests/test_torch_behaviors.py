"""The port's behaviour modules against the JAX package, on the CPU.

``dispatch`` runs on IDENTICAL float inputs on both sides (made with numpy
from a seed, with constructed edge cases), so the obstacle and turn tests
see the same numbers: integer and boolean machine state must match
exactly, over a chain of steps that feeds each side its own new state.
Wheels go through atan2 and cos, which PyTorch and XLA may round an ulp
apart: 1e-6 absolute (wheel speeds are at most 0.12).

Edge cases: sum_x = ±0 and a 1e-9 residue of either sign (prox angles
atan2(±0.3, ±0 / ±1e-9)), angles exactly ±π/2 and ±π, atan2(−0.0, x < 0)
inside the wheel conversion, prox values exactly at the threshold, zero
vectors, turn durations of 1, inactive modules frozen, and ``reset_where``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.env import behaviors as jbeh
from swarmacb_tpu.env.behaviors import BehaviorState as JaxBehaviorState

from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import DirectionalGateEnv, behaviors
from swarmacb_torch.env.state import BehaviorState

E, N, STEPS = 4, 20, 12
MAX_SPEED, ALPHA, THR = 0.12, 5.0, 0.1
FIELDS = ("explore_state", "explore_steps", "explore_dir", "photo_avoiding",
          "photo_steps", "photo_dir", "antiphoto_avoiding", "antiphoto_steps",
          "antiphoto_dir")

f32 = np.float32
HALF_PI = f32(np.pi / 2)
EDGE_ANGLES = np.array([
    HALF_PI, -HALF_PI, np.nextafter(HALF_PI, f32(4)), np.nextafter(-HALF_PI, f32(-4)),
    np.nextafter(HALF_PI, f32(0)), f32(np.pi), -f32(np.pi), f32(0.0), f32(-0.0),
    np.arctan2(f32(0.3), f32(0.0)), np.arctan2(f32(0.3), f32(-0.0)),
    np.arctan2(f32(-0.3), f32(1e-9)), np.arctan2(f32(-0.3), f32(-1e-9)),
    np.arctan2(f32(0.3), f32(1e-9)), np.arctan2(f32(0.3), f32(-1e-9)),
    np.arctan2(f32(-0.0), f32(-0.5)), np.arctan2(f32(0.0), f32(-0.5)),
], dtype=f32)


def _step_inputs(rng):
    """One step's float inputs: random, with the edge cases planted."""
    prox_value = rng.uniform(0.0, 0.3, (E, N)).astype(f32)
    prox_angle = rng.uniform(-np.pi, np.pi, (E, N)).astype(f32)
    light_value = rng.uniform(0.0, 1.0, (E, N)).astype(f32)
    light_angle = rng.uniform(-np.pi, np.pi, (E, N)).astype(f32)
    rab_x = rng.normal(0.0, 0.5, (E, N)).astype(f32)
    rab_y = rng.normal(0.0, 0.5, (E, N)).astype(f32)
    k = len(EDGE_ANGLES)
    flat = lambda a: a.reshape(-1)  # noqa: E731
    flat(prox_angle)[:k] = EDGE_ANGLES
    flat(light_angle)[k:2 * k] = EDGE_ANGLES
    flat(prox_value)[:k:2] = f32(THR)                       # at the threshold
    flat(prox_value)[1:k:2] = np.nextafter(f32(THR), f32(0))
    # zero steering vectors and atan2(−0.0, x < 0) in the wheel conversion:
    # no prox and no light, rab = (−0.5, ∓0)
    z = slice(2 * k, 2 * k + 6)
    flat(prox_value)[z] = 0.0
    flat(light_value)[z] = 0.0
    flat(rab_x)[z] = [-0.5, -0.5, 0.0, -0.0, 0.05, 0.0]
    flat(rab_y)[z] = [-0.0, 0.0, 0.0, -0.0, -0.0, 1e-9]
    return prox_value, prox_angle, light_value, light_angle, rab_x, rab_y


def _initial_state(rng):
    i32 = lambda lo, hi: rng.integers(lo, hi, (E, N)).astype(np.int32)  # noqa: E731
    sign = lambda: np.where(rng.random((E, N)) < 0.5, -1.0, 1.0).astype(f32)  # noqa: E731
    return dict(explore_state=i32(0, 2), explore_steps=i32(0, 4), explore_dir=sign(),
                photo_avoiding=rng.random((E, N)) < 0.5, photo_steps=i32(0, 4),
                photo_dir=sign(), antiphoto_avoiding=rng.random((E, N)) < 0.5,
                antiphoto_steps=i32(0, 4), antiphoto_dir=sign())


def _torch_state(d):
    return BehaviorState(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})


def _jax_state(d):
    return JaxBehaviorState(**{k: jnp.asarray(v) for k, v in d.items()})


def _assert_state_equal(ts, js, what):
    for f in FIELDS:
        got = getattr(ts, f).numpy()
        want = np.asarray(getattr(js, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f"{f} {what}")


@pytest.mark.parametrize("seed", [0, 1])
def test_dispatch_matches_jax_on_identical_inputs(seed):
    rng = np.random.default_rng(seed)
    init = _initial_state(rng)
    ts, js = _torch_state(init), _jax_state(init)
    jdispatch = jax.jit(lambda m, s, *a, dur: jbeh.dispatch(
        m, s, *a, None, MAX_SPEED, ALPHA, THR, injected_durations=dur))
    triggered = 0
    for t in range(STEPS):
        module_ids = rng.integers(0, 6, (E, N)).astype(np.int32)
        module_ids.reshape(-1)[:6] = np.arange(6)
        inputs = _step_inputs(rng)
        dur = {k: rng.integers(1, 5, (E, N)).astype(np.int32)
               for k in ("explore", "photo", "antiphoto")}
        dur["explore"].reshape(-1)[::3] = 1                  # duration 1
        before = ts
        left, right, ts = behaviors.dispatch(
            torch.from_numpy(module_ids), ts, *map(torch.from_numpy, inputs),
            {k: torch.from_numpy(v) for k, v in dur.items()}, MAX_SPEED, ALPHA, THR)
        jleft, jright, js = jdispatch(jnp.asarray(module_ids), js,
                                      *map(jnp.asarray, inputs),
                                      dur={k: jnp.asarray(v) for k, v in dur.items()})
        _assert_state_equal(ts, js, f"step {t}")
        np.testing.assert_allclose(left.numpy(), np.asarray(jleft), rtol=0, atol=1e-6)
        np.testing.assert_allclose(right.numpy(), np.asarray(jright), rtol=0, atol=1e-6)
        # modules other than 0/2/3 leave every machine frozen; module 0
        # leaves the photo machines, and so on
        frozen = {"explore": module_ids != 0, "photo": module_ids != 2,
                  "antiphoto": module_ids != 3}
        for f in FIELDS:
            mask = frozen[f.split("_")[0]]
            np.testing.assert_array_equal(getattr(ts, f).numpy()[mask],
                                          getattr(before, f).numpy()[mask],
                                          err_msg=f"{f} moved while inactive")
        triggered += int((ts.explore_state.numpy() != before.explore_state.numpy()).sum())
        # Stop (module 1) is still
        assert not left.numpy()[module_ids == 1].any()
    assert triggered > 0, "no exploration machine changed state — weak test"


def test_compute_wheels_from_vector_edge_vectors():
    dx = np.array([-0.5, -0.5, 0.0, -0.0, 1e-6, 0.3, -0.3, 0.0, 0.2, -1e-9],
                  dtype=f32)
    dy = np.array([-0.0, 0.0, 0.0, -0.0, 1e-6, 0.0, 1e-9, 0.4, -0.2, -0.3],
                  dtype=f32)
    got = behaviors.compute_wheels_from_vector(torch.from_numpy(dx),
                                               torch.from_numpy(dy), MAX_SPEED)
    want = jbeh.compute_wheels_from_vector(jnp.asarray(dx), jnp.asarray(dy), MAX_SPEED)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    # atan2(∓0, −0.5) = ∓π, shifted to π: both are the back hemisphere,
    # (L, R) = (1, cos π) scaled
    for i in (0, 1):
        assert float(got[0][i]) == pytest.approx(MAX_SPEED)
        assert float(got[1][i]) == pytest.approx(-MAX_SPEED)


def test_reset_where_matches_jax():
    rng = np.random.default_rng(5)
    init = _initial_state(rng)
    mask = np.array([True, False, True, False])
    got = _torch_state(init).reset_where(torch.from_numpy(mask))
    want = _jax_state(init).reset_where(jnp.asarray(mask))
    _assert_state_equal(got, want, "after reset_where")
    assert not got.explore_state.numpy()[mask].any()


def test_dispatch_draws_durations_from_the_generator(monkeypatch):
    """The env step draws the durations that ``dispatch`` latches, from the
    state's generator: explore, photo, antiphoto in that order, right after
    the reset's draws; the same seed gives the same durations, each in
    {1..4}."""
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="daisy", num_envs=E),
                             device="cpu")
    seen = []
    real = behaviors.dispatch
    monkeypatch.setattr(behaviors, "dispatch",
                        lambda *a, **kw: seen.append(a[8]) or real(*a, **kw))
    expected = []
    for _ in range(2):
        state, _ = env.reset(torch.Generator().manual_seed(9))
        g = torch.Generator()
        g.set_state(state.generator.get_state())
        expected.append([behaviors.draw_durations(g, (E, N), "cpu") for _ in range(3)])
        env.step(state, torch.zeros((E, N), dtype=torch.int32))
    for durations, want in zip(seen, expected):
        assert list(durations) == ["explore", "photo", "antiphoto"]
        for got, w in zip(durations.values(), want):
            assert got.dtype == torch.int32 and tuple(got.shape) == (E, N)
            assert torch.equal(got, w)
            assert int(got.min()) >= 1 and int(got.max()) <= 4
    assert all(torch.equal(a, b) for a, b in zip(seen[0].values(), seen[1].values()))
    assert len(torch.unique(seen[0]["explore"])) > 1
