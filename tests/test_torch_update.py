"""The learning half of the port against the JAX package, on the CPU.

- λ-returns, advantages, their normalisation, the three losses and the
  schedules against ``swarmacb_tpu.agents.{buffer,losses}``: elementwise
  float32 work with the same formulas, rtol 1e-6, and atol 1e-6 for the
  O(1) λ-returns, whose T-step recursion XLA contracts into fused
  multiply-adds (a few ulps apart from PyTorch's separate ops).
- The critic tail's gradient: the port's ``fused_tail`` on CPU tensors
  (plain autograd) against ``jax.vjp`` of the JAX package's ``fused_tail``
  in interpret mode, which runs the Pallas backward body ``_bwd_kernel``:
  rtol 1e-5, atol 2e-5, as ``tests/test_baseline_tail.py`` holds the JAX
  kernel to its own reference.
- One whole update (N = 20, E = 3, T = 4, hidden 32) against the JAX
  trainer's ``_update_fn`` with ``fused_tail`` off, from the same flax
  weights, rollout and epoch permutations. Three minibatches per epoch
  (5, 5, 2 groups); the first is chunked 2, 2, 1 under
  ``accum_chunk_groups = 2``. The first minibatch's loss and gradients
  before any step are held strictly: loss to 2e-6 relative, each gradient
  to 3e-5 of its largest element (float32 sums in other orders through
  the 32-wide networks). After three epochs, each parameter is held to
  2.2·num_epochs·lr, because a first Adam step moves a coordinate by
  ≈ lr·sign(g), and a gradient near 0 can take either sign on the two
  sides (the bound of tests/test_update_parity.py:314-327).
- Two iterations of ``POCATrainer.train`` finish with finite metrics, and a
  non-finite loss stops ``train``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.agents import POCAConfig as JaxPOCAConfig
from swarmacb_tpu.agents import POCATrainer as JaxTrainer
from swarmacb_tpu.agents import buffer as jbuf
from swarmacb_tpu.agents import losses as jlosses
from swarmacb_tpu.agents.buffer import Rollout as JaxRollout
from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxEnvCfg
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv
from swarmacb_tpu.ops import baseline_tail as jbt

from swarmacb_torch import ops
from swarmacb_torch.agents import POCAConfig, POCATrainer, Rollout
from swarmacb_torch.agents import buffer, losses
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.convert import flax_to_state_dict, load_flax_params
from swarmacb_torch.env import DirectionalGateEnv


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=1e-6, atol=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ── buffer and losses ─────────────────────────────────────────────────────

def _buffer_arrays(seed, T=9, E=4, N=5):
    rng = np.random.default_rng(seed)
    f = np.float32
    dones = (rng.random((T, E)) < 0.25).astype(f)
    dones[3, 0] = dones[T - 1, 1] = 1.0          # dones inside and at the end
    return dict(rewards=rng.normal(size=(T, E)).astype(f), dones=dones,
                team_values=rng.normal(size=(T, E)).astype(f),
                baselines=rng.normal(size=(T, E, N)).astype(f),
                bootstrap=rng.normal(size=(E,)).astype(f))


def test_lambda_returns_and_advantages_match_jax():
    a = _buffer_arrays(0)
    args = (a["rewards"], a["dones"], a["team_values"], a["bootstrap"])
    _close(buffer.lambda_returns(*map(_t, args), 0.99, 0.95),
           jbuf.lambda_returns(*map(jnp.asarray, args), 0.99, 0.95))
    shape = a["baselines"].shape[:2]
    zeros = np.zeros(shape + (2,), np.float32)
    fields = dict(obs=zeros, critic_states=zeros, actions=zeros, log_probs=zeros,
                  rewards=a["rewards"], dones=a["dones"],
                  team_values=a["team_values"], baselines=a["baselines"])
    ret, adv = buffer.compute_advantages(
        Rollout(**{k: _t(v) for k, v in fields.items()}), _t(a["bootstrap"]),
        0.99, 0.95)
    jret, jadv = jbuf.compute_advantages(
        JaxRollout(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jnp.asarray(a["bootstrap"]), 0.99, 0.95)
    _close(ret, jret)
    _close(adv, jadv)
    _close(buffer.normalize_advantages(adv), jbuf.normalize_advantages(jadv))
    _close(buffer.flatten_time_env(adv), jbuf.flatten_time_env(adv.numpy()), atol=0)


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    f = np.float32
    B, A = 64, 2
    values = rng.normal(size=B).astype(f)
    old_values = (values + rng.normal(size=B) * 0.4).astype(f)
    returns = rng.normal(size=B).astype(f)
    adv = rng.normal(size=(B, 1)).astype(f)
    logp = rng.normal(size=(B, A)).astype(f) * 0.5 - 1.0
    old_logp = (logp + rng.normal(size=(B, A)) * 0.3).astype(f)
    for eps in (0.2, 0.1):
        _close(losses.trust_region_value_loss(_t(values), _t(old_values),
                                              _t(returns), eps),
               jlosses.trust_region_value_loss(values, old_values, returns, eps))
        _close(losses.trust_region_policy_loss(_t(adv), _t(logp), _t(old_logp), eps),
               jlosses.trust_region_policy_loss(adv, logp, old_logp, eps))
    parts = [torch.tensor(v) for v in (0.3, 1.7, 2.2, 2.8)]
    _close(losses.poca_total_loss(*parts, 0.005),
           jlosses.poca_total_loss(*[jnp.float32(float(p)) for p in parts], 0.005))
    assert (losses.LR_MIN, losses.EPS_MIN, losses.BETA_MIN) == (
        jlosses.LR_MIN, jlosses.EPS_MIN, jlosses.BETA_MIN)
    for kind in ("linear", "constant"):
        ours = losses.make_schedule(kind, 3e-4, losses.LR_MIN, 1000)
        theirs = jlosses.make_schedule(kind, 3e-4, jlosses.LR_MIN, 1000)
        for step in (0, 1, 400, 999, 1000, 5000):
            np.testing.assert_allclose(ours(step), theirs(step), rtol=1e-6)
    decay = losses.PolynomialDecay(0.2, 0.1, 100, power=2.0)
    np.testing.assert_allclose(
        [decay(s) for s in (0, 50, 100)],
        [jlosses.PolynomialDecay(0.2, 0.1, 100, power=2.0)(s) for s in (0, 50, 100)],
        rtol=1e-6)


# ── the critic tail's gradient ────────────────────────────────────────────

NAMES = ("attn_lhs", "attn_mI", "wa", "dws", "x_a", "delta", "bias")


@pytest.mark.parametrize("B,N,h", [(6, 5, 32), (3, 4, 64)])
def test_tail_gradient_matches_the_pallas_backward(B, N, h):
    H = 4
    HM = H * N
    rng = np.random.default_rng(B + h)
    arrays = [rng.uniform(size=(B, N * N, HM)) / HM, rng.uniform(size=(B, H, N, N)) / N,
              rng.normal(size=(B, HM, h)) * 0.3, rng.normal(size=(B, H, N, h)) * 0.2,
              rng.normal(size=(B, N, h)), rng.normal(size=(B, N, h)) * 0.5,
              rng.normal(size=(h,)) * 0.1]
    arrays = [a.astype(np.float32) for a in arrays]
    dout = rng.normal(size=(B, N, h)).astype(np.float32)

    out, vjp = jax.vjp(lambda *a: jbt.fused_tail(*a, N, True),
                       *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dout))

    args = [_t(a).requires_grad_() for a in arrays]
    got_out = ops.fused_tail(*args, N)
    _close(got_out, out, rtol=1e-5, atol=2e-5)
    got = torch.autograd.grad(got_out, args, _t(dout))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=2e-5,
                                   err_msg=f"cotangent of {name}")


# ── one whole update against the JAX trainer ──────────────────────────────

E, N_AG, T, HID = 3, 20, 4, 32
UPDATE_CFG = dict(horizon=T, num_epochs=3, mini_batch_size=5, buffer_size_hint=0,
                  accum_chunk_groups=2, hidden_dim=HID, lr=3e-4, seed=3)


def _synth_rollout(seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        obs=rng.normal(size=(T, E, N_AG, 24)).astype(f),
        critic_states=(rng.normal(size=(T, E, N_AG, 5)) * 0.5).astype(f),
        actions=rng.normal(size=(T, E, N_AG, 2)).astype(f),
        log_probs=rng.uniform(-2.5, -0.5, size=(T, E, N_AG, 2)).astype(f),
        rewards=(rng.normal(size=(T, E)) * 0.5).astype(f),
        dones=np.array([[0, 0, 1], [1, 0, 0], [0, 0, 0], [0, 1, 0]], f),
        team_values=(rng.normal(size=(T, E)) * 0.5).astype(f),
        baselines=(rng.normal(size=(T, E, N_AG)) * 0.5).astype(f),
    ), (rng.normal(size=(E,)) * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def update_pair():
    jtrainer = JaxTrainer(JaxEnv(JaxEnvCfg(num_envs=E)),
                          JaxPOCAConfig(**UPDATE_CFG, fused_tail=False))
    trainer = POCATrainer(DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=E),
                                             device="cpu"),
                          POCAConfig(**UPDATE_CFG))
    params = jtrainer.train_state.params
    load_flax_params(trainer, params)
    data, bootstrap = _synth_rollout(5)
    key = jax.random.PRNGKey(11)
    perms = np.stack([np.asarray(jax.random.permutation(k, T * E))
                      for k in jax.random.split(key, UPDATE_CFG["num_epochs"])])
    return jtrainer, trainer, params, data, bootstrap, key, perms


def _state_dict_grads(trainer):
    return {f"{net}.{n}": p.grad for net in ("actor", "critic")
            for n, p in getattr(trainer, net).named_parameters()}


def _flax_flat(tree):
    return {f"{net}.{k}": v for net in ("actor", "critic")
            for k, v in flax_to_state_dict(tree[net]).items()}


def test_minibatch_shapes_match_jax(update_pair):
    jtrainer, trainer, *_ = update_pair
    assert trainer.group_mb == jtrainer.group_mb == 5
    assert trainer._chunk_rows(5) == jtrainer._chunk_rows(5) == 2
    assert trainer._grad_chunks(5) == jtrainer._grad_chunks(5) == 3
    assert trainer._grad_chunks(2) == 1


def test_first_minibatch_loss_and_gradients_match_jax(update_pair):
    jtrainer, trainer, params, data, bootstrap, _, perms = update_pair
    c = trainer.cfg
    rollout = JaxRollout(**{k: jnp.asarray(v) for k, v in data.items()})
    returns, adv = jbuf.compute_advantages(rollout, jnp.asarray(bootstrap),
                                           c.gamma, c.lam)
    flat = jtrainer._flatten_buffer(rollout, returns, jbuf.normalize_advantages(adv))
    idx = perms[0][:trainer.group_mb]
    grad_fn = jax.jit(jax.value_and_grad(jtrainer._feedforward_loss, has_aux=True))
    (loss, aux), grads = grad_fn(params, {k: v[idx] for k, v in flat.items()},
                                 c.clip_eps, c.beta)

    ours = Rollout(**{k: _t(v) for k, v in data.items()})
    returns_t, adv_t = buffer.compute_advantages(ours, _t(bootstrap), c.gamma, c.lam)
    flat_t = trainer._flatten_buffer(ours, returns_t, buffer.normalize_advantages(adv_t))
    trainer.optimizer.zero_grad(set_to_none=True)
    total, aux_t = trainer._accumulate_grads(
        {k: v[torch.from_numpy(idx)] for k, v in flat_t.items()}, c.clip_eps, c.beta,
        trainer._feedforward_loss)
    try:
        np.testing.assert_allclose(float(total), float(loss), rtol=2e-6, atol=1e-7)
        np.testing.assert_allclose(aux_t.numpy(), np.array([float(a) for a in aux]),
                                   rtol=2e-6, atol=1e-7)
        got, want = _state_dict_grads(trainer), _flax_flat(grads)
        assert got.keys() == want.keys()
        for name, w in want.items():
            w = np.asarray(w)
            scale = max(float(np.abs(w).max()), 1e-3)
            np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=3e-5 * scale,
                                       err_msg=f"gradient of {name}")
    finally:
        trainer.optimizer.zero_grad(set_to_none=True)


def test_update_matches_jax(update_pair):
    jtrainer, trainer, _, data, bootstrap, key, perms = update_pair
    c = trainer.cfg
    rollout = JaxRollout(**{k: jnp.asarray(v) for k, v in data.items()})
    new_state, jmetrics = jtrainer._update_jit(
        jtrainer.train_state, rollout, jnp.asarray(bootstrap), jnp.float32(c.lr),
        jnp.float32(c.clip_eps), jnp.float32(c.beta), key)
    metrics = trainer._update(Rollout(**{k: _t(v) for k, v in data.items()}),
                              _t(bootstrap), c.lr, c.clip_eps, c.beta,
                              injected_perms=torch.from_numpy(perms))
    bound = 2.2 * c.num_epochs * c.lr
    for k in ("policy_loss", "value_loss", "baseline_loss", "entropy"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-2, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(float(metrics["mean_abs_advantage"]),
                               float(jmetrics["mean_abs_advantage"]), rtol=1e-6)
    after = _flax_flat(new_state.params)
    got = {f"{net}.{k}": v for net in ("actor", "critic")
           for k, v in getattr(trainer, net).state_dict().items()}
    assert got.keys() == after.keys()
    moved = 0.0
    for name, w in after.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w), rtol=0,
                                   atol=bound, err_msg=f"parameter {name}")
    for name, w in _flax_flat(jtrainer.train_state.params).items():
        moved = max(moved, float(np.abs(got[name].numpy() - np.asarray(w)).max()))
    assert moved > bound, "the update moved no parameter past the tolerance"


# ── the training loop ─────────────────────────────────────────────────────

def test_train_two_iterations(capsys):
    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=2), device="cpu")
    T_small = 6
    cfg = POCAConfig(hidden_dim=16, horizon=T_small, mini_batch_size=5,
                     accum_chunk_groups=3, total_timesteps=2 * T_small * 2 * 20,
                     lr_schedule="linear", eps_schedule="linear",
                     beta_schedule="linear")
    trainer = POCATrainer(env, cfg)
    before = [p.detach().clone() for p in trainer.critic.parameters()]
    lr0, eps0, beta0 = trainer._schedules()
    _, obs = trainer.train()
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[POCA]")]
    assert len(lines) == 2 and "upd=2" in lines[-1]
    assert "nan" not in " ".join(lines) and "inf" not in " ".join(lines)
    assert trainer.global_step == cfg.total_timesteps and trainer.update_count == 2
    lr1, eps1, beta1 = trainer._schedules()
    assert lr1 < lr0 and eps1 < eps0 and beta1 < beta0
    assert obs.shape == (2, 20, 24) and bool(torch.isfinite(obs).all())
    assert all(bool(torch.isfinite(p).all()) for p in trainer.critic.parameters())
    assert any(not torch.equal(p, q) for p, q in zip(trainer.critic.parameters(), before))


def test_train_stops_on_a_non_finite_loss(monkeypatch):
    """A NaN loss means diverged training: ``train`` raises at the iteration
    it appears instead of running on to ``total_timesteps``."""
    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=1), device="cpu")
    trainer = POCATrainer(env, POCAConfig(hidden_dim=8, horizon=2,
                                          total_timesteps=10 * 2 * 20))
    nan = torch.tensor(float("nan"))
    monkeypatch.setattr(trainer, "_update", lambda *a, **k: {
        "policy_loss": nan, "value_loss": nan, "baseline_loss": nan,
        "entropy": nan, "mean_abs_advantage": nan})
    with pytest.raises(FloatingPointError, match="diverged"):
        trainer.train(progress=False)
    assert trainer.update_count == 1
