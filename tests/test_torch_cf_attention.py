"""The port's fused counterfactual attention (``ops.fused_cf_attention``,
``POCACritic(fused_attention=True)``) against the JAX package, on the CPU,
where every op takes its plain version.

- ``cf_reference`` forward against the JAX ``cf_reference`` at the shapes
  of ``tests/test_cf_attention.py`` and at score scale 12 (saturated
  softmax rows): rtol 2e-5, atol 2e-5, the JAX kernel test's own.
- Its nine cotangents (plain autograd) against ``jax.vjp`` of the JAX
  ``fused_cf_attention`` in interpret mode, which runs the Pallas backward
  body ``_bwd_kernel``: rtol 2e-4, atol 2e-5, the JAX test's own.
- The fused critic with converted flax params against the flax
  ``POCACritic(fused_attention=True)`` (Pallas interpret mode): the
  baselines at rtol 1e-5 / atol 2e-5, and every parameter gradient at 3e-5
  of its largest element (float32 sums in other orders).
- One whole update with ``fused_attention=True`` (N = 20, E = 3, T = 4,
  hidden 32) against the JAX trainer's ``_update_fn`` with
  ``fused_attention=True``, from the same flax weights, rollout and epoch
  permutations, at the tolerances of ``tests/test_torch_update.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.agents import POCAConfig as JaxPOCAConfig
from swarmacb_tpu.agents import POCATrainer as JaxTrainer
from swarmacb_tpu.agents.buffer import Rollout as JaxRollout
from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxEnvCfg
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv
from swarmacb_tpu.models.networks import POCACritic as FlaxCritic
from swarmacb_tpu.ops import cf_attention as jcf

from swarmacb_torch import ops
from swarmacb_torch.agents import POCAConfig, POCATrainer, Rollout
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.convert import flax_to_state_dict, load_flax_params
from swarmacb_torch.env import DirectionalGateEnv
from swarmacb_torch.models import POCACritic
from swarmacb_torch.ops.cf_attention import NAMES

from test_torch_update import E, T, UPDATE_CFG, _flax_flat, _synth_rollout


def _inputs(seed, B=4, H=2, N=6, h=64, d=16, score_scale=3.0):
    """Scores at trained-like magnitude (×3) or saturated (×12), folded
    values and residual entities, as tests/test_cf_attention.py draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    arrays = [f(B, H, N, N) * score_scale, f(B, H, N, N) * score_scale,
              f(B, H, N, N) * score_scale, f(B, H, N, 1) * score_scale,
              f(B, H, N, h), f(B, H, N, h), f(B, N, h), f(B, N, h), f(h)]
    return [a.astype(np.float32) for a in arrays], d


@pytest.mark.parametrize("shape", [dict(), dict(B=2, H=4, N=20, h=128, d=32),
                                   dict(B=3, N=5, score_scale=8.0),
                                   dict(score_scale=12.0)])
def test_cf_reference_matches_jax(shape):
    arrays, d = _inputs(0, **shape)
    ops.reset_launches()
    got = ops.fused_cf_attention(*map(torch.from_numpy, arrays), d)
    assert ops.launches["fused_cf_attention"] == 0
    want = jcf.cf_reference(*map(jnp.asarray, arrays), d)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [dict(), dict(B=2, H=4, N=20, h=32, d=8)])
def test_cotangents_match_the_pallas_backward(shape):
    arrays, d = _inputs(1, **shape)
    B, N, h = arrays[6].shape
    dout = np.random.default_rng(2).normal(size=(B, N, h)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jcf.fused_cf_attention(*a, d, True),
                       *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dout))

    args = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got_out = ops.fused_cf_attention(*args, d)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(got_out, args, torch.from_numpy(dout))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5,
                                   err_msg=f"cotangent of {name}")


# ── the critic ────────────────────────────────────────────────────────────

CRITIC_KW = dict(state_dim=5, act_dim=2, num_agents=6, hidden=32, num_heads=4,
                 num_layers=2)


@pytest.fixture(scope="module")
def fused_critics():
    flax_fused = FlaxCritic(**CRITIC_KW, fused_attention=True)
    # the two flax branches share one parameter tree; the plain one
    # initialises it without running the Pallas kernel
    params = FlaxCritic(**CRITIC_KW).init(jax.random.PRNGKey(3), jnp.zeros((2, 6, 5)),
                                          jnp.zeros((2, 6, 2)))["params"]
    # perturb the zero-initialised biases so that a wrong bias mapping shows
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    leaves = [l + 0.05 * rng.normal(size=l.shape).astype(np.float32) for l in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    critics = {}
    for fused in (True, False):
        with torch.device("meta"):
            m = POCACritic(**CRITIC_KW, fused_attention=fused)
        m.to_empty(device="cpu")
        m.load_state_dict(flax_to_state_dict(params), strict=True)
        critics[fused] = m
    rng = np.random.default_rng(1)
    states = rng.normal(size=(4, 6, 5)).astype(np.float32)
    actions = rng.normal(size=(4, 6, 2)).astype(np.float32)
    return flax_fused, params, critics, states, actions


def test_fused_critic_matches_flax(fused_critics):
    """Values and every parameter gradient of ``all_baselines`` through the
    fused branch, against the flax critic's fused branch (Pallas interpret
    mode); the converter maps the same parameters as for the plain path."""
    flax_fused, params, critics, states, actions = fused_critics
    critic = critics[True]
    probe = np.random.default_rng(4).normal(size=(4, 6)).astype(np.float32)

    def loss(p):
        b = flax_fused.apply({"params": p}, jnp.asarray(states), jnp.asarray(actions),
                             method=flax_fused.all_baselines)
        return (b * probe).sum(), b

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    got = critic.all_baselines(torch.from_numpy(states), torch.from_numpy(actions))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=2e-5)
    grads = torch.autograd.grad((got * torch.from_numpy(probe)).sum(),
                                list(critic.parameters()), allow_unused=True)
    got_g = {n: g for (n, _), g in zip(critic.named_parameters(), grads)}
    want_g = flax_to_state_dict(jgrads)
    # the team-value-only encoders get no gradient from the baselines
    assert {n for n, g in got_g.items() if g is not None} == {
        n for n, w in want_g.items() if float(np.abs(w.numpy()).max()) > 0}
    for name, w in want_g.items():
        g = got_g[name]
        w = w.numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g, w, rtol=0, atol=3e-5 * scale,
                                   err_msg=f"gradient of {name}")


def test_fused_and_plain_critics_agree(fused_critics):
    """The port's two branches of ``all_baselines`` are one function with one
    set of parameters: values and parameter gradients agree."""
    _, _, critics, states, actions = fused_critics
    s, a = torch.from_numpy(states), torch.from_numpy(actions)
    outs = {k: m.all_baselines(s, a) for k, m in critics.items()}
    np.testing.assert_allclose(outs[True].detach().numpy(),
                               outs[False].detach().numpy(), rtol=1e-5, atol=1e-5)
    g = {k: torch.autograd.grad(outs[k].sum(), list(critics[k].parameters()),
                                allow_unused=True) for k in critics}
    for (name, _), gf, gp in zip(critics[True].named_parameters(), g[True], g[False]):
        assert (gf is None) == (gp is None), name
        if gf is not None:
            scale = max(float(gp.abs().max()), 1e-3)
            np.testing.assert_allclose(gf.numpy(), gp.numpy(), rtol=0,
                                       atol=3e-5 * scale, err_msg=name)


# ── one whole update against the JAX trainer ──────────────────────────────

def test_fused_update_matches_jax():
    """``POCATrainer._update`` with ``fused_attention=True`` against the JAX
    trainer's ``_update_fn`` with ``fused_attention=True`` (its critic's
    Pallas kernels in interpret mode): the same weights, rollout and epoch
    permutations; metrics at rtol 1e-2 / atol 1e-3 and every parameter
    within 2.2·num_epochs·lr, the bounds of tests/test_torch_update.py."""
    jtrainer = JaxTrainer(JaxEnv(JaxEnvCfg(num_envs=E)),
                          JaxPOCAConfig(**UPDATE_CFG, fused_attention=True))
    trainer = POCATrainer(DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=E),
                                             device="cpu"),
                          POCAConfig(**UPDATE_CFG, fused_attention=True))
    assert jtrainer.critic.fused_attention and trainer.critic.fused_attention
    params = jtrainer.train_state.params
    load_flax_params(trainer, params)
    data, bootstrap = _synth_rollout(5)
    key = jax.random.PRNGKey(11)
    perms = np.stack([np.asarray(jax.random.permutation(k, T * E))
                      for k in jax.random.split(key, UPDATE_CFG["num_epochs"])])
    c = trainer.cfg
    rollout = JaxRollout(**{k: jnp.asarray(v) for k, v in data.items()})
    new_state, jmetrics = jtrainer._update_jit(
        jtrainer.train_state, rollout, jnp.asarray(bootstrap), jnp.float32(c.lr),
        jnp.float32(c.clip_eps), jnp.float32(c.beta), key)
    ops.reset_launches()
    metrics = trainer._update(Rollout(**{k: torch.from_numpy(v) for k, v in data.items()}),
                              torch.from_numpy(bootstrap), c.lr, c.clip_eps, c.beta,
                              injected_perms=torch.from_numpy(perms))
    assert ops.launches["fused_cf_attention"] == ops.launches["fused_tail"] == 0
    for k in ("policy_loss", "value_loss", "baseline_loss", "entropy"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-2, atol=1e-3, err_msg=k)
    bound = 2.2 * c.num_epochs * c.lr
    after = _flax_flat(new_state.params)
    got = {f"{net}.{k}": v for net in ("actor", "critic")
           for k, v in getattr(trainer, net).state_dict().items()}
    assert got.keys() == after.keys()
    for name, w in after.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w), rtol=0,
                                   atol=bound, err_msg=f"parameter {name}")
    moved = max(float(np.abs(got[n].numpy() - np.asarray(w)).max())
                for n, w in _flax_flat(params).items())
    assert moved > bound, "the update moved no parameter past the tolerance"
