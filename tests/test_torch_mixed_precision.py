"""Mixed precision (``POCAConfig.mixed_precision``, ``mp_stages``): the
port's bf16 critic against the JAX package's, on the CPU.

The JAX critic is ``POCACritic(compute_dtype=bfloat16, mp_stages=...)``
with ``fused_tail=True`` (its Pallas tail in interpret mode) or
``fused_attention=True``: the branches whose tail is float32, as the port's
tail is on every device. Weights from ``convert.py``, drawn N(0, 1/fan_in)
with biases N(0, 0.1²) so that the attention moves the critic's outputs
(the init's T-Fixup gains would hide it).

Bounds:
- every bf16 projection (q, k, v, fc_out) equals flax's ``Dense(dtype=bf16)``
  in at least 99.9 % of its elements: the product rounded to bf16, then the
  bias added in bf16. ``F.linear`` with the bias rounds once and misses it;
- values and baselines: the port-vs-JAX mean |Δ| at most a tenth of the
  JAX package's own bf16-vs-float32 distance, so the rounding points match
  and both sides are not merely near float32; and within the float32
  tolerance of ``tests/test_torch_models.py`` (rtol 1e-5, atol 2e-5);
- ``mp_stages=""`` gives the float32 critic's values and baselines bit for
  bit;
- a bf16 projection's weight gradient equals flax's; its bias gradient is
  the float32 sum of the output's bf16 cotangent rounded once, which XLA on
  the CPU sums in bf16 instead (``test_torch_mixed_precision_update.py``
  holds one minibatch's gradients against the JAX trainer's).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from swarmacb_tpu.models.networks import POCACritic as FlaxCritic

from swarmacb_torch.agents import POCAConfig
from swarmacb_torch.convert import flax_to_state_dict
from swarmacb_torch.models import POCACritic
from swarmacb_torch.models.networks import _project
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, N, H, HID = 3, 5, 4, 32
KW = dict(state_dim=5, act_dim=2, num_agents=N, hidden=HID, num_heads=H, num_layers=2)
STAGES = ["qkvo", "qk", "vo", ""]
BRANCHES = ["fused_tail", "fused_attention"]
EQUAL_SHARE = 0.999


def _wide(tree, seed):
    """Every kernel N(0, 1/fan_in), every bias and vector N(0, 0.1²)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    leaves = [(rng.normal(size=l.shape) * (l.shape[0] ** -0.5 if l.ndim == 2 else 0.1)
               ).astype(np.float32) for l in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def params():
    init = FlaxCritic(**KW).init(jax.random.PRNGKey(3), jnp.zeros((2, N, 5)),
                                 jnp.zeros((2, N, 2)))["params"]
    return _wide(init, 0)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, 5)).astype(np.float32),
            rng.normal(size=(B, N, 2)).astype(np.float32))


def _port(params, branch, dtype, stages):
    with torch.device("meta"):
        m = POCACritic(**KW, fused_attention=branch == "fused_attention",
                       compute_dtype=dtype, mp_stages=stages)
    m.to_empty(device="cpu")
    m.load_state_dict(flax_to_state_dict(params), strict=True)
    return m


def _flax(branch, dtype, stages="qkvo"):
    return FlaxCritic(**KW, fused_tail=True, fused_attention=branch == "fused_attention",
                      compute_dtype=dtype, mp_stages=stages)


def _outputs_port(m, states, actions):
    with torch.no_grad():
        return (m.critic_pass(torch.from_numpy(states)).numpy(),
                m.all_baselines(torch.from_numpy(states), torch.from_numpy(actions)).numpy())


def _outputs_flax(m, params, states, actions):
    v = m.apply({"params": params}, jnp.asarray(states), method=m.critic_pass)
    b = m.apply({"params": params}, jnp.asarray(states), jnp.asarray(actions),
                method=m.all_baselines)
    return np.asarray(v), np.asarray(b)


def _share_equal(got: torch.Tensor, want) -> float:
    return float((got.float().numpy() == np.asarray(want.astype(jnp.float32))).mean())


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("stages", STAGES)
def test_bf16_critic_matches_jax(params, stages, branch):
    states, actions = _inputs()
    got = _outputs_port(_port(params, branch, torch.bfloat16, stages), states, actions)
    if not stages:
        # no stage in bf16: the float32 critic, bit for bit
        want = _outputs_port(_port(params, branch, None, "qkvo"), states, actions)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return
    want = _outputs_flax(_flax(branch, jnp.bfloat16, stages), params, states, actions)
    f32 = _outputs_flax(_flax(branch, None), params, states, actions)
    for name, g, w, r in zip(("values", "baselines"), got, want, f32):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-5, err_msg=name)
        ours, theirs = np.abs(g - w).mean(), np.abs(w - r).mean()
        assert theirs > 1e-6, f"{name}: bf16 moved the JAX critic by only {theirs:.3g}"
        assert ours <= theirs / 10, (f"{name}: port vs JAX {ours:.3g}, more than a tenth "
                                     f"of JAX bf16 vs float32 {theirs:.3g}")


@pytest.mark.parametrize("stages", STAGES)
def test_projections_round_as_flax_dense(params, stages):
    """q, k and v (``project_qkv``) and fc_out take bf16 exactly where
    ``stages`` names them, and equal flax's Dense outputs there."""
    x = np.random.default_rng(2).normal(size=(B, N, HID)).astype(np.float32)
    flax_critic = _flax("fused_tail", jnp.bfloat16, stages)
    want = flax_critic.apply({"params": params}, jnp.asarray(x), method=lambda m, x: (
        *m.self_attn.project_qkv(x), m.self_attn.fc_out(x)))
    rsa = _port(params, "fused_tail", torch.bfloat16, stages).self_attn
    with torch.no_grad():
        got = (*rsa.project_qkv(torch.from_numpy(x)),
               _project(rsa.fc_out, torch.from_numpy(x), rsa.dtypes["o"]))
    for s, g, w in zip("qkvo", got, want):
        assert g.dtype == (torch.bfloat16 if s in stages else torch.float32), s
        assert w.dtype == (jnp.bfloat16 if s in stages else jnp.float32), s
        share = _share_equal(g, w)
        if s in stages:
            assert share >= EQUAL_SHARE, f"{s}: {share:.4%} of elements equal flax's"
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_f_linear_with_bias_misses_flax_dense():
    """Rounding the product and the bias add once (``F.linear`` with the
    bias) misses flax's Dense(dtype=bf16) by more than the bound; two
    roundings (``_project``) meet it."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(256, 128)).astype(np.float32)
    dense = fnn.Dense(128, dtype=jnp.bfloat16)
    p = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    p = {"kernel": p["kernel"], "bias": jnp.asarray(rng.normal(size=128) * 0.5, jnp.float32)}
    want = dense.apply({"params": p}, jnp.asarray(x))
    layer = torch.nn.Linear(128, 128)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.asarray(p["kernel"]).T.copy()))
        layer.bias.copy_(torch.from_numpy(np.array(p["bias"])))
        two = _project(layer, torch.from_numpy(x), torch.bfloat16)
        bf = torch.bfloat16
        one = F.linear(torch.from_numpy(x).to(bf), layer.weight.to(bf), layer.bias.to(bf))
    assert _share_equal(two, want) >= EQUAL_SHARE
    assert _share_equal(one, want) < EQUAL_SHARE


def test_bias_gradient_of_a_bf16_dense():
    """The gradient of a bf16 projection's bias is the sum over rows of its
    bf16 output's cotangent: the port's sums in float32 and rounds once;
    the JAX package's, on the CPU, misses that sum in most elements (XLA
    sums the transposed broadcast in bf16). The weight's gradient, a
    product, is equal."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(6, 20, HID)).astype(np.float32)
    ct = rng.normal(size=(6, 20, HID)).astype(np.float32)
    dense = fnn.Dense(HID, dtype=jnp.bfloat16)
    p = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    g = jax.grad(lambda p: (dense.apply({"params": p}, jnp.asarray(x)).astype(jnp.float32)
                            * ct).sum())(p)
    layer = torch.nn.Linear(HID, HID)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.array(p["kernel"]).T))
        layer.bias.copy_(torch.from_numpy(np.array(p["bias"])))
    (_project(layer, torch.from_numpy(x), torch.bfloat16).float()
     * torch.from_numpy(ct)).sum().backward()
    once = torch.from_numpy(ct).bfloat16().float().sum((0, 1)).bfloat16().float()
    assert torch.equal(layer.bias.grad, once)
    assert float((once.numpy() == np.asarray(g["bias"])).mean()) < 0.5
    np.testing.assert_array_equal(layer.weight.grad.numpy().T, np.asarray(g["kernel"]))


def test_config_refuses_stages_outside_qkvo():
    with pytest.raises(ValueError, match="subset of 'qkvo'"):
        POCAConfig(mp_stages="qkx")
    with pytest.raises(ValueError, match="subset of 'qkvo'"):
        dataclasses.replace(POCAConfig(), mp_stages="z")
