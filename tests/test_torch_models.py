"""The port's networks with converted flax weights, against the flax
modules of the JAX package, on the CPU.

Float tolerance: rtol 1e-5, atol 2e-5. Both sides run float32 with the same
formulas; flax's LayerNorm takes the variance as E[x²] − E[x]², PyTorch's
two-pass, which moves the normalised values by ~1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.models.networks import Actor as FlaxActor
from swarmacb_tpu.models.networks import POCACritic as FlaxCritic
from swarmacb_tpu.ops import baseline_tail as bt

from swarmacb_torch import ops
from swarmacb_torch.convert import flax_to_state_dict
from swarmacb_torch.models import Actor, POCACritic

RTOL, ATOL = 1e-5, 2e-5
H_DIM, N, HEADS = 32, 6, 4


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _torch_module(cls, params, *args, **kw):
    with torch.device("meta"):
        m = cls(*args, **kw)
    m.to_empty(device="cpu")
    m.load_state_dict(flax_to_state_dict(params), strict=True)
    return m


@pytest.fixture(scope="module")
def critic_pair():
    kw = dict(state_dim=5, act_dim=2, num_agents=N, hidden=H_DIM,
              num_heads=HEADS, num_layers=2)
    flax_plain = FlaxCritic(**kw)
    params = flax_plain.init(jax.random.PRNGKey(3), jnp.zeros((2, N, 5)),
                             jnp.zeros((2, N, 2)))["params"]
    # perturb the zero-initialised biases so that a wrong bias mapping shows
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    leaves = [l + 0.05 * rng.normal(size=l.shape).astype(np.float32)
              for l in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    torch_critic = _torch_module(POCACritic, params, **kw)
    return flax_plain, FlaxCritic(**kw, fused_tail=True), params, torch_critic


def _critic_inputs(B=4, seed=1):
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(B, N, 5)).astype(np.float32)
    actions = rng.normal(size=(B, N, 2)).astype(np.float32)
    return states, actions


def test_actor_matches_flax():
    flax_actor = FlaxActor(act_dim=2, hidden=H_DIM, num_layers=2)
    params = flax_actor.init(jax.random.PRNGKey(0), jnp.zeros((2, 24)))["params"]
    params = jax.tree_util.tree_map(lambda x: x + 0.1, params)  # nonzero biases
    actor = _torch_module(Actor, params, 24, 2, hidden=H_DIM, num_layers=2)
    obs = np.random.default_rng(2).normal(size=(7, 24)).astype(np.float32)
    noise = np.random.default_rng(3).normal(size=(7, 2)).astype(np.float32)
    mu, std = actor(torch.from_numpy(obs))
    jmu, jstd = flax_actor.apply({"params": params}, jnp.asarray(obs))
    _close(mu, jmu)
    _close(std, jstd)
    act = Actor.sample(mu, std, noise=torch.from_numpy(noise))
    jact = jmu + jstd * noise
    _close(act, jact)
    _close(Actor.log_prob(mu, std, act), FlaxActor.log_prob(jmu, jstd, jact))
    _close(Actor.entropy(std), FlaxActor.entropy(jstd))


def test_critic_pass_matches_flax(critic_pair):
    flax_plain, _, params, critic = critic_pair
    states, _ = _critic_inputs()
    with torch.no_grad():
        got = critic.critic_pass(torch.from_numpy(states))
    want = flax_plain.apply({"params": params}, jnp.asarray(states),
                            method=flax_plain.critic_pass)
    _close(got, want)


@pytest.mark.parametrize("tail", ["xla", "pallas_interpret"])
def test_all_baselines_matches_flax(critic_pair, tail):
    """Against both JAX tails: the XLA composition and the Pallas kernel
    (interpret mode on the CPU)."""
    flax_plain, flax_fused, params, critic = critic_pair
    module = flax_plain if tail == "xla" else flax_fused
    states, actions = _critic_inputs()
    with torch.no_grad():
        got = critic.all_baselines(torch.from_numpy(states),
                                   torch.from_numpy(actions))
    want = module.apply({"params": params}, jnp.asarray(states),
                        jnp.asarray(actions), method=module.all_baselines)
    _close(got, want)


def test_baseline_matches_flax_and_all_baselines(critic_pair):
    """The single-agent baseline b_i (reference construction) equals the
    port's all_baselines column i and the flax baseline."""
    flax_plain, _, params, critic = critic_pair
    states, actions = _critic_inputs()
    i = 2
    others = [j for j in range(N) if j != i]
    args = (states[:, i], states[:, others], actions[:, others])
    with torch.no_grad():
        got = critic.baseline(*(torch.from_numpy(a) for a in args))
        allb = critic.all_baselines(torch.from_numpy(states),
                                    torch.from_numpy(actions))
    want = flax_plain.apply({"params": params}, *(jnp.asarray(a) for a in args),
                            method=flax_plain.baseline)
    _close(got, want)
    _close(got[:, 0], allb[:, i], atol=1e-5)


def test_converter_keys_and_transposes(critic_pair):
    """Every flax leaf lands on a port parameter; kernels are transposed —
    fc_out is square, so only the values can show a missing transpose."""
    _, _, params, critic = critic_pair
    sd = flax_to_state_dict(params)
    assert set(sd) == set(critic.state_dict())
    kern = np.asarray(params["self_attn"]["fc_out"]["kernel"])
    np.testing.assert_array_equal(sd["self_attn.fc_out.weight"].numpy(), kern.T)
    assert not np.array_equal(kern, kern.T)


def _tail_inputs(B, N_, H, h, seed):
    rng = np.random.default_rng(seed)
    HM = H * N_
    return dict(
        attn_lhs=(rng.uniform(size=(B, N_ * N_, HM)) / HM).astype(np.float32),
        attn_mI=(rng.uniform(size=(B, H, N_, N_)) / N_).astype(np.float32),
        wa=(rng.normal(size=(B, HM, h)) * 0.3).astype(np.float32),
        dws=(rng.normal(size=(B, H, N_, h)) * 0.2).astype(np.float32),
        x_a=rng.normal(size=(B, N_, h)).astype(np.float32),
        delta=(rng.normal(size=(B, N_, h)) * 0.5).astype(np.float32),
        bias=(rng.normal(size=(h,)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("B,N_,h", [(6, 5, 32), (8, 5, 128), (3, 4, 64)])
def test_plain_fused_tail_matches_jax(B, N_, h):
    """The kernel's plain version (a CPU tensor selects it) against
    bt.tail_reference at the shapes of tests/test_baseline_tail.py, which
    holds the Pallas kernel against the same reference; the Pallas kernel
    against the port is test_all_baselines_matches_flax[pallas_interpret]."""
    inp = _tail_inputs(B, N_, 4, h, seed=B + h)
    ops.reset_launches()
    got = ops.fused_tail(*(torch.from_numpy(v) for v in inp.values()), N_)
    assert ops.launches["fused_tail"] == 0
    ref = bt.tail_reference(**{k: jnp.asarray(v) for k, v in inp.items()}, N=N_)
    _close(got, ref, rtol=1e-5, atol=1e-5)
