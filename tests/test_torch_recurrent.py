"""The recurrent actor of the port (cyclamen) against the JAX package's
flax modules, on the CPU.

- ``LSTMCell`` and ``RecurrentDiscreteActor.step`` / ``forward_sequence``
  against ``swarmacb_tpu.models.networks`` on the same weights, carried
  across by ``swarmacb_torch.convert`` (the flax tree's biases perturbed so
  that a wrong bias mapping shows), with a non-zero starting carry and
  dones in the middle of the sequence: logits and carries within 2e-6
  (float32 products and gate sums in the same order, through 7 steps).
- The initializers: ``w_ih`` within the xavier bound √(6/(in + 4M)) and
  spread over it, ``w_hh`` with orthonormal rows (w_hh @ w_hhᵀ = I within
  1e-5), the head's bias zero.
- ``_window_groups`` equal to the JAX trainer's for several (T, L).
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.agents import POCAConfig as JaxPOCAConfig
from swarmacb_tpu.agents import POCATrainer as JaxTrainer
from swarmacb_tpu.models.networks import LSTMCell as FlaxLSTMCell
from swarmacb_tpu.models.networks import RecurrentDiscreteActor as FlaxRecurrentActor

from swarmacb_torch.agents import POCAConfig, POCATrainer
from swarmacb_torch.convert import flax_to_state_dict
from swarmacb_torch.models import LSTMCell, RecurrentDiscreteActor

OBS, HID, MEM, A = 4, 16, 8, 6
B, T = 5, 7
TOL = 2e-6


def _perturbed(params, seed):
    """The flax tree with every leaf moved by N(0, 0.05²): the zero biases
    then differ, so a wrong bias mapping shows."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [l + 0.05 * rng.normal(size=l.shape).astype(np.float32) for l in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _torch_module(cls, params, *args, **kw):
    with torch.device("meta"):
        m = cls(*args, **kw)
    m.to_empty(device="cpu")
    m.load_state_dict(flax_to_state_dict(params), strict=True)
    return m


def _close(got, want, atol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(B, T, OBS)).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(B, MEM))).astype(np.float32)
    c0 = rng.normal(size=(B, MEM)).astype(np.float32)
    dones = np.zeros((B, T), np.float32)
    dones[0, 2] = dones[1, 4] = dones[1, 5] = dones[3, T - 1] = 1.0
    return obs, (h0, c0), dones


@pytest.fixture(scope="module")
def actor_pair():
    flax_actor = FlaxRecurrentActor(num_actions=A, hidden=HID, num_layers=1, memory=MEM)
    carry0 = (jnp.zeros((2, MEM)), jnp.zeros((2, MEM)))
    params = flax_actor.init(jax.random.PRNGKey(4), jnp.zeros((2, OBS)), carry0,
                             method=flax_actor.step)["params"]
    params = _perturbed(params, 2)
    actor = _torch_module(RecurrentDiscreteActor, params, OBS, A, hidden=HID,
                          num_layers=1, memory=MEM)
    return flax_actor, params, actor


def test_lstm_cell_matches_flax(inputs):
    obs, (h0, c0), _ = inputs
    x = obs[:, 0]
    cell = FlaxLSTMCell(MEM)
    params = _perturbed(cell.init(jax.random.PRNGKey(5), (jnp.asarray(h0), jnp.asarray(c0)),
                                  jnp.asarray(x))["params"], 3)
    (h_want, c_want), out_want = cell.apply({"params": params},
                                            (jnp.asarray(h0), jnp.asarray(c0)), jnp.asarray(x))
    ours = _torch_module(LSTMCell, params, OBS, MEM)
    assert ours.w_ih.shape == (OBS, 4 * MEM) and ours.w_hh.shape == (MEM, 4 * MEM)
    np.testing.assert_array_equal(ours.w_ih.detach().numpy(), np.asarray(params["w_ih"]))
    with torch.no_grad():
        (h, c), out = ours((torch.from_numpy(h0), torch.from_numpy(c0)), torch.from_numpy(x))
    _close(h, h_want)
    _close(c, c_want)
    _close(out, out_want)


def test_recurrent_actor_tree_converts_both_ways(actor_pair):
    """Every flax leaf has its port parameter and no port parameter is left
    over (strict load); the LSTM leaves keep the flax layout."""
    _, params, actor = actor_pair
    sd = flax_to_state_dict(params)
    assert set(sd) == set(actor.state_dict()) == {
        "net.layers.0.weight", "net.layers.0.bias", "lstm.w_ih", "lstm.w_hh",
        "lstm.bias", "logits_head.weight", "logits_head.bias"}
    np.testing.assert_array_equal(sd["lstm.w_hh"].numpy(), np.asarray(params["lstm"]["w_hh"]))
    np.testing.assert_array_equal(sd["logits_head.weight"].numpy(),
                                  np.asarray(params["logits_head"]["kernel"]).T)


def test_recurrent_actor_step_matches_flax(actor_pair, inputs):
    flax_actor, params, actor = actor_pair
    obs, (h0, c0), _ = inputs
    carry_j = (jnp.asarray(h0), jnp.asarray(c0))
    carry_t = (torch.from_numpy(h0), torch.from_numpy(c0))
    for t in range(3):
        logits_j, carry_j = flax_actor.apply({"params": params}, jnp.asarray(obs[:, t]),
                                             carry_j, method=flax_actor.step)
        with torch.no_grad():
            logits_t, carry_t = actor.step(torch.from_numpy(obs[:, t]), carry_t)
        _close(logits_t, logits_j)
        _close(carry_t[0], carry_j[0])
        _close(carry_t[1], carry_j[1])


@pytest.mark.parametrize("with_dones", [True, False])
def test_forward_sequence_matches_flax(actor_pair, inputs, with_dones):
    flax_actor, params, actor = actor_pair
    obs, (h0, c0), dones = inputs
    d_j = jnp.asarray(dones) if with_dones else None
    d_t = torch.from_numpy(dones) if with_dones else None
    logits_j, (h_j, c_j) = flax_actor.apply(
        {"params": params}, jnp.asarray(obs), (jnp.asarray(h0), jnp.asarray(c0)), d_j,
        method=flax_actor.forward_sequence)
    with torch.no_grad():
        logits_t, (h_t, c_t) = actor.forward_sequence(
            torch.from_numpy(obs), (torch.from_numpy(h0), torch.from_numpy(c0)), d_t)
    _close(logits_t, logits_j)
    _close(h_t, h_j)
    _close(c_t, c_j)
    if with_dones:
        # row 3 ended on its last step: its returned carry is zero
        assert not h_t[3].any() and not c_t[3].any()


def test_forward_sequence_zeroes_the_carry_after_a_done(actor_pair, inputs):
    """Stepping the sequence by hand with the carry zeroed after row 0's
    done at t = 2 gives forward_sequence's logits."""
    _, _, actor = actor_pair
    obs, (h0, c0), dones = inputs
    with torch.no_grad():
        seq, _ = actor.forward_sequence(torch.from_numpy(obs),
                                        (torch.from_numpy(h0), torch.from_numpy(c0)),
                                        torch.from_numpy(dones))
        carry = (torch.from_numpy(h0[:1]), torch.from_numpy(c0[:1]))
        for t in range(T):
            logits, carry = actor.step(torch.from_numpy(obs[:1, t]), carry)
            _close(logits[0], seq[0, t].numpy())
            if dones[0, t]:
                carry = actor.initial_state(1)


def test_lstm_initializers():
    in_dim, mem = 128, 128
    with torch.device("meta"):
        actor = RecurrentDiscreteActor(OBS, A, hidden=in_dim, num_layers=1, memory=mem)
    actor.to_empty(device="cpu")
    actor.init_weights(torch.Generator().manual_seed(0))
    w_ih = actor.lstm.w_ih.detach()
    bound = math.sqrt(6.0 / (in_dim + 4 * mem))
    assert w_ih.shape == (in_dim, 4 * mem)
    assert float(w_ih.abs().max()) <= bound
    assert float(w_ih.abs().max()) > 0.99 * bound
    # U(±b) has variance b²/3
    assert abs(float(w_ih.var()) / (bound ** 2 / 3) - 1.0) < 0.05
    w_hh = actor.lstm.w_hh.detach().double()
    assert w_hh.shape == (mem, 4 * mem)
    np.testing.assert_allclose((w_hh @ w_hh.T).numpy(), np.eye(mem), rtol=0, atol=1e-5)
    assert not actor.lstm.bias.detach().any() and not actor.logits_head.bias.detach().any()
    # the head's kaiming normal × 0.2: std 0.2/√M
    std = float(actor.logits_head.weight.detach().std())
    assert abs(std / (0.2 / math.sqrt(mem)) - 1.0) < 0.15


@pytest.mark.parametrize("horizon,seq_len", [(6, 4), (10, 4), (200, 64), (1000, 64),
                                             (4, 64)])
def test_window_groups_match_jax(horizon, seq_len):
    ours = POCATrainer._window_groups(SimpleNamespace(
        cfg=POCAConfig(horizon=horizon, sequence_length=seq_len)))
    theirs = JaxTrainer._window_groups(SimpleNamespace(
        cfg=JaxPOCAConfig(horizon=horizon, sequence_length=seq_len)))
    assert ours == theirs
    starts = sorted(s for group in ours.values() for s in group)
    assert starts == list(range(0, horizon, min(seq_len, horizon)))
    assert sum(L * len(group) for L, group in ours.items()) == horizon
