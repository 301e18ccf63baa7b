"""The recurrent (cyclamen) update of the port against the JAX trainer, on
the CPU.

The construction and tolerances of tests/test_torch_discrete_update.py:
N = 20, E = 3, hidden 32 with one layer, LSTM memory 16, the same flax
weights, rollout and epoch permutations. The horizon T = 5 with
``sequence_length`` 2 makes two window groups, {2: [0, 2], 1: [4]}: six
windows of two decisions and three of one. ``mini_batch_size`` 10 gives
minibatches of 5 and 1 windows of length 2 (the 5 chunked 2, 2, 1 under
``accum_chunk_groups`` = 4, a tail chunk) and one of the 3 windows of
length 1, so three Adam steps an epoch.

The rollout's stored carry and log-probs come from the JAX actor itself,
stepped through the buffer from a random carry with the carry zeroed after
each done, so that the windows' recomputed log-probs start near the stored
ones (which then get N(0, 0.2²) noise, so that the clip matters).

Held: the first minibatch of each group before any step, loss to 2e-6
relative and each gradient to 3e-5 of its tensor's largest element; after
three epochs, every parameter within 2.2·num_epochs·lr (a first Adam step
moves a coordinate by ≈ lr·sign(g), and a gradient near 0 can take either
sign on the two sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.agents import POCAConfig as JaxPOCAConfig
from swarmacb_tpu.agents import POCATrainer as JaxTrainer
from swarmacb_tpu.agents import buffer as jbuf
from swarmacb_tpu.agents.buffer import Rollout as JaxRollout
from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxEnvCfg
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv

from swarmacb_torch.agents import POCAConfig, POCATrainer, Rollout
from swarmacb_torch.agents import buffer
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.convert import flax_to_state_dict, load_flax_params
from swarmacb_torch.env import DirectionalGateEnv

E, N, T, HID, MEM, A, OBS = 3, 20, 5, 32, 16, 6, 4
UPDATE_CFG = dict(horizon=T, num_epochs=3, mini_batch_size=10, buffer_size_hint=0,
                  accum_chunk_groups=4, hidden_dim=HID, num_layers=1, recurrent=True,
                  memory_size=MEM, sequence_length=2, lr=3e-4, seed=3)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _synth_rollout(seed, jtrainer, params):
    """A cyclamen rollout whose stored carries and log-probs are the JAX
    actor's own along the buffer."""
    rng = np.random.default_rng(seed)
    f = np.float32
    obs = rng.normal(size=(T, E, N, OBS)).astype(f)
    actions = rng.integers(0, A, (T, E, N, 1)).astype(f)
    dones = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1], [0, 1, 0], [0, 0, 0]], f)
    step = jax.jit(lambda o, c: jtrainer.actor.apply({"params": params["actor"]}, o, c,
                                                      method=jtrainer.actor.step))
    carry = (jnp.asarray(0.5 * rng.normal(size=(E * N, MEM)), jnp.float32),
             jnp.asarray(rng.normal(size=(E * N, MEM)), jnp.float32))
    mem_h, mem_c, logp = [], [], []
    for t in range(T):
        mem_h.append(np.asarray(carry[0]).reshape(E, N, MEM))
        mem_c.append(np.asarray(carry[1]).reshape(E, N, MEM))
        logits, carry = step(jnp.asarray(obs[t].reshape(E * N, OBS)), carry)
        lp = jax.nn.log_softmax(logits, -1)
        logp.append(np.take_along_axis(np.asarray(lp), actions[t].reshape(-1, 1).astype(int),
                                       -1).reshape(E, N, 1))
        keep = jnp.asarray(np.repeat(1.0 - dones[t], N)[:, None], jnp.float32)
        carry = (carry[0] * keep, carry[1] * keep)
    return dict(
        obs=obs,
        critic_states=(rng.normal(size=(T, E, N, 5)) * 0.5).astype(f),
        actions=actions,
        log_probs=(np.stack(logp) + rng.normal(size=(T, E, N, 1)) * 0.2).astype(f),
        rewards=(rng.normal(size=(T, E)) * 0.5).astype(f),
        dones=dones,
        team_values=(rng.normal(size=(T, E)) * 0.5).astype(f),
        baselines=(rng.normal(size=(T, E, N)) * 0.5).astype(f),
        memory_h=np.stack(mem_h), memory_c=np.stack(mem_c),
    ), (rng.normal(size=(E,)) * 0.5).astype(f)


def _jax_perms(key, groups):
    """The JAX recurrent update's permutations (trainer.py:1013-1020): per
    epoch, one split of the epoch key per group in sorted(L) order."""
    perms = []
    for epoch_key in jax.random.split(key, UPDATE_CFG["num_epochs"]):
        per = {}
        for L, starts in sorted(groups.items()):
            epoch_key, k_perm = jax.random.split(epoch_key)
            per[L] = torch.from_numpy(np.array(jax.random.permutation(
                k_perm, len(starts) * E)))
        perms.append(per)
    return perms


@pytest.fixture(scope="module")
def update_pair():
    jtrainer = JaxTrainer(JaxEnv(JaxEnvCfg(variant="cyclamen", num_envs=E)),
                          JaxPOCAConfig(**UPDATE_CFG, fused_tail=False))
    trainer = POCATrainer(DirectionalGateEnv(
        DirectionalGateEnvCfg(variant="cyclamen", num_envs=E), device="cpu"),
        POCAConfig(**UPDATE_CFG))
    params = jtrainer.train_state.params
    load_flax_params(trainer, params)
    data, bootstrap = _synth_rollout(5, jtrainer, params)
    key = jax.random.PRNGKey(11)
    return jtrainer, trainer, params, data, bootstrap, key


def _flax_flat(tree):
    return {f"{net}.{k}": v for net in ("actor", "critic")
            for k, v in flax_to_state_dict(tree[net]).items()}


def test_recurrent_layout_matches_jax(update_pair):
    jtrainer, trainer, *_ = update_pair
    assert trainer._window_groups() == jtrainer._window_groups() == {2: [0, 2], 1: [4]}
    assert trainer.group_mb == jtrainer.group_mb == 10
    # five windows of two decisions: chunks of 2, 2 and a tail of 1
    assert trainer._chunk_rows(5, 2) == jtrainer._chunk_rows(5, 2) == 2
    assert trainer._grad_chunks(5, 2) == jtrainer._grad_chunks(5, 2) == 3
    assert trainer._grad_chunks(3, 1) == jtrainer._grad_chunks(3, 1) == 1
    assert trainer.actor.lstm.w_ih.shape == (HID, 4 * MEM)


def test_window_batches_match_jax(update_pair):
    jtrainer, trainer, _, data, bootstrap, _ = update_pair
    c = trainer.cfg
    jroll = JaxRollout(**{k: jnp.asarray(v) for k, v in data.items()})
    returns, adv = jbuf.compute_advantages(jroll, jnp.asarray(bootstrap), c.gamma, c.lam)
    want = jtrainer._window_batches(jroll, returns, adv)
    ours = Rollout(**{k: _t(v) for k, v in data.items()})
    returns_t, adv_t = buffer.compute_advantages(ours, _t(bootstrap), c.gamma, c.lam)
    got = trainer._window_batches(ours, returns_t, adv_t)
    assert got.keys() == want.keys()
    for L in want:
        assert got[L].keys() == want[L].keys()
        for name, w in want[L].items():
            np.testing.assert_allclose(got[L][name].numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{L}: {name}")


@pytest.mark.parametrize("L,size", [(1, 3), (2, 5)])
def test_recurrent_first_minibatch_loss_and_gradients_match_jax(update_pair, L, size):
    """The first minibatch of each group, from the JAX update's first
    permutation of it: the 3 windows of length 1 in one pass, 5 windows of
    length 2 in chunks of 2, 2 and 1."""
    jtrainer, trainer, params, data, bootstrap, key = update_pair
    c = trainer.cfg
    jroll = JaxRollout(**{k: jnp.asarray(v) for k, v in data.items()})
    returns, adv = jbuf.compute_advantages(jroll, jnp.asarray(bootstrap), c.gamma, c.lam)
    windows = jtrainer._window_batches(jroll, returns, jbuf.normalize_advantages(adv))[L]
    idx = _jax_perms(key, trainer._window_groups())[0][L][:size].numpy()
    grad_fn = jax.jit(jax.value_and_grad(jtrainer._recurrent_loss, has_aux=True))
    (loss, aux), grads = grad_fn(params, {k: v[idx] for k, v in windows.items()},
                                 c.clip_eps, c.beta)

    ours = Rollout(**{k: _t(v) for k, v in data.items()})
    returns_t, adv_t = buffer.compute_advantages(ours, _t(bootstrap), c.gamma, c.lam)
    windows_t = trainer._window_batches(ours, returns_t,
                                        buffer.normalize_advantages(adv_t))[L]
    trainer.optimizer.zero_grad(set_to_none=True)
    total, aux_t = trainer._accumulate_grads(
        {k: v[torch.from_numpy(idx)] for k, v in windows_t.items()}, c.clip_eps, c.beta,
        trainer._recurrent_loss, groups_per_row=L)
    try:
        np.testing.assert_allclose(float(total), float(loss), rtol=2e-6, atol=1e-7)
        np.testing.assert_allclose(aux_t.numpy(), np.array([float(a) for a in aux]),
                                   rtol=2e-6, atol=1e-7)
        got = {f"{net}.{n}": p.grad for net in ("actor", "critic")
               for n, p in getattr(trainer, net).named_parameters()}
        want = _flax_flat(grads)
        assert got.keys() == want.keys()
        for name, w in want.items():
            w = np.asarray(w)
            scale = max(float(np.abs(w).max()), 1e-3)
            np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=3e-5 * scale,
                                       err_msg=f"gradient of {name}")
        assert float(np.abs(np.asarray(grads["actor"]["lstm"]["w_hh"])).max()) > 0
    finally:
        trainer.optimizer.zero_grad(set_to_none=True)


def test_recurrent_update_matches_jax(update_pair):
    jtrainer, trainer, _, data, bootstrap, key = update_pair
    c = trainer.cfg
    jroll = JaxRollout(**{k: jnp.asarray(v) for k, v in data.items()})
    new_state, jmetrics = jtrainer._update_jit(
        jtrainer.train_state, jroll, jnp.asarray(bootstrap), jnp.float32(c.lr),
        jnp.float32(c.clip_eps), jnp.float32(c.beta), key)
    steps = []
    sgd_step = trainer._sgd_step
    trainer._sgd_step = lambda batch, *a: steps.append(batch["obs"].shape[:2]) or sgd_step(
        batch, *a)
    try:
        metrics = trainer._update(Rollout(**{k: _t(v) for k, v in data.items()}),
                                  _t(bootstrap), c.lr, c.clip_eps, c.beta,
                                  injected_perms=_jax_perms(key, trainer._window_groups()))
    finally:
        del trainer._sgd_step
    assert steps == [(3, 1), (5, 2), (1, 2)] * c.num_epochs
    bound = 2.2 * c.num_epochs * c.lr
    for k in ("policy_loss", "value_loss", "baseline_loss", "entropy"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-2, atol=1e-3, err_msg=k)
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


def test_recurrent_train_iteration_threads_the_carry():
    """``train_iteration`` on the CPU on both env paths: finite metrics, the
    actor moved, and the carry it returns is the rollout's last one."""
    for fused in (False, True):
        env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="cyclamen", num_envs=2),
                                 device="cpu")
        trainer = POCATrainer(env, POCAConfig(hidden_dim=16, num_layers=1, horizon=5,
                                              mini_batch_size=4, recurrent=True,
                                              memory_size=8, sequence_length=2,
                                              fused_env_step=fused))
        before = trainer.actor.lstm.w_hh.detach().clone()
        st, obs = env.reset(trainer.generator)
        carry = trainer.init_actor_carry()
        assert [tuple(x.shape) for x in carry] == [(2 * N, 8)] * 2 and not carry[0].any()
        _, obs, carry, m = trainer.train_iteration(st, obs, carry)
        assert all(np.isfinite(v) for v in m.values()), m
        assert carry[0].shape == (2 * N, 8) and carry[0].any()
        assert not torch.equal(before, trainer.actor.lstm.w_hh)


def test_recurrent_needs_discrete_actions():
    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=1), device="cpu")
    with pytest.raises(ValueError, match="only implemented for discrete actions"):
        POCATrainer(env, POCAConfig(hidden_dim=8, recurrent=True))
