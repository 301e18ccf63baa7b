"""The discrete (daisy) update of the port against the JAX trainer, on the CPU.

The same construction and tolerances as tests/test_torch_update.py holds
the dandelion update to (N = 20, E = 3, T = 4, hidden 32, the same flax
weights, rollout and epoch permutations; three minibatches per epoch, the
first chunked 2, 2, 1): the first minibatch's loss to 2e-6 relative and
each gradient to 3e-5 of its largest element; after three epochs, each
parameter within 2.2·num_epochs·lr. What differs here is the discrete
branch: a categorical actor (log_softmax log-probs, one stored action
column, entropy of the logits) and one-hot actions into the critic, whose
state-action embedding is then 5 + 6 wide.
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

E, N, T, HID, A = 3, 20, 4, 32, 6
UPDATE_CFG = dict(horizon=T, num_epochs=3, mini_batch_size=5, buffer_size_hint=0,
                  accum_chunk_groups=2, hidden_dim=HID, lr=3e-4, seed=3)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _synth_rollout(seed, actor_logits):
    """A rollout whose stored log-probs are the actor's own (so the PPO
    ratios start at one and the clip matters only after a step)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    obs = rng.normal(size=(T, E, N, 24)).astype(f)
    actions = rng.integers(0, A, (T, E, N, 1)).astype(f)
    logp = jax.nn.log_softmax(actor_logits(obs.reshape(-1, 24)), -1)
    old = np.take_along_axis(np.asarray(logp), actions.reshape(-1, 1).astype(int), -1)
    return dict(
        obs=obs,
        critic_states=(rng.normal(size=(T, E, N, 5)) * 0.5).astype(f),
        actions=actions,
        log_probs=(old.reshape(T, E, N, 1) + rng.normal(size=(T, E, N, 1)) * 0.2).astype(f),
        rewards=(rng.normal(size=(T, E)) * 0.5).astype(f),
        dones=np.array([[0, 0, 1], [1, 0, 0], [0, 0, 0], [0, 1, 0]], f),
        team_values=(rng.normal(size=(T, E)) * 0.5).astype(f),
        baselines=(rng.normal(size=(T, E, N)) * 0.5).astype(f),
    ), (rng.normal(size=(E,)) * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def update_pair():
    jtrainer = JaxTrainer(JaxEnv(JaxEnvCfg(variant="daisy", num_envs=E)),
                          JaxPOCAConfig(**UPDATE_CFG, fused_tail=False))
    trainer = POCATrainer(DirectionalGateEnv(
        DirectionalGateEnvCfg(variant="daisy", num_envs=E), device="cpu"),
        POCAConfig(**UPDATE_CFG))
    params = jtrainer.train_state.params
    load_flax_params(trainer, params)
    data, bootstrap = _synth_rollout(5, jax.jit(
        lambda o: jtrainer.actor.apply({"params": params["actor"]}, o)))
    key = jax.random.PRNGKey(11)
    perms = np.stack([np.asarray(jax.random.permutation(k, T * E))
                      for k in jax.random.split(key, UPDATE_CFG["num_epochs"])])
    return jtrainer, trainer, params, data, bootstrap, key, perms


def _flax_flat(tree):
    return {f"{net}.{k}": v for net in ("actor", "critic")
            for k, v in flax_to_state_dict(tree[net]).items()}


def test_discrete_trainer_shapes_match_jax(update_pair):
    jtrainer, trainer, *_ = update_pair
    assert (trainer.act_dim, trainer.act_dim_critic) == (jtrainer.act_dim,
                                                         jtrainer.act_dim_critic) == (1, A)
    assert trainer.actor.logits_head.weight.shape == (A, HID)
    assert trainer.critic.obs_act_entity_enc.encoder.layers[0].weight.shape == (HID, 5 + A)
    acts = torch.tensor([[[2.0], [5.0]]])
    np.testing.assert_array_equal(
        trainer._encode_actions_for_critic(acts).numpy(),
        np.asarray(jtrainer._encode_actions_for_critic(jnp.asarray(acts.numpy()))))


def test_discrete_first_minibatch_loss_and_gradients_match_jax(update_pair):
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
        got = {f"{net}.{n}": p.grad for net in ("actor", "critic")
               for n, p in getattr(trainer, net).named_parameters()}
        want = _flax_flat(grads)
        assert got.keys() == want.keys()
        for name, w in want.items():
            w = np.asarray(w)
            scale = max(float(np.abs(w).max()), 1e-3)
            np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=3e-5 * scale,
                                       err_msg=f"gradient of {name}")
        assert float(np.abs(np.asarray(grads["actor"]["logits_head"]["kernel"])).max()) > 0
    finally:
        trainer.optimizer.zero_grad(set_to_none=True)


def test_discrete_update_matches_jax(update_pair):
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


@pytest.mark.parametrize("variant,fused", [("daisy", True), ("lily", False),
                                           ("tulip", True)])
def test_discrete_train_iteration_runs(variant, fused):
    """One ``train_iteration`` per discrete variant and env path on the CPU
    finishes with finite metrics and moves the actor."""
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=2),
                             device="cpu")
    trainer = POCATrainer(env, POCAConfig(hidden_dim=16, horizon=3, mini_batch_size=4,
                                          fused_env_step=fused))
    before = trainer.actor.logits_head.weight.detach().clone()
    st, obs = env.reset(trainer.generator)
    _, obs, _, m = trainer.train_iteration(st, obs, ())
    assert all(np.isfinite(v) for v in m.values()), m
    assert obs.shape == (2, N, env.obs_dim)
    assert not torch.equal(before, trainer.actor.logits_head.weight)
