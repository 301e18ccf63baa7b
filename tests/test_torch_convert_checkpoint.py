"""``scripts/convert_jax_checkpoint.py``: a checkpoint of the JAX package
becomes one the port resumes from, on the CPU.

A JAX trainer (dandelion, N = 20, E = 3, T = 4, hidden 16) takes one
``_update_jit`` so that Adam's moments are not zero, and saves
``poca_final`` with the JAX ``Checkpointer``. The converted directory is
restored into a port trainer. Its params and both moments must equal the
JAX ones exactly after the kernels' transposes, and Adam's ``step`` must
equal optax's ``count``. A further update of both, on the same rollout and
epoch permutations, must agree within 2.2·num_epochs·lr, the bound of
``tests/test_torch_update.py`` (a first Adam step moves a coordinate by
≈ lr·sign(g), and a gradient near 0 can take either sign on the two sides).

A recurrent (cyclamen) checkpoint converts the same way: the LSTM's
``w_ih``, ``w_hh`` and ``bias`` and their Adam moments keep the flax layout
and must equal the JAX ones exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.agents import Checkpointer as JaxCheckpointer
from swarmacb_tpu.agents import POCAConfig as JaxPOCAConfig
from swarmacb_tpu.agents import POCATrainer as JaxTrainer
from swarmacb_tpu.agents.buffer import Rollout as JaxRollout
from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxEnvCfg
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv

from swarmacb_torch.agents import Checkpointer, POCAConfig, POCATrainer, Rollout
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.convert import flax_to_state_dict
from swarmacb_torch.env import DirectionalGateEnv
from torch_scripts import load_script

E, N, T = 3, 20, 4
CFG = dict(horizon=T, num_epochs=3, mini_batch_size=5, buffer_size_hint=0,
           accum_chunk_groups=2, hidden_dim=16, lr=3e-4, seed=3)


def _rollout(seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    data = dict(
        obs=rng.normal(size=(T, E, N, 24)).astype(f),
        critic_states=(rng.normal(size=(T, E, N, 5)) * 0.5).astype(f),
        actions=rng.normal(size=(T, E, N, 2)).astype(f),
        log_probs=rng.uniform(-2.5, -0.5, size=(T, E, N, 2)).astype(f),
        rewards=(rng.normal(size=(T, E)) * 0.5).astype(f),
        dones=np.array([[0, 0, 1], [1, 0, 0], [0, 0, 0], [0, 1, 0]], f),
        team_values=(rng.normal(size=(T, E)) * 0.5).astype(f),
        baselines=(rng.normal(size=(T, E, N)) * 0.5).astype(f))
    return data, (rng.normal(size=(E,)) * 0.5).astype(f)


def _jax_update(jtrainer, seed, key):
    data, bootstrap = _rollout(seed)
    c = jtrainer.cfg
    state, _ = jtrainer._update_jit(
        jtrainer.train_state, JaxRollout(**{k: jnp.asarray(v) for k, v in data.items()}),
        jnp.asarray(bootstrap), jnp.float32(c.lr), jnp.float32(c.clip_eps),
        jnp.float32(c.beta), key)
    jtrainer.train_state = state


def _port_update(trainer, seed, key):
    """The same update on the port, with the JAX update's permutations."""
    data, bootstrap = _rollout(seed)
    perms = np.stack([np.asarray(jax.random.permutation(k, T * E))
                      for k in jax.random.split(key, CFG["num_epochs"])])
    c = trainer.cfg
    trainer._update(Rollout(**{k: torch.from_numpy(v) for k, v in data.items()}),
                    torch.from_numpy(bootstrap), c.lr, c.clip_eps, c.beta,
                    injected_perms=torch.from_numpy(perms))


def _flat(tree):
    return {f"{net}.{k}": v.numpy() for net in ("actor", "critic")
            for k, v in flax_to_state_dict(tree[net]).items()}


def _port_moments(trainer):
    """{name: (step, exp_avg, exp_avg_sq)} of the port's Adam, by name."""
    state = trainer.optimizer.state_dict()["state"]
    names = ([f"actor.{n}" for n, _ in trainer.actor.named_parameters()]
             + [f"critic.{n}" for n, _ in trainer.critic.named_parameters()])
    return {n: (float(state[i]["step"]), state[i]["exp_avg"].numpy(),
                state[i]["exp_avg_sq"].numpy()) for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert")
    jtrainer = JaxTrainer(JaxEnv(JaxEnvCfg(num_envs=E)),
                          JaxPOCAConfig(**CFG, fused_tail=False))
    _jax_update(jtrainer, 1, jax.random.PRNGKey(21))
    jtrainer.global_step, jtrainer.update_count = T * E * N, 1
    src = JaxCheckpointer(root / "jax", keep=2).save(jtrainer, final=True)
    dst = load_script("convert_jax_checkpoint").main([str(src), str(root / "torch" / "poca_final")])
    trainer = POCATrainer(DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=E), device="cpu"),
                          POCAConfig(**{**CFG, "seed": 8}))
    meta = Checkpointer(root / "torch").restore(dst, trainer)
    return jtrainer, trainer, meta


def test_converted_checkpoint_equals_the_jax_state(converted):
    jtrainer, trainer, meta = converted
    assert (meta["global_step"], meta["update_count"]) == (T * E * N, 1)
    assert (trainer.global_step, trainer.update_count) == (T * E * N, 1)
    assert {k: v for k, v in meta.items() if k not in ("global_step", "update_count")} \
        == jtrainer.checkpoint_metadata()
    params = {f"{net}.{k}": v.numpy() for net in ("actor", "critic")
              for k, v in getattr(trainer, net).state_dict().items()}
    want = _flat(jtrainer.train_state.params)
    assert params.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(params[name], w, err_msg=name)
    adam = jtrainer.train_state.opt_state.inner_state[0]
    mu, nu = _flat(adam.mu), _flat(adam.nu)
    moments = _port_moments(trainer)
    assert moments.keys() == want.keys()
    for name, (step, m, v) in moments.items():
        assert step == int(adam.count) == 9, name
        np.testing.assert_array_equal(m, mu[name], err_msg=f"exp_avg of {name}")
        np.testing.assert_array_equal(v, nu[name], err_msg=f"exp_avg_sq of {name}")
    assert np.abs(mu["critic.self_attn.fc_out.weight"]).max() > 0
    w = mu["critic.self_attn.fc_out.weight"]
    assert not np.array_equal(w, w.T), "fc_out's moment must not be symmetric"


def test_a_further_update_agrees_with_jax(converted):
    jtrainer, trainer, _ = converted
    before = _flat(jtrainer.train_state.params)
    key = jax.random.PRNGKey(22)
    _jax_update(jtrainer, 2, key)
    _port_update(trainer, 2, key)
    bound = 2.2 * CFG["num_epochs"] * CFG["lr"]
    want = _flat(jtrainer.train_state.params)
    got = {f"{net}.{k}": v.numpy() for net in ("actor", "critic")
           for k, v in getattr(trainer, net).state_dict().items()}
    moved = 0.0
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=bound, err_msg=name)
        moved = max(moved, float(np.abs(w - before[name]).max()))
    assert moved > bound, "the update moved no parameter past the tolerance"
    assert all(step == 18.0 for step, _, _ in _port_moments(trainer).values())


CYC_CFG = dict(CFG, num_layers=1, recurrent=True, memory_size=8, sequence_length=3)


def _cyclamen_rollout(seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    data, bootstrap = _rollout(seed)
    data.update(obs=rng.normal(size=(T, E, N, 4)).astype(f),
                actions=rng.integers(0, 6, (T, E, N, 1)).astype(f),
                log_probs=rng.uniform(-2.5, -1.0, size=(T, E, N, 1)).astype(f),
                memory_h=(0.5 * rng.normal(size=(T, E, N, 8))).astype(f),
                memory_c=rng.normal(size=(T, E, N, 8)).astype(f))
    return data, bootstrap


def test_recurrent_checkpoint_converts_exactly(tmp_path):
    jtrainer = JaxTrainer(JaxEnv(JaxEnvCfg(variant="cyclamen", num_envs=E)),
                          JaxPOCAConfig(**CYC_CFG, fused_tail=False))
    data, bootstrap = _cyclamen_rollout(4)
    c = jtrainer.cfg
    jtrainer.train_state, _ = jtrainer._update_jit(
        jtrainer.train_state, JaxRollout(**{k: jnp.asarray(v) for k, v in data.items()}),
        jnp.asarray(bootstrap), jnp.float32(c.lr), jnp.float32(c.clip_eps),
        jnp.float32(c.beta), jax.random.PRNGKey(23))
    jtrainer.global_step, jtrainer.update_count = T * E * N, 1
    src = JaxCheckpointer(tmp_path / "jax", keep=2).save(jtrainer, final=True)
    dst = load_script("convert_jax_checkpoint").main([str(src), str(tmp_path / "torch" / "poca_final")])
    trainer = POCATrainer(DirectionalGateEnv(DirectionalGateEnvCfg(variant="cyclamen",
                                                                   num_envs=E), device="cpu"),
                          POCAConfig(**{**CYC_CFG, "seed": 8}))
    meta = Checkpointer(tmp_path / "torch").restore(dst, trainer)
    assert meta["recurrent"] and meta["memory_size"] == 8
    params = {f"{net}.{k}": v.numpy() for net in ("actor", "critic")
              for k, v in getattr(trainer, net).state_dict().items()}
    want = _flat(jtrainer.train_state.params)
    assert params.keys() == want.keys()
    assert {"actor.lstm.w_ih", "actor.lstm.w_hh", "actor.lstm.bias"} <= params.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(params[name], w, err_msg=name)
    adam = jtrainer.train_state.opt_state.inner_state[0]
    mu, nu = _flat(adam.mu), _flat(adam.nu)
    # three epochs of windows {3: [0], 1: [3]}, three windows each: one
    # window a minibatch of length 3 (5 // 3), all three of length 1
    for name, (step, m, v) in _port_moments(trainer).items():
        assert step == int(adam.count) == 12, name
        np.testing.assert_array_equal(m, mu[name], err_msg=f"exp_avg of {name}")
        np.testing.assert_array_equal(v, nu[name], err_msg=f"exp_avg_sq of {name}")
    assert np.abs(mu["actor.lstm.w_hh"]).max() > 0
