"""One minibatch of the POCA update under mixed precision
(``mixed_precision=True``, ``mp_stages="qkvo"``): the port's loss and
gradients against the JAX trainer's, on the CPU, from the same weights
(the actor's from the JAX init, the critic's drawn N(0, 1/fan_in) with
biases N(0, 0.1²)) and the same minibatch, on the default critic branch
(the JAX ``fused_tail=True``, in interpret mode). Both branches share every
bf16 op, which ``tests/test_torch_mixed_precision.py`` holds on each; the
fused attention's float32 gradient is ``tests/test_torch_cf_attention.py``'s.

The JAX loss runs op by op, so that each op rounds where its source says:
under jit, XLA on the CPU may keep float32 where an op rounds to bf16
(it moved this minibatch's loss by 6e-5 relative). Both sides accumulate
two chunks of 2 groups, the JAX trainer's way (trainer.py ``_sgd_step``).

Bounds: the loss and its parts to 2e-6 relative; the gradients of the
actor and of the critic's layers after the attention to 3e-5 of their
tensor's largest element, ``tests/test_torch_update.py``'s float32 bounds;
every other gradient to one bf16 step (2⁻⁸) of max(its largest element,
1e-2), and the bf16 projections' biases to four. Those gradients reach bf16
casts, which flip a rounding wherever flax's and PyTorch's float32
LayerNorms differ by an ulp; and XLA on the CPU sums a bf16 Dense's bias
gradient in bf16 over the chunk's rows, where PyTorch sums in float32 and
rounds once (``tests/test_torch_mixed_precision.py``). The floor covers the
key bias, whose exact gradient is zero (a softmax row's shift).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from swarmacb_tpu.agents import POCAConfig as JaxPOCAConfig
from swarmacb_tpu.agents import POCATrainer as JaxTrainer
from swarmacb_tpu.agents import buffer as jbuf
from swarmacb_tpu.agents.buffer import Rollout as JaxRollout
from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxEnvCfg
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv

from swarmacb_torch.agents import POCAConfig, POCATrainer, Rollout, buffer
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.convert import flax_to_state_dict, load_flax_params
from swarmacb_torch.env import DirectionalGateEnv

from test_torch_mixed_precision import HID, _wide
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

E, N_AG, T = 3, 5, 4
UPDATE_CFG = dict(horizon=T, num_epochs=1, mini_batch_size=4, buffer_size_hint=0,
                  accum_chunk_groups=2, hidden_dim=HID, lr=3e-4, seed=3,
                  mixed_precision=True, mp_stages="qkvo")
BF16_BIASES = tuple(f"critic.self_attn.fc_{s}.bias" for s in ("q", "k", "v", "out"))


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


def test_minibatch_loss_and_gradients_match_jax():
    jtrainer = JaxTrainer(JaxEnv(JaxEnvCfg(num_envs=E, num_agents=N_AG)),
                          JaxPOCAConfig(**UPDATE_CFG, fused_tail=True))
    trainer = POCATrainer(DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=E, num_agents=N_AG),
                                             device="cpu"), POCAConfig(**UPDATE_CFG))
    assert trainer.critic.self_attn.dtypes == dict.fromkeys("qkvo", torch.bfloat16)
    params = dict(jtrainer.train_state.params)
    params["critic"] = _wide(params["critic"], 7)
    load_flax_params(trainer, params)
    data, bootstrap = _synth_rollout(5)
    c = trainer.cfg
    idx = np.random.default_rng(6).permutation(T * E)[:trainer.group_mb]

    rollout = JaxRollout(**{k: jnp.asarray(v) for k, v in data.items()})
    returns, adv = jbuf.compute_advantages(rollout, jnp.asarray(bootstrap), c.gamma, c.lam)
    flat = jtrainer._flatten_buffer(rollout, returns, jbuf.normalize_advantages(adv))
    grad_fn = jax.value_and_grad(jtrainer._feedforward_loss, has_aux=True)
    parts = [grad_fn(params, {k: v[idx[lo:lo + 2]] for k, v in flat.items()},
                     c.clip_eps, c.beta) for lo in (0, 2)]
    grads = jax.tree_util.tree_map(lambda a, b: (0 + a + b) * 0.5, parts[0][1], parts[1][1])
    loss = (float(parts[0][0][0]) + float(parts[1][0][0])) * 0.5
    aux = (np.stack(parts[0][0][1]) + np.stack(parts[1][0][1])) * 0.5

    ours = Rollout(**{k: torch.from_numpy(v) for k, v in data.items()})
    returns_t, adv_t = buffer.compute_advantages(ours, torch.from_numpy(bootstrap),
                                                 c.gamma, c.lam)
    flat_t = trainer._flatten_buffer(ours, returns_t, buffer.normalize_advantages(adv_t))
    assert trainer._grad_chunks(len(idx)) == 2
    total, aux_t = trainer._accumulate_grads(
        {k: v[torch.from_numpy(idx)] for k, v in flat_t.items()}, c.clip_eps, c.beta,
        trainer._feedforward_loss)
    np.testing.assert_allclose(float(total), loss, rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(aux_t.numpy(), aux, rtol=2e-6, atol=1e-7)
    got = {f"{net}.{n}": p.grad for net in ("actor", "critic")
           for n, p in getattr(trainer, net).named_parameters()}
    want = {f"{net}.{k}": v for net in ("actor", "critic")
            for k, v in flax_to_state_dict(grads[net]).items()}
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].dtype == torch.float32, name
        if name.startswith(("actor.", "critic.value_head.", "critic.linear_encoder.")):
            atol = 3e-5 * max(float(np.abs(w).max()), 1e-3)
        else:
            steps = 4 if name in BF16_BIASES else 1
            atol = steps * 2.0 ** -8 * max(float(np.abs(w).max()), 1e-2)
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=atol,
                                   err_msg=f"gradient of {name}")
