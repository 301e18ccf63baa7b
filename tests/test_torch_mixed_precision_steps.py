"""Six Adam steps of the POCA update under mixed precision
(``mixed_precision=True``, ``mp_stages="qkvo"``) against the JAX trainer, on
the CPU: the multi-step check that ``tests/test_torch_mixed_precision_update.py``
(one minibatch) leaves open.

The same weights (the actor's from the JAX init, the critic's drawn
N(0, 1/fan_in) with biases N(0, 0.1²)), the same buffer and the same six
minibatches (two epochs of three, from one seed); each step's JAX gradient
comes from the JAX trainer's ``_feedforward_loss`` on the default critic
branch (``fused_tail=True``, the Pallas tail in interpret mode, as that
file takes it) over the trainer's two chunks of 2 groups, and is applied
with the JAX trainer's own optax Adam; the port takes
``POCATrainer._sgd_step``. That file takes the JAX loss op by op, since
under jit XLA on the CPU keeps float32 where an op rounds to bf16; op by
op, six steps would take minutes (~17 s a chunk). So the JAX gradient is
compiled with XLA's ``xla_allow_excess_precision`` off, which rounds every
op where its source says: on step 0's first chunk it agreed with the op-by-op
loss and gradients to a few float32 ulps, where jit with the default option
is ~1e-5 off in the loss. Step 0's losses are held to the port's at that
file's 2e-6, which the default option would miss.

Bounds. 2.2·steps·lr, stated before the first run, holds every parameter
after the six steps, as ``chip_smoke.py``'s phase 3h holds the bf16 update
(card against CPU). It cannot fail: one Adam step moves a coordinate by
about lr at most, so any two runs stay within it. The checks that can fail:

- each step's losses at the port's own parameters, the JAX loss evaluated
  there, to 2e-6 relative at step 0 and to 2e-5 after it (measured: 5.5e-6
  at step 2, one bf16 rounding that flax's and PyTorch's float32
  LayerNorms put on either side of a tie). A port that keeps float32 in
  any one of the q, k, v, o projections after step 0 misses this by
  1.5e-4 to 9.4e-4;
- each step's losses against the JAX trainer's own, to 1e-3 relative
  (measured: 1.9e-4 in the value loss, from the key bias below). A flipped
  gradient sign misses it by 2.9e-3 at step 1;
- every parameter but the key bias within 0.25·lr of the JAX trainer's
  (measured: 0.089·lr, ``fc_q.weight``; a flipped sign puts them 11–12·lr
  apart). The key bias's exact gradient is zero (a softmax row's shift), so
  it takes a full Adam step on its gradient's rounding, in either sign
  (measured 8.9·lr), and only 2.2·steps·lr holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from swarmacb_tpu.agents import POCAConfig as JaxPOCAConfig
from swarmacb_tpu.agents import POCATrainer as JaxTrainer
from swarmacb_tpu.agents import buffer as jbuf
from swarmacb_tpu.agents.buffer import Rollout as JaxRollout
from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxEnvCfg
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv

from swarmacb_torch.agents import POCAConfig, POCATrainer, Rollout, buffer
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.convert import _torch_key, flax_to_state_dict, load_flax_params
from swarmacb_torch.env import DirectionalGateEnv

from test_torch_mixed_precision import _wide
from test_torch_mixed_precision_update import E, N_AG, T, UPDATE_CFG, _synth_rollout
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

STEPS = 6
SAME_RTOL = 2e-5
LOSS_RTOL = 1e-3
PARAM_FRAC = 0.25
KEY_BIAS = "critic.self_attn.fc_k.bias"


def _rounded(fn):
    """``fn`` compiled with ``xla_allow_excess_precision`` off, once per
    batch size: every op rounds to its own dtype, as op by op."""
    compiled = {}

    def call(params, batch, *args):
        rows = len(next(iter(batch.values())))
        if rows not in compiled:
            compiled[rows] = jax.jit(fn).lower(params, batch, *args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled[rows](params, batch, *args)
    return call


def _port_as_flax(trainer, like):
    """The port's actor and critic as a flax tree shaped like ``like``
    (``convert.flax_to_state_dict`` the other way)."""
    sd = {net: getattr(trainer, net).state_dict() for net in ("actor", "critic")}

    def leaf(path, _):
        name, is_kernel = _torch_key([k.key for k in path[1:]])
        a = sd[path[0].key][name].detach().numpy()
        return jnp.asarray(a.T if is_kernel else a)
    return jax.tree_util.tree_map_with_path(leaf, like)


def test_six_bf16_adam_steps_stay_within_the_bound():
    jtrainer = JaxTrainer(JaxEnv(JaxEnvCfg(num_envs=E, num_agents=N_AG)),
                          JaxPOCAConfig(**UPDATE_CFG, fused_tail=True))
    trainer = POCATrainer(DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=E, num_agents=N_AG),
                                             device="cpu"), POCAConfig(**UPDATE_CFG))
    assert trainer.critic.self_attn.dtypes == dict.fromkeys("qkvo", torch.bfloat16)
    params = dict(jtrainer.train_state.params)
    params["critic"] = _wide(params["critic"], 7)
    load_flax_params(trainer, params)
    start = {f"{net}.{n}": p.detach().clone() for net in ("actor", "critic")
             for n, p in getattr(trainer, net).named_parameters()}
    c = trainer.cfg
    data, bootstrap = _synth_rollout(5)
    rng = np.random.default_rng(6)
    mb = trainer.group_mb
    order = np.concatenate([rng.permutation(T * E) for _ in range(2)])
    minibatches = [order[k * mb:(k + 1) * mb] for k in range(STEPS)]

    rollout = JaxRollout(**{k: jnp.asarray(v) for k, v in data.items()})
    returns, adv = jbuf.compute_advantages(rollout, jnp.asarray(bootstrap), c.gamma, c.lam)
    flat = jtrainer._flatten_buffer(rollout, returns, jbuf.normalize_advantages(adv))
    grad_fn = jax.value_and_grad(jtrainer._feedforward_loss, has_aux=True)
    rounded = _rounded(grad_fn)
    opt_state = jtrainer.tx.init(params)

    ours = Rollout(**{k: torch.from_numpy(v) for k, v in data.items()})
    returns_t, adv_t = buffer.compute_advantages(ours, torch.from_numpy(bootstrap),
                                                 c.gamma, c.lam)
    flat_t = trainer._flatten_buffer(ours, returns_t, buffer.normalize_advantages(adv_t))
    assert trainer._grad_chunks(mb) == 2

    def jax_loss(at, chunks):
        parts = [rounded(at, chunk, c.clip_eps, c.beta) for chunk in chunks]
        grads = jax.tree_util.tree_map(lambda a, b: (0 + a + b) * 0.5, parts[0][1], parts[1][1])
        return grads, (np.stack(parts[0][0][1]) + np.stack(parts[1][0][1])) * 0.5

    losses = []
    for step, idx in enumerate(minibatches):
        chunks = [{k: v[idx[lo:lo + 2]] for k, v in flat.items()} for lo in (0, 2)]
        grads, aux = jax_loss(params, chunks)
        # the JAX loss at the port's own parameters, which part from the JAX
        # trainer's after step 0
        aux_here = jax_loss(_port_as_flax(trainer, params), chunks)[1] if step else aux
        updates, opt_state = jtrainer.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        aux_t = trainer._sgd_step({k: v[torch.from_numpy(idx)] for k, v in flat_t.items()},
                                  c.clip_eps, c.beta, trainer._feedforward_loss).numpy()
        # the same parameters: ``test_torch_mixed_precision_update``'s bound at step 0
        np.testing.assert_allclose(aux_t, aux_here, rtol=SAME_RTOL if step else 2e-6, atol=1e-7,
                                   err_msg=f"step {step}'s losses at the port's parameters")
        losses.append((aux_t, aux))

    for step, (got_aux, want_aux) in enumerate(losses):
        np.testing.assert_allclose(got_aux, want_aux, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=f"step {step}'s losses against the JAX trainer's")

    bound = 2.2 * STEPS * c.lr
    want = {f"{net}.{k}": np.asarray(v) for net in ("actor", "critic")
            for k, v in flax_to_state_dict(params[net]).items()}
    got = {f"{net}.{n}": p.detach() for net in ("actor", "critic")
           for n, p in getattr(trainer, net).named_parameters()}
    assert got.keys() == want.keys()
    worst, moved = 0.0, 0.0
    for name, w in want.items():
        diff = float(np.abs(got[name].numpy() - w).max())
        moved = max(moved, float((got[name] - start[name]).abs().max()))
        assert diff <= bound, (
            f"parameter {name}: max|Δ| {diff:.3e} past 2.2·steps·lr = {bound:.3e}")
        if name != KEY_BIAS:
            worst = max(worst, diff)
            assert diff <= PARAM_FRAC * c.lr, (
                f"parameter {name}: max|Δ| {diff / c.lr:.3e}·lr past {PARAM_FRAC}·lr")
    print(f"six bf16 Adam steps: parameters but the key bias within {worst / c.lr:.3e}·lr "
          f"of the JAX trainer's; the largest move {moved:.3e}")
    assert moved > STEPS * c.lr * 0.5, "the steps moved no parameter — weak test"
