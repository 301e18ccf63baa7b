"""A rollout and a minibatch update of dandelion at ``hidden_dim=1024``
(E = 2, T = 4) on the CPU, the port against the JAX trainer, on one critic
path: the helpers of ``test_torch_wide_critic_update.py`` (the default,
tail path) and ``test_torch_wide_critic_fused_update.py``
(``fused_attention``).

The port's rollout against the JAX trainer's actor, critic and env taken
step by step as its ``_rollout_fn`` does, with the same weights (the
port's init, read into the JAX trainer), noise and spawns (the tolerances of ``tests/test_torch_rollout.py``); the first
minibatch's loss and gradients, on a rollout buffer made from a seed,
against the JAX trainer's ``_feedforward_loss`` and one Adam step (the
tolerances of ``tests/test_torch_update.py``). On the card the critic at this width
takes the wide route of its kernels; on the CPU, their plain versions.

With ``mixed_precision`` (``test_torch_wide_mixed_precision_{tail,fused}.py``)
both trainers take bf16 in the critic's q/k/v/o projections, and the update
is held as ``tests/test_torch_mixed_precision_update.py`` holds it at the
YAML's width: the JAX loss op by op in the JAX trainer's two chunks, and
that file's bounds on the gradients.
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
from swarmacb_tpu.env.behaviors import BehaviorState as JaxBehaviorState
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv
from swarmacb_tpu.env.state import EnvState as JaxEnvState
from swarmacb_tpu.models.networks import Actor as FlaxActor

from swarmacb_torch import ops
from swarmacb_torch.agents import POCAConfig, POCATrainer, Rollout, buffer
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.convert import _torch_key, flax_to_state_dict
from swarmacb_torch.env import DirectionalGateEnv

E, N_AG, T, HID = 2, 20, 4, 1024
CFG = dict(horizon=T, num_epochs=1, mini_batch_size=4, buffer_size_hint=0,
           accum_chunk_groups=2, hidden_dim=HID, lr=3e-4, seed=3)


def _initial(seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0, 1, (E, N_AG))) * 1.1
    th = rng.uniform(0, 2 * np.pi, (E, N_AG))
    pos = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (E, N_AG)).astype(np.float32)
    step_count = np.array([JaxEnvCfg().max_episode_length - 3, 5], np.int32)
    noise = rng.normal(size=(T, E * N_AG, 2)).astype(np.float32)
    sr = np.sqrt(rng.uniform(0, 1, (T, E, N_AG)))
    sth = rng.uniform(0, 2 * np.pi, (T, E, N_AG))
    spawn_pos = np.stack([sr * np.cos(sth), sr * np.sin(sth)], -1).astype(np.float32)
    spawn_yaw = rng.uniform(-np.pi, np.pi, (T, E, N_AG)).astype(np.float32)
    return pos, yaw, step_count, noise, spawn_pos, spawn_yaw


def _jax_trainer_with_weights_of(trainer, cfg):
    """The JAX trainer of ``cfg`` holding the port ``trainer``'s weights in
    the flax layout (``convert._torch_key``, the converter's mapping, read
    backwards), in place of its own init: flax's eager init at this width
    takes ~10 s on the CPU."""
    def init_params_for_seed(self, seed):
        key = jax.random.PRNGKey(seed)
        dummy = {"actor": (jnp.zeros((2, self.obs_dim)),),
                 "critic": (jnp.zeros((2, self.num_agents, self.STATE_DIM)),
                            jnp.zeros((2, self.num_agents, self.act_dim_critic)))}
        params = {}
        for net in ("actor", "critic"):
            module, port = getattr(self, net), getattr(trainer, net).state_dict()

            def leaf(path, shape):
                name, is_kernel = _torch_key(tuple(p.key for p in path))
                a = port[name].numpy()
                a = a.T if is_kernel else a
                assert a.shape == shape.shape, name
                return jnp.asarray(a)

            shapes = jax.eval_shape(module.init, key, *dummy[net])["params"]
            params[net] = jax.tree_util.tree_map_with_path(leaf, shapes)
        return params, key

    own = JaxTrainer.init_params_for_seed
    JaxTrainer.init_params_for_seed = init_params_for_seed
    try:
        return JaxTrainer(JaxEnv(JaxEnvCfg(num_envs=E)), cfg)
    finally:
        JaxTrainer.init_params_for_seed = own


# the critic's bf16 projections' biases (tests/test_torch_mixed_precision_update.py)
BF16_BIASES = tuple(f"critic.self_attn.fc_{s}.bias" for s in ("q", "k", "v", "out"))


def pair(fused, mixed_precision=False):
    """The port's trainer and the JAX trainer at hidden 1024 on one critic
    path (with ``fused_attention`` the JAX critic is the Pallas
    ``fused_cf_attention`` in interpret mode), with the same weights. With
    ``mixed_precision`` both take bf16 at ``mp_stages="qkvo"``, and the
    critic's weights are drawn N(0, 1/fan_in), its biases and vectors
    N(0, 0.1²), as the bf16 update test draws them: the init's tiny gains
    would leave the critic's outputs near a constant."""
    mp = dict(mixed_precision=True, mp_stages="qkvo") if mixed_precision else {}
    trainer = POCATrainer(DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=E), device="cpu"),
                          POCAConfig(**CFG, **mp, fused_attention=fused))
    if mixed_precision:
        rng = np.random.default_rng(7)
        with torch.no_grad():
            for p in trainer.critic.parameters():
                std = p.shape[1] ** -0.5 if p.dim() == 2 else 0.1
                p.copy_(torch.from_numpy((std * rng.normal(size=tuple(p.shape))
                                          ).astype(np.float32)))
    jtrainer = _jax_trainer_with_weights_of(
        trainer, JaxPOCAConfig(**CFG, **mp, fused_attention=fused))
    assert trainer.cfg.mixed_precision == jtrainer.cfg.mixed_precision == mixed_precision
    assert trainer.critic.fused_attention == jtrainer.critic.fused_attention == fused
    params = jtrainer.train_state.params
    for net in ("actor", "critic"):             # the same weights, converted both ways
        port = getattr(trainer, net).state_dict()
        assert all(torch.equal(port[k], v) for k, v in flax_to_state_dict(params[net]).items())
    return trainer, jtrainer


def rollouts(trainer, jtrainer):
    """The port's rollout and the JAX trainer's, T decisions from one state
    with the same noise and spawns: (rollout, bootstrap, the JAX fields)."""
    pos, yaw, step_count, noise, spawn_pos, spawn_yaw = _initial()
    env = trainer.env
    state = env.make_state(pos, yaw, torch.Generator(), step_count=step_count)
    ops.reset_launches()
    _, _, _, rollout, bootstrap, _ = trainer.collect(
        state, env._observations(state), trainer.init_actor_carry(),
        injected_noise=torch.from_numpy(noise),
        injected_spawn=(torch.from_numpy(spawn_pos), torch.from_numpy(spawn_yaw)))
    assert not any(ops.launches.values())

    jenv, params = jtrainer.env, jtrainer.train_state.params
    step_fn, obs_fn = jax.jit(jenv.step), jax.jit(jenv._observations)
    jstate = JaxEnvState(
        pos=jnp.asarray(pos), yaw=jnp.asarray(yaw),
        prev_ground=jnp.asarray(state.prev_ground.numpy()),
        step_count=jnp.asarray(step_count), episode_reward=jnp.zeros(E),
        completed_group_reward=jnp.zeros(E), behavior=JaxBehaviorState.init(E, N_AG),
        key=jax.random.PRNGKey(0))
    critic = jtrainer.critic
    pc = params["critic"]
    act_fn = lambda o: jtrainer.actor.apply({"params": params["actor"]}, o)  # noqa: E731
    value_fn = jax.jit(lambda s: critic.apply({"params": pc}, s, method=critic.critic_pass))
    base_fn = jax.jit(lambda s, a: critic.apply({"params": pc}, s, a,
                                                method=critic.all_baselines))
    obs = obs_fn(jstate)
    ref = {k: [] for k in ("obs", "critic_states", "actions", "log_probs", "rewards", "dones",
                           "team_values", "baselines")}
    for t in range(T):
        mu, std = act_fn(obs.reshape(E * N_AG, -1))
        act = mu + std * noise[t]
        actions = act.reshape(E, N_AG, 2)
        cs = jenv.critic_state(jstate)
        jstate_next, ts = step_fn(jstate, jnp.clip(actions, -3.0, 3.0) / 3.0,
                                  injected_spawn=(jnp.asarray(spawn_pos[t]),
                                                  jnp.asarray(spawn_yaw[t])))
        for k, v in (("obs", obs), ("critic_states", cs), ("actions", actions),
                     ("log_probs", FlaxActor.log_prob(mu, std, act).reshape(E, N_AG, 2)),
                     ("rewards", ts.reward), ("dones", ts.done.astype(jnp.float32)),
                     ("team_values", value_fn(cs)[:, 0]), ("baselines", base_fn(cs, actions))):
            ref[k].append(np.asarray(v))
        jstate, obs = jstate_next, ts.obs
    ref = {k: np.stack(v) for k, v in ref.items()}
    ref["bootstrap"] = np.array(value_fn(jenv.critic_state(jstate))[:, 0])
    return rollout, bootstrap, ref


# the rollout's fields and their tolerances (tests/test_torch_rollout.py)
FIELDS = [("obs", 1e-4), ("critic_states", 2e-5), ("actions", 2e-5), ("log_probs", 2e-5),
          ("rewards", 0), ("dones", 0), ("team_values", 2e-5), ("baselines", 2e-5)]


def check_rollout_field(both, field, atol):
    rollout, bootstrap, ref = both
    got = getattr(rollout, field).numpy()
    assert got.shape == ref[field].shape
    np.testing.assert_allclose(got, ref[field], rtol=0, atol=atol)
    np.testing.assert_allclose(bootstrap.numpy(), ref["bootstrap"], rtol=0, atol=2e-5)


def _flat_grads(trainer):
    return {f"{net}.{n}": p.grad for net in ("actor", "critic")
            for n, p in getattr(trainer, net).named_parameters()}


def _flax_flat(tree):
    return {f"{net}.{k}": v for net in ("actor", "critic")
            for k, v in flax_to_state_dict(tree[net]).items()}


def _synth_rollout(seed=5):
    """A T × E rollout buffer and bootstrap made with numpy from a seed, at
    the scales of ``tests/test_torch_update.py``'s, with dones inside it."""
    rng = np.random.default_rng(seed)
    f = np.float32
    data = dict(
        obs=rng.normal(size=(T, E, N_AG, 24)).astype(f),
        critic_states=(rng.normal(size=(T, E, N_AG, 5)) * 0.5).astype(f),
        actions=rng.normal(size=(T, E, N_AG, 2)).astype(f),
        log_probs=rng.uniform(-2.5, -0.5, size=(T, E, N_AG, 2)).astype(f),
        rewards=(rng.normal(size=(T, E)) * 0.5).astype(f),
        dones=np.array([[0, 1], [1, 0], [0, 0], [0, 0]], f),
        team_values=(rng.normal(size=(T, E)) * 0.5).astype(f),
        baselines=(rng.normal(size=(T, E, N_AG)) * 0.5).astype(f))
    return data, (rng.normal(size=(E,)) * 0.5).astype(f)


def _jax_grads(jtrainer, params, batch, c):
    """The JAX loss, its parts and gradients on ``batch``: jitted and
    unchunked in float32; under mixed precision op by op (under jit XLA on
    the CPU may keep float32 where an op rounds to bf16) in two chunks of
    2 groups, averaged as the JAX ``_sgd_step`` averages them."""
    grad_fn = jax.value_and_grad(jtrainer._feedforward_loss, has_aux=True)
    if not jtrainer.cfg.mixed_precision:
        (loss, aux), grads = jax.jit(grad_fn)(params, batch, c.clip_eps, c.beta)
        return float(loss), np.array([float(a) for a in aux]), grads
    parts = [grad_fn(params, {k: v[lo:lo + 2] for k, v in batch.items()}, c.clip_eps, c.beta)
             for lo in (0, 2)]
    grads = jax.tree_util.tree_map(lambda a, b: (0 + a + b) * 0.5, parts[0][1], parts[1][1])
    loss = (float(parts[0][0][0]) + float(parts[1][0][0])) * 0.5
    aux = (np.stack(parts[0][0][1]) + np.stack(parts[1][0][1])) * 0.5
    return loss, aux, grads


def _grad_atol(name, w, mixed_precision):
    """3e-5 of the gradient's largest element (floored at 1e-3); under
    mixed precision, every gradient of the critic gets the bf16 class of
    ``tests/test_torch_mixed_precision_update.py``: one bf16 step (2⁻⁸) of
    max(its largest element, 1e-2), four for the bf16 projections' biases.
    At h = 32 that file holds the layers after the attention to 3e-5, but
    here the flipped roundings of the 1024-term products (see
    ``check_bf16_projections``) reach their forward values too: their
    gradients part by more than 3e-5 of their largest element."""
    if not mixed_precision or name.startswith("actor."):
        return 3e-5 * max(float(np.abs(w).max()), 1e-3)
    return (4 if name in BF16_BIASES else 1) * 2.0 ** -8 * max(float(np.abs(w).max()), 1e-2)


def check_bf16_projections(trainer, jtrainer):
    """Each bf16 projection of the port's critic (q, k, v from
    ``project_qkv``; fc_out) against the JAX critic's ``Dense(dtype=bf16)``
    on the same float32 input, the normalized embeddings of a rollout
    buffer's critic states: bf16 on both sides, and bit-equal in at least
    99.9 % of the elements. At this width each product sums 1024 terms, and
    a float32 sum in another order rounds to the neighbouring bf16 value
    where it lies near a rounding boundary (a few elements in 10⁴); float32
    in place of bf16, or the bias add fused into the product's one
    rounding, parts in far more."""
    from swarmacb_torch.models.networks import _project

    data, _ = _synth_rollout()
    rsa = trainer.critic.self_attn
    with torch.no_grad():
        x = rsa.normalize(trainer.critic.obs_entity_enc(torch.from_numpy(data["critic_states"])))
        ours = (*rsa.project_qkv(x), _project(rsa.fc_out, x, rsa.dtypes["o"]))
    critic = jtrainer.critic
    theirs = critic.apply(
        {"params": jtrainer.train_state.params["critic"]}, jnp.asarray(x.numpy()),
        method=lambda m, v: tuple(getattr(m.self_attn, f"fc_{s}")(v)
                                  for s in ("q", "k", "v", "out")))
    for name, a, b in zip("qkvo", ours, theirs):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, name
        share = float(np.mean(a.float().numpy() == np.asarray(b.astype(jnp.float32))))
        assert share >= 0.999, f"bf16 projection {name}: {share:.4%} bit-equal"


def check_minibatch_update(trainer, jtrainer):
    """One minibatch (4 of the T·E = 8 groups; the port takes it in chunks
    of 2) of a rollout buffer made from a seed: loss to 2e-6 relative and
    each gradient to 3e-5 of its largest element before the step (under
    mixed precision the value and baseline losses to one bf16 step of their
    size, and ``_grad_atol``'s bounds); after one Adam step (the JAX
    trainer's optimizer on the JAX gradients) each parameter within
    2.2·lr."""
    fused = trainer.critic.fused_attention
    mixed_precision = trainer.cfg.mixed_precision
    params = jtrainer.train_state.params
    c = trainer.cfg
    data, bootstrap = _synth_rollout()
    rollout = JaxRollout(**{k: jnp.asarray(v) for k, v in data.items()})
    returns, adv = jbuf.compute_advantages(rollout, jnp.asarray(bootstrap), c.gamma, c.lam)
    flat = jtrainer._flatten_buffer(rollout, returns, jbuf.normalize_advantages(adv))
    idx = np.array([5, 0, 7, 2])
    batch = {k: v[idx] for k, v in flat.items()}
    loss, aux, grads = _jax_grads(jtrainer, params, batch, c)
    # the JAX _sgd_step's Adam step on these (unchunked) gradients
    updates, _ = jtrainer.tx.update(grads, jtrainer.train_state.opt_state, params)
    new_params = optax.apply_updates(params, updates)

    ours = Rollout(**{k: torch.from_numpy(v) for k, v in data.items()})
    returns_t, adv_t = buffer.compute_advantages(ours, torch.from_numpy(bootstrap),
                                                 c.gamma, c.lam)
    flat_t = trainer._flatten_buffer(ours, returns_t, buffer.normalize_advantages(adv_t))
    batch_t = {k: v[torch.from_numpy(idx)] for k, v in flat_t.items()}
    assert trainer._grad_chunks(len(idx)) == jtrainer._grad_chunks(len(idx)) == 2
    trainer.optimizer.zero_grad(set_to_none=True)
    total, aux_t = trainer._accumulate_grads(batch_t, c.clip_eps, c.beta,
                                             trainer._feedforward_loss)
    if mixed_precision:
        check_bf16_projections(trainer, jtrainer)
    # the loss parts the bf16 projections reach (value, baseline) take
    # _grad_atol's bf16 class: one bf16 step of their size
    rtol = np.array([2e-6, *[2.0 ** -8 if mixed_precision else 2e-6] * 2, 2e-6])
    gap = np.abs(aux_t.numpy() - aux)
    assert np.all(gap <= 1e-7 + rtol * np.abs(aux)), (
        f"loss parts (policy, value, baseline, entropy) {aux_t.numpy()} against {aux}")
    # total = policy + 0.5·value + 0.25·baseline − β·entropy
    slack = float(np.dot([0, 0.5, 0.25, 0], (rtol - 2e-6) * np.abs(aux)))
    np.testing.assert_allclose(float(total), loss, rtol=2e-6, atol=1e-7 + slack)
    got, want = _flat_grads(trainer), _flax_flat(grads)
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].dtype == torch.float32, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=_grad_atol(name, w, mixed_precision),
                                   err_msg=f"gradient of {name} (fused_attention={fused}, "
                                           f"mixed_precision={mixed_precision})")
    ops.reset_launches()
    trainer._sgd_step(batch_t, c.clip_eps, c.beta, trainer._feedforward_loss)
    assert not any(ops.launches.values())
    after = _flax_flat(new_params)
    state = {f"{net}.{k}": v for net in ("actor", "critic")
             for k, v in getattr(trainer, net).state_dict().items()}
    for name, w in after.items():
        np.testing.assert_allclose(state[name].numpy(), np.asarray(w), rtol=0,
                                   atol=2.2 * c.lr, err_msg=f"parameter {name}")
    moved = max(float(np.abs(state[n].numpy() - np.asarray(w)).max())
                for n, w in _flax_flat(params).items())
    assert moved > 0.5 * c.lr, "the step moved no parameter"
