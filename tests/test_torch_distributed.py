"""The port's data-parallel ranks (``swarmacb_torch.parallel``) on the CPU:
two gloo ranks, each a spawned process (``tests/torch_dist_workers.py``).

- The draw rule: a rank's draws are its columns of the global draw, in
  the (E, N) layout and in the padded lanes layout of ``fused_env_step``.
- The rollout: two ranks of E = 4 arenas (T = 4) against one process of
  E = 8, for dandelion and daisy, on the composed step and on the plain
  K4 path. On the K4 path every field is bit-identical. On the composed
  path integer results are exact (rewards, dones, completed group rewards,
  step counts, behaviour machines, daisy's actions), baselines within 1e-5
  and other floats within 1e-6 (tests/test_distributed.py:71-77), but the
  observations within 1e-5: there the light sensor's ``atan2`` rounds by
  where an element falls in the CPU's vector loop, so a tensor of 80 robots
  and one of 160 can give angles one ulp apart; four steps carry that to
  2.4e-6 in the observations (and one ulp in dandelion's wheel commands).
- One update against the JAX trainer on ``make_mesh(2)``
  (``_update_dispatch`` under ``jit``: its ``shard_map``), ``fused_tail``
  off, on the synthetic rollout of tests/test_torch_update.py at E = 4:
  each rank takes its columns and JAX's permutation of its shard
  (``permutation(k, T·E_loc)`` for k in ``split(fold_in(key, rank),
  epochs)``), minibatches of 3 rows a rank (3, 3, 2), chunked 2 + 1. The
  losses as tests/test_torch_update.py holds them, every parameter within
  2.2·num_epochs·lr, the two ranks bit-identical.
- The advantages normalized over the ranks against the whole buffer's, to
  1e-6; a tiny cyclamen iteration on two ranks (finite, in lockstep, the
  per-rank window count (group_mb // world) // L); the refusals.
"""

import pathlib

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
from swarmacb_tpu.parallel import make_mesh as jax_make_mesh

from swarmacb_torch.agents import POCAConfig, POCATrainer, buffer
from swarmacb_torch.config import DirectionalGateEnvCfg, load_config
from swarmacb_torch.convert import flax_to_state_dict
from swarmacb_torch.env import DirectionalGateEnv
from swarmacb_torch.parallel import Mesh, draw_local, make_mesh
import torch_dist_workers as workers
from torch_scripts import load_script
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
E, T, N_AG, WORLD = 4, 4, 20, 2
UPDATE_CFG = dict(horizon=T, num_epochs=3, mini_batch_size=6, buffer_size_hint=0,
                  accum_chunk_groups=2, hidden_dim=32, lr=3e-4, seed=3)
INTEGER_FIELDS = ("rewards", "dones", "step_rewards", "aux_dones", "completed", "step_count",
                  "explore_state", "photo_steps")
# the fields whose arenas lie on axis 0 (the rollout's lie on axis 1)
ARENA_FIRST = ("bootstrap", "final_obs", "step_count", "explore_state", "photo_steps")


def _synth_rollout(seed):
    """tests/test_torch_update.py's synthetic rollout, at E = 4."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        obs=rng.normal(size=(T, E, N_AG, 24)).astype(f),
        critic_states=(rng.normal(size=(T, E, N_AG, 5)) * 0.5).astype(f),
        actions=rng.normal(size=(T, E, N_AG, 2)).astype(f),
        log_probs=rng.uniform(-2.5, -0.5, size=(T, E, N_AG, 2)).astype(f),
        rewards=(rng.normal(size=(T, E)) * 0.5).astype(f),
        dones=np.array([[0, 0, 1, 0], [1, 0, 0, 0], [0, 0, 0, 1], [0, 1, 0, 0]], f),
        team_values=(rng.normal(size=(T, E)) * 0.5).astype(f),
        baselines=(rng.normal(size=(T, E, N_AG)) * 0.5).astype(f),
    ), (rng.normal(size=(E,)) * 0.5).astype(np.float32)


def _jax_update(tmp):
    """The JAX mesh update; writes what the ranks need to ``tmp/jax.npz``."""
    jtrainer = JaxTrainer(JaxEnv(JaxEnvCfg(num_envs=E)),
                          JaxPOCAConfig(**UPDATE_CFG, fused_tail=False),
                          mesh=jax_make_mesh(WORLD))
    data, bootstrap = _synth_rollout(5)
    key = jax.random.PRNGKey(11)
    c = jtrainer.cfg
    new_state, jmetrics = jax.jit(jtrainer._update_dispatch)(
        jtrainer.train_state, JaxRollout(**{k: jnp.asarray(v) for k, v in data.items()}),
        jnp.asarray(bootstrap), jnp.float32(c.lr), jnp.float32(c.clip_eps),
        jnp.float32(c.beta), key)
    arrays = {f"rollout.{k}": v for k, v in data.items()}
    arrays["bootstrap"] = bootstrap
    for s in range(WORLD):
        arrays[f"perms{s}"] = np.stack([
            np.asarray(jax.random.permutation(k, T * E // WORLD))
            for k in jax.random.split(jax.random.fold_in(key, s), c.num_epochs)])
    for net in ("actor", "critic"):
        for k, v in flax_to_state_dict(jtrainer.train_state.params[net]).items():
            arrays[f"{net}.{k}"] = v.numpy()
    # written whole, then moved into place: the ranks wait for the name
    np.savez(tmp / "jax.partial.npz", **arrays)
    (tmp / "jax.partial.npz").rename(tmp / "jax.npz")
    after = {f"{net}.{k}": v.numpy() for net in ("actor", "critic")
             for k, v in flax_to_state_dict(new_state.params[net]).items()}
    before = {k: arrays[k] for k in after}
    return jmetrics, after, before, arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks start first and compute what needs nothing of JAX while
    this process runs the JAX mesh update and writes it for them; then the
    one-process rollouts, while the ranks update."""
    tmp = tmp_path_factory.mktemp("dist")
    ctx = workers.start_ranks(workers.rank_main, WORLD, tmp / "ranks", str(tmp / "jax.npz"),
                              UPDATE_CFG, E)
    jmetrics, after, before, arrays = _jax_update(tmp)
    single = {case: workers.rollout_fields(workers.rollout_trainer(*case))
              for case in workers.ROLLOUT_CASES}
    ranks = workers.join_ranks(ctx, tmp / "ranks", 150)
    return dict(rollout=[r["rollouts"] for r in ranks], update=ranks, single=single,
                jmetrics=jmetrics, after=after, before=before, arrays=arrays)


# ── the draw rule ─────────────────────────────────────────────────────────

@pytest.mark.parametrize("lanes", [False, True])
def test_a_rank_draws_its_columns_of_the_global_draw(lanes):
    """Each of two shards of E = 8 (and the lanes layout, padded to 128
    columns globally and again locally) keeps its columns of the draw one
    env of all 8 arenas makes, and leaves the generator where it leaves
    it."""
    E_g, N = 8, 20
    whole = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=E_g), device="cpu")
    gen = torch.Generator().manual_seed(4)

    def rand(shape):
        return torch.rand(shape, generator=gen)

    shape = (3, N, 128) if lanes else (3, E_g, N)
    want = whole.draw(rand, shape, dim=2 if lanes else 1, lanes=lanes)
    after = torch.rand(5, generator=gen)
    for lo in (0, 4):
        part = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=4), device="cpu",
                                  shard=(lo, E_g))
        gen.manual_seed(4)
        shape = (3, N, 128) if lanes else (3, 4, N)
        got = part.draw(rand, shape, dim=2 if lanes else 1, lanes=lanes)
        assert tuple(got.shape) == shape
        if lanes:
            assert torch.equal(got[..., :4], want[..., lo:lo + 4])
            assert not got[..., 4:].any()
        else:
            assert torch.equal(got, want[:, lo:lo + 4])
        assert torch.equal(torch.rand(5, generator=gen), after)


def test_draw_local_keeps_the_rows_of_its_arenas():
    gen = torch.Generator()
    draw = lambda s: torch.randn(s, generator=gen)  # noqa: E731
    gen.manual_seed(0)
    whole = draw((6 * 20, 2))
    gen.manual_seed(0)
    assert torch.equal(draw_local(draw, (2 * 20, 2), 0, 4 * 20, 6 * 20), whole[80:120])
    gen.manual_seed(0)
    assert torch.equal(draw_local(draw, (6 * 20, 2), 0, 0, 6 * 20), whole)


# ── the rollout ───────────────────────────────────────────────────────────

@pytest.mark.parametrize("case", workers.ROLLOUT_CASES, ids=lambda c: f"{c[0]}-{'K4' if c[1] else 'composed'}")
def test_two_ranks_roll_out_as_one_process(runs, case):
    single = runs["single"][case]
    ranks = [r[case] for r in runs["rollout"]]
    for name, want in single.items():
        got = np.concatenate([r[name] for r in ranks], axis=0 if name in ARENA_FIRST else 1)
        assert got.shape == want.shape, name
        if case[1] or name in INTEGER_FIELDS or (name == "actions" and case[0] == "daisy"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name in ("baselines", "team_values", "bootstrap"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
        elif name in ("obs", "final_obs"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)


# ── the update against the JAX mesh update ────────────────────────────────

def test_minibatches_are_the_jax_shard_minibatches(runs):
    r0 = runs["update"][0]
    # group_mb over all 16 groups; a rank takes 6 // 2 = 3 of its 8 rows
    assert r0["group_mb"] == 6 and r0["minibatch_rows"] == 3


def test_update_losses_match_jax(runs):
    for out in runs["update"]:
        for k in ("policy_loss", "value_loss", "baseline_loss", "entropy"):
            np.testing.assert_allclose(out["metrics"][k], float(runs["jmetrics"][k]),
                                       rtol=1e-2, atol=1e-3, err_msg=k)


def test_update_parameters_match_jax_and_the_ranks_agree(runs):
    c = POCAConfig(**UPDATE_CFG)
    bound = 2.2 * c.num_epochs * c.lr
    r0, r1 = (out["params"] for out in runs["update"])
    assert r0.keys() == r1.keys() == runs["after"].keys()
    moved = 0.0
    for name, want in runs["after"].items():
        assert torch.equal(r0[name], r1[name]), f"the ranks differ in {name}"
        np.testing.assert_allclose(r0[name].numpy(), want, rtol=0, atol=bound,
                                   err_msg=f"parameter {name}")
        moved = max(moved, float(np.abs(r0[name].numpy() - runs["before"][name]).max()))
    assert moved > bound, "the update moved no parameter past the tolerance"


def test_update_takes_one_all_reduce_a_minibatch(runs):
    """Two for the advantage moments, one a minibatch (3 epochs × 3), one
    for the mean |advantage|: 12 collectives, each of one flat buffer."""
    n_params = sum(v.numel() for v in runs["update"][0]["params"].values())
    comm = runs["update"][0]["comm"]
    assert comm["calls"] == 2 + 9 + 1
    assert comm["bytes"] == 4 * (3 + 9 * (n_params + 4))


def test_mean_abs_advantage_is_over_all_ranks(runs):
    a = runs["arrays"]
    returns, adv = jbuf.compute_advantages(
        JaxRollout(**{k[len("rollout."):]: jnp.asarray(v) for k, v in a.items()
                      if k.startswith("rollout.")}), jnp.asarray(a["bootstrap"]),
        0.99, 0.95)
    want = float(jnp.abs(jbuf.normalize_advantages(adv)).mean())
    for out in runs["update"]:
        np.testing.assert_allclose(out["metrics"]["mean_abs_advantage"], want, rtol=1e-6)


def test_advantages_normalized_over_the_ranks(runs):
    full = workers.advantages(E)
    got = np.concatenate([out["normalized"] for out in runs["update"]], axis=1)
    want = buffer.normalize_advantages(torch.from_numpy(full)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jbuf.normalize_advantages(jnp.asarray(full))),
                               rtol=0, atol=1e-6)


def test_cyclamen_ranks_train_in_lockstep(runs):
    c0, c1 = (out["cyclamen"] for out in runs["update"])
    assert c0["finite"] and c1["finite"] and c0["digest"] == c1["digest"]
    for k in ("policy_loss", "value_loss", "baseline_loss", "entropy"):
        assert np.isfinite(c0["metrics"][k]) and c0["metrics"][k] == c1["metrics"][k], k
    # group_mb = min(8, 6·4) = 8 over both ranks; a rank's windows of L:
    # (8 // 2) // L, at most the rank's windows of that length (2 each)
    assert c0["group_mb"] == 8
    assert c0["windows"] == {workers.CYC_L: 1, 2: 2} == c1["windows"]


# ── the communication account ─────────────────────────────────────────────

def test_comm_account_counts_the_update_s_all_reduces():
    """``scripts/comm_account_torch.py`` for tulip at E = 8 (the YAML's
    T = 1000, bpe = buffer_size // batch_size minibatches an epoch): the
    SGD steps are num_epochs·bpe on any number of ranks, and the wire bytes
    2(p − 1)/p of the steps' flat buffers (the parameters and four losses)
    and four scalars."""
    row = load_script("comm_account_torch").account("tulip", 8)
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="tulip", num_envs=8), device="cpu")
    cfg = load_config(str(ROOT / "configs" / "DirGate_tulip.yaml"))[2]
    trainer = POCATrainer(env, cfg)
    params = sum(p.numel() for p in [*trainer.actor.parameters(),
                                     *trainer.critic.parameters()])
    bpe = cfg.buffer_size_hint // cfg.mini_batch_size
    assert row["params"] == params and row["sgd_steps_per_update"] == cfg.num_epochs * bpe
    for p in (2, 4, 8):
        entry = row[f"ranks_{p}"]
        assert entry["sgd_steps"] == cfg.num_epochs * bpe
        assert entry["allreduce_calls"] == cfg.num_epochs * bpe + 4
        wire = 2 * (p - 1) / p * (4 * (params + 4) * cfg.num_epochs * bpe + 16)
        assert entry["wire_MB_per_update"] == pytest.approx(wire / 2**20, rel=1e-12)


# ── refusals ──────────────────────────────────────────────────────────────

def _mesh(rank, world):
    return Mesh(rank=rank, world=world, device=torch.device("cpu"), group=None,
                backend="gloo")


def test_uneven_envs_rejected():
    with pytest.raises(ValueError, match="must divide over 4 ranks"):
        _mesh(0, 4).shard_range(6)
    assert _mesh(1, 2).shard_range(6) == (3, 6)


def test_the_trainer_refuses_an_env_that_is_not_its_shard():
    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=4), device="cpu", shard=(0, 8))
    with pytest.raises(ValueError, match="rank 1 of 2 holds"):
        POCATrainer(env, POCAConfig(hidden_dim=8), mesh=_mesh(1, 2))
    with pytest.raises(ValueError, match="needs the mesh"):
        POCATrainer(env, POCAConfig(hidden_dim=8))
    with pytest.raises(ValueError, match="does not hold"):
        DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=4), device="cpu", shard=(6, 8))


def test_more_nccl_ranks_than_gpus_raise(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 NCCL ranks on this host need 2 GPUs; 1 are "
                                         "visible"):
        make_mesh(world=2, rank=0, device="cuda:0")


@pytest.mark.parametrize("local_world", [4, 8])
def test_nccl_counts_the_gpus_of_this_host(monkeypatch, local_world):
    """torchrun over two hosts of four GPUs: a world of 8 joins with 4 cards
    a host; 8 ranks on one host of 4 cards raise."""
    joined = {}
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: joined.update(device=d))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: joined.update(backend=backend, **kw))
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: joined["backend"])
    if local_world > 4:
        with pytest.raises(ValueError, match="8 NCCL ranks on this host need 8 GPUs; 4 "
                                             "are visible"):
            make_mesh(device="cuda")
        assert joined == {}
        return
    mesh = make_mesh(device="cuda")
    assert (mesh.rank, mesh.world, mesh.device, mesh.backend) == (
        5, 8, torch.device("cuda", 1), "nccl")
    assert joined["device"] == torch.device("cuda", 1)
    assert (joined["rank"], joined["world_size"], joined["init_method"]) == (5, 8, "env://")


def test_a_launch_makes_its_tensors_card_current(monkeypatch):
    """A kernel on ``cuda:1`` launches with ``cuda:1`` current and on its
    stream, whatever device the process has current (the seed mesh's lanes
    on the second card of one process)."""
    from swarmacb_torch.ops import _cuda

    current, calls = ["cuda:0"], []

    class Guard:
        def __init__(self, device):
            self.device = str(device)

        def __enter__(self):
            self.saved, current[0] = current[0], self.device

        def __exit__(self, *exc):
            current[0] = self.saved

    class Stream:
        def __init__(self, device):
            self.cuda_stream = f"stream of {device}"

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    tensor = type("CudaTensor", (), {"device": torch.device("cuda", 1)})()

    def entry(*args):
        calls.append((current[0], args))
        return 0

    _cuda.launch(tensor, "k", entry, 7, 8)
    assert calls == [("cuda:1", (7, 8, "stream of cuda:1"))] and current == ["cuda:0"]
    with pytest.raises(RuntimeError, match="k: CUDA launch failed with error 1"):
        _cuda.launch(tensor, "k", lambda *args: 1)
