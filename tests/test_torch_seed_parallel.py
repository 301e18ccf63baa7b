"""The port's seed-parallel trainer (``agents/seed_parallel.py``) on the CPU.

Each lane must be the serial ``POCATrainer`` of its seed at the JAX lane's
gradient-chunk cap, bit for bit (tulip and dandelion: E = 2, h = 16, T = 8,
two iterations; cyclamen, the recurrent actor: one). The cap and the
per-seed summary tags are held against the JAX ``SeedParallelTrainer``
itself. Checkpoints, resume (the newest common step, else a common
``poca_final``; the cadence from the restored step), the divergence guard
and the refusals follow ``tests/test_seed_parallel.py``, with the fixes of
``ADVICE.md`` as the port's intended divergences.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from swarmacb_tpu.agents import POCAConfig as JaxPOCAConfig
from swarmacb_tpu.agents import SeedParallelTrainer as JaxSeedParallelTrainer
from swarmacb_tpu.env import make_env as jax_make_env

from swarmacb_torch.agents import Checkpointer, POCAConfig, POCATrainer, SeedParallelTrainer
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import DirectionalGateEnv
from torch_scripts import load_script
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T, E = 8, 2
ITER = T * E * 20                    # decisions of one iteration (N = 20)
METRICS = ("policy_loss", "value_loss", "baseline_loss", "entropy", "mean_abs_advantage",
           "mean_rollout_reward", "mean_step_reward", "mean_team_value")


def tiny_cfg(**kw):
    # minibatches of 8 groups; the lanes' cap 6 // 2 = 3 chunks them 3, 3, 2
    base = dict(horizon=T, total_timesteps=10**9, hidden_dim=16, num_layers=1,
                buffer_size_hint=0, mini_batch_size=8, accum_chunk_groups=6,
                summary_freq=10**9, checkpoint_interval=10**9)
    base.update(kw)
    return POCAConfig(**base)


def tiny_env(variant="tulip"):
    return DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=E), device="cpu")


def run_serial(env, cfg, seed, iters):
    """The serial trainer of ``seed`` at the lane's cap, started as
    ``POCATrainer.train`` starts."""
    t = POCATrainer(env, dataclasses.replace(cfg, seed=seed, accum_chunk_groups=3))
    es, obs = env.reset(t.generator)
    carry = t.init_actor_carry()
    out = []
    for _ in range(iters):
        es, obs, carry, m = t.train_iteration(es, obs, carry)
        out.append(m)
    return out, t, obs


def run_parallel(env, cfg, seeds, iters):
    tr = SeedParallelTrainer(env, cfg, seeds)
    es, obs, carry = tr._reset_all()
    out = []
    for _ in range(iters):
        es, obs, carry, m = tr.train_iteration(es, obs, carry)
        out.append(m)
    return out, tr, obs


def _state_equal(a, b):
    for net in ("actor", "critic"):
        sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{net}.{k}"
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])


@pytest.mark.parametrize("variant,iters", [("tulip", 2), ("dandelion", 2), ("cyclamen", 1)])
def test_lanes_equal_serial_runs(variant, iters):
    """Every metric, parameter, Adam moment and observation of each lane
    equals the serial run of its seed, bit for bit."""
    env = tiny_env(variant)
    cfg = tiny_cfg(recurrent=variant == "cyclamen", sequence_length=4)
    seeds = [0, 1]
    par, tr, par_obs = run_parallel(env, cfg, seeds, iters)
    assert tr.cfg.accum_chunk_groups == 3 and tr.lanes[0]._grad_chunks(8) == 3
    assert tr.recurrent == (variant == "cyclamen")
    for lane, seed in enumerate(seeds):
        ser, t, ser_obs = run_serial(env, cfg, seed, iters)
        for it in range(iters):
            for k in METRICS:
                assert par[it][k][lane] == ser[it][k], (seed, it, k)
            assert (par[it]["lr"], par[it]["eps"], par[it]["beta"]) == (
                ser[it]["lr"], ser[it]["eps"], ser[it]["beta"])
        _state_equal(tr.lanes[lane], t)
        assert torch.equal(par_obs[lane], ser_obs)
    assert par[0]["policy_loss"][0] != par[0]["policy_loss"][1]


@pytest.fixture(scope="module")
def jax_trainer():
    """The JAX seed-parallel trainer: dandelion (its log-std tags), three
    seeds, the default chunk cap."""
    env = jax_make_env("SwarmACB-DirectionalGate-v0", variant="dandelion", num_envs=E,
                       use_pallas=False)
    cfg = JaxPOCAConfig(horizon=T, total_timesteps=10**9, hidden_dim=16, num_layers=1,
                        summary_freq=10**9, checkpoint_interval=10**9,
                        split_update_groups=0)
    return JaxSeedParallelTrainer(env, cfg, [0, 1, 2])


def test_lane_chunk_cap_equals_jax(jax_trainer):
    tr = SeedParallelTrainer(tiny_env("dandelion"), tiny_cfg(accum_chunk_groups=1024),
                             [0, 1, 2])
    assert tr.cfg.accum_chunk_groups == jax_trainer.base.cfg.accum_chunk_groups == 341
    assert all(lane.cfg.accum_chunk_groups == 341 for lane in tr.lanes)
    assert [lane.cfg.seed for lane in tr.lanes] == [0, 1, 2]


class FakeWriter:
    def __init__(self):
        self.records = []

    def add_scalar(self, tag, value, step):
        self.records.append((tag, step))

    def add_text(self, tag, text, step=0):
        self.records.append((tag, step))

    def flush(self):
        pass


def test_summary_tags_equal_jax(jax_trainer):
    """Each live lane writes the JAX ``_write_summaries`` tags, in its order,
    with the episode tags where its episodes ended; a dead lane writes
    none."""
    S = 3
    m = {k: np.array([0.1, 0.2, 0.3]) for k in METRICS}
    m.update(lr=3e-4, eps=0.2, beta=5e-3)
    ours = SeedParallelTrainer(tiny_env("dandelion"), tiny_cfg(), [0, 1, 2],
                               writers=[FakeWriter() for _ in range(S)])
    theirs = jax_trainer
    theirs.writers = [FakeWriter() for _ in range(S)]
    for tr in (ours, theirs):
        tr.global_step = 640
        tr.alive[:] = [True, False, True]
    for i, lane in enumerate(ours.lanes):
        lane.global_step = 640
        lane._rollout_reward_history[:] = theirs._rollout_reward_history[i][:] = [0.5]
        if i == 0:     # episodes ended in lane 0 only
            lane.completed_episode_returns[:] = [1.0, 2.0]
            lane.completed_episode_lengths[:] = [1199.0]
            lane.completed_group_rewards[:] = [3.0]
            theirs.completed_episode_returns[0][:] = [1.0, 2.0]
            theirs.completed_episode_lengths[0][:] = [1199.0]
            theirs.completed_group_rewards[0][:] = [3.0]
    ours._write_summaries(m, 123.0)
    theirs._write_summaries(m, 123.0)
    for i in range(S):
        assert ours.writers[i].records == theirs.writers[i].records, i
    tags = [t for t, _ in ours.writers[0].records]
    assert "Environment/Cumulative Reward" in tags and "Policy/Std dim1" in tags
    assert ours.writers[1].records == []
    assert len(ours.writers[2].records) == len(tags) - 3


def test_save_resume_and_the_cadence(tmp_path):
    """Per-seed checkpoints are serial checkpoints; ``try_resume`` restores
    every lane at the newest common step, else at a common ``poca_final``;
    the resumed cadence continues from the restored step."""
    env = tiny_env("tulip")
    seeds = [0, 1]
    cks = [Checkpointer(tmp_path / f"s{s}", keep=3) for s in seeds]
    cfg = tiny_cfg(total_timesteps=2 * ITER, checkpoint_interval=ITER, summary_freq=ITER)
    writers = [FakeWriter() for _ in seeds]
    tr = SeedParallelTrainer(env, cfg, seeds, writers=writers)
    tr.train(checkpointers=cks, progress=False)
    for ck in cks:
        assert sorted(p.name for p in ck.dir.iterdir()) == [
            f"poca_{ITER}", f"poca_{2 * ITER}", "poca_final"]
    for w in writers:
        assert sorted({s for tag, s in w.records}) == [ITER, 2 * ITER]

    # a serial trainer restores a lane's checkpoint (play_torch.py's contract)
    t = POCATrainer(env, dataclasses.replace(cfg, seed=1))
    cks[1].restore(cks[1].dir / "poca_final", t)
    _state_equal(t, tr.lanes[1])
    assert json.loads((cks[1].dir / "poca_final" / "metadata.json").read_text())[
        "global_step"] == 2 * ITER

    # resume at the newest common step; intervals of two iterations: the
    # JAX loop would save and summarise after the first resumed iteration,
    # the port's next multiple is 4·ITER, past the budget
    cfg2 = dataclasses.replace(cfg, total_timesteps=3 * ITER, checkpoint_interval=2 * ITER,
                               summary_freq=2 * ITER)
    writers2 = [FakeWriter() for _ in seeds]
    tr2 = SeedParallelTrainer(env, cfg2, seeds, writers=writers2)
    assert tr2.try_resume(cks)
    assert (tr2.global_step, tr2.update_count) == (2 * ITER, 2)
    saved = Checkpointer.restore_params(cks[0].dir / f"poca_{2 * ITER}", device="cpu")
    assert all(torch.equal(v, tr2.lanes[0].critic.state_dict()[k])
               for k, v in saved["critic"].items())
    tr2.train(checkpointers=cks, progress=False)
    assert (tr2.global_step, tr2.update_count) == (3 * ITER, 3)
    assert not (cks[0].dir / f"poca_{3 * ITER}").exists()
    assert all(w.records == [] for w in writers2)
    assert json.loads((cks[0].dir / "poca_final" / "metadata.json").read_text())[
        "global_step"] == 3 * ITER

    # with every numbered directory of one seed gone, the lanes resume at
    # the common poca_final; with the finals at different steps, fresh
    for p in cks[1].dir.glob("poca_[0-9]*"):
        for f in p.iterdir():
            f.unlink()
        p.rmdir()
    tr3 = SeedParallelTrainer(env, cfg2, seeds)
    assert tr3.try_resume(cks) and tr3.global_step == 3 * ITER
    tr3.lanes[1].global_step = ITER
    cks[1].save(tr3.lanes[1], final=True)
    assert not SeedParallelTrainer(env, cfg2, seeds).try_resume(cks)


def test_resume_fresh_when_nothing_is_saved(tmp_path):
    tr = SeedParallelTrainer(tiny_env("tulip"), tiny_cfg(), [0, 1])
    assert not tr.try_resume([Checkpointer(tmp_path / f"s{s}") for s in (0, 1)])


def _poison(lane):
    with torch.no_grad():
        for p in [*lane.actor.parameters(), *lane.critic.parameters()]:
            p.fill_(float("nan"))


def test_nan_lane_is_quarantined_others_continue(tmp_path):
    env = tiny_env("tulip")
    tr = SeedParallelTrainer(env, tiny_cfg(total_timesteps=2 * ITER), [0, 1])
    _poison(tr.lanes[0])
    cks = [Checkpointer(tmp_path / f"s{s}", keep=3) for s in (0, 1)]
    tr.train(checkpointers=cks, progress=False)
    assert list(tr.alive) == [False, True]
    assert [p.name for p in cks[0].dir.iterdir()] == [f"poca_diverged_{ITER}"]
    assert (cks[1].dir / "poca_final" / "metadata.json").exists()
    # the dead lane was not stepped again; the other reached the budget
    assert tr.lanes[0].update_count == 1 and tr.lanes[1].update_count == 2
    assert all(bool(torch.isfinite(p).all()) for p in tr.lanes[1].critic.parameters())


def test_all_dead_raises():
    tr = SeedParallelTrainer(tiny_env("tulip"), tiny_cfg(total_timesteps=2 * ITER), [0, 1])
    for lane in tr.lanes:
        _poison(lane)
    with pytest.raises(FloatingPointError, match="all seed lanes diverged"):
        tr.train(progress=False)


@pytest.mark.parametrize("seeds,kw,error,match", [
    ([1, 1], {}, ValueError, "duplicate"),
    ([], {}, ValueError, "no seeds"),
    ([0, 1], dict(writers=[None]), ValueError, "one writer per seed"),
    ([0, 1, 2], dict(mesh=["cpu", "cpu"]), ValueError, "3 seeds not divisible over 2 devices"),
])
def test_refusals(seeds, kw, error, match):
    with pytest.raises(error, match=match):
        SeedParallelTrainer(tiny_env("tulip"), tiny_cfg(), seeds, **kw)


def test_seed_mesh_lanes_equal_serial_runs():
    """Four seeds over a seed mesh of two devices (two CPU devices here):
    two lanes a device, so a lane's cap is 6 // 2 = 3 (JAX
    ``lanes_per_dev``), and each lane is the serial run of its seed at that
    cap, bit for bit."""
    env = tiny_env("tulip")
    seeds = [0, 1, 2, 3]
    tr = SeedParallelTrainer(env, tiny_cfg(), seeds, mesh=["cpu", "cpu"])
    assert tr.devices == [torch.device("cpu")] * 2
    assert all(lane.cfg.accum_chunk_groups == 3 for lane in tr.lanes)
    es, obs, carry = tr._reset_all()
    *_, m = tr.train_iteration(es, obs, carry)
    for lane, seed in enumerate(seeds):
        ser, t, _ = run_serial(env, tiny_cfg(), seed, 1)
        for k in METRICS:
            assert m[k][lane] == ser[0][k], (seed, k)
        _state_equal(tr.lanes[lane], t)


@pytest.mark.parametrize("spec,want", [("0-9", list(range(10))), ("0,2,5", [0, 2, 5]),
                                       ("3, 1-2,3", [1, 2, 3]), ("7", [7])])
def test_parse_seeds(spec, want):
    assert load_script("train_torch")._parse_seeds(spec) == want


@pytest.mark.parametrize("spec,match", [("", "names no seed"), (" , ", "names no seed"),
                                        ("9-0", "reversed range"), ("0-x", "--seeds")])
def test_parse_seeds_refuses(spec, match):
    with pytest.raises(SystemExit, match=match):
        load_script("train_torch")._parse_seeds(spec)
