"""Checkpoints, summaries and the training loop's cadence of the port,
against the JAX package, on the CPU (tiny trainers: E = 2, T = 4,
hidden 16).

- The checkpointer's policy as ``tests/test_trainer.py`` holds the JAX one
  to: rotation, crash debris, ``latest()`` falling back to ``poca_final``,
  and a quarantined save that never resumes.
- ``metadata.json`` carries the JAX trainer's ``checkpoint_metadata()``
  (dandelion and daisy) plus the counters.
- A save and a restore into a freshly built trainer give a bit-identical
  next update: parameters and Adam state.
- ``_write_summaries`` emits the JAX trainer's (tag, step) sequence, values
  within 1e-6 relative, from the same metrics, episode lists, reward
  history and log_std.
- ``train()`` summarises and saves at the JAX loop's steps on a fresh run;
  on a resumed run its cadence follows the restored step.
- A non-finite loss leaves ``poca_diverged_<step>`` and raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmacb_tpu.agents import POCAConfig as JaxPOCAConfig
from swarmacb_tpu.agents import POCATrainer as JaxTrainer
from swarmacb_tpu.config.env_cfg import DirectionalGateEnvCfg as JaxEnvCfg
from swarmacb_tpu.env.directional_gate import DirectionalGateEnv as JaxEnv

from swarmacb_torch.agents import Checkpointer, POCAConfig, POCATrainer, Rollout
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import DirectionalGateEnv

E, T, N, HID = 2, 4, 20, 16
TINY = dict(hidden_dim=HID, horizon=T, mini_batch_size=3, accum_chunk_groups=2)


def tiny(variant="dandelion", **cfg):
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=E),
                             device="cpu")
    return POCATrainer(env, POCAConfig(**{**TINY, **cfg}))


@pytest.fixture(scope="module")
def jax_trainers():
    built = {}

    def get(variant):
        if variant not in built:
            built[variant] = JaxTrainer(JaxEnv(JaxEnvCfg(variant=variant, num_envs=E)),
                                        JaxPOCAConfig(**TINY))
        return built[variant]
    return get


# ── the checkpointer's policy ─────────────────────────────────────────────

def test_checkpoint_rotation(tmp_path):
    trainer = tiny()
    ck = Checkpointer(tmp_path, keep=2)
    for i in range(4):
        trainer.global_step = (i + 1) * 100
        ck.save(trainer)
    kept = sorted(p.name for p in tmp_path.glob("poca_*"))
    assert kept == ["poca_300", "poca_400"]
    assert sorted(p.name for p in (tmp_path / "poca_400").iterdir()) == [
        "metadata.json", "state.pt"]


def test_crash_debris_is_removed_and_never_resumed(tmp_path):
    """A numbered directory without metadata (a save that died before its
    sidecar) cannot be restored: ``latest()`` skips it and the next
    rotation deletes it instead of counting it toward ``keep``."""
    trainer = tiny()
    ck = Checkpointer(tmp_path, keep=2)
    trainer.global_step = 100
    good = ck.save(trainer)
    (tmp_path / "poca_200").mkdir()
    assert ck.latest() == good
    trainer.global_step = 300
    ck.save(trainer)
    assert sorted(p.name for p in tmp_path.glob("poca_*")) == ["poca_100", "poca_300"]


def test_latest_falls_back_to_final(tmp_path):
    trainer = tiny()
    ck = Checkpointer(tmp_path, keep=2)
    assert ck.latest() is None
    trainer.global_step = 500
    final = ck.save(trainer, final=True)
    assert final.name == "poca_final" and ck.latest() == final
    assert Checkpointer.load_metadata(final)["global_step"] == 500


def test_quarantined_checkpoint_never_resumes(tmp_path):
    trainer = tiny()
    ck = Checkpointer(tmp_path, keep=2)
    trainer.global_step = 100
    good = ck.save(trainer)
    trainer.global_step = 200
    bad = ck.save(trainer, quarantine=True)
    assert bad.name == "poca_diverged_200" and bad.exists()
    assert ck.latest() == good
    for step in (300, 400, 500):
        trainer.global_step = step
        ck.save(trainer)
    names = {p.name for p in tmp_path.glob("poca_*")}
    assert names == {"poca_diverged_200", "poca_400", "poca_500"}
    assert ck.latest().name == "poca_500"


def test_a_save_replaces_a_directory_of_the_same_name(tmp_path):
    trainer = tiny()
    ck = Checkpointer(tmp_path)
    (tmp_path / "poca_final").mkdir()
    (tmp_path / "poca_final" / "stale").write_text("x")
    path = ck.save(trainer, final=True)
    assert sorted(p.name for p in path.iterdir()) == ["metadata.json", "state.pt"]


@pytest.mark.parametrize("variant", ["dandelion", "daisy"])
def test_metadata_matches_jax(tmp_path, jax_trainers, variant):
    jtrainer = jax_trainers(variant)
    trainer = tiny(variant)
    assert trainer.checkpoint_metadata() == jtrainer.checkpoint_metadata()
    trainer.global_step, trainer.update_count = 4321, 7
    meta = json.loads((Checkpointer(tmp_path).save(trainer) / "metadata.json").read_text())
    assert meta == {**jtrainer.checkpoint_metadata(), "global_step": 4321,
                    "update_count": 7}


# ── resume ────────────────────────────────────────────────────────────────

def _rollout(seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    data = dict(
        obs=rng.normal(size=(T, E, N, 24)).astype(f),
        critic_states=(rng.normal(size=(T, E, N, 5)) * 0.5).astype(f),
        actions=rng.normal(size=(T, E, N, 2)).astype(f),
        log_probs=rng.uniform(-2.5, -0.5, size=(T, E, N, 2)).astype(f),
        rewards=(rng.normal(size=(T, E)) * 0.5).astype(f),
        dones=np.array([[0, 1], [0, 0], [1, 0], [0, 0]], f),
        team_values=(rng.normal(size=(T, E)) * 0.5).astype(f),
        baselines=(rng.normal(size=(T, E, N)) * 0.5).astype(f))
    rollout = Rollout(**{k: torch.from_numpy(v) for k, v in data.items()})
    bootstrap = torch.from_numpy((rng.normal(size=(E,)) * 0.5).astype(f))
    perms = torch.from_numpy(np.stack([rng.permutation(T * E) for _ in range(3)]))
    return rollout, bootstrap, perms


def _update(trainer, seed):
    rollout, bootstrap, perms = _rollout(seed)
    c = trainer.cfg
    trainer._update(rollout, bootstrap, c.lr, c.clip_eps, c.beta, injected_perms=perms)


def _assert_same_state(a, b):
    for net in ("actor", "critic"):
        sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{net}.{k}"
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys() and len(oa) == len(list(a.optimizer.param_groups[0]["params"]))
    for i in oa:
        assert oa[i].keys() == ob[i].keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), f"optimizer state {i}.{k}"


def test_resume_is_exact(tmp_path):
    """Trainer A updates once (so Adam's moments are not zero) and saves;
    trainer B, built from another seed, restores. Both then take the same
    update: parameters and Adam state stay bit-identical."""
    a = tiny()
    _update(a, 1)
    a.global_step, a.update_count = 160, 1
    path = Checkpointer(tmp_path).save(a)
    b = tiny(seed=9)
    assert not torch.equal(a.actor.mu_head.weight, b.actor.mu_head.weight)
    meta = Checkpointer(tmp_path).restore(path, b)
    assert (b.global_step, b.update_count) == (160, 1) == (meta["global_step"],
                                                           meta["update_count"])
    _assert_same_state(a, b)
    assert float(b.optimizer.state_dict()["state"][0]["step"]) == 9.0
    _update(a, 2)
    _update(b, 2)
    _assert_same_state(a, b)
    assert float(b.optimizer.state_dict()["state"][0]["step"]) == 18.0


def test_restore_params(tmp_path):
    trainer = tiny()
    _update(trainer, 1)
    path = Checkpointer(tmp_path).save(trainer, final=True)
    params = Checkpointer.restore_params(path, device="cpu")
    for net in ("actor", "critic"):
        want = getattr(trainer, net).state_dict()
        assert params[net].keys() == want.keys()
        for k, v in params[net].items():
            assert v.device.type == "cpu" and torch.equal(v, want[k]), f"{net}.{k}"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Checkpointer.restore_params(path)


# ── summaries ─────────────────────────────────────────────────────────────

class RecordingWriter:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def flush(self):
        pass


@pytest.mark.parametrize("variant", ["dandelion", "daisy"])
def test_summaries_match_jax(monkeypatch, jax_trainers, variant):
    jtrainer = jax_trainers(variant)
    trainer = tiny(variant)
    rng = np.random.default_rng(4)
    m = {k: float(v) for k, v in zip(
        ("policy_loss", "value_loss", "baseline_loss", "entropy", "mean_abs_advantage",
         "lr", "eps", "beta", "mean_rollout_reward", "mean_step_reward",
         "mean_team_value"), rng.normal(size=11))}
    lists = {name: rng.normal(size=5).tolist() for name in (
        "completed_episode_returns", "completed_episode_lengths",
        "completed_group_rewards", "_rollout_reward_history")}
    if not trainer.discrete:
        log_std = rng.normal(scale=0.3, size=(1, 2)).astype(np.float32)
        trainer.actor.log_std.data.copy_(torch.from_numpy(log_std))
        params = jax.tree_util.tree_map(lambda x: x, jtrainer.train_state.params)
        params["actor"]["log_std"] = jnp.asarray(log_std)
        monkeypatch.setattr(jtrainer, "train_state",
                            jtrainer.train_state.replace(params=params))
    written = []
    for t in (jtrainer, trainer):
        monkeypatch.setattr(t, "writer", RecordingWriter())
        monkeypatch.setattr(t, "global_step", 12345)
        for name, values in lists.items():
            monkeypatch.setattr(t, name, list(values))
        t._write_summaries(m, 987.5)
        written.append(t.writer.scalars)
        assert not t.completed_episode_returns and not t.completed_group_rewards
    want, got = written
    assert [(tag, s) for tag, _, s in got] == [(tag, s) for tag, _, s in want]
    np.testing.assert_allclose([v for _, v, _ in got], [v for _, v, _ in want], rtol=1e-6)
    tags = {tag for tag, _, _ in got}
    assert ("Policy/Std dim1" in tags) == (variant == "dandelion")
    assert len(got) == (19 if variant == "dandelion" else 16)


# ── the loop's cadence ────────────────────────────────────────────────────

class RecordingCheckpointer:
    def __init__(self):
        self.saves = []

    def save(self, trainer, final=False, quarantine=False):
        self.saves.append(("final" if final else "quarantine" if quarantine else "periodic",
                           trainer.global_step))


CADENCE = dict(summary_freq=250, checkpoint_interval=400, total_timesteps=1600)


def _fake_iterations(monkeypatch, trainer):
    """train_iteration adds one iteration's decisions without computing."""
    decisions = T * E * N
    m = dict.fromkeys(("policy_loss", "value_loss", "baseline_loss", "entropy"), 0.0)

    def step():
        trainer.global_step += decisions
        trainer.update_count += 1

    def fake(env_state, obs, carry):
        step()
        return env_state, obs, carry, m
    monkeypatch.setattr(trainer, "train_iteration", fake)
    summaries = []
    monkeypatch.setattr(trainer, "_write_summaries",
                        lambda m, sps: summaries.append(trainer.global_step))
    return summaries


def _cadence(monkeypatch, trainer, start=0):
    for name, value in CADENCE.items():
        monkeypatch.setattr(trainer.cfg, name, value)
    for name, value in (("global_step", start), ("update_count", 0),
                        ("writer", RecordingWriter())):
        monkeypatch.setattr(trainer, name, value)
    summaries = _fake_iterations(monkeypatch, trainer)
    ck = RecordingCheckpointer()
    trainer.train(checkpointer=ck, progress=False)
    return summaries, ck.saves


def test_cadence_matches_jax_on_a_fresh_run(monkeypatch, jax_trainers):
    jtrainer = jax_trainers("dandelion")
    want = _cadence(monkeypatch, jtrainer)
    got = _cadence(monkeypatch, tiny())
    assert got == want
    assert got == ([320, 640, 800, 1120, 1280, 1600],
                   [("periodic", 480), ("periodic", 800), ("periodic", 1280),
                    ("periodic", 1600), ("final", 1600)])


def test_resumed_cadence_follows_the_restored_step(monkeypatch):
    """From step 800 the next summary is at 1000 and the next save at 1200
    (the JAX loop would restart both at one interval)."""
    summaries, saves = _cadence(monkeypatch, tiny(), start=800)
    assert summaries == [1120, 1280, 1600]
    assert saves == [("periodic", 1280), ("periodic", 1600), ("final", 1600)]


def test_non_finite_loss_quarantines_and_raises(monkeypatch, tmp_path):
    trainer = tiny(total_timesteps=10 * T * E * N)
    nan = torch.tensor(float("nan"))
    monkeypatch.setattr(trainer, "_update", lambda *a, **k: dict.fromkeys(
        ("policy_loss", "value_loss", "baseline_loss", "entropy",
         "mean_abs_advantage"), nan))
    ck = Checkpointer(tmp_path)
    with pytest.raises(FloatingPointError, match="quarantined"):
        trainer.train(checkpointer=ck, progress=False)
    step = T * E * N
    assert trainer.update_count == 1
    assert [p.name for p in tmp_path.iterdir()] == [f"poca_diverged_{step}"]
    assert Checkpointer.load_metadata(tmp_path / f"poca_diverged_{step}")["global_step"] == step
    assert ck.latest() is None


@pytest.mark.parametrize("iterations", [3, 5])
def test_profile_dir_traces_iterations_two_to_four(tmp_path, iterations):
    """``profile_dir`` wraps iterations 2-4 in torch.profiler and writes the
    trace, also when the run ends before iteration 4."""
    trainer = tiny(total_timesteps=iterations * T * E * N)
    trainer.profile_dir = str(tmp_path / "trace")
    trainer.train(progress=False)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trainer.update_count == iterations and trace["traceEvents"]
