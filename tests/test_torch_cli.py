"""The port's command lines on the CPU, in process: ``train_torch.py``
(train one iteration, then resume with ``--checkpoint latest``),
``play_torch.py`` (with and without ``--render``),
``eval_checkpoints_torch.py``, the mixed-precision and seed-parallel
options, the options the port refuses, and the card width check (fault
F1), which runs before the env is built.

dandelion at ``--num_envs 2 --hidden_dim 16``, from its YAML with the
horizon cut to 100 decisions and the summary and checkpoint intervals to
one iteration (100 × 2 × 20 = 4,000 decisions). cyclamen (the LSTM actor)
the same way from its YAML, with the horizon cut to 20 decisions and the
BPTT windows to 8, so that its update has windows of 8, 8 and 4 decisions
(two groups); its resume must restore the saved state bit for bit, and
play carries the LSTM state. The writer is the JSONL one, so no
TensorBoard import slows the run.
"""

import contextlib
import copy
import io
import json
import pathlib

import pytest
import torch
import yaml

from swarmacb_torch.agents import SeedParallelTrainer
from swarmacb_torch.utils import JsonlWriter
from torch_scripts import load_script
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DANDELION = str(ROOT / "configs" / "DirGate_dandelion.yaml")
CYCLAMEN = str(ROOT / "configs" / "DirGate_cyclamen.yaml")
ITER = 100 * 2 * 20
CYC_ITER = 20 * 2 * 20
SMALL = ["--config", DANDELION, "--device", "cpu", "--num_envs", "2", "--hidden_dim", "16"]
TAGS = ["Losses/Policy Loss", "Losses/Value Loss", "Losses/POCA/Baseline Loss",
        "Policy/Entropy", "Policy/Learning Rate", "Policy/Epsilon", "Policy/Beta",
        "Policy/Extrinsic Reward", "Policy/Extrinsic Value Estimate", "Policy/Std dim0",
        "Policy/Std dim1", "Policy/Log Std Mean", "Extra/SPS", "Extra/Mean Rollout Reward",
        "Extra/Rolling Avg Rollout Reward", "Extra/Mean Abs Advantage"]


@pytest.fixture(scope="module")
def train_torch():
    return load_script("train_torch")


@pytest.fixture(scope="module")
def play_torch():
    return load_script("play_torch")


@pytest.fixture(scope="module")
def trained(tmp_path_factory, train_torch):
    """One iteration from scratch, then one more resumed from the newest
    checkpoint; returns (checkpoint dir, log dir, the two runs' output)."""
    root = tmp_path_factory.mktemp("cli")
    cfg = yaml.safe_load(pathlib.Path(DANDELION).read_text())
    cfg["behaviors"]["DirGate_dandelion"].update(time_horizon=100, summary_freq=ITER,
                                                 checkpoint_interval=ITER)
    (root / "dandelion.yaml").write_text(yaml.safe_dump(cfg))
    argv = [*SMALL, "--config", str(root / "dandelion.yaml"), "--checkpoint", "latest",
            "--checkpoint_dir", str(root / "ckpt"), "--log_dir", str(root / "logs")]
    mp = pytest.MonkeyPatch()
    mp.setattr(train_torch, "make_writer", JsonlWriter)
    outputs = []
    try:
        for total in (ITER, 2 * ITER):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                trainer = train_torch.main([*argv, "--total_timesteps", str(total)])
            outputs.append((buf.getvalue(), trainer))
    finally:
        mp.undo()
    return root / "ckpt", root / "logs", outputs


@pytest.fixture(scope="module")
def trained_cyclamen(tmp_path_factory, train_torch):
    """cyclamen: one iteration from scratch, then ``prepare`` of the resume
    (the state it restored) and one more iteration; returns (checkpoint
    dir, the first run's output and trainer, the state the resume
    restored, the resumed trainer)."""
    root = tmp_path_factory.mktemp("cli_cyclamen")
    cfg = yaml.safe_load(pathlib.Path(CYCLAMEN).read_text())
    block = cfg["behaviors"]["DirGate_cyclamen"]
    block.update(time_horizon=20, summary_freq=CYC_ITER, checkpoint_interval=CYC_ITER)
    block["network_settings"]["memory"]["sequence_length"] = 8
    (root / "cyclamen.yaml").write_text(yaml.safe_dump(cfg))
    argv = ["--config", str(root / "cyclamen.yaml"), "--device", "cpu", "--num_envs", "2",
            "--hidden_dim", "16", "--checkpoint", "latest", "--checkpoint_dir",
            str(root / "ckpt"), "--log_dir", str(root / "logs")]
    mp = pytest.MonkeyPatch()
    mp.setattr(train_torch, "make_writer", JsonlWriter)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            first = train_torch.main([*argv, "--total_timesteps", str(CYC_ITER)])
            resumed, ckpt = train_torch.prepare([*argv, "--total_timesteps",
                                                 str(2 * CYC_ITER)])
            restored = {"actor": {k: v.clone() for k, v in resumed.actor.state_dict().items()},
                        "optimizer": copy.deepcopy(resumed.optimizer.state_dict())}
            resumed.train(checkpointer=ckpt)
    finally:
        mp.undo()
    return root / "ckpt", buf.getvalue(), first, restored, resumed


def test_cyclamen_trains_resumes_exactly_and_plays(trained_cyclamen, play_torch):
    ckpt, out, first, restored, resumed = trained_cyclamen
    assert first.recurrent and type(first.actor).__name__ == "RecurrentDiscreteActor"
    assert (first.cfg.memory_size, first.cfg.sequence_length) == (128, 8)
    assert first._window_groups() == {8: [0, 8], 4: [16]}
    assert "upd=1" in out and "upd=2" in out
    meta = json.loads((ckpt / "poca_final" / "metadata.json").read_text())
    assert (meta["variant"], meta["recurrent"], meta["memory_size"],
            meta["sequence_length"], meta["global_step"]) == ("cyclamen", True, 128, 8,
                                                              2 * CYC_ITER)
    saved = torch.load(ckpt / f"poca_{CYC_ITER}" / "state.pt", weights_only=True)
    assert restored["actor"].keys() == saved["actor"].keys()
    assert all(torch.equal(restored["actor"][k], v) for k, v in saved["actor"].items())
    for i, s in saved["optimizer"]["state"].items():
        assert all(torch.equal(restored["optimizer"]["state"][i][k], v) for k, v in s.items())
    assert (resumed.global_step, resumed.update_count) == (2 * CYC_ITER, 2)
    stats = play_torch.main(["--checkpoint", str(ckpt / "poca_final"), "--device", "cpu",
                             "--num_envs", "2", "--num_episodes", "4", "--episode_length",
                             "5"])
    assert stats["env_steps"] == 98 and len(stats["returns"]) == 4
    assert list(stats["lengths"]) == [49.0] * 4


def test_cyclamen_variant_flag_builds_the_lstm_actor(train_torch, tmp_path):
    """``--variant cyclamen`` on another variant's YAML switches on the LSTM
    actor, as ``--config`` of cyclamen's YAML does."""
    trainer, _ = train_torch.prepare([*SMALL, "--variant", "cyclamen", "--no-tensorboard",
                                      "--checkpoint_dir", str(tmp_path)])
    assert trainer.recurrent and trainer.env.cfg.variant == "cyclamen"
    assert trainer.actor.lstm.w_hh.shape == (128, 512)


def test_play_carries_and_zeroes_the_lstm_state(trained_cyclamen, play_torch, monkeypatch):
    """play_torch.py steps the actor with the carry it returned, and zeroes
    an arena's carry once its episode ended (scripts/play.py:216-220)."""
    from swarmacb_torch.models import RecurrentDiscreteActor

    seen = []
    step = RecurrentDiscreteActor.step

    def spy(self, obs, carry):
        seen.append(carry[0].clone())
        out = step(self, obs, carry)
        seen.append(out[1][0].clone())
        return out

    monkeypatch.setattr(RecurrentDiscreteActor, "step", spy)
    stats = play_torch.main(["--checkpoint", str(trained_cyclamen[0] / "poca_final"),
                             "--device", "cpu", "--num_envs", "2", "--num_episodes", "4",
                             "--episode_length", "1", "--deterministic"])
    assert stats["env_steps"] == 18 and stats["lengths"].tolist() == [9.0] * 4
    ins, outs = seen[0::2], seen[1::2]
    assert not ins[0].any()                       # the first step starts from zeros
    for t in range(1, 18):
        if t == 9:                                # both episodes ended at step 9
            assert outs[t - 1].any() and not ins[t].any()
        else:                                     # otherwise the carry goes on
            assert torch.equal(ins[t], outs[t - 1])


def test_train_then_resume(trained):
    ckpt, logs, ((out1, t1), (out2, t2)) = trained
    assert "starting fresh" in out1 and "upd=1" in out1
    assert f"Loaded ← {ckpt / f'poca_{ITER}'}" in out2 and "upd=2" in out2
    assert (t1.global_step, t1.update_count) == (ITER, 1)
    assert (t2.global_step, t2.update_count) == (2 * ITER, 2)
    assert sorted(p.name for p in ckpt.iterdir()) == [
        f"poca_{ITER}", f"poca_{2 * ITER}", "poca_final"]
    meta = json.loads((ckpt / "poca_final" / "metadata.json").read_text())
    assert (meta["global_step"], meta["update_count"], meta["variant"]) == (
        2 * ITER, 2, "dandelion")
    records = [json.loads(line) for line in (logs / "scalars.jsonl").read_text().splitlines()]
    assert [r["tag"] for r in records if "text" in r] == ["hyperparameters"] * 2
    for step in (ITER, 2 * ITER):
        tags = [r["tag"] for r in records if r.get("step") == step and "value" in r]
        assert [t for t in tags if t in TAGS] == TAGS, step


def test_play_gives_the_episode_length(trained, play_torch, capsys):
    ckpt = trained[0] / "poca_final"
    stats = play_torch.main(["--checkpoint", str(ckpt), "--device", "cpu", "--num_envs", "2",
                             "--num_episodes", "2", "--episode_length", "10",
                             "--deterministic"])
    out = capsys.readouterr().out
    assert "── Evaluation results" in out and "mean len : 99.0" in out
    assert stats["env_steps"] == 99 and len(stats["returns"]) == 2


def test_play_renders_headless(trained, play_torch, monkeypatch, capsys):
    pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    play_torch.main(["--checkpoint", str(trained[0] / "poca_final"), "--device", "cpu",
                     "--num_envs", "1", "--num_episodes", "1", "--episode_length", "5",
                     "--render", "--hz", "1000"])
    assert "mean len : 49.0" in capsys.readouterr().out


def test_eval_checkpoints_prints_its_table(trained, capsys):
    rows = load_script("eval_checkpoints_torch").main(
        [str(trained[0]), "--episodes", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [(name, mode) for name, mode, _ in rows] == [("ckpt", "stoch"), ("ckpt", "det")]
    assert "| run | mode | mean | std | min | max | median |" in out
    assert "| ckpt | det |" in out and "| ckpt | stoch |" in out


def _no_env(*args, **kwargs):
    raise AssertionError("the env was built")


@pytest.mark.parametrize("flags,world,cuda,message", [
    (["--num_envs", "3", "--data_parallel", "2"], None, False,
     "num_envs=3 not divisible by 2 ranks"),
    (["--seeds", "0-2", "--data_parallel", "2"], None, False,
     "3 seeds not divisible by 2 devices"),
    (["--seeds", "0-1", "--distributed"], "2", False,
     "--seeds with --distributed over several processes"),
    (["--data_parallel", "2", "--distributed"], "1", False,
     "--data_parallel 2 under --distributed: torchrun started 1 rank"),
    (["--data_parallel", "2"], None, True, "--data_parallel 2: 1 GPU"),
])
def test_unported_options_stop_before_the_env(train_torch, monkeypatch, flags, world, cuda,
                                              message):
    """The data-parallel options the port refuses stop the run before the
    env is built or any rank starts: arenas (or, with ``--seeds``, seeds)
    that do not divide over the ranks, ``--seeds`` over several
    ``torchrun`` processes, a ``--data_parallel`` other than the world
    ``torchrun`` started, and more ranks than visible GPUs on the card (no
    card is needed to name one)."""
    monkeypatch.setattr(train_torch, "make_env", _no_env)
    monkeypatch.setattr(train_torch, "make_mesh", _no_env)
    if world is not None:
        monkeypatch.setenv("WORLD_SIZE", world)
    if cuda:
        monkeypatch.setattr(train_torch, "resolve_device", lambda device: torch.device("cuda"))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=message):
        train_torch.main([*SMALL, *flags])


@pytest.mark.parametrize("flags,mixed,stages,seeds", [
    (["--mixed_precision"], True, "qkvo", None),
    (["--mp_stages", "qk"], False, "qk", None),
    (["--mixed_precision", "--mp_stages", "auto"], True, "qkvo", None),
    (["--seeds", "0-1"], False, "qkvo", [0, 1]),
    (["--seeds", "0-1", "--data_parallel", "2"], False, "qkvo", [0, 1]),
])
def test_ported_options_are_taken(train_torch, tmp_path, capsys, flags, mixed, stages, seeds):
    """``--mixed_precision``, ``--mp_stages`` (a subset of "qkvo", or the
    variant's validated stages with ``auto``) and ``--seeds`` build, and one
    iteration of 10 decisions trains with finite losses; ``--seeds`` gives
    each seed its ``_seed<s>`` directories."""
    cfg = yaml.safe_load(pathlib.Path(DANDELION).read_text())
    cfg["behaviors"]["DirGate_dandelion"].update(time_horizon=10)
    (tmp_path / "dandelion.yaml").write_text(yaml.safe_dump(cfg))
    ckpt = tmp_path / "ckpt"
    trainer = train_torch.main([*SMALL, "--config", str(tmp_path / "dandelion.yaml"),
                                "--total_timesteps", str(10 * 2 * 20), "--no-tensorboard",
                                "--checkpoint_dir", str(ckpt), "--log_dir",
                                str(tmp_path / "logs"), *flags])
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[POCA] step=")]
    assert len(line) == 1 and "upd=1" in line[0]
    assert "nan" not in line[0] and "inf" not in line[0]
    assert (trainer.cfg.mixed_precision, trainer.cfg.mp_stages) == (mixed, stages)
    lanes = trainer.lanes if seeds else [trainer]
    dtype = torch.bfloat16 if mixed else None
    for lane in lanes:
        assert lane.critic.self_attn.dtypes == {s: dtype if s in stages else None
                                                for s in "qkvo"}
        assert all(bool(torch.isfinite(p).all()) for p in lane.critic.parameters())
    if seeds:
        assert isinstance(trainer, SeedParallelTrainer) and trainer.seeds == seeds
        assert len(trainer.devices) == (2 if "--data_parallel" in flags else 1)
        assert trainer.alive.all()
        for s in seeds:
            assert (tmp_path / f"ckpt_seed{s}" / "poca_final" / "metadata.json").exists()
        assert not ckpt.exists()
    else:
        assert (ckpt / "poca_final" / "metadata.json").exists()


def test_mp_stages_auto_refuses_a_variant_outside_its_table(train_torch, monkeypatch):
    monkeypatch.setattr(train_torch, "VALIDATED_MP_STAGES", {"lily": "qk"})
    monkeypatch.setattr(train_torch, "make_env", _no_env)
    with pytest.raises(SystemExit, match="no validated bf16 stages for 'dandelion'"):
        train_torch.main([*SMALL, "--mixed_precision", "--mp_stages", "auto"])


@pytest.mark.parametrize("flags,message", [
    (["--mp_stages", "qkx"], "subset of 'qkvo'"),
    (["--seeds", "9-0"], "reversed range"),
    (["--seeds", "0-1", "--checkpoint", "some/dir"], "only via --checkpoint latest"),
])
def test_bad_precision_and_seed_options_stop_before_the_env(train_torch, monkeypatch, flags,
                                                             message):
    monkeypatch.setattr(train_torch, "make_env", _no_env)
    with pytest.raises(SystemExit, match=message):
        train_torch.main([*SMALL, *flags])


@pytest.mark.parametrize("flags", [[], ["--fused_attention", "on"]])
def test_card_widths_are_checked_before_the_env(train_torch, monkeypatch, flags):
    """F1 closed: on the card, ``--hidden_dim 1024``, a width the tuned
    critic kernels refuse, passes every check and reaches the env (the
    critic takes the kernels' wide route). Naming the CUDA device, and
    counting one GPU, needs no card."""
    monkeypatch.setattr(train_torch, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(train_torch, "make_env", _no_env)
    with pytest.raises(AssertionError, match="the env was built"):
        train_torch.main(["--config", DANDELION, "--hidden_dim", "1024", *flags])


def test_ignored_kernel_flags_print_one_note(train_torch, monkeypatch, capsys):
    monkeypatch.setattr(train_torch, "make_env", _no_env)
    with pytest.raises(AssertionError, match="the env was built"):
        train_torch.main([*SMALL, "--use_pallas", "on", "--fused_tail", "off"])
    assert capsys.readouterr().out.count("NOTE: --use_pallas and --fused_tail are ignored") == 1
