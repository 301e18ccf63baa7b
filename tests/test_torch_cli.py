"""The port's command lines on the CPU, in process: ``train_torch.py``
(train one iteration, then resume with ``--checkpoint latest``),
``play_torch.py`` (with and without ``--render``),
``eval_checkpoints_torch.py``, the options the port refuses, and the card
width check (fault F1), which runs before the env is built.

dandelion at ``--num_envs 2 --hidden_dim 16``, from its YAML with the
horizon cut to 100 decisions and the summary and checkpoint intervals to
one iteration (100 × 2 × 20 = 4,000 decisions). The writer is the JSONL
one, so no TensorBoard import slows the run.
"""

import contextlib
import io
import json
import pathlib

import pytest
import torch
import yaml

from swarmacb_torch.utils import JsonlWriter
from torch_scripts import load_script

ROOT = pathlib.Path(__file__).resolve().parents[1]
DANDELION = str(ROOT / "configs" / "DirGate_dandelion.yaml")
ITER = 100 * 2 * 20
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


@pytest.mark.parametrize("flags,message", [
    (["--mixed_precision"], "item 10"),
    (["--mp_stages", "qk"], "item 10"),
    (["--seeds", "0-1"], "items 12 and 13"),
    (["--distributed"], "items 12 and 13"),
    (["--data_parallel", "4"], "items 12 and 13"),
    (["--variant", "cyclamen"], "item 9"),
    (["--config", str(ROOT / "configs" / "DirGate_cyclamen.yaml")], "item 9"),
])
def test_unported_options_stop_before_the_env(train_torch, monkeypatch, flags, message):
    monkeypatch.setattr(train_torch, "make_env", _no_env)
    with pytest.raises(SystemExit, match=message):
        train_torch.main([*SMALL, *flags])


@pytest.mark.parametrize("flags,message", [
    ([], "fused_tail: the kernels take"),
    (["--fused_attention", "on"], "fused_cf_attention: the kernels take"),
])
def test_card_widths_are_checked_before_the_env(train_torch, monkeypatch, flags, message):
    """F1: on the card, a width its kernels refuse stops the run at once,
    with the kernels' message. Naming the CUDA device needs no card."""
    monkeypatch.setattr(train_torch, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(train_torch, "make_env", _no_env)
    with pytest.raises(SystemExit, match=message):
        train_torch.main(["--config", DANDELION, "--hidden_dim", "1024", *flags])


def test_ignored_kernel_flags_print_one_note(train_torch, monkeypatch, capsys):
    monkeypatch.setattr(train_torch, "make_env", _no_env)
    with pytest.raises(AssertionError, match="the env was built"):
        train_torch.main([*SMALL, "--use_pallas", "on", "--fused_tail", "off"])
    assert capsys.readouterr().out.count("NOTE: --use_pallas and --fused_tail are ignored") == 1
