"""``scripts/train_torch.py`` over several processes on the CPU: the
counterpart of tests/test_multiprocess.py.

``--data_parallel 2 --device cpu`` spawns two gloo ranks of two arenas
each (dandelion from its YAML at ``--num_envs 4 --hidden_dim 16``, the
horizon cut to 10 decisions, summaries and checkpoints every iteration of
800 decisions) and trains two iterations. Both ranks must print the same
parameter digest, the digest of the ``poca_final`` that rank 0 alone
saved; rank 0 alone prints the iteration lines and saves;
``--checkpoint latest`` restores the step on both ranks and trains a third
iteration in lockstep. A world of one under ``--distributed`` (torchrun's
variables set by hand) must save the plain run's ``poca_final`` bit for
bit. Every run is a subprocess with a time limit, one thread a process,
and ``--no-tensorboard`` (TensorBoard's import takes as long as a run).
That rank 0 alone makes a summary writer is held in process: ``prepare``
of each rank of a two-rank mesh, its collectives stubbed. So is that each
line the trainer and the checkpointer print goes out as one write: the
ranks share their parent's standard output, and where it is unbuffered
(PYTHONUNBUFFERED, ``python -u``) ``print`` writes a line's text and its
newline apart, so that another rank's line could land between them.
"""

import contextlib
import io
import json
import os
import pathlib
import re
import socket
import subprocess
import sys

import pytest
import torch
import yaml

from swarmacb_torch.parallel import Mesh, digest
from torch_scripts import load_script
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "train_torch.py"
ITER = 10 * 4 * 20
DIGEST = re.compile(r"\[train\] rank (\d)/(\d) \(gloo, cpu\): step ([\d,]+), "
                    r"parameter digest ([0-9a-f]{64})")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(tmp, name, *flags, env=None):
    """train_torch.py in a subprocess, its checkpoints and logs under
    ``tmp/name``."""
    argv = [sys.executable, str(SCRIPT), "--config", str(tmp / "dandelion.yaml"),
            "--device", "cpu", "--num_envs", "4", "--hidden_dim", "16",
            "--no-tensorboard", "--checkpoint_dir", str(tmp / name / "ckpt"),
            "--log_dir", str(tmp / name / "logs"), *flags]
    return subprocess.Popen(argv, env={**os.environ, "OMP_NUM_THREADS": "1", **(env or {})},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=90):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, f"train_torch.py failed:\n{out[-2000:]}\n{err[-3000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    cfg = yaml.safe_load((ROOT / "configs" / "DirGate_dandelion.yaml").read_text())
    cfg["behaviors"]["DirGate_dandelion"].update(time_horizon=10, summary_freq=ITER,
                                                 checkpoint_interval=ITER)
    (tmp / "dandelion.yaml").write_text(yaml.safe_dump(cfg))
    two = str(2 * ITER)
    torchrun = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    procs = {"dp": _start(tmp, "dp", "--data_parallel", "2", "--total_timesteps", two),
             "plain": _start(tmp, "plain", "--total_timesteps", two),
             "world1": _start(tmp, "world1", "--distributed", "--total_timesteps", two,
                              env=torchrun)}
    out = {name: _finish(p) for name, p in procs.items()}
    out["resume"] = _finish(_start(tmp, "dp", "--data_parallel", "2", "--checkpoint", "latest",
                                   "--total_timesteps", str(3 * ITER)))
    return tmp, out


def _digests(out):
    return sorted((int(r), int(w), int(step.replace(",", "")), d)
                  for r, w, step, d in DIGEST.findall(out))


def _state(path):
    return torch.load(path / "state.pt", map_location="cpu", weights_only=True)


def test_two_ranks_train_in_lockstep(runs):
    tmp, out = runs
    (r0, w0, s0, d0), (r1, w1, s1, d1) = _digests(out["dp"])
    assert (r0, r1, w0, w1, s0, s1) == (0, 1, 2, 2, 2 * ITER, 2 * ITER)
    assert d0 == d1
    # the first run's last save (the resumed run has since replaced poca_final)
    state = _state(tmp / "dp" / "ckpt" / f"poca_{2 * ITER}")
    assert d0 == digest([*state["actor"].values(), *state["critic"].values()])
    assert "[train] data-parallel over 2 rank(s) (gloo): 2 arenas a rank" in out["dp"]


def test_rank_zero_alone_writes(runs):
    tmp, out = runs
    assert sum(l.startswith("[POCA] step=") for l in out["dp"].splitlines()) == 2
    saved = [l.split("/")[-1] for l in out["dp"].splitlines() if l.startswith("[POCA] Saved")]
    assert saved == [f"poca_{ITER}", f"poca_{2 * ITER}", "poca_final"]


class _Writes(io.StringIO):
    """A standard output that keeps each write apart."""

    def __init__(self):
        super().__init__()
        self.writes = []

    def write(self, s):
        self.writes.append(s)
        return super().write(s)


def test_each_printed_line_is_one_write(tmp_path, monkeypatch):
    """One iteration of ``train_torch.py`` in process, its checkpoint saved,
    then a second resumed from it: every line of the trainer and the
    checkpointer is one write of the line and its newline."""
    cfg = yaml.safe_load((ROOT / "configs" / "DirGate_dandelion.yaml").read_text())
    cfg["behaviors"]["DirGate_dandelion"].update(time_horizon=10, summary_freq=ITER,
                                                 checkpoint_interval=ITER)
    (tmp_path / "dandelion.yaml").write_text(yaml.safe_dump(cfg))
    argv = ["--config", str(tmp_path / "dandelion.yaml"), "--device", "cpu", "--num_envs", "4",
            "--hidden_dim", "16", "--no-tensorboard", "--total_timesteps", str(ITER),
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "logs")]
    train_torch = load_script("train_torch")
    out = _Writes()
    monkeypatch.setattr("sys.stdout", out)
    train_torch.main(argv)
    train_torch.main([*argv[:-4], "--total_timesteps", str(2 * ITER), "--checkpoint", "latest",
                      *argv[-4:]])
    lines = [w for w in out.writes if w.startswith(("[POCA]", "[train] rank"))]
    assert {w.split(" ")[1] for w in lines} >= {"step=800", "Saved", "Loaded", "step=1,600"}
    assert all(w.endswith("\n") and w.count("\n") == 1 for w in lines), lines


class _TwoRanks(Mesh):
    """A rank of a two-rank CPU mesh with no process group behind it."""

    def check_replicated(self, tensors, what):
        pass


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_zero_alone_makes_a_summary_writer(tmp_path, monkeypatch, rank):
    train_torch = load_script("train_torch")
    made = []
    monkeypatch.setattr(train_torch, "make_writer", lambda d: made.append(d) or _Writer())
    monkeypatch.setattr(train_torch, "make_mesh", lambda **kw: _TwoRanks(
        rank=kw["rank"], world=kw["world"], device=torch.device("cpu"), group=None,
        backend="gloo"))
    argv = ["--config", str(ROOT / "configs" / "DirGate_dandelion.yaml"), "--device", "cpu",
            "--num_envs", "4", "--hidden_dim", "16", "--data_parallel", "2",
            "--log_dir", str(tmp_path / "logs"), "--checkpoint_dir", str(tmp_path / "ckpt")]
    with contextlib.redirect_stdout(io.StringIO()):
        trainer, _ = train_torch.prepare(argv, rank=rank, init_method="unused")
    assert (trainer.rank, trainer.world, trainer.env.shard) == (rank, 2, (2 * rank, 4))
    assert made == ([str(tmp_path / "logs")] if rank == 0 else [])
    assert (trainer.writer is None) == (rank == 1)


class _Writer:
    def add_text(self, *args):
        pass


def test_resume_restores_the_step_on_both_ranks(runs):
    tmp, out = runs
    loaded = [l for l in out["resume"].splitlines() if l.startswith("[POCA] Loaded")]
    assert len(loaded) == 2 and all(f"poca_{2 * ITER}" in l and f"(step {2 * ITER})" in l
                                    for l in loaded)
    (_, _, s0, d0), (_, _, s1, d1) = _digests(out["resume"])
    assert s0 == s1 == 3 * ITER and d0 == d1
    meta = json.loads((tmp / "dp" / "ckpt" / "poca_final" / "metadata.json").read_text())
    assert (meta["global_step"], meta["update_count"]) == (3 * ITER, 3)


def test_world_of_one_equals_the_plain_run(runs):
    tmp, out = runs
    assert "[train] data-parallel over 1 rank(s) (gloo): 4 arenas a rank" in out["world1"]
    plain = _state(tmp / "plain" / "ckpt" / "poca_final")
    world1 = _state(tmp / "world1" / "ckpt" / "poca_final")
    for net in ("actor", "critic"):
        assert plain[net].keys() == world1[net].keys()
        for k, v in plain[net].items():
            assert torch.equal(v, world1[net][k]), f"{net}.{k}"
    for i, s in plain["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, world1["optimizer"]["state"][i][k]), (i, k)
