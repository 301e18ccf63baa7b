"""The validation pipeline on the port's output, on the CPU.

``scripts/train_torch.py --device cpu`` trains lily at a tiny size (two
arenas, ``--hidden_dim 16``, from a copy of its YAML with the horizon cut to
20 decisions, one summary and one checkpoint an iteration, and episodes of
1 s, so that every iteration completes some), two iterations from scratch,
then one more resumed with ``--checkpoint latest``. TensorBoard's writer is
the one the card's run uses. Held:

- ``scripts/extract_curves.py``'s ``extract`` reads ``Extra/Group Reward
  Mean`` back from the run's event files, one point at each step the
  trainer wrote it, with the value it wrote; the resumed run's point comes
  after the first run's, under the same tag;
- ``scripts/extract_curves.py --wall-time`` writes the curve's CSV, and
  ``scripts/validation_figures_torch.py`` computes its three figures;
- the same code gives JAX lily seed 1's figures from its CSV in
  ``docs/validation/``, 30.72 M, 29.81 and 35.45, and seeds 1–9's ranges,
  26.56–72.64 M (median 30.72 M), 15.30–34.90 and 31.91–36.47.
"""

import contextlib
import io
import pathlib
import statistics

import numpy as np
import pytest
import yaml

from torch_scripts import load_script
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LILY = ROOT / "configs" / "DirGate_lily.yaml"
JAX_CURVE = ROOT / "docs" / "validation" / "DirGate_lily_seed{}__extra_group_reward_mean.csv"
TAG = "Extra/Group Reward Mean"
T, E, N = 20, 2, 20
ITER = T * E * N


@pytest.fixture(scope="module")
def figures_script():
    return load_script("validation_figures_torch")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two iterations, then a third resumed; returns (log dir, the points
    the trainer wrote under TAG, each run's last step)."""
    from torch.utils.tensorboard import SummaryWriter

    train_torch = load_script("train_torch")
    root = tmp_path_factory.mktemp("curve")
    cfg = yaml.safe_load(LILY.read_text())
    block = cfg["behaviors"]["DirGate_lily"]
    block.update(time_horizon=T, summary_freq=ITER, checkpoint_interval=ITER)
    block["environment"]["episode_length_s"] = 1.0
    (root / "lily.yaml").write_text(yaml.safe_dump(cfg))
    logs = root / "DirGate_lily_torch_seed1"
    argv = ["--config", str(root / "lily.yaml"), "--device", "cpu", "--num_envs", str(E),
            "--hidden_dim", "16", "--seed", "1", "--checkpoint", "latest",
            "--checkpoint_dir", str(root / "ckpt"), "--log_dir", str(logs)]
    written = []

    class Recording(SummaryWriter):
        def add_scalar(self, tag, value, step=None, *args, **kwargs):
            if tag == TAG:
                written.append((step, float(value)))
            return super().add_scalar(tag, value, step, *args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(train_torch, "make_writer", Recording)
    ends = []
    try:
        for total in (2 * ITER, 3 * ITER):
            with contextlib.redirect_stdout(io.StringIO()):
                trainer = train_torch.main([*argv, "--total_timesteps", str(total)])
            assert trainer.env.cfg.max_episode_length < T
            ends.append(trainer.global_step)
    finally:
        mp.undo()
    return logs, written, ends


def test_extract_reads_each_logged_point_back(run):
    extract_curves = load_script("extract_curves")
    logs, written, ends = run
    assert ends == [2 * ITER, 3 * ITER]
    rows = extract_curves.extract(logs, TAG)
    assert rows, "no points under the tag"
    assert [s for s, _ in rows] == [s for s, _ in written] == [ITER, 2 * ITER, 3 * ITER]
    for (_, got), (_, want) in zip(rows, written):
        assert np.float32(got) == np.float32(want)
    # the resumed run wrote its point after the first run's, in its own
    # event file beside the first
    assert len(list(logs.glob("events.out.tfevents.*"))) == 2


def test_the_curve_s_figures(run, figures_script, tmp_path):
    extract_curves = load_script("extract_curves")
    logs, written, _ = run
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_curves.main([str(logs), "--out", str(tmp_path), "--wall-time"]) == 0
    csv = tmp_path / "DirGate_lily_torch_seed1__extra_group_reward_mean.csv"
    rows = figures_script.read_curve(csv)
    assert [s for s, _, _ in rows] == [s for s, _ in written]
    assert all(m is not None and m >= 0 for _, _, m in rows)
    f = figures_script.figures(rows)
    values = [v for _, v in written]
    # three points: no 5-point window, none at 54–60 M; the tail is the last
    assert f["points"] == 3 and f["last_step"] == 3 * ITER
    assert f["reach_step"] is None and f["mean_54_60M"] is None
    assert f["tail_mean"] == pytest.approx(values[-1], rel=1e-6)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert figures_script.main([str(csv)]) == 0
    assert "rolling mean reaches 25 at never; 54–60 M mean never" in out.getvalue()


def test_jax_lily_seed1_figures(figures_script):
    f = figures_script.figures(figures_script.read_curve(str(JAX_CURVE).format(1)))
    assert f["reach_step"] == 30_720_000
    assert round(f["mean_54_60M"], 2) == 29.81
    assert round(f["tail_mean"], 2) == 35.45
    assert f["points"] == 312 and f["last_step"] == 120_000_000


def test_jax_lily_seeds_ranges(figures_script):
    fs = [figures_script.figures(figures_script.read_curve(str(JAX_CURVE).format(s)))
          for s in range(1, 10)]
    reach = [f["reach_step"] for f in fs]
    assert (min(reach), max(reach), statistics.median(reach)) == (
        26_560_000, 72_640_000, 30_720_000)
    spans = [round(f["mean_54_60M"], 2) for f in fs]
    tails = [round(f["tail_mean"], 2) for f in fs]
    assert (min(spans), max(spans)) == (15.30, 34.90)
    assert (min(tails), max(tails)) == (31.91, 36.47)
    # the rule's partial form: 8 of the 9 reach 25 by 60 M
    assert sum(r <= 60_000_000 for r in reach) == 8


def test_reach_and_spans_on_a_made_curve(figures_script):
    """The rolling mean is trailing and needs five points; 54 M and 60 M
    are inside the span."""
    rows = [(s * 1_000_000, v, None) for s, v in
            [(50, 30.0), (54, 20.0), (55, 24.0), (56, 26.0), (60, 30.0), (61, 40.0)]]
    # windows ending at 60 M: (30+20+24+26+30)/5 = 26
    assert figures_script.reach(rows) == (60_000_000, None)
    assert figures_script.span_mean(rows) == pytest.approx(25.0)
    assert figures_script.tail_mean(rows) == 40.0
    assert figures_script.reach(rows[:4]) == (None, None)
