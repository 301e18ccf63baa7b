"""The validation pipeline on the port's output, on the CPU.

``scripts/train_torch.py --device cpu`` trains each of the three variants
the port has trained on the card (lily, the categorical MLP; dandelion, the
Gaussian actor; cyclamen, the LSTM actor with its BPTT windows cut to 10
decisions) at a tiny size (two arenas, ``--hidden_dim 16``, from a copy of
its YAML with the horizon cut to 20 decisions, one summary and one
checkpoint an iteration, and episodes of 1 s, so that every iteration
completes some), two iterations from scratch, then one more resumed with
``--checkpoint latest``. TensorBoard's writer is the one the card's run
uses. Held, for each variant:

- ``scripts/extract_curves.py``'s ``extract`` reads ``Extra/Group Reward
  Mean`` back from the run's event files, one point at each step the
  trainer wrote it, with the value it wrote; the resumed run's point comes
  after the first run's, under the same tag;
- dandelion's run writes its actor's ``Policy/Std dim<d>`` and
  ``Policy/Log Std Mean`` at each summary, read back the same way, the last
  ones those of the trained ``log_std``; the categorical actors write none;
- ``scripts/extract_curves.py --wall-time`` writes the curve's CSV, and
  ``scripts/validation_figures_torch.py`` computes its three figures;
- the same code gives the JAX figures from the CSVs in ``docs/validation/``:
  lily seed 1 30.72 M, 29.81 and 35.45 at the default level of 25, seeds
  1–9 26.56–72.64 M (median 30.72 M), 15.30–34.90 and 31.91–36.47;
  dandelion seed 1 at ``--level 2.5`` 21.76 M, 2.75 and 3.02, seeds 1–7
  12.16–39.36 M (median 24.32 M), 2.58–2.98 and 2.82–3.16, with the 10-lane
  unit 11.20–39.36 M (median 24.00 M), 2.58–3.02 and 2.56–3.26; cyclamen
  seed 1 48.64 M, 25.02 and 28.75, seeds 1–9 21.12–48.64 M (median
  29.44 M), 20.06–28.35 and 21.54–33.62; the bf16 overlays of ``--mp_stages
  auto``, dandelion "qkvo" seed 1 at 2.5 24.32 M, 2.65 and 2.94, lily "qk"
  seeds 1 and 2 39.36 M and 44.80 M, 32.89 and 27.39, 36.89 and 35.51.
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
CONFIGS = ROOT / "configs"
JAX_CURVES = ROOT / "docs" / "validation"
JAX_CURVE = JAX_CURVES / "DirGate_lily_seed{}__extra_group_reward_mean.csv"
TAG = "Extra/Group Reward Mean"
STD_TAGS = ("Policy/Std dim0", "Policy/Std dim1", "Policy/Log Std Mean")
T, E, N = 20, 2, 20
ITER = T * E * N


@pytest.fixture(scope="module")
def figures_script():
    return load_script("validation_figures_torch")


@pytest.fixture(scope="module", params=["lily", "dandelion", "cyclamen"])
def run(request, tmp_path_factory):
    """Two iterations, then a third resumed; returns (the variant, its log
    dir, the points the trainer wrote under each tag, each run's last
    step, the last trainer)."""
    from torch.utils.tensorboard import SummaryWriter

    variant = request.param
    train_torch = load_script("train_torch")
    root = tmp_path_factory.mktemp(f"curve_{variant}")
    cfg = yaml.safe_load((CONFIGS / f"DirGate_{variant}.yaml").read_text())
    block = cfg["behaviors"][f"DirGate_{variant}"]
    block.update(time_horizon=T, summary_freq=ITER, checkpoint_interval=ITER)
    block["environment"]["episode_length_s"] = 1.0
    memory = block["network_settings"].get("memory")
    if memory is not None:
        memory.update(memory_size=16, sequence_length=10)
    (root / f"{variant}.yaml").write_text(yaml.safe_dump(cfg))
    logs = root / f"DirGate_{variant}_torch_seed1"
    argv = ["--config", str(root / f"{variant}.yaml"), "--device", "cpu",
            "--num_envs", str(E), "--hidden_dim", "16", "--seed", "1",
            "--checkpoint", "latest", "--checkpoint_dir", str(root / "ckpt"),
            "--log_dir", str(logs)]
    written = {}

    class Recording(SummaryWriter):
        def add_scalar(self, tag, value, step=None, *args, **kwargs):
            written.setdefault(tag, []).append((step, float(value)))
            return super().add_scalar(tag, value, step, *args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(train_torch, "make_writer", Recording)
    ends = []
    try:
        for total in (2 * ITER, 3 * ITER):
            with contextlib.redirect_stdout(io.StringIO()):
                trainer = train_torch.main([*argv, "--total_timesteps", str(total)])
            assert trainer.env.cfg.max_episode_length < T
            assert trainer.recurrent == (variant == "cyclamen")
            assert trainer.discrete == (variant != "dandelion")
            ends.append(trainer.global_step)
    finally:
        mp.undo()
    return variant, logs, written, ends, trainer


def test_extract_reads_each_logged_point_back(run):
    extract_curves = load_script("extract_curves")
    variant, logs, written, ends, trainer = run
    assert ends == [2 * ITER, 3 * ITER]
    tags = (TAG, *STD_TAGS) if variant == "dandelion" else (TAG,)
    for tag in tags:
        rows = extract_curves.extract(logs, tag)
        assert rows, f"no points under {tag}"
        assert [s for s, _ in rows] == [s for s, _ in written[tag]] == [
            ITER, 2 * ITER, 3 * ITER], tag
        for (_, got), (_, want) in zip(rows, written[tag]):
            assert np.float32(got) == np.float32(want), tag
    # the resumed run wrote its point after the first run's, in its own
    # event file beside the first
    assert len(list(logs.glob("events.out.tfevents.*"))) == 2
    if variant != "dandelion":
        assert not any(tag.startswith("Policy/Std") or tag == STD_TAGS[-1]
                       for tag in written)
        return
    # the Gaussian actor's std, written as exp(log_std) per wheel and the
    # mean log_std; the last point is the trained parameter's
    for i in range(3):
        stds = [written[tag][i][1] for tag in STD_TAGS[:2]]
        assert written[STD_TAGS[2]][i][1] == pytest.approx(
            float(np.mean(np.log(stds))), rel=1e-5, abs=1e-6)
    log_std = trainer.actor.log_std.detach().numpy()[0]
    assert [written[tag][-1][1] for tag in STD_TAGS[:2]] == pytest.approx(
        np.exp(log_std).tolist(), rel=1e-6)
    # three updates moved it from its zero start
    assert np.all(np.isfinite(log_std)) and np.any(log_std != 0.0)


def test_the_curve_s_figures(run, figures_script, tmp_path):
    extract_curves = load_script("extract_curves")
    variant, logs, written, _, _ = run
    written = written[TAG]
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_curves.main([str(logs), "--out", str(tmp_path), "--wall-time"]) == 0
    csv = tmp_path / f"DirGate_{variant}_torch_seed1__extra_group_reward_mean.csv"
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
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert figures_script.main([str(csv), "--level", "2.5"]) == 0
    assert "rolling mean reaches 2.5 at never; 54–60 M mean never" in out.getvalue()


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


def _jax_figures(figures_script, names, level):
    return [figures_script.figures(figures_script.read_curve(
        JAX_CURVES / f"DirGate_{name}__extra_group_reward_mean.csv"), level)
        for name in names]


@pytest.mark.parametrize("variant, level, reach, span, tail", [
    ("dandelion", 2.5, 21_760_000, 2.75, 3.02),
    ("cyclamen", 25.0, 48_640_000, 25.02, 28.75),
    # the bf16 overlays, --mp_stages auto: dandelion "qkvo", lily "qk"
    ("dandelion_mp", 2.5, 24_320_000, 2.65, 2.94),
    ("lily_mpqk", 25.0, 39_360_000, 32.89, 36.89),
    ("lily_mpqk_seed2", 25.0, 44_800_000, 27.39, 35.51),
])
def test_jax_seed1_figures_at_the_variant_s_level(figures_script, variant, level,
                                                   reach, span, tail):
    """Seed 1 of each curve, or the seed a case names."""
    name = variant if "_seed" in variant else f"{variant}_seed1"
    f, = _jax_figures(figures_script, [name], level)
    assert f["reach_step"] == reach
    assert round(f["mean_54_60M"], 2) == span
    assert round(f["tail_mean"], 2) == tail
    assert f["points"] == 312 and f["last_step"] == 120_000_000


@pytest.mark.parametrize("names, level, reach, spans, tails", [
    ([f"dandelion_seed{s}" for s in range(1, 8)], 2.5,
     (12_160_000, 39_360_000, 24_320_000), (2.58, 2.98), (2.82, 3.16)),
    ([f"dandelion_seed{s}" for s in range(1, 8)]
     + [f"dandelion_sp_seed{s}" for s in range(10)], 2.5,
     (11_200_000, 39_360_000, 24_000_000), (2.58, 3.02), (2.56, 3.26)),
    ([f"cyclamen_seed{s}" for s in range(1, 10)], 25.0,
     (21_120_000, 48_640_000, 29_440_000), (20.06, 28.35), (21.54, 33.62)),
], ids=["dandelion_seeds_1-7", "dandelion_all_17_curves", "cyclamen_seeds_1-9"])
def test_jax_seeds_ranges_at_the_variant_s_level(figures_script, names, level,
                                                  reach, spans, tails):
    fs = _jax_figures(figures_script, names, level)
    got = [f["reach_step"] for f in fs]
    assert None not in got
    assert (min(got), max(got), statistics.median(got)) == reach
    span = [round(f["mean_54_60M"], 2) for f in fs]
    tail = [round(f["tail_mean"], 2) for f in fs]
    assert (min(span), max(span)) == spans
    assert (min(tail), max(tail)) == tails
    # every curve reaches its level by 60 M, the partial rule's point
    assert max(got) <= 60_000_000


@pytest.mark.parametrize("name, level, points, last, reach, span, tail", [
    ("lily_torch", 25.0, 311, 120_000_000, 26_240_000, 27.02, 32.02),
    ("dandelion_torch", 2.5, 312, 120_000_000, 24_320_000, 2.81, 2.78),
    ("cyclamen_torch", 25.0, 311, 120_000_000, 17_920_000, 23.40, 32.10),
    # the bf16 runs (P5, P6): the curves that came back from the card end
    # before 120 M, so they have no tail figure; P6's none at 54–60 M
    ("dandelion_torch_mp", 2.5, 170, 65_280_000, 39_040_000, 2.93, None),
    ("lily_torch_mpqk", 25.0, 120, 46_080_000, 24_960_000, None, None),
])
def test_the_port_s_curves_give_the_recorded_figures(figures_script, name, level, points,
                                                      last, reach, span, tail):
    """Each curve the port trained on the card, committed under
    ``docs/validation_torch/``, read back through ``read_curve``: its
    points, its last decision count and the figures ``PERF.md`` §6
    records."""
    rows = figures_script.read_curve(
        ROOT / "docs" / "validation_torch" / f"DirGate_{name}_seed1__extra_group_reward_mean.csv")
    f = figures_script.figures(rows, level)
    assert f["points"] == points and f["last_step"] == last
    assert [s for s, _, _ in rows] == sorted({s for s, _, _ in rows})
    assert f["reach_step"] == reach
    assert (None if f["mean_54_60M"] is None else round(f["mean_54_60M"], 2)) == span
    if tail is not None:
        assert round(f["tail_mean"], 2) == tail
