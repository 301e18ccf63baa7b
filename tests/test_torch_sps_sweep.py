"""``scripts/sps_sweep_torch.py`` on the CPU: one JSON line per E with the
JAX sweep's keys (but ``path``; ``compile_plus_first_s`` is
``first_iteration_s``), decisions/s equal to horizon·E·N·iters over the
timed seconds within the rounding of ``iter_s``, a finite positive phase
split, and no run without a card unless ``--device cpu`` is given. The
trainer is the YAML's (hidden 512), cut to E = 2, 3 and T = 4."""

import json

import pytest
import torch

from torch_scripts import load_script
from torch_threads import one_torch_thread  # noqa: F401

# the JAX script's keys (scripts/sps_sweep.py:77-87) the port keeps
JAX_KEYS = ("variant", "E", "horizon", "group_mb", "chunk_rows", "mixed_precision",
            "fused_env_step", "iter_s", "decisions_per_sec")
PHASES = ("rollout", "prep", "mb_steps_total", "phase_sum", "blocked_iter")


@pytest.fixture(scope="module")
def sweep():
    return load_script("sps_sweep_torch")


@pytest.mark.parametrize("variant,flags", [("dandelion", []),
                                           ("daisy", ["--fused_env_step", "on"])])
def test_one_line_per_e_with_the_rate_and_phases(sweep, capsys, variant, flags):
    assert sweep.main(["--device", "cpu", "--variant", variant, "--envs", "2,3",
                       "--horizon", "4", "--iters", "1", *flags]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["E"] for r in lines] == [2, 3]
    for r in lines:
        assert set(JAX_KEYS) <= set(r) and "path" not in r
        assert r["variant"] == variant and r["horizon"] == 4 and r["card"] == "cpu"
        assert r["fused_env_step"] is (variant == "daisy")
        decisions = r["horizon"] * r["E"] * 20 * r["iters"]
        # iter_s is rounded to 1 ms, decisions_per_sec to 1
        slack = decisions / r["iter_s"] ** 2 * 5e-4 + 0.5
        assert abs(r["decisions_per_sec"] - decisions / r["iter_s"]) <= slack
        assert r["first_iteration_s"] > 0
        ps = r["phase_split_s"]
        assert all(ps[k] > 0 for k in PHASES) and ps["n_mb_steps"] > 0
        assert ps["phase_sum"] <= ps["blocked_iter"] + 1e-3


def test_refuses_without_a_card(sweep, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep.main(["--envs", "2", "--horizon", "4", "--iters", "1"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
