"""The machinery of ``scripts/measure_drift_torch.py`` (card-vs-CPU drift
over whole episodes, ``swarmacb_torch/utils/drift.py``) on the CPU.

- ``--device cpu`` runs both sides on the CPU, for every case (dandelion,
  daisy and lily on the composed and the fused env step) over a few steps:
  the drift is zero, the JSON last line carries the fields
  ``tests/test_tpu_drift.py`` reads, and the run meets the JAX package's
  criteria (exit 0);
- the same fixed action log, starting state and env draws for every run of
  a case, whichever process makes them;
- the numbers and the criteria on made-up trajectories: a drift past 1e-3 m
  sets the onset, and each criterion misses where it should.
"""

import json

import numpy as np
import pytest
import torch

from swarmacb_torch.utils import drift
from torch_scripts import load_script
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 3
FIELDS = ("pos_drift_100_steps_m", "divergence_onset_step", "reward_step_agreement",
          "episode_reward_sum_diff")


def test_cpu_against_cpu_has_zero_drift_in_every_case(capsys):
    script = load_script("measure_drift_torch")
    assert script.main(["--device", "cpu", "--steps", str(STEPS)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == sorted(f"{v}/{p}" for v in drift.VARIANTS for p in drift.PATHS)
    for case, m in out.items():
        assert set(FIELDS) <= set(m), case
        assert m["pos_drift_100_steps_m"] == m["max_pos_drift_m"] == 0.0, case
        assert m["divergence_onset_step"] == STEPS, case
        assert m["reward_step_agreement"] == 1.0, case
        assert m["episode_reward_sum_diff"] == m["max_reward_diff"] == 0.0, case


@pytest.mark.parametrize("variant", drift.VARIANTS)
def test_inputs_are_the_same_in_every_run(variant):
    a, b = drift.make_inputs(variant, 4), drift.make_inputs(variant, 4)
    for k in ("actions", "pos", "yaw", "spawn_pos", "spawn_yaw"):
        assert torch.equal(a[k], b[k]), k
    assert (a["durations"] is None) == (variant == "dandelion")
    if a["durations"] is not None:
        assert all(torch.equal(a["durations"][k], b["durations"][k]) for k in a["durations"])
    rng = np.random.default_rng(drift.SEED)      # the JAX script's action log
    if variant == "dandelion":
        want = rng.uniform(-1.5, 1.5, (4, drift.E, drift.N, 2)).astype(np.float32)
    else:
        want = rng.integers(0, 6, (4, drift.E, drift.N)).astype(np.int32)
    np.testing.assert_array_equal(a["actions"].numpy(), want)


def _trajectory(steps=300):
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(steps, drift.E, drift.N, 2))
    rewards = rng.integers(-1, 2, (steps, drift.E)).astype(np.float64)
    return pos, rewards


def test_drift_and_criteria_on_made_up_trajectories():
    pos, rew = _trajectory()
    ok = drift.drift((pos + 5e-5, rew), (pos, rew))
    assert ok["divergence_onset_step"] == 300 and ok["reward_step_agreement"] == 1.0
    assert drift.misses(ok, 300) == []
    late = pos.copy()
    late[250:, 1, 3, 0] += 0.01                  # apart from step 250 on
    m = drift.drift((late, rew), (pos, rew))
    assert m["divergence_onset_step"] == 250 and drift.misses(m, 300) == []
    early = pos.copy()
    early[50:, 0, 0, 1] += 2e-3                  # past 1e-4 m before step 100
    rew2 = rew.copy()
    rew2[::20, 0] += 1.0                         # 15 of 1,200 rewards differ, Σ by 15
    m = drift.drift((early, rew2), (pos, rew))
    assert m["divergence_onset_step"] == 50 and m["episode_reward_sum_diff"] == 15.0
    assert m["reward_step_agreement"] == pytest.approx(1 - 15 / 1200)
    assert len(drift.misses(m, 300)) == 4        # each of the four criteria
