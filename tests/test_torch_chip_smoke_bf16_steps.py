"""Phase 3h's hold of each bf16 Adam step, rehearsed on the CPU.

``chip_smoke.phase_small_reference(mixed_precision=True)`` runs with a second
CPU trainer (device "cpu:0") in the card's place, so that both sides take
the same arithmetic: its checks pass, and each step's losses part from the
CPU's by exactly 0. Then a fault goes into the second trainer as its update
starts, and ``chip_smoke._hold_bf16_steps`` must catch it:

- a flipped gradient sign (each gradient negated before Adam's step): the
  losses at its own parameters still agree, but from step 1 on they leave
  the CPU run's own by far more than ``MP_RUN_TOL`` (measured: 2.83e4 times
  it, at step 5's value loss);
- float32 in place of bf16 in the critic's q/k/v/o projections: the losses
  at its own parameters leave the CPU's bf16 ones by more than
  ``MP_SAME_TOL`` (measured: 12.7 times it, at step 1's value loss), which
  no other check of the phase sees.

And the tolerances admit what the card may do: another summation order,
here the second trainer's minibatches in chunks of one group in place of
three, passes both (measured: 0.124 of ``MP_SAME_TOL`` and 0.116 of
``MP_RUN_TOL``); only the phase's chunk count check notices it.
"""

import copy
import importlib.util
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SAME = "against the CPU's at the card's parameters"
RUN = "against the CPU run's own step"


@pytest.fixture()
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_rehearsal", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "DEVICE", "cpu:0")
    monkeypatch.setattr(module, "failures", [])
    return module


def _inject(smoke, monkeypatch, fault):
    """``fault(trainer)`` on the second trainer whose steps are recorded,
    the card's stand-in."""
    inner, seen = smoke._record_steps, []

    def record(trainer):
        seen.append(trainer)
        if len(seen) == 2:
            assert str(trainer.device) == "cpu:0"
            fault(trainer)
        return inner(trainer)
    monkeypatch.setattr(smoke, "_record_steps", record)


def _flip_gradients(trainer):
    step = trainer.optimizer.step

    def flipped(*args, **kwargs):
        for group in trainer.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.neg_()
        return step(*args, **kwargs)
    trainer.optimizer.step = flipped


def _float32_projections(trainer):
    trainer.critic.self_attn.dtypes = dict.fromkeys("qkvo", None)


def test_the_same_arithmetic_passes(smoke, capsys):
    smoke.phase_small_reference(torch, mixed_precision=True)
    assert smoke.failures == []
    held = [line for line in capsys.readouterr().out.splitlines() if "bf16 Adam steps" in line]
    assert len(held) == 2 and all("[ok]" in line and " 0.000e+00, at" in line
                                  for line in held), held


@pytest.mark.parametrize("fault, caught_by, missed_by", [
    (_flip_gradients, RUN, SAME),
    (_float32_projections, SAME, None),
], ids=["flipped gradient sign", "float32 in place of bf16"])
def test_a_fault_in_the_card_s_steps_fails(smoke, monkeypatch, fault, caught_by, missed_by):
    _inject(smoke, monkeypatch, fault)
    smoke.phase_small_reference(torch, mixed_precision=True)
    held = [f for f in smoke.failures if "bf16 Adam steps" in f]
    assert any(caught_by in f for f in held), smoke.failures
    if missed_by is not None:
        assert not any(missed_by in f for f in held), held


def test_another_summation_order_passes(smoke, monkeypatch, capsys):
    def one_group_a_chunk(trainer):
        trainer.cfg = copy.copy(trainer.cfg)
        trainer.cfg.accum_chunk_groups = 1
    _inject(smoke, monkeypatch, one_group_a_chunk)
    smoke.phase_small_reference(torch, mixed_precision=True)
    assert smoke.failures == ["the first minibatch runs in three chunks, the last a tail"]
    held = [line for line in capsys.readouterr().out.splitlines() if "bf16 Adam steps" in line]
    ratios = [float(line.split(") ")[-1].split(",")[0]) for line in held]
    assert len(held) == 2 and all("[ok]" in line for line in held) and max(ratios) > 0, held
