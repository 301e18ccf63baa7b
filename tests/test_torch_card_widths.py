"""The trainer refuses, before any rollout, the widths that the card's
critic kernels do not take, with the kernels' own message; the CPU, where
every op takes its plain version, takes any width. No card is needed: the
check reads only the device's type."""

import dataclasses

import pytest
import torch

from swarmacb_torch.agents import POCAConfig, POCATrainer
from swarmacb_torch.agents.trainer import check_card_widths
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import DirectionalGateEnv

CUDA = torch.device("cuda")
BASE = POCAConfig()           # hidden 512, 4 heads, the default (tail) path


@pytest.mark.parametrize("N,change,message", [
    (20, dict(hidden_dim=1024), "fused_tail: the kernels take"),
    (20, dict(hidden_dim=1024, fused_attention=True), "fused_cf_attention: the kernels take"),
    (33, {}, "N <= 32"),
    (33, dict(fused_attention=True), "N <= 32"),
    (20, dict(critic_num_heads=8, fused_attention=True), "H <= 4"),
    (7, dict(critic_num_heads=3), r"H\*N % 4 == 0"),
    (20, dict(hidden_dim=130), "h % 4 == 0"),
])
def test_card_refuses_what_its_kernels_refuse(N, change, message):
    with pytest.raises(ValueError, match=message):
        check_card_widths(CUDA, N, dataclasses.replace(BASE, **change))


@pytest.mark.parametrize("N,change", [
    (20, {}),
    (20, dict(fused_attention=True)),
    (20, dict(hidden_dim=128, num_layers=1)),
    (32, dict(critic_num_heads=8)),           # the tail kernels take H > 4
    (7, dict(critic_num_heads=4)),
])
def test_card_takes_the_widths_its_kernels_take(N, change):
    check_card_widths(CUDA, N, dataclasses.replace(BASE, **change))


@pytest.mark.parametrize("change", [dict(hidden_dim=1024), dict(critic_num_heads=3),
                                    dict(critic_num_heads=8, fused_attention=True)])
def test_cpu_takes_any_width(change):
    check_card_widths("cpu", 33, dataclasses.replace(BASE, **change))
    check_card_widths(torch.device("cpu"), 7, dataclasses.replace(BASE, **change))


def test_trainer_checks_before_building_anything(monkeypatch):
    """``POCATrainer.__init__`` runs the check on the env's device first:
    an env that reports a CUDA device is refused before any network or
    generator is made on it."""
    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=2), device="cpu")
    monkeypatch.setattr(env, "device", CUDA)
    with pytest.raises(ValueError, match="fused_tail: the kernels take"):
        POCATrainer(env, dataclasses.replace(BASE, hidden_dim=1024))
