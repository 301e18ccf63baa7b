"""Every critic width the JAX package trains with trains on the card: the
widths that the tuned critic kernels refuse take their wide route, by
shape alone (``ops.baseline_tail.route`` on the default path,
``ops.cf_attention.route`` with ``fused_attention``), and the trainer no
longer refuses any width. The CPU, where every op takes its plain version,
takes any width. No card is needed: the route reads only the shape."""

import dataclasses

import pytest
import torch

from swarmacb_torch import ops
from swarmacb_torch.agents import POCAConfig, POCATrainer
from swarmacb_torch.agents import trainer as trainer_module
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import DirectionalGateEnv
from swarmacb_torch.models import POCACritic
from swarmacb_torch.ops import baseline_tail, cf_attention

BASE = POCAConfig()           # hidden 512, 4 heads, the default (tail) path


def _route(N, cfg):
    path = cf_attention if cfg.fused_attention else baseline_tail
    return path.route(N, cfg.critic_num_heads, cfg.hidden_dim)


@pytest.mark.parametrize("N,change,limit", [
    (20, dict(hidden_dim=1024), "h <= 512"),
    (20, dict(hidden_dim=1024, fused_attention=True), "h <= 512"),
    (33, {}, "N <= 32"),
    (33, dict(fused_attention=True), "N <= 32"),
    (20, dict(critic_num_heads=8, fused_attention=True), "H <= 4"),
    (7, dict(critic_num_heads=3), "H*N % 4 == 0"),
    (20, dict(hidden_dim=130), "h % 4 == 0"),
])
def test_card_refuses_what_its_kernels_refuse(N, change, limit):
    """A width past one of the tuned kernels' limits takes the wide route."""
    assert _route(N, dataclasses.replace(BASE, **change)) == "wide", limit


@pytest.mark.parametrize("N,change", [
    (20, {}),
    (20, dict(fused_attention=True)),
    (20, dict(hidden_dim=128, num_layers=1)),
    (32, dict(critic_num_heads=8)),           # the tail kernels take H > 4
    (7, dict(critic_num_heads=4)),
])
def test_card_takes_the_widths_its_kernels_take(N, change):
    assert _route(N, dataclasses.replace(BASE, **change)) == "tuned"


@pytest.mark.parametrize("change", [dict(hidden_dim=1024),
                                    dict(critic_num_heads=3, hidden_dim=129),
                                    dict(critic_num_heads=8, fused_attention=True)])
def test_cpu_takes_any_width(change):
    """The CPU critic at these widths computes its baselines through the
    plain versions, and launches nothing."""
    cfg = dataclasses.replace(BASE, **change)
    for N in (33, 7):
        critic = POCACritic(5, 2, N, hidden=cfg.hidden_dim, num_heads=cfg.critic_num_heads,
                            num_layers=1,
                            fused_attention=bool(cfg.fused_attention))
        critic.init_weights(torch.Generator().manual_seed(0))
        before = dict(ops.launches)
        with torch.no_grad():
            out = critic.all_baselines(torch.randn(2, N, 5), torch.randn(2, N, 2))
        assert out.shape == (2, N) and bool(torch.isfinite(out).all())
        assert ops.launches == before


def test_trainer_checks_before_building_anything():
    """The trainer builds at ``--hidden_dim 1024`` (the check that refused
    it on the card is gone), and on the card its critic would take the wide
    route."""
    assert not hasattr(trainer_module, "check_card_widths")
    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=1), device="cpu")
    cfg = dataclasses.replace(BASE, hidden_dim=1024, horizon=2)
    trainer = POCATrainer(env, cfg)
    assert trainer.critic.hidden == 1024 and _route(env.num_agents, cfg) == "wide"
