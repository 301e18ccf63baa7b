"""The port stands alone: no JAX, no JAX package, no silent CPU fallback."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from swarmacb_torch import ops
from swarmacb_torch.config import DirectionalGateEnvCfg
from swarmacb_torch.env import DirectionalGateEnv, make_env
from torch_scripts import load_script

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "swarmacb_tpu")
PORT_FILES = (sorted((ROOT / "swarmacb_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py"]
              + [ROOT / "scripts" / f for f in ("profile_torch_rollout.py",
                                                "profile_torch_update.py",
                                                "probe_torch_rsqrt.py",
                                                "time_cf_backward.py",
                                                "probe_tf32_rates.py",
                                                "time_tail_backward.py",
                                                "time_env_kernels.py",
                                                "time_train_iteration.py",
                                                "train_torch.py",
                                                "play_torch.py",
                                                "eval_checkpoints_torch.py",
                                                "comm_account_torch.py",
                                                "measure_drift_torch.py",
                                                "manual_control_torch.py",
                                                "sps_sweep_torch.py",
                                                "validation_figures_torch.py")])


def _imported_modules(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, swarmacb_torch, swarmacb_torch.env, swarmacb_torch.agents,"
            " swarmacb_torch.ops, swarmacb_torch.convert, swarmacb_torch.models,"
            " swarmacb_torch.utils\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card():
    """Without ``device=`` the env runs on CUDA; where there is no card it
    raises instead of running on the CPU."""
    cfg = DirectionalGateEnvCfg(num_envs=2)
    if torch.cuda.is_available():
        assert DirectionalGateEnv(cfg).device.type == "cuda"
        assert make_env("SwarmACB-DirectionalGate-v0", cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DirectionalGateEnv(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_env("SwarmACB-DirectionalGate-v0", cfg)
    assert DirectionalGateEnv(cfg, device="cpu").device.type == "cpu"


def test_scripts_default_to_the_card(tmp_path, monkeypatch):
    """``--device`` of the train, play and eval scripts defaults to the card:
    without a card, train and play raise before they build the env, and
    eval passes no ``--device`` on to play unless it is given one."""
    train, play, evaluate = (load_script(n) for n in ("train_torch", "play_torch",
                                                  "eval_checkpoints_torch"))
    assert train.build_parser().parse_args([]).device is None
    assert play.build_parser().parse_args(["--checkpoint", "c"]).device is None
    assert evaluate.build_parser().parse_args([]).device is None
    cmds = []
    monkeypatch.setattr(evaluate.subprocess, "run", lambda cmd, **kw: cmds.append(cmd)
                        or subprocess.CompletedProcess(cmd, 1, "", ""))
    evaluate.run_eval(tmp_path, 1, False, 0, None)
    evaluate.run_eval(tmp_path, 1, True, 0, "cpu")
    assert "--device" not in cmds[0] and cmds[1][cmds[1].index("--device") + 1] == "cpu"
    if torch.cuda.is_available():
        return
    from swarmacb_torch.agents import Checkpointer, POCAConfig, POCATrainer

    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=1), device="cpu")
    ckpt = Checkpointer(tmp_path).save(POCATrainer(env, POCAConfig(hidden_dim=8)), final=True)
    monkeypatch.setattr(train, "make_env", lambda *a, **k: pytest.fail("env built"))
    monkeypatch.setattr(play, "make_env", lambda *a, **k: pytest.fail("env built"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--config", str(ROOT / "configs" / "DirGate_dandelion.yaml")])
    with pytest.raises(RuntimeError, match="CUDA"):
        play.main(["--checkpoint", str(ckpt)])


def test_chip_smoke_fails_without_a_card(tmp_path):
    """With no CUDA device visible the smoke run exits non-zero and prints
    no result line."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_wrappers_refuse_a_non_cpu_tensor_they_cannot_launch_on():
    """Only a CPU tensor selects the plain version: any other device goes
    to the kernel or raises (here: the meta device)."""
    pos = torch.zeros((2, 4, 2), device="meta")
    yaw = torch.zeros((2, 4), device="meta")
    seg = torch.zeros((14, 4), device="meta")
    with pytest.raises(ValueError):
        ops.pairwise_sensors(pos, yaw, prox_range=0.1, robot_radius=0.035,
                             rab_range=0.2, alpha_rab=5.0, wall_segments=seg)
    with pytest.raises(ValueError):
        ops.resolve_robot_collisions(pos, 0.035)
    B, N, H, h = 2, 3, 4, 8
    meta = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    with pytest.raises(ValueError):
        ops.fused_tail(meta(B, N * N, H * N), meta(B, H, N, N), meta(B, H * N, h),
                       meta(B, H, N, h), meta(B, N, h), meta(B, N, h), meta(h), N)
    with pytest.raises(ValueError):
        ops.fused_cf_attention(meta(B, H, N, N), meta(B, H, N, N), meta(B, H, N, N),
                               meta(B, H, N, 1), meta(B, H, N, h), meta(B, H, N, h),
                               meta(B, N, h), meta(B, N, h), meta(h), 2)


def _tail_args(B=2, N=3, H=4, h=8, device="cpu"):
    g = torch.Generator().manual_seed(0)
    shapes = [(B, N * N, H * N), (B, H, N, N), (B, H * N, h), (B, H, N, h),
              (B, N, h), (B, N, h), (h,)]
    return [torch.randn(s, generator=g).to(device).requires_grad_() for s in shapes]


def test_cpu_fused_tail_returns_gradients():
    """A CPU call whose inputs need a gradient runs the plain version under
    autograd, and the gradient reaches all seven inputs."""
    args = _tail_args()
    out = ops.fused_tail(*args, 3)
    grads = torch.autograd.grad((out * out).sum(), args)
    for a, g in zip(args, grads):
        assert g.shape == a.shape and bool(torch.isfinite(g).all())
        assert float(g.abs().sum()) > 0


def test_fused_tail_with_gradients_takes_the_kernel_path_off_the_cpu():
    """Off the CPU, inputs that need a gradient go through the kernels'
    autograd function, which refuses what it cannot launch on."""
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.fused_tail(*_tail_args(device="meta"), 3)


def test_mixed_precision_trainer_trains_on_the_cpu():
    """``mixed_precision=True`` builds a trainer whose critic projections
    take bf16 and whose parameters stay float32; on the CPU its kernels take
    their plain versions (no launch), and one iteration gives finite
    losses."""
    from swarmacb_torch.agents import POCAConfig, POCATrainer

    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=1), device="cpu")
    trainer = POCATrainer(env, POCAConfig(hidden_dim=8, horizon=2, mini_batch_size=2,
                                          mixed_precision=True))
    assert trainer.critic.self_attn.dtypes == dict.fromkeys("qkvo", torch.bfloat16)
    ops.reset_launches()
    st, obs = env.reset(trainer.generator)
    _, _, _, metrics = trainer.train_iteration(st, obs, ())
    assert not any(ops.launches.values())
    assert all(np.isfinite(v) for v in metrics.values())
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for p in trainer.critic.parameters())


def test_fused_attention_trainer_takes_the_plain_path_on_the_cpu():
    """``fused_attention=True`` builds a trainer whose critic takes the fused
    branch; on the CPU that branch is the plain version (no kernel launch),
    and a short rollout gives finite baselines."""
    from swarmacb_torch.agents import POCAConfig, POCATrainer

    env = DirectionalGateEnv(DirectionalGateEnvCfg(num_envs=1), device="cpu")
    trainer = POCATrainer(env, POCAConfig(hidden_dim=8, horizon=2,
                                          fused_attention=True))
    assert trainer.critic.fused_attention
    assert not POCATrainer(env, POCAConfig(hidden_dim=8)).critic.fused_attention
    ops.reset_launches()
    st, obs = env.reset(trainer.generator)
    _, _, _, rollout, _, _ = trainer.rollout(st, obs, ())
    assert not any(ops.launches.values())
    assert rollout.baselines.shape == (2, 1, 20)
    assert bool(torch.isfinite(rollout.baselines).all())


@pytest.mark.parametrize("variant", ["daisy", "lily", "tulip"])
def test_discrete_variants_build_on_the_cpu(variant):
    """The discrete variants build, with a categorical actor over the six
    behaviour modules, and a fused-env-step trainer takes the plain K4 on
    the CPU (no kernel launch)."""
    from swarmacb_torch.agents import POCAConfig, POCATrainer

    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant=variant, num_envs=1),
                             device="cpu")
    trainer = POCATrainer(env, POCAConfig(hidden_dim=8, horizon=2,
                                          fused_env_step=True))
    assert trainer.discrete and trainer.actor.logits_head.out_features == 6
    ops.reset_launches()
    st, obs = env.reset(trainer.generator)
    _, obs, _, rollout, _, _ = trainer.rollout(st, obs, ())
    assert not any(ops.launches.values())
    assert rollout.actions.shape == (2, 1, 20, 1)
    assert obs.shape == (1, 20, env.obs_dim)


@pytest.mark.parametrize("fused_env_step", [False, True])
def test_recurrent_variant_builds_on_the_cpu(fused_env_step):
    """cyclamen builds the LSTM actor, and its rollout on either env path
    takes the plain versions on the CPU (no kernel launch), storing the
    carry from before each decision."""
    from swarmacb_torch.agents import POCAConfig, POCATrainer
    from swarmacb_torch.models import RecurrentDiscreteActor

    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="cyclamen", num_envs=1),
                             device="cpu")
    trainer = POCATrainer(env, POCAConfig(hidden_dim=8, horizon=2, recurrent=True,
                                          memory_size=4, fused_env_step=fused_env_step))
    assert isinstance(trainer.actor, RecurrentDiscreteActor)
    ops.reset_launches()
    st, obs = env.reset(trainer.generator)
    _, _, carry, rollout, _, _ = trainer.rollout(st, obs, trainer.init_actor_carry())
    assert not any(ops.launches.values())
    assert rollout.memory_h.shape == rollout.memory_c.shape == (2, 1, 20, 4)
    assert not rollout.memory_h[0].any() and rollout.memory_h[1].any()
    assert carry[0].shape == (20, 4)


def test_fused_env_step_refuses_a_tile_it_cannot_launch_on():
    lanes = {n: torch.zeros((20, 128), device="meta") for n in ("px", "py", "yaw", "prev")}
    lanes |= {"sc": torch.zeros((1, 128), dtype=torch.int32, device="meta"),
              "er": torch.zeros((1, 128), device="meta"),
              "cg": torch.zeros((1, 128), device="meta")}
    tile = torch.zeros((20, 128), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.fused_env_step(lanes, (tile, tile), (), (tile, tile, tile),
                           DirectionalGateEnvCfg(num_envs=1))


def test_every_kernel_source_is_registered_and_plain_c():
    """Each ``csrc/*.cu`` builds on its own (an entry of ``_cuda.SOURCES``
    and ``SIGNATURES``), includes no PyTorch header, and none takes fast
    math; the sensor and step kernels, tuned and wide, build with FMA
    contraction off. The
    tail's forward (``tail_forward.cu``) and backward (``baseline_tail.cu``)
    are two sources: only the backward caps its registers."""
    from swarmacb_torch.ops import _cuda

    sources = sorted(p.stem for p in _cuda.CSRC.glob("*.cu"))
    assert sources == sorted(_cuda.SOURCES) == sorted(_cuda.SIGNATURES)
    for name in sources:
        includes = [line for line in (_cuda.CSRC / f"{name}.cu").read_text(
            encoding="utf-8").splitlines() if line.startswith("#include")]
        assert includes and not any("torch" in i or "ATen" in i or "c10" in i
                                    for i in includes), name
        flags = (*_cuda._COMMON_FLAGS, *_cuda.SOURCES[name])
        assert not any("fast_math" in f or "fast-math" in f for f in flags), name
    for name in ("pairwise", "fused_step", "pairwise_wide", "fused_step_wide"):
        assert "-fmad=false" in _cuda.SOURCES[name]
    assert _cuda.SOURCES["baseline_tail"] == ("-maxrregcount=168",)
    assert _cuda.SOURCES["tail_forward"] == ()
    assert "tail_forward_launch" in _cuda.SIGNATURES["tail_forward"]
    assert set(_cuda.launches) >= {"fused_env_step", "pairwise_sensors"}


def test_config_yaml_loads_through_the_port():
    from swarmacb_torch.config import load_config

    run, variant, cfg, env_ov = load_config(ROOT / "configs" / "DirGate_dandelion.yaml")
    assert (run, variant) == ("DirGate_dandelion", "dandelion")
    assert cfg.hidden_dim == 512 and cfg.horizon == 1000 and not cfg.recurrent
    assert env_ov == {"num_envs": 5, "episode_length_s": 120.0}
