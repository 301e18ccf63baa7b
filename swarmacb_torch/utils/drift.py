"""Card-vs-CPU drift of the port's env over whole episodes: the machinery
of ``scripts/measure_drift_torch.py`` (which sets out what it measures), in
the package so that its CPU runs can go to spawned processes.

Counterpart of ``scripts/tpu/measure_drift.py``; the criteria are the JAX
package's (``tests/test_tpu_drift.py``).
"""

from __future__ import annotations

import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from ..config import DirectionalGateEnvCfg
from ..env import DirectionalGateEnv
from ..env import lanes as laneslib
from ..env.behaviors import draw_durations

STEPS = 1200                 # one whole episode (120 s at 10 Hz)
E, N = 4, 20
SEED = 2024
VARIANTS = ("dandelion", "daisy", "lily")
PATHS = ("composed", "fused_env_step")
ONSET_M = 1e-3               # a position this far apart marks divergence

# the JAX package's criteria (tests/test_tpu_drift.py)
MAX_POS_DRIFT_100_M = 1e-4
MIN_DIVERGENCE_ONSET_STEP = 200
MIN_REWARD_AGREEMENT = 0.99
MAX_EPISODE_REWARD_SUM_DIFF = 2.0


def make_inputs(variant: str, steps: int) -> dict:
    """One variant's starting state, action log and env draws, on the CPU."""
    cfg = DirectionalGateEnvCfg(variant=variant, num_envs=E)
    rng = np.random.default_rng(SEED)
    if cfg.discrete_actions:
        actions = torch.from_numpy(rng.integers(0, 6, (steps, E, N)).astype(np.int32))
    else:
        actions = torch.from_numpy(rng.uniform(-1.5, 1.5, (steps, E, N, 2)).astype(np.float32))
    env = DirectionalGateEnv(cfg, device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    state, _ = env.reset(gen)
    spawn_pos, spawn_yaw = env._sample_spawn(gen, (steps * E, N))
    durations = ({k: draw_durations(gen, (steps, E, N), "cpu")
                  for k in ("explore", "photo", "antiphoto")}
                 if cfg.discrete_actions else None)
    return dict(cfg=cfg, actions=actions, pos=state.pos, yaw=state.yaw,
                spawn_pos=spawn_pos.reshape(steps, E, N, 2),
                spawn_yaw=spawn_yaw.reshape(steps, E, N), durations=durations)


def run_trajectory(device, path: str, inputs: dict) -> tuple[np.ndarray, np.ndarray]:
    """Positions (steps, E, N, 2) and rewards (steps, E) of one run on
    ``device``, on the composed env step or the fused one."""
    env = DirectionalGateEnv(inputs["cfg"], device=device)
    dev = env.device
    on = {k: v.to(dev) for k, v in inputs.items()
          if k not in ("cfg", "durations")}
    durations = (None if inputs["durations"] is None
                 else {k: v.to(dev) for k, v in inputs["durations"].items()})
    steps = on["actions"].shape[0]
    state = env.make_state(on["pos"], on["yaw"], torch.Generator(device=dev))
    pos, rewards = [], []
    lanes = laneslib.state_to_lanes(env, state) if path == "fused_env_step" else None
    for t in range(steps):
        draws = None if durations is None else {k: v[t] for k, v in durations.items()}
        spawn = (on["spawn_pos"][t], on["spawn_yaw"][t])
        if lanes is None:
            state, ts = env.step(state, on["actions"][t], injected_durations=draws,
                                 injected_spawn=spawn)
            pos.append(state.pos)
            rewards.append(ts.reward)
        else:
            lanes, reward, _, _ = laneslib.step_lanes(
                env, lanes, laneslib.actions_to_lanes(env, on["actions"][t]),
                want_obs=False, injected_durations=draws, injected_spawn=spawn)
            pos.append(torch.stack([laneslib.from_lanes(lanes["px"], E),
                                    laneslib.from_lanes(lanes["py"], E)], dim=-1))
            rewards.append(reward)
    return (torch.stack(pos).cpu().numpy().astype(np.float64),
            torch.stack(rewards).cpu().numpy().astype(np.float64))


def drift(run, reference) -> dict:
    """The JAX script's numbers for ``run`` against ``reference``, each a
    (positions, rewards) pair."""
    (pos, rew), (pos_ref, rew_ref) = run, reference
    steps = pos.shape[0]
    d_pos = np.abs(pos - pos_ref).reshape(steps, -1).max(1)
    over = np.nonzero(~(d_pos <= ONSET_M))[0]
    return {"max_pos_drift_m": float(d_pos.max()),
            "pos_drift_100_steps_m": float(d_pos[:100].max()),
            "divergence_onset_step": int(over[0]) if over.size else steps,
            "max_reward_diff": float(np.abs(rew - rew_ref).max()),
            "reward_step_agreement": float((rew == rew_ref).mean()),
            "episode_reward_sum_diff": float(np.abs(rew.sum(0) - rew_ref.sum(0)).max())}


def misses(m: dict, steps: int) -> list[str]:
    """The criteria one case's numbers miss. A run that never diverged has
    its onset at its step count, which misses nothing."""
    out = []
    if not m["pos_drift_100_steps_m"] <= MAX_POS_DRIFT_100_M:
        out.append(f"position drift over the first 100 steps "
                   f"{m['pos_drift_100_steps_m']:.3e} m > {MAX_POS_DRIFT_100_M:g} m")
    if m["divergence_onset_step"] < min(steps, MIN_DIVERGENCE_ONSET_STEP):
        out.append(f"divergence at step {m['divergence_onset_step']} < "
                   f"{MIN_DIVERGENCE_ONSET_STEP}")
    if not m["reward_step_agreement"] >= MIN_REWARD_AGREEMENT:
        out.append(f"per-step reward agreement {m['reward_step_agreement']:.4%} < "
                   f"{MIN_REWARD_AGREEMENT:.0%}")
    if not m["episode_reward_sum_diff"] <= MAX_EPISODE_REWARD_SUM_DIFF:
        out.append(f"Σ-reward difference {m['episode_reward_sum_diff']:g} > "
                   f"{MAX_EPISODE_REWARD_SUM_DIFF:g}")
    return out


def cpu_reference(variant: str, path: str, steps: int):
    """The CPU run of one case, from inputs made afresh (they are the same
    in every process), and its wall seconds."""
    t0 = time.perf_counter()
    out = run_trajectory("cpu", path, make_inputs(variant, steps))
    return out, time.perf_counter() - t0


def _one_thread():
    torch.set_num_threads(1)


def measure(device, steps=STEPS, workers=0, log=print) -> dict:
    """Every case's numbers, ``device`` against the CPU. With ``workers``,
    the CPU runs go to that many spawned processes of one thread each,
    while this one drives ``device``; they finish before it returns."""
    cases = [(v, p) for v in VARIANTS for p in PATHS]
    pool = None
    if workers:
        pool = ProcessPoolExecutor(max_workers=workers, initializer=_one_thread,
                                   mp_context=multiprocessing.get_context("spawn"))
    try:
        pending = {case: pool.submit(cpu_reference, *case, steps) for case in cases} if pool else {}
        out = {}
        for variant, path in cases:
            t0 = time.perf_counter()
            run = run_trajectory(device, path, make_inputs(variant, steps))
            run_s = time.perf_counter() - t0
            reference, cpu_s = (pending[(variant, path)].result() if pool
                                else cpu_reference(variant, path, steps))
            m = out[f"{variant}/{path}"] = drift(run, reference)
            log(f"{variant:10s} {path:15s} pos@100 {m['pos_drift_100_steps_m']:.2e} m  "
                f"onset step {m['divergence_onset_step']}  reward agree "
                f"{m['reward_step_agreement'] * 100:.2f}%  |Σreward Δ| "
                f"{m['episode_reward_sum_diff']:g}  ({device} {run_s:.1f} s, cpu "
                f"{cpu_s:.1f} s)")
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    return out
