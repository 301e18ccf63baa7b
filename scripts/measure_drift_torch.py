#!/usr/bin/env python3
"""How far the port's env on the card drifts from the CPU over whole
1200-step episodes.

The port's counterpart of ``scripts/tpu/measure_drift.py``. For each case,
dandelion, daisy and lily, each on the composed env step
(``DirectionalGateEnv.step``: K1 and K2) and on the fused one
(``env.lanes.step_lanes``: K4), E = 4 arenas of N = 20 robots run 1200
steps on the card and on the CPU, where every op takes its plain version.
Both sides start from one state made on the CPU, take one fixed action log
from ``np.random.default_rng(2024)`` (uniform wheels in ±1.5, or behaviour
modules 0–5), and are fed the same env draws (turn durations, auto-reset
spawns), made once on the CPU and injected on both devices.

Per case it reports, under the JAX script's names: ``max_pos_drift_m``,
``pos_drift_100_steps_m`` (the largest |Δ position| over the first 100
steps), ``divergence_onset_step`` (the first step at which some position
differs by more than 1e-3 m, or the step count if none does),
``max_reward_diff``, ``reward_step_agreement`` (the share of (step, arena)
rewards that are equal) and ``episode_reward_sum_diff`` (the largest
|Δ Σ reward| of an arena). It holds them to the JAX package's criteria
(``tests/test_tpu_drift.py``): at most 1e-4 m at step 100, onset at step
200 or later, at least 99 % per-step reward agreement, a Σ-reward
difference of at most 2.0; and exits 1 when a case misses one. The last
line of its output is one JSON object, case → numbers. Against the card,
the CPU runs go to spawned processes, one a case, while this one drives
the card (the machinery is ``swarmacb_torch/utils/drift.py``).

    python scripts/measure_drift_torch.py                  # the card against the CPU
    python scripts/measure_drift_torch.py --device cpu --steps 5
        # both sides on the CPU: the machinery, with zero drift
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from swarmacb_torch.utils.drift import (E, N, PATHS, STEPS, VARIANTS,  # noqa: E402
                                        measure, misses)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="the side held against the CPU (default: the card)")
    p.add_argument("--steps", type=int, default=STEPS)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("measure_drift_torch: no CUDA device is available", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"{torch.cuda.get_device_name(device)} against the CPU, E={E}, N={N}, "
              f"{args.steps} steps", flush=True)
    else:
        print(f"{device} against the CPU, E={E}, N={N}, {args.steps} steps", flush=True)
    # against the card, the CPU runs go to one process a case
    workers = len(VARIANTS) * len(PATHS) if device.type == "cuda" else 0
    out = measure(device, args.steps, workers=workers, log=lambda line: print(line, flush=True))
    failed = {case: misses(m, args.steps) for case, m in out.items()}
    for case, why in failed.items():
        for w in why:
            print(f"MISSED {case}: {w}", flush=True)
    print(json.dumps(out), flush=True)
    return 1 if any(failed.values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
