#!/usr/bin/env python3
"""Where the time of the fused attention's backward (K5b) goes, on one
NVIDIA GPU.

    python3 scripts/time_cf_backward.py [--B 1024] [--N 20] [--H 4] [--h 512]

K5b is four kernels of ``swarmacb_torch/ops/csrc/cf_attention.cu``, joined
by scratch in device memory: the softmax terms and base products of each
(group, head), the rows of each (group, counterfactual) with the d_fc
scratch, the sums of each group over counterfactuals (d_num, d_xa, and the
d_bias partial, summed over groups by a small fifth kernel), and the
products of each (group, head) (dS_aa, dS_sa, d_wa). This script builds the
source with the flags of ``swarmacb_torch.ops._cuda``, prints what ptxas
gave each kernel of the backward (registers, spills, shared memory), and at
the given shape (default: the main path's) times the whole backward and
each stage alone, beside each stage's bound and, for the base products and
the products stage, ``torch.bmm`` of the stage's products (cuBLAS, float32
with TF32 off). Times are medians of ``chip_smoke.device_ms``. Prints the
card's name and power limit, and a JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from swarmacb_torch.ops import _cuda, cf_attention  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=chip_smoke.E_MAIN)
    ap.add_argument("--N", type=int, default=chip_smoke.N_MAIN)
    ap.add_argument("--H", type=int, default=chip_smoke.H_MAIN)
    ap.add_argument("--h", type=int, default=chip_smoke.HID_MAIN)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_cf_backward: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    _cuda.build(["cf_attention"])
    ptxas = chip_smoke.ptxas_report(_cuda.build_log("cf_attention"),
                                    chip_smoke.CF_BACKWARD_KERNELS)
    for name, info in ptxas.items():
        print(f"  ptxas {name}: {info}", flush=True)

    B, N, H, h = args.B, args.N, args.H, args.h
    d = h // H
    cycles_per_ms = chip_smoke._sleep_cycles_per_ms(torch)
    inputs = chip_smoke._cf_inputs(torch, B, N, H, h, chip_smoke.SEED + 5, 3.0)
    rng = np.random.default_rng(chip_smoke.SEED + 6)
    dout = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).cuda()
    whole = chip_smoke.device_ms(
        torch, lambda: cf_attention.backward_kernel(inputs, dout, d), cycles_per_ms)
    stages = chip_smoke.time_cf_backward_stages(torch, inputs, dout, d, cycles_per_ms)
    print(f"  whole backward {whole:9.4f} ms", flush=True)
    for i, (name, st) in enumerate(stages.items()):
        lib = "" if st["library_ms"] is None else f", torch.bmm {st['library_ms']:.4f} ms"
        print(f"  stage {i} {name:<9} {st['ms']:9.4f} ms{lib}, bound {st['bound_ms']:.4f} ms "
              f"({st['bound_by']})", flush=True)
    print(f"B={B}, N={N}, H={H}, h={h}, median of {chip_smoke.RUNS} runs each, on {card}",
          flush=True)
    print(json.dumps({"card": card, "shape": [B, N, H, h], "whole_ms": whole,
                      "stages": stages, "ptxas": ptxas}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
