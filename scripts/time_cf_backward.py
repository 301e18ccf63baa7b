#!/usr/bin/env python3
"""Where the time of the fused attention's backward (K5b) goes, on one
NVIDIA GPU.

    python3 scripts/time_cf_backward.py [--B 1024] [--N 20] [--H 4] [--h 512]
                                        [--wide] [--root DIR] [--label L]

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

``--wide`` times the wide route instead (``cf_attention_wide.cu``, the
shapes ``cf_attention.route`` sends past the tuned kernels; default
h = 1024): its four backward stages and its two forward stages (K5f-wide:
base, rows), each beside its bound, both directions whole beside the staged
route's byte bound (each stage's inputs, outputs and scratch moved once),
and the forward also at the rollout's B = 16. ``--root`` times the package
of another checkout with this script's helpers (unpack the parent with
``git archive <commit> | tar -x -C runs/parent``); set two versions side by
side in one call as parent, change, change, parent.
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

# the wide route's kernels, this tree's and the parent's
WIDE_KERNELS = tuple(dict.fromkeys((*chip_smoke.WIDE_KERNELS["cf_attention_wide"],
                                    "cf_wide_terms_kernel", "cf_wide_fwd_rows_kernel",
                                    "cf_wide_bwd_rows_kernel", "cf_wide_sums_kernel",
                                    "gemm_kernel", "tc_gemm_kernel",
                                    "sum_over_groups_kernel")))


def _print_stages(direction, stages):
    for i, (name, st) in enumerate(stages.items()):
        lib = "" if st["library_ms"] is None else f", torch.bmm {st['library_ms']:.4f} ms"
        print(f"  {direction} stage {i} {name:<9} {st['ms']:9.4f} ms{lib}, bound "
              f"{st['bound_ms']:.4f} ms ({st['bound_by']}: {st['bytes'] / 1e6:.1f} MB, "
              f"{st['flops'] / 1e9:.2f} GFLOP)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=chip_smoke.E_MAIN)
    ap.add_argument("--N", type=int, default=chip_smoke.N_MAIN)
    ap.add_argument("--H", type=int, default=chip_smoke.H_MAIN)
    ap.add_argument("--h", type=int, default=None,
                    help=f"default {chip_smoke.HID_MAIN}, with --wide {chip_smoke.HID_WIDE}")
    ap.add_argument("--wide", action="store_true",
                    help="time the wide route (cf_attention_wide.cu)")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose swarmacb_torch is timed")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_cf_backward: no CUDA device is available", file=sys.stderr)
        return 1
    import swarmacb_torch
    from swarmacb_torch.ops import _cuda, cf_attention

    if Path(swarmacb_torch.__file__).resolve().parents[1] != root:
        print(f"time_cf_backward: swarmacb_torch is not {root}'s", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{card}; timing {root} {args.label}", flush=True)
    source = "cf_attention_wide" if args.wide else "cf_attention"
    _cuda.build([source])
    ptxas = chip_smoke.ptxas_report(_cuda.build_log(source),
                                    WIDE_KERNELS if args.wide
                                    else chip_smoke.CF_BACKWARD_KERNELS)
    for name, info in ptxas.items():
        print(f"  ptxas {name}: {info}", flush=True)

    B, N, H = args.B, args.N, args.H
    h = args.h or (chip_smoke.HID_WIDE if args.wide else chip_smoke.HID_MAIN)
    d = h // H
    wide = args.wide
    cycles_per_ms = chip_smoke._sleep_cycles_per_ms(torch)
    inputs = chip_smoke._cf_inputs(torch, B, N, H, h, chip_smoke.SEED + 5, 3.0)
    rng = np.random.default_rng(chip_smoke.SEED + 6)
    dout = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).cuda()
    whole = chip_smoke.device_ms(
        torch, lambda: cf_attention.backward_kernel(inputs, dout, d, wide=wide), cycles_per_ms)
    stages = chip_smoke.time_cf_backward_stages(torch, inputs, dout, d, cycles_per_ms,
                                                wide=wide)
    route_b, _ = chip_smoke.bound_ms(sum(st["bytes"] for st in stages.values()), 0)
    out = {"card": card, "root": str(root), "label": args.label, "wide": wide,
           "shape": [B, N, H, h], "whole_ms": whole, "route_bound_ms": route_b,
           "stages": stages, "ptxas": ptxas}
    print(f"  whole backward {whole:9.4f} ms (staged route's byte bound {route_b:.4f} ms)",
          flush=True)
    _print_stages("backward", stages)
    if wide:
        with torch.no_grad():
            fwd = {}
            for b in (B, chip_smoke.WIDE_ROLLOUT_B):
                part = [a[:b].contiguous() for a in inputs[:-1]] + [inputs[-1]]
                st = chip_smoke.time_cf_forward_stages(torch, part, d, cycles_per_ms,
                                                       wide=True)
                r_ms, _ = chip_smoke.bound_ms(sum(s["bytes"] for s in st.values()), 0)
                fwd[b] = dict(ms=chip_smoke.device_ms(
                    torch, lambda: cf_attention.forward_kernel(part, d, wide=True),
                    cycles_per_ms), route_bound_ms=r_ms, stages=st)
                print(f"  forward (K5f-wide) at B={b} {fwd[b]['ms']:9.4f} ms (staged route's "
                      f"byte bound {r_ms:.4f} ms)", flush=True)
                _print_stages("forward", st)
        out["forward"] = fwd
    print(f"B={B}, N={N}, H={H}, h={h}, median of {chip_smoke.RUNS} runs each, on {card}",
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
