#!/usr/bin/env python3
"""Where the time of the tail's backward (K3b) goes, on one NVIDIA GPU.

    python3 scripts/time_tail_backward.py [--B 1024] [--N 20] [--H 4] [--h 512]
                                          [--wide] [--root DIR] [--label L]

K3b is three kernels of ``swarmacb_torch/ops/csrc/baseline_tail.cu``,
joined by the d_fc scratch: the rows of each (b, I), the batched product
attn_lhsᵀ·d_fc (d_wa, with d_xa and the d_bias partial summed over groups
by a fourth, small kernel), and the batched product d_fc·waᵀ (d_attn_lhs).
This script builds the source with the flags of ``swarmacb_torch.ops._cuda``,
prints what ptxas gave each kernel of the file (registers, spills, shared
memory), and at the given shape (default: the main path's) times the whole
backward and each stage alone, beside each stage's bound and, for the two
products, ``torch.bmm`` on the same operands (cuBLAS, float32 with TF32
off). Times are medians of ``chip_smoke.device_ms``. Prints the card's name
and power limit, and a JSON line.

``--wide`` times the wide route instead (``tail_wide.cu``, the shapes
``baseline_tail.route`` sends past the tuned kernels; default h = 1024):
its three stages, each beside the bound of its route (the products in
3×TF32 on the tensor cores) and the float32 one, the whole backward, and
the wide forward (K3f-wide) at B and at the rollout's B = 16. ``--root``
times the package of another checkout with this script's helpers (unpack
the parent with ``git archive <commit> | tar -x -C runs/parent``); set two
versions side by side in one call as parent, change, change, parent.
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

KERNELS = ("tail_bwd_rows_kernel", "tail_bwd_wa_kernel",
           "sum_over_groups_kernel", "tail_bwd_attn_kernel")
# the wide route's kernels, this tree's and the parent's (gemm_kernel)
WIDE_KERNELS = (*chip_smoke.WIDE_KERNELS["tail_wide"], "gemm_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=chip_smoke.E_MAIN)
    ap.add_argument("--N", type=int, default=chip_smoke.N_MAIN)
    ap.add_argument("--H", type=int, default=chip_smoke.H_MAIN)
    ap.add_argument("--h", type=int, default=None,
                    help=f"default {chip_smoke.HID_MAIN}, with --wide {chip_smoke.HID_WIDE}")
    ap.add_argument("--wide", action="store_true", help="time the wide route (tail_wide.cu)")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose swarmacb_torch is timed")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_tail_backward: no CUDA device is available", file=sys.stderr)
        return 1
    import swarmacb_torch
    from swarmacb_torch.ops import _cuda, baseline_tail

    if Path(swarmacb_torch.__file__).resolve().parents[1] != root:
        print(f"time_tail_backward: swarmacb_torch is not {root}'s", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{card}; timing {root} {args.label}", flush=True)
    source = "tail_wide" if args.wide else "baseline_tail"
    _cuda.build([source])
    ptxas = chip_smoke.ptxas_report(_cuda.build_log(source),
                                    WIDE_KERNELS if args.wide else KERNELS)
    for name, info in ptxas.items():
        print(f"  ptxas {name}: {info}", flush=True)

    B, N, H = args.B, args.N, args.H
    h = args.h or (chip_smoke.HID_WIDE if args.wide else chip_smoke.HID_MAIN)
    cycles_per_ms = chip_smoke._sleep_cycles_per_ms(torch)
    inputs = chip_smoke._tail_inputs(torch, B, N, H, h, chip_smoke.SEED + 1)
    rng = np.random.default_rng(chip_smoke.SEED + 3)
    dout = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).cuda()
    whole = chip_smoke.device_ms(
        torch, lambda: baseline_tail.backward_kernel(inputs, dout, N, wide=args.wide),
        cycles_per_ms)
    stages = chip_smoke.time_tail_backward_stages(torch, inputs, dout, N, cycles_per_ms,
                                                  wide=args.wide)
    out = {"card": card, "root": str(root), "label": args.label, "wide": args.wide,
           "shape": [B, N, H, h], "whole_ms": whole, "stages": stages, "ptxas": ptxas}
    bb = chip_smoke.tail_backward_bounds(B, N, H, h)
    print(f"  whole backward {whole:9.4f} ms (float32 bound {bb['f32_bound_ms']:.4f} ms"
          + (f"; route bound {bb['bound_ms']:.4f} ms, with the d_fc scratch "
             f"{bb['scratch_bound_ms']:.4f} ms" if args.wide else "") + ")", flush=True)
    for i, (name, st) in enumerate(stages.items(), 1):
        lib = "" if st["library_ms"] is None else f", torch.bmm {st['library_ms']:.4f} ms"
        f32 = f"; float32 bound {st['f32_bound_ms']:.4f} ms" if args.wide else ""
        print(f"  stage {i} {name:<10} {st['ms']:9.4f} ms{lib}, bound {st['bound_ms']:.4f} ms "
              f"({st['bound_by']}){f32}", flush=True)
    if args.wide:
        with torch.no_grad():
            fwd = {}
            for b in (B, chip_smoke.WIDE_ROLLOUT_B):
                part = [a[:b] for a in inputs[:-1]] + [inputs[-1]]
                bf = chip_smoke.tail_forward_bounds(b, N, H, h)
                fwd[b] = dict(ms=chip_smoke.device_ms(
                    torch, lambda: baseline_tail._forward_kernel(part, N, wide=True),
                    cycles_per_ms), bound_ms=bf["bound_ms"], f32_bound_ms=bf["f32_bound_ms"])
                print(f"  forward (K3f-wide) at B={b} {fwd[b]['ms']:9.4f} ms, route bound "
                      f"{bf['bound_ms']:.4f} ms ({bf['bound_by']}), float32 bound "
                      f"{bf['f32_bound_ms']:.4f} ms", flush=True)
        out["forward"] = fwd
    print(f"B={B}, N={N}, H={H}, h={h}, median of {chip_smoke.RUNS} runs each, on {card}",
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
