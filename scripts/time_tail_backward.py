#!/usr/bin/env python3
"""Where the time of the tail's backward kernel (K3b) goes, on one NVIDIA GPU.

    python3 scripts/time_tail_backward.py [--B 1024] [--N 20] [--H 4] [--h 512]

No per-instruction profiler runs on the machines this port is measured on,
so this script builds variants of ``swarmacb_torch/ops/csrc/baseline_tail.cu``
that leave steps of ``fused_tail_bwd_kernel`` out and times each at the
given shape (default: the main path's), with the median device time of
``chip_smoke.device_ms``:

  - ``as built``: the source with the flags of ``swarmacb_torch.ops._cuda``;
  - ``uncapped``: the same without ``-maxrregcount`` (two blocks per SM);
  - ``no step 3``: without the contractions over o (d_attn_lhs, d_attn_mI);
  - ``no step 2``: without the d_wa and d_dws sums;
  - ``step 1 only``: the fc recompute, LayerNorm backward, d_xa, d_delta.

A variant that leaves a step out leaves its outputs unwritten: only the
times mean anything. The steps are cut at the source's own markers
(``// 2.`` and ``// 3.``). Prints registers and spills per variant, the
card's name and power limit, and a JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from swarmacb_torch.ops import _cuda  # noqa: E402

STEP2 = "    // 2. this thread's columns"
STEP3 = "    // 3. contractions over o"
LOOP_END = "  if (owns) store4(d_bias_part"


def _variant_source(src: str) -> str:
    """The source with steps 2 and 3 of the backward under #ifndef guards."""
    a, b, c = src.index(STEP2), src.index(STEP3), src.index(LOOP_END)
    c = src.rindex("  }\n", 0, c)          # the closing brace of the I loop
    return (src[:a] + "#ifndef SKIP_STEP2\n" + src[a:b] + "#endif\n"
            + "#ifndef SKIP_STEP3\n" + src[b:c] + "#endif\n" + src[c:])


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
        print("time_tail_backward: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)

    out_dir = _cuda.BUILD_DIR / "tail_backward_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src_path = out_dir / "baseline_tail_steps.cu"
    src_path.write_text(_variant_source(
        (_cuda.CSRC / "baseline_tail.cu").read_text()))
    flags = [*_cuda._COMMON_FLAGS, *_cuda.SOURCES["baseline_tail"]]
    uncapped = [f for f in flags if not f.startswith("-maxrregcount")]
    variants = {"as built": flags, "uncapped": uncapped,
                "no step 3": flags + ["-DSKIP_STEP3"],
                "no step 2": flags + ["-DSKIP_STEP2"],
                "step 1 only": flags + ["-DSKIP_STEP2", "-DSKIP_STEP3"]}
    nvcc = _cuda._nvcc()
    procs = {}
    for i, (name, fl) in enumerate(variants.items()):
        lib = out_dir / f"variant{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *fl, "-o", str(lib), str(src_path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    regs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            raise RuntimeError(f"nvcc failed for variant {name!r}")
        lines = log.splitlines()
        at = next(i for i, l in enumerate(lines)
                  if "Compiling entry" in l and "fused_tail_bwd_kernel" in l)
        end = next((i for i in range(at + 1, len(lines))
                    if "Compiling entry" in lines[i]), len(lines))
        regs[name] = "; ".join(l.split("info    :")[-1].strip()
                               for l in lines[at + 1:end]
                               if "registers" in l or "spill" in l)

    B, N, H, h = args.B, args.N, args.H, args.h
    cycles_per_ms = chip_smoke._sleep_cycles_per_ms(torch)
    inputs = chip_smoke._tail_inputs(torch, B, N, H, h, chip_smoke.SEED + 1)
    rng = np.random.default_rng(chip_smoke.SEED + 3)
    dout = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).cuda()
    grads = [torch.empty_like(t) for t in inputs]
    part = torch.empty((B, h), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (*inputs, dout, *grads, part)]
    ms = {}
    for name, (lib, _) in procs.items():
        fn = ctypes.CDLL(str(lib)).fused_tail_bwd_launch
        fn.argtypes = _cuda.SIGNATURES["baseline_tail"]["fused_tail_bwd_launch"]
        fn.restype = ctypes.c_int

        def call():
            _cuda.check(fn(*ptrs, B, N, H, h, stream), name)

        call()
        torch.cuda.synchronize()
        ms[name] = chip_smoke.device_ms(torch, call, cycles_per_ms)
        print(f"  {name:<12} {ms[name]:9.4f} ms   ({regs[name]})", flush=True)
    print(f"B={B}, N={N}, H={H}, h={h}, median of {chip_smoke.RUNS} runs each, "
          f"on {card}", flush=True)
    print(json.dumps({"card": card, "shape": [B, N, H, h], "ms": ms,
                      "ptxas": regs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
