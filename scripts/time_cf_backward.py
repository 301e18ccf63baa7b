#!/usr/bin/env python3
"""Where the time of the fused attention's backward kernel (K5b) goes, on one
NVIDIA GPU.

    python3 scripts/time_cf_backward.py [--B 1024] [--N 20] [--H 4] [--h 512]

No per-instruction profiler runs on the machines this port is measured on,
so this script builds variants of ``swarmacb_torch/ops/csrc/cf_attention.cu``
that leave steps of ``cf_bwd_kernel`` out, or hold fewer of its blocks on an
SM, and times each at the given shape (default: the main path's) with the
median device time of ``chip_smoke.device_ms``:

  - ``as built``: the source with the flags of ``swarmacb_torch.ops._cuda``;
  - ``uncapped``: the same without ``-maxrregcount``;
  - ``2 blocks/SM`` and ``1 block/SM``: the launch asks for more shared
    memory than the block uses, so that fewer blocks share an SM and the
    scratch of the blocks in flight (num and d_num, 2·H·N·h floats a group)
    takes less of the 50 MB L2;
  - ``no step 3``: without the products with the finished d_num;
  - ``no steps 2-3``: also without row I of dS_sa;
  - ``pass 1 only``: also without pass 2 of step 1 (the three dot products
    of every row, and the d_num, d_wa and d_dws sums): the recompute of fc,
    the LayerNorm backward, d_xa and d_delta.

A variant that leaves a step out leaves its outputs unwritten: only the
times mean anything. The steps are cut at the source's own markers. Prints
registers and spills per variant, the card's name and power limit, and a
JSON line.
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

# (start marker, end marker, guard) of each step that a variant can leave out
CUTS = [("      // pass 2: per head", "    }\n    bias_acc = add4(bias_acc, bias_I);",
         "SKIP_PASS2"),
        ("    // 2. row I of dS_sa", "  }\n  __syncthreads();  // s_dEaa and s_dZ",
         "SKIP_STEP2"),
        ("  // 3. per head", "  if (owns) store4(d_bias_part", "SKIP_STEP3")]
LAUNCH = "cf_bwd_kernel<<<B, threads, smem, s>>>"
ALLOW = "allow_smem(cf_bwd_kernel, smem)"


def _variant_source(src: str) -> str:
    """The source with the steps under #ifndef guards, and the backward's
    launch asking for at least MIN_SMEM bytes of shared memory."""
    for start, end, guard in CUTS:
        a, b = src.index(start), src.index(end)
        src = src[:a] + f"#ifndef {guard}\n" + src[a:b] + "#endif\n" + src[b:]
    padded = "(smem < MIN_SMEM ? MIN_SMEM : smem)"
    src = src.replace(LAUNCH, LAUNCH.replace("smem, s", f"{padded}, s"))
    src = src.replace(ALLOW, ALLOW.replace("smem)", f"{padded})"))
    return "#ifndef MIN_SMEM\n#define MIN_SMEM 0\n#endif\n" + src


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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)

    out_dir = _cuda.BUILD_DIR / "cf_backward_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src_path = out_dir / "cf_attention_steps.cu"
    src_path.write_text(_variant_source((_cuda.CSRC / "cf_attention.cu").read_text()))
    flags = [*_cuda._COMMON_FLAGS, *_cuda.SOURCES["cf_attention"]]
    uncapped = [f for f in flags if not f.startswith("-maxrregcount")]
    variants = {"as built": flags, "uncapped": uncapped,
                "2 blocks/SM": flags + ["-DMIN_SMEM=80000"],
                "1 block/SM": flags + ["-DMIN_SMEM=120000"],
                "no step 3": flags + ["-DSKIP_STEP3"],
                "no steps 2-3": flags + ["-DSKIP_STEP2", "-DSKIP_STEP3"],
                "pass 1 only": flags + ["-DSKIP_PASS2", "-DSKIP_STEP2",
                                        "-DSKIP_STEP3"]}
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
                  if "Compiling entry" in l and "cf_bwd_kernel" in l)
        end = next((i for i in range(at + 1, len(lines))
                    if "Compiling entry" in lines[i]), len(lines))
        regs[name] = "; ".join(l.split("info    :")[-1].strip()
                               for l in lines[at + 1:end]
                               if "registers" in l or "spill" in l)

    B, N, H, h = args.B, args.N, args.H, args.h
    cycles_per_ms = chip_smoke._sleep_cycles_per_ms(torch)
    inputs = chip_smoke._cf_inputs(torch, B, N, H, h, chip_smoke.SEED + 5, 3.0)
    rng = np.random.default_rng(chip_smoke.SEED + 6)
    dout = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).cuda()
    grads = [torch.empty_like(t) for t in inputs]
    scratch = [torch.empty((B, h), device="cuda"),
               torch.empty((B, H, N, h), device="cuda"),
               torch.empty((B, H, N, h), device="cuda")]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (*inputs, dout, *grads, *scratch)]
    sqrt_d = float((h // H) ** 0.5)
    ms = {}
    for name, (lib, _) in procs.items():
        fn = ctypes.CDLL(str(lib)).cf_attention_bwd_launch
        fn.argtypes = _cuda.SIGNATURES["cf_attention"]["cf_attention_bwd_launch"]
        fn.restype = ctypes.c_int

        def call():
            _cuda.check(fn(*ptrs, B, N, H, h, sqrt_d, stream), name)

        call()
        torch.cuda.synchronize()
        ms[name] = chip_smoke.device_ms(torch, call, cycles_per_ms)
        print(f"  {name:<13} {ms[name]:9.4f} ms   ({regs[name]})", flush=True)
    print(f"B={B}, N={N}, H={H}, h={h}, median of {chip_smoke.RUNS} runs each, "
          f"on {card}", flush=True)
    print(json.dumps({"card": card, "shape": [B, N, H, h], "ms": ms,
                      "ptxas": regs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
