#!/usr/bin/env python3
"""Does ``torch.rsqrt`` on the card round as the port's CUDA kernels'
``rsqrtf`` does?

    python3 scripts/probe_torch_rsqrt.py

K4 (``swarmacb_torch/ops/csrc/fused_step.cu``) takes rsqrt plus one Newton
step where its plain version takes ``torch.rsqrt`` plus the same step. This
builds a one-line kernel, ``y = rsqrtf(x)``, with nvcc and K4's flags into
``build/probe/``, runs it on every float32 in [2^-40, 2^6) (the range of
the squared distances and vector norms K4 feeds it), and compares the
result bit for bit with ``torch.rsqrt`` of the same inputs. Prints the
number of inputs whose results differ and the largest difference in ulps.
Needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>
__global__ void probe(const float* x, float* y, long n) {
  long k = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (k < n) y[k] = rsqrtf(x[k]);
}
extern "C" int probe_launch(const float* x, float* y, long n, void* stream) {
  probe<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import torch

    from swarmacb_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("probe_torch_rsqrt: no CUDA device is available", file=sys.stderr)
        return 1
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "rsqrt_probe.cu").write_text(SOURCE)
    lib_path = out / "librsqrt_probe.so"
    flags = [*_cuda._COMMON_FLAGS, *_cuda.SOURCES["fused_step"]]
    subprocess.run([_cuda._nvcc(), *flags, "-o", str(lib_path),
                    str(out / "rsqrt_probe.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                                 ctypes.c_void_p]
    lib.probe_launch.restype = ctypes.c_int

    lo = int(torch.tensor(2.0 ** -40).view(torch.int32))
    hi = int(torch.tensor(2.0 ** 6).view(torch.int32))
    chunk = 1 << 26
    differ, worst, total = 0, 0, 0
    for start in range(lo, hi, chunk):
        bits = torch.arange(start, min(start + chunk, hi), device="cuda",
                            dtype=torch.int32)
        x = bits.view(torch.float32)
        y = torch.empty_like(x)
        err = lib.probe_launch(x.data_ptr(), y.data_ptr(), x.numel(),
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe launch failed with error {err}")
        ref = torch.rsqrt(x)
        ulps = (y.view(torch.int32).long() - ref.view(torch.int32).long()).abs()
        differ += int((ulps != 0).sum())
        worst = max(worst, int(ulps.max()))
        total += x.numel()
    print(f"{torch.cuda.get_device_name(0)}: rsqrtf against torch.rsqrt on {total:,} "
          f"float32 inputs in [2^-40, 2^6): {differ:,} differ, largest difference "
          f"{worst} ulp")
    return 0


if __name__ == "__main__":
    sys.exit(main())
