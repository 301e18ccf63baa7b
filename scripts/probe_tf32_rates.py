#!/usr/bin/env python3
"""How fast do the H100's tensor cores take TF32 products through mma.sync
and through wgmma?

    python3 scripts/probe_tf32_rates.py [--steps 2000]

K3f (``swarmacb_torch/ops/csrc/tail_forward.cu``) takes its product in
3xTF32 on the tensor cores. This builds two throughput kernels with nvcc
and the port's flags into ``build/probe/`` and times each on the card with
CUDA events, one block of 512 threads on every SM, operands that never
leave the chip:

- ``mma.sync.m16n8k8`` TF32: each warp keeps 5 x 4 accumulator tiles
  (80 rows x 32 columns) and issues three products into each per step;
- ``wgmma.m64n128k8`` TF32: four warpgroups, A and B from shared memory,
  three products per step;
- ``wgmma.m64n80k8`` TF32 as K3f issues it: four warpgroups, each two
  accumulators of 64 x 80, A from registers, B from shared memory, three
  products into each per step, and a wait for them before the next step.

Prints the card's name and power limit and one JSON line with each rate in
TFLOP/s, beside the card's published TF32 rate (495 TFLOP/s, dense).
Needs one CUDA device.
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

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(512, 1) mma_rate(float* out, int steps, uint32_t seed) {
  float acc[5][4][4] = {};
  uint32_t a[5][4], b[4][2];
  for (int i = 0; i < 5; ++i)
    for (int e = 0; e < 4; ++e) a[i][e] = seed * (i + 3 * e + threadIdx.x);
  for (int j = 0; j < 4; ++j)
    for (int e = 0; e < 2; ++e) b[j][e] = seed * (j + 7 * e + threadIdx.x);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], a[i], b[j]);
  }
  float sum = 0.f;
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 4; ++j)
      for (int e = 0; e < 4; ++e) sum += acc[i][j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

__device__ inline uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32);
}

__global__ void __launch_bounds__(512, 1) wgmma_rate(float* out, int steps) {
  extern __shared__ __align__(128) float sm[];
  for (int q = threadIdx.x; q < 64 * 8 + 4 * 128 * 8; q += blockDim.x) sm[q] = 0.001f * (q % 17);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x / 128;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const uint64_t da = smem_desc(sm, 128, 256);
  const uint64_t db = smem_desc(sm + 64 * 8 + wg * 128 * 8, 128, 256);
  for (int s = 0; s < steps; ++s) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sum += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

// K3f's shape: four warpgroups, each two m64n80k8 accumulators, A from
// registers, B (80 x 8, K-major, no swizzle) from shared memory
__global__ void __launch_bounds__(512, 1) wgmma_rs80_rate(float* out, int steps, uint32_t seed) {
  extern __shared__ __align__(128) float sm[];
  for (int q = threadIdx.x; q < 80 * 8; q += blockDim.x) sm[q] = 0.001f * (q % 17);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[2][40];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int i = 0; i < 40; ++i) d[mb][i] = 0.f;
  uint32_t a[2][4];
  for (int mb = 0; mb < 2; ++mb)
    for (int e = 0; e < 4; ++e) a[mb][e] = (seed * (mb + 3 * e + threadIdx.x)) & 0x3F7FE000u;
  const uint64_t db = smem_desc(sm, 10 * 128, 128);
  for (int s = 0; s < steps; ++s) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
          "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
          : "+f"(d[mb][0]), "+f"(d[mb][1]), "+f"(d[mb][2]), "+f"(d[mb][3]), "+f"(d[mb][4]),
        "+f"(d[mb][5]), "+f"(d[mb][6]), "+f"(d[mb][7]), "+f"(d[mb][8]), "+f"(d[mb][9]),
        "+f"(d[mb][10]), "+f"(d[mb][11]), "+f"(d[mb][12]), "+f"(d[mb][13]), "+f"(d[mb][14]),
        "+f"(d[mb][15]), "+f"(d[mb][16]), "+f"(d[mb][17]), "+f"(d[mb][18]), "+f"(d[mb][19]),
        "+f"(d[mb][20]), "+f"(d[mb][21]), "+f"(d[mb][22]), "+f"(d[mb][23]), "+f"(d[mb][24]),
        "+f"(d[mb][25]), "+f"(d[mb][26]), "+f"(d[mb][27]), "+f"(d[mb][28]), "+f"(d[mb][29]),
        "+f"(d[mb][30]), "+f"(d[mb][31]), "+f"(d[mb][32]), "+f"(d[mb][33]), "+f"(d[mb][34]),
        "+f"(d[mb][35]), "+f"(d[mb][36]), "+f"(d[mb][37]), "+f"(d[mb][38]), "+f"(d[mb][39])
          : "r"(a[mb][0]), "r"(a[mb][1]), "r"(a[mb][2]), "r"(a[mb][3]), "l"(db));
      }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float sum = 0.f;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int i = 0; i < 40; ++i) sum += d[mb][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int run_mma(float* out, int blocks, int steps, void* stream) {
  mma_rate<<<blocks, 512, 0, static_cast<cudaStream_t>(stream)>>>(out, steps, 12345u);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int run_wgmma_rs80(float* out, int blocks, int steps, void* stream) {
  wgmma_rs80_rate<<<blocks, 512, 80 * 8 * 4, static_cast<cudaStream_t>(stream)>>>(out, steps,
                                                                                  12345u);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int run_wgmma(float* out, int blocks, int steps, void* stream) {
  const int smem = (64 * 8 + 4 * 128 * 8) * 4;
  wgmma_rate<<<blocks, 512, smem, static_cast<cudaStream_t>(stream)>>>(out, steps);
  return static_cast<int>(cudaGetLastError());
}
"""

# operations per step and block: mma.sync, 16 warps x 60 m16n8k8; wgmma,
# 4 warpgroups x 3 m64n128k8; wgmma_rs80, 4 warpgroups x 2 x 3 m64n80k8
FLOP_PER_STEP = {"run_mma": 16 * 60 * 2 * 16 * 8 * 8, "run_wgmma": 4 * 3 * 2 * 64 * 128 * 8,
                 "run_wgmma_rs80": 4 * 2 * 3 * 2 * 64 * 80 * 8}
PEAK_TF32 = 495e12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    args = ap.parse_args()

    import torch

    from swarmacb_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("probe_tf32_rates: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "tf32_rates.cu").write_text(SOURCE)
    lib_path = out_dir / "libtf32_rates.so"
    subprocess.run([_cuda._nvcc(), *_cuda._COMMON_FLAGS, "-o", str(lib_path),
                    str(out_dir / "tf32_rates.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 512, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, flop in FLOP_PER_STEP.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if fn(out.data_ptr(), sms, 10, stream):
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if fn(out.data_ptr(), sms, args.steps, stream):
            raise RuntimeError(f"{name}: launch failed")
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        rates[name.removeprefix("run_") + "_tflops"] = sms * args.steps * flop / ms / 1e9
    print(json.dumps({"card": card, "tf32_peak_tflops": PEAK_TF32 / 1e12, **rates}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
