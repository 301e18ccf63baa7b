// Forward of the counterfactual-baseline tail of POCACritic.all_baselines,
// for Hopper (sm_90a).
//
// Replaces (TPU kernel): swarmacb_tpu/ops/baseline_tail.py: fused_tail, its
// forward _fused_tail_fwd (Pallas body _fwd_kernel). The backward
// (_fused_tail_bwd) is not ported here.
//
// Computes, per group b and counterfactual agent I (inputs: attn_lhs
// (B, N*N, H*N) with row I*N+n and column h*N+m, attn_mI (B, H, N, N) as
// [h, I, n], wa (B, H*N, h), dws (B, H, N, h), x_a and delta (B, N, h),
// bias (h,)):
//   fc[n, o]  = sum_m attn_lhs[b, I*N+n, m] * wa[b, m, o]
//             + sum_h attn_mI[b, h, I, n] * dws[b, h, I, o]
//             + bias[o] + x_a[b, n, o] + (n == I) * delta[b, I, o]
//   y[n, :]   = LayerNorm(fc[n, :])   (non-affine, eps 1e-5, two-pass stats)
//   out[b, I] = mean_n y[n, :]
//
// What bounds it on the H100: arithmetic. At the main path's B = 1024
// groups, N = 20, H = 4, h = 512 it does ~37 GFLOP of f32 work (the
// attention x folded-values product is 34 of them) against ~600 MB of
// inputs and outputs: ~0.55 ms at the 67 TFLOP/s f32 CUDA-core rate, which
// is above the ~0.18 ms the bytes take at 3.35 TB/s. Tensor cores would
// lift the arithmetic bound, but TF32 keeps ~3 decimal digits and would
// change the numbers the critic learns from; that is a later step.
//
// Design: one block per (b, I), b-major, so the N blocks of a group run
// close together and L2 (50 MB) serves their re-reads of wa[b] (160 KB) —
// fc is never written to device memory, the point of the TPU kernel too.
// Each block stages its N attention rows (N*H*N floats) in shared memory;
// each thread owns 4 adjacent output columns (one float4 per row of wa) and
// accumulates kRows rows of fc in registers per pass over wa, so wa[b] is
// read ceil(N / kRows) times per block. LayerNorm statistics of those rows
// are block reductions (warp shuffles, then one shared-memory step), and
// the pooled row accumulates in registers until the single store.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 4;   // output columns per thread (float4)
constexpr int kRows = 10;  // fc rows accumulated per pass over wa
constexpr float kLnEps = 1e-5f;

// Sums v[0..kRows) over the whole block; every thread gets the totals.
__device__ void block_sum(float (&v)[kRows], float* s_red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float x = v[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) s_red[warp * kRows + r] = x;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float x = 0.f;
    for (int w = 0; w < nwarps; ++w) x += s_red[w * kRows + r];
    v[r] = x;
  }
  __syncthreads();
}

__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void fused_tail_fwd_kernel(
    const float* __restrict__ attn_lhs, const float* __restrict__ attn_mI,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ out, int N, int H,
    int h) {
  extern __shared__ float smem[];
  const int HM = H * N;
  float* s_attn = smem;            // N rows of HM
  float* s_red = smem + N * HM;    // (blockDim / 32) * kRows

  const int b = blockIdx.x / N;
  const int I = blockIdx.x % N;
  const int o0 = threadIdx.x * kCols;
  const bool owns = o0 < h;

  const float* src = attn_lhs + (static_cast<size_t>(b) * N + I) * N * HM;
  for (int k = threadIdx.x; k < N * HM; k += blockDim.x) s_attn[k] = src[k];
  __syncthreads();

  const float* wa_b = wa + static_cast<size_t>(b) * HM * h;
  float4 bi = make_float4(0.f, 0.f, 0.f, 0.f), dl = bi;
  if (owns) {
    bi = load4(bias + o0);
    dl = load4(delta + (static_cast<size_t>(b) * N + I) * h + o0);
  }
  float pooled[kCols] = {0.f, 0.f, 0.f, 0.f};

  for (int n0 = 0; n0 < N; n0 += kRows) {
    float fc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) fc[r][c] = 0.f;

    if (owns) {
      // attention x folded values
      for (int m = 0; m < HM; ++m) {
        const float4 w = load4(wa_b + static_cast<size_t>(m) * h + o0);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float a = s_attn[min(n0 + r, N - 1) * HM + m];
          fc[r][0] += a * w.x;
          fc[r][1] += a * w.y;
          fc[r][2] += a * w.z;
          fc[r][3] += a * w.w;
        }
      }
      // rank-1 diagonal value correction, summed over heads first
      float r1[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) r1[r][c] = 0.f;
      for (int hh = 0; hh < H; ++hh) {
        const size_t row = (static_cast<size_t>(b) * H + hh) * N + I;
        const float4 dv = load4(dws + row * h + o0);
        const float* am = attn_mI + row * N;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float a = am[min(n0 + r, N - 1)];
          r1[r][0] += a * dv.x;
          r1[r][1] += a * dv.y;
          r1[r][2] += a * dv.z;
          r1[r][3] += a * dv.w;
        }
      }
      // residual: bias, x_a[n], and delta[I] on the diagonal n == I
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = min(n0 + r, N - 1);
        const float4 xa = load4(x_a + (static_cast<size_t>(b) * N + n) * h + o0);
        const float on_diag = (n == I) ? 1.f : 0.f;
        fc[r][0] = ((fc[r][0] + r1[r][0]) + bi.x) + xa.x + on_diag * dl.x;
        fc[r][1] = ((fc[r][1] + r1[r][1]) + bi.y) + xa.y + on_diag * dl.y;
        fc[r][2] = ((fc[r][2] + r1[r][2]) + bi.z) + xa.z + on_diag * dl.z;
        fc[r][3] = ((fc[r][3] + r1[r][3]) + bi.w) + xa.w + on_diag * dl.w;
      }
    }

    // non-affine LayerNorm over the h columns of each row: two-pass stats
    float stat[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      stat[r] = owns ? ((fc[r][0] + fc[r][1]) + fc[r][2]) + fc[r][3] : 0.f;
    block_sum(stat, s_red);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float mu = stat[r] / static_cast<float>(h);
#pragma unroll
      for (int c = 0; c < kCols; ++c) fc[r][c] -= mu;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) s += fc[r][c] * fc[r][c];
      stat[r] = owns ? s : 0.f;
    }
    block_sum(stat, s_red);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (n0 + r < N) {
        const float rstd = 1.0f / sqrtf(stat[r] / static_cast<float>(h) + kLnEps);
#pragma unroll
        for (int c = 0; c < kCols; ++c) pooled[c] += fc[r][c] * rstd;
      }
    }
  }

  if (owns) {
    const float rows = static_cast<float>(N);
    const float4 res = make_float4(pooled[0] / rows, pooled[1] / rows,
                                   pooled[2] / rows, pooled[3] / rows);
    *reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * N + I) * h + o0) = res;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success). Needs h % 4 == 0
// and 16-byte aligned pointers (checked by the Python wrapper).
int fused_tail_fwd_launch(const float* attn_lhs, const float* attn_mI,
                          const float* wa, const float* dws, const float* x_a,
                          const float* delta, const float* bias, float* out,
                          int B, int N, int H, int h, void* stream) {
  const int threads = ((h / kCols + 31) / 32) * 32;
  if (h % kCols != 0 || threads > 1024 || B <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(N) * H * N + (threads / 32) * kRows) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_tail_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_tail_fwd_kernel<<<B * N, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      attn_lhs, attn_mI, wa, dws, x_a, delta, bias, out, N, H, h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
