// The wide route of the counterfactual-baseline tail of
// POCACritic.all_baselines (K3f forward, K3b backward), for Hopper
// (sm_90a): every shape the JAX function takes, where the tuned kernels
// (tail_forward.cu, baseline_tail.cu) take h <= 512 with h % 4 == 0,
// N <= 32 and H * N % 4 == 0. ops/baseline_tail.py picks the route by
// shape alone (route()).
//
// Replaces (TPU kernels): swarmacb_tpu/ops/baseline_tail.py: _fused_tail_fwd
// (Pallas body _fwd_kernel) and _fused_tail_bwd (Pallas body _bwd_kernel),
// at the widths whose _pick_G shrinks the groups per block until a block
// fits.
//
// The function, per group b and counterfactual I (the inputs of
// baseline_tail.cu): fc[n, o] = sum_m attn_lhs[b, I*N+n, m] wa[b, m, o]
// + sum_h attn_mI[b, h, I, n] dws[b, h, I, o] + bias[o] + x_a[b, n, o]
// + (n == I) delta[b, I, o]; y = LayerNorm(fc[n, :]); out[b, I] = mean_n y.
//
// What bounds it: arithmetic, as the tuned kernels. At B = 1024, N = 20,
// H = 4, h = 1024 the forward's product is ~67 GFLOP and the backward's
// three (the fc recompute, d_wa, d_attn_lhs) ~200 GFLOP, against ~2 GB of
// inputs, outputs and d_fc scratch (chip_smoke._tail_forward_work and
// _tail_backward_work count them). This route is the simple one: float32 on
// the CUDA cores, 4-byte loads, no tensor cores.
//
// Design (wide_common.cuh for what the routes share):
//   forward (tail_wide_fwd_kernel), one block of 256 threads per (b, I):
//     the fc rows, kRows at a time, each thread 2 columns of a 512-column
//     tile, the attention rows staged in shared memory by slices of kSlice
//     columns m and read as float4s, wa read from L2 row by row; the rows go
//     to shared memory where N * h floats fit the wrapper's budget, else to
//     a (B, N*N, h) scratch in device memory. Then the two-pass statistics,
//     one warp a row, and the pool.
//   backward, the three stages of baseline_tail.cu joined by d_fc:
//     1. rows (tail_wide_bwd_rows_kernel), one block per (b, I): fc into
//        its rows of d_fc, the statistics, the LayerNorm backward in place,
//        then d_delta, d_dws (a thread a column, summed over n) and
//        d_attn_mI (a warp a (head, n), summed over the row's tiles);
//     2. d_wa = attn_lhs^T d_fc per group (gemm), d_xa = the sum over I of
//        d_fc (tail_wide_sums_kernel, a thread a column), its sum over n
//        into a (B, h) partial and the sum of the partials over b;
//     3. d_attn_lhs = d_fc wa^T per group (gemm).

#include "wide_common.cuh"

namespace {

using namespace wide;

constexpr int kSlice = 256;  // attention columns m staged at a time

// Floats of shared memory of a rows block before the rows themselves: the
// staged attention and `stats` arrays of N floats (and one more).
__host__ __device__ inline size_t head_floats(int N, int stats) {
  return static_cast<size_t>(kSlice) * kRows + static_cast<size_t>(stats) * N + 1;
}

// The fc rows of counterfactual I of group b into rows[n * h + o]. s_a holds
// kSlice * kRows floats, 16-byte aligned. The whole block calls it; it ends
// with a barrier.
__device__ void build_fc(float* rows, float* s_a, const float* attn_lhs,
                         const float* attn_mI, const float* wa,
                         const float* dws, const float* x_a,
                         const float* delta, const float* bias, int b, int I,
                         int N, int H, int h) {
  const int HM = H * N;
  const size_t bI = static_cast<size_t>(b) * N + I;
  const float* lhs = attn_lhs + bI * N * HM;  // row n of I at lhs[n * HM]
  const float* wa_b = wa + static_cast<size_t>(b) * HM * h;
  for (int n0 = 0; n0 < N; n0 += kRows) {
    for (int c0 = 0; c0 < h; c0 += kTile) {
      float acc[kRows][kCpt] = {};
      for (int m0 = 0; m0 < HM; m0 += kSlice) {
        const int ms = min(kSlice, HM - m0);
        __syncthreads();  // every thread is done with the last slice
        for (int q = threadIdx.x; q < ms * kRows; q += blockDim.x) {
          const int r = q / ms, mm = q % ms;
          s_a[mm * kRows + r] =
              n0 + r < N ? lhs[static_cast<size_t>(n0 + r) * HM + m0 + mm] : 0.f;
        }
        __syncthreads();
        for (int mm = 0; mm < ms; ++mm) {
          const float4 a0 = *reinterpret_cast<const float4*>(s_a + mm * kRows);
          const float4 a1 = *reinterpret_cast<const float4*>(s_a + mm * kRows + 4);
          const float av[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float* w = wa_b + static_cast<size_t>(m0 + mm) * h;
#pragma unroll
          for (int k = 0; k < kCpt; ++k) {
            const int o = c0 + threadIdx.x + k * kThreads;
            const float wv = o < h ? w[o] : 0.f;
#pragma unroll
            for (int r = 0; r < kRows; ++r) acc[r][k] += av[r] * wv;
          }
        }
      }
      // the rank-1 term over heads, then bias, x_a and delta on n == I
#pragma unroll
      for (int k = 0; k < kCpt; ++k) {
        const int o = c0 + threadIdx.x + k * kThreads;
        if (o >= h) continue;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int n = n0 + r;
          if (n >= N) continue;
          float r1 = 0.f;
          for (int hh = 0; hh < H; ++hh) {
            const size_t row = (static_cast<size_t>(b) * H + hh) * N + I;
            r1 += attn_mI[row * N + n] * dws[row * h + o];
          }
          float fc = ((acc[r][k] + r1) + bias[o]) +
                     x_a[(static_cast<size_t>(b) * N + n) * h + o];
          if (n == I) fc += delta[bI * h + o];
          rows[static_cast<size_t>(n) * h + o] = fc;
        }
      }
    }
  }
  __syncthreads();
}

// Forward: pooled out[b, I] of one (b, I) a block. `scratch` is null when
// the rows stay in shared memory, else the (B, N*N, h) rows in device
// memory.
__global__ void __launch_bounds__(kThreads) tail_wide_fwd_kernel(
    const float* __restrict__ attn_lhs, const float* __restrict__ attn_mI,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, float* scratch, float* __restrict__ out,
    int N, int H, int h) {
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;
  float* s_mu = s_a + kSlice * kRows;
  float* s_rstd = s_mu + N;
  const int b = blockIdx.x / N, I = blockIdx.x % N;
  const size_t bI = static_cast<size_t>(b) * N + I;
  float* rows = scratch != nullptr ? scratch + bI * N * h : smem + head_floats(N, 2);
  build_fc(rows, s_a, attn_lhs, attn_mI, wa, dws, x_a, delta, bias, b, I, N, H, h);
  row_stats(rows, N, h, s_mu, s_rstd);
  pool_rows(rows, s_mu, s_rstd, N, h, out + bI * h);
}

// Backward, stage 1: the rows of d_fc of one (b, I) a block, and d_delta,
// d_dws[b, :, I] and d_attn_mI[b, :, I, :].
__global__ void __launch_bounds__(kThreads) tail_wide_bwd_rows_kernel(
    const float* __restrict__ attn_lhs, const float* __restrict__ attn_mI,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, const float* __restrict__ dout,
    float* d_fc, float* __restrict__ d_attn_mI, float* __restrict__ d_dws,
    float* __restrict__ d_delta, int N, int H, int h) {
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;
  float* s_mu = s_a + kSlice * kRows;
  float* s_rstd = s_mu + N;
  float* s_m2 = s_rstd + N;
  float* s_m1 = s_m2 + N;
  const int b = blockIdx.x / N, I = blockIdx.x % N;
  const size_t bI = static_cast<size_t>(b) * N + I;
  float* rows = d_fc + bI * N * h;
  build_fc(rows, s_a, attn_lhs, attn_mI, wa, dws, x_a, delta, bias, b, I, N, H, h);
  row_stats(rows, N, h, s_mu, s_rstd);
  layernorm_backward(rows, dout + bI * h, N, h, s_mu, s_rstd, s_m2, s_m1);
  for (int o = threadIdx.x; o < h; o += blockDim.x)
    d_delta[bI * h + o] = rows[static_cast<size_t>(I) * h + o];
  for (int hh = 0; hh < H; ++hh) {
    const size_t row = (static_cast<size_t>(b) * H + hh) * N + I;
    for (int o = threadIdx.x; o < h; o += blockDim.x) {
      float s = 0.f;
      for (int n = 0; n < N; ++n)
        s += attn_mI[row * N + n] * rows[static_cast<size_t>(n) * h + o];
      d_dws[row * h + o] = s;
    }
  }
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  for (int p = warp; p < H * N; p += nwarps) {
    const int hh = p / N, n = p % N;
    const size_t row = (static_cast<size_t>(b) * H + hh) * N + I;
    const float* r = rows + static_cast<size_t>(n) * h;
    const float* v = dws + row * h;
    const float s = warp_row_sum(h, [&](int o) { return r[o] * v[o]; });
    if ((threadIdx.x & 31) == 0) d_attn_mI[row * N + n] = s;
  }
}

// Backward, stage 2's sums: d_xa[b, n] = sum over I of d_fc[b, I*N+n], and
// its sum over n into part[b]; one thread a column, blocks b-major.
__global__ void tail_wide_sums_kernel(const float* __restrict__ d_fc,
                                      float* __restrict__ d_xa,
                                      float* __restrict__ part, int N, int h,
                                      int col_blocks) {
  const int b = blockIdx.x / col_blocks;
  const int o = (blockIdx.x % col_blocks) * blockDim.x + threadIdx.x;
  if (o >= h) return;
  const float* f = d_fc + static_cast<size_t>(b) * N * N * h;
  float bp = 0.f;
  for (int n = 0; n < N; ++n) {
    float s = 0.f;
    for (int I = 0; I < N; ++I) s += f[(static_cast<size_t>(I) * N + n) * h + o];
    d_xa[(static_cast<size_t>(b) * N + n) * h + o] = s;
    bp += s;
  }
  part[static_cast<size_t>(b) * h + o] = bp;
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launches (0 = success), or
// cudaErrorInvalidValue for shapes the route does not take.

// Forward: out (B, N, h). `scratch` null keeps the rows in shared memory
// (invalid if N * h floats do not fit), else the (B, N*N, h) rows.
int tail_wide_forward_launch(const float* attn_lhs, const float* attn_mI,
                             const float* wa, const float* dws,
                             const float* x_a, const float* delta,
                             const float* bias, float* scratch, float* out,
                             int B, int N, int H, int h, void* stream) {
  if (!wide_shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  size_t floats = head_floats(N, 2);
  if (scratch == nullptr) floats += static_cast<size_t>(N) * h;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = allow_smem(tail_wide_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_wide_fwd_kernel<<<B * N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      attn_lhs, attn_mI, wa, dws, x_a, delta, bias, scratch, out, N, H, h);
  return static_cast<int>(cudaGetLastError());
}

// Backward, stage 1: d_fc (B, N*N, h) scratch, d_attn_mI, d_dws, d_delta.
int tail_wide_bwd_rows_launch(const float* attn_lhs, const float* attn_mI,
                              const float* wa, const float* dws,
                              const float* x_a, const float* delta,
                              const float* bias, const float* dout,
                              float* d_fc, float* d_attn_mI, float* d_dws,
                              float* d_delta, int B, int N, int H, int h,
                              void* stream) {
  if (!wide_shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = head_floats(N, 3) * sizeof(float);
  cudaError_t err = allow_smem(tail_wide_bwd_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_wide_bwd_rows_kernel<<<B * N, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      attn_lhs, attn_mI, wa, dws, x_a, delta, bias, dout, d_fc, d_attn_mI, d_dws,
      d_delta, N, H, h);
  return static_cast<int>(cudaGetLastError());
}

// Backward, stage 2: d_wa = attn_lhs^T d_fc, d_xa, and d_bias through the
// (B, h) scratch part.
int tail_wide_bwd_wa_launch(const float* attn_lhs, const float* d_fc,
                            float* d_wa, float* d_xa, float* d_bias,
                            float* part, int B, int N, int H, int h,
                            void* stream) {
  if (!wide_shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long NN = static_cast<long long>(N) * N, HM = static_cast<long long>(H) * N;
  // A(m, r) = attn_lhs[b, r, m]; B(r, o) = d_fc[b, r, o]; d_wa[b, m, o]
  cudaError_t err = gemm(Operand{attn_lhs, NN * HM, 1, HM}, Operand{d_fc, NN * h, h, 1},
                         B, static_cast<int>(HM), h, static_cast<int>(NN),
                         Store{d_wa, HM * h, h, 1}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_blocks = (h + kThreads - 1) / kThreads;
  if (static_cast<long long>(B) * col_blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  tail_wide_sums_kernel<<<B * col_blocks, kThreads, 0, s>>>(d_fc, d_xa, part, N, h,
                                                            col_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_over_groups(part, d_bias, B, h, s));
}

// Backward, stage 3: d_attn_lhs = d_fc wa^T.
int tail_wide_bwd_attn_launch(const float* d_fc, const float* wa,
                              float* d_attn_lhs, int B, int N, int H, int h,
                              void* stream) {
  if (!wide_shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const long long NN = static_cast<long long>(N) * N, HM = static_cast<long long>(H) * N;
  // A(r, o) = d_fc[b, r, o]; B(o, m) = wa[b, m, o]; d_attn_lhs[b, r, m]
  return static_cast<int>(gemm(Operand{d_fc, NN * h, h, 1}, Operand{wa, HM * h, 1, h},
                               B, static_cast<int>(NN), static_cast<int>(HM), h,
                               Store{d_attn_lhs, NN * HM, HM, 1},
                               static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
