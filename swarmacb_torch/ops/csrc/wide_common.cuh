// Device code shared by the wide routes of the critic kernels
// (tail_wide.cu: K3f and K3b; cf_attention_wide.cu: K5f and K5b), for
// Hopper (sm_90a).
//
// The wide route takes every shape the JAX functions take: any B, N, H and
// h >= 1, with 4-byte loads, so neither h nor H * N needs to be a multiple
// of 4. A rows block owns one (group b, counterfactual I) and its N rows of
// h columns; every sum over a row runs over column tiles of at most kTile
// floats, the tiles' sums added in order (the plain version of that
// arithmetic is baseline_tail.layernorm_tiled). LayerNorm statistics take
// two passes, the mean and then the mean of squared deviations, as the JAX
// package's _ln_stats does. Every sum has a fixed order and there are no
// atomics, so two calls give the same bits.
//
// The batched products (gemm_kernel) run on the CUDA cores in float32: a
// 64 x 64 tile of outputs a block of 256 threads, 4 x 4 a thread, K-slices
// of 16 staged in shared memory through 4-byte loads, each operand read
// through its own strides, so one kernel takes A, its transpose, B and its
// transpose. Each K-slice is summed on its own and then added to the
// total, so a long sum (K = h = 1024) rounds as a blocked one, not as one
// running sum. What each product does with its outputs is an epilogue.
// Sums over many groups (d_bias over B) are compensated (Neumaier).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace wide {

constexpr int kTile = 512;        // columns of a tile: the sums' unit
constexpr int kThreads = 256;     // threads of a rows block
constexpr int kCpt = kTile / kThreads;  // columns a thread takes in a tile
constexpr int kRows = 8;          // rows a thread accumulates at a time
constexpr float kLnEps = 1e-5f;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The sum of f(o) over the columns o < h, tile by tile: in a tile each lane
// sums its columns lane, lane + 32, ..., then the warp; the tiles' sums are
// added in order. The whole warp calls it, and every lane gets the total.
template <class F>
__device__ inline float warp_row_sum(int h, F f) {
  const int lane = threadIdx.x & 31;
  float total = 0.f;
  for (int c0 = 0; c0 < h; c0 += kTile) {
    const int c1 = min(c0 + kTile, h);
    float part = 0.f;
    for (int o = c0 + lane; o < c1; o += 32) part += f(o);
    total += warp_sum(part);
  }
  return total;
}

// LayerNorm statistics of rows[n * h .. n * h + h) for n < N, one warp a
// row: mu[n], then rstd[n] from the mean of squared deviations. The whole
// block calls it; it ends with a barrier.
__device__ void row_stats(const float* rows, int N, int h, float* s_mu,
                          float* s_rstd) {
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const float cols = static_cast<float>(h);
  for (int n = warp; n < N; n += nwarps) {
    const float* r = rows + static_cast<size_t>(n) * h;
    const float mu = warp_row_sum(h, [&](int o) { return r[o]; }) / cols;
    const float var = warp_row_sum(h, [&](int o) {
                        const float x = r[o] - mu;
                        return x * x;
                      }) / cols;
    if ((threadIdx.x & 31) == 0) {
      s_mu[n] = mu;
      s_rstd[n] = 1.0f / sqrtf(var + kLnEps);
    }
  }
  __syncthreads();
}

// out[o] = mean over n of (rows[n][o] - mu[n]) * rstd[n], for o < h.
__device__ void pool_rows(const float* rows, const float* s_mu,
                          const float* s_rstd, int N, int h, float* out) {
  for (int o = threadIdx.x; o < h; o += blockDim.x) {
    float s = 0.f;
    for (int n = 0; n < N; ++n)
      s += (rows[static_cast<size_t>(n) * h + o] - s_mu[n]) * s_rstd[n];
    out[o] = s / static_cast<float>(N);
  }
}

// The LayerNorm backward of the block's N rows, in place: rows hold fc and
// become d_fc = rstd * ((d_y - mean(d_y)) - y * mean(d_y * y)), with
// d_y = dout / N on every row (the pool's backward). s_m2 holds N floats
// and s_m1 one. The whole block calls it; it ends with a barrier.
__device__ void layernorm_backward(float* rows, const float* dout, int N,
                                   int h, const float* s_mu,
                                   const float* s_rstd, float* s_m2,
                                   float* s_m1) {
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const float cols = static_cast<float>(h), rows_n = static_cast<float>(N);
  if (warp == 0) {
    const float m1 = warp_row_sum(h, [&](int o) { return dout[o] / rows_n; }) / cols;
    if (threadIdx.x == 0) s_m1[0] = m1;
  }
  for (int n = warp; n < N; n += nwarps) {
    const float* r = rows + static_cast<size_t>(n) * h;
    const float mu = s_mu[n], rstd = s_rstd[n];
    const float m2 = warp_row_sum(h, [&](int o) {
                       return (dout[o] / rows_n) * ((r[o] - mu) * rstd);
                     }) / cols;
    if ((threadIdx.x & 31) == 0) s_m2[n] = m2;
  }
  __syncthreads();
  const float m1 = s_m1[0];
  for (int o = threadIdx.x; o < h; o += blockDim.x) {
    const float dy = dout[o] / rows_n;
    for (int n = 0; n < N; ++n) {
      float* x = rows + static_cast<size_t>(n) * h + o;
      const float y = (*x - s_mu[n]) * s_rstd[n];
      *x = s_rstd[n] * ((dy - m1) - y * s_m2[n]);
    }
  }
  __syncthreads();
}

// ── The batched product ────────────────────────────────────────────────────

// An operand of a batched product: element (z, row, col) at
// p[z * zs + row * rs + col * cs].
struct Operand {
  const float* p;
  long long zs, rs, cs;
};

// Epilogues: what the product does with output (z, i, j).
struct Store {  // C = A B
  float* p;
  long long zs, rs, cs;
  __device__ void operator()(long long z, int i, int j, float v) const {
    p[z * zs + i * rs + j * cs] = v;
  }
};

struct Accumulate {  // C = C + A B
  float* p;
  long long zs, rs, cs;
  __device__ void operator()(long long z, int i, int j, float v) const {
    float* c = p + z * zs + i * rs + j * cs;
    *c = *c + v;
  }
};

constexpr int kGemmTile = 64;     // rows and columns of outputs a block
constexpr int kGemmK = 16;        // depth of a staged K-slice
constexpr int kGemmThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kGemmStride = kGemmTile + 4;  // staged row: whole float4s

// out(z, i, j) = sum_k A(z, i, k) B(z, k, j) for i < M, j < Nc, summed in
// order of k, then handed to the epilogue. Blocks run z-major over the
// tiles_m x tiles_n tiles of each z. A staged K-slice is loaded with
// consecutive threads on consecutive addresses of whichever index of the
// operand is contiguous.
template <class Epilogue>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(
    Operand A, Operand B, int M, int Nc, int K, int tiles_m, int tiles_n,
    Epilogue epi) {
  __shared__ __align__(16) float s_a[kGemmK][kGemmStride];
  __shared__ __align__(16) float s_b[kGemmK][kGemmStride];
  const int tiles = tiles_m * tiles_n;
  const long long z = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int i0 = (t / tiles_n) * kGemmTile, j0 = (t % tiles_n) * kGemmTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* a = A.p + z * A.zs;
  const float* b = B.p + z * B.zs;
  const bool a_down = A.rs == 1;  // A's rows contiguous: threads go down them
  const bool b_across = B.cs == 1;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kGemmK) {
    float part[4][4] = {};
    for (int q = tid; q < kGemmTile * kGemmK; q += kGemmThreads) {
      int i = a_down ? q % kGemmTile : q / kGemmK;
      int k = a_down ? q / kGemmTile : q % kGemmK;
      s_a[k][i] = (i0 + i < M && k0 + k < K)
                      ? a[(i0 + i) * A.rs + (k0 + k) * A.cs] : 0.f;
      const int j = b_across ? q % kGemmTile : q / kGemmK;
      k = b_across ? q / kGemmTile : q % kGemmK;
      s_b[k][j] = (j0 + j < Nc && k0 + k < K)
                      ? b[(k0 + k) * B.rs + (j0 + j) * B.cs] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kGemmK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&s_a[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&s_b[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] += ar[i] * br[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gi = i0 + ty * 4 + i, gj = j0 + tx * 4 + j;
      if (gi < M && gj < Nc) epi(z, gi, gj, acc[i][j]);
    }
}

// Launches gemm_kernel over `batch` products of M x Nc outputs, depth K.
template <class Epilogue>
cudaError_t gemm(Operand A, Operand B, long long batch, int M, int Nc, int K,
                 Epilogue epi, cudaStream_t stream) {
  const int tiles_m = (M + kGemmTile - 1) / kGemmTile;
  const int tiles_n = (Nc + kGemmTile - 1) / kGemmTile;
  const long long blocks = batch * tiles_m * tiles_n;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  gemm_kernel<<<static_cast<unsigned>(blocks), kGemmThreads, 0, stream>>>(
      A, B, M, Nc, K, tiles_m, tiles_n, epi);
  return cudaGetLastError();
}

// A compensated sum (Neumaier): the running sum and the rounding it lost.
struct CompensatedSum {
  float s = 0.f, c = 0.f;
  __device__ void add(float x) {
    const float t = s + x;
    c += fabsf(s) >= fabsf(x) ? (s - t) + x : (x - t) + s;
    s = t;
  }
  __device__ float total() const { return s + c; }
};

// out[o] = sum over b of part[b * h + o], in order of b, compensated.
__global__ void sum_over_groups_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int B, int h) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= h) return;
  CompensatedSum sum;
  for (int b = 0; b < B; ++b) sum.add(part[static_cast<size_t>(b) * h + o]);
  out[o] = sum.total();
}

inline cudaError_t sum_over_groups(const float* part, float* out, int B, int h,
                                   cudaStream_t stream) {
  sum_over_groups_kernel<<<(h + 127) / 128, 128, 0, stream>>>(part, out, B, h);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Shapes the wide route takes: every extent at least 1, and grids and
// offsets that fit their types.
inline bool wide_shape_ok(int B, int N, int H, int h) {
  return B > 0 && N > 0 && H > 0 && h > 0 &&
         static_cast<long long>(B) * N <= INT_MAX &&
         static_cast<long long>(N) * N * h <= INT_MAX &&
         static_cast<long long>(H) * N * N <= INT_MAX;
}

}  // namespace wide
