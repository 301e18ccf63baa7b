// Device code shared by the wide routes of the critic kernels
// (tail_wide.cu: K3f and K3b; cf_attention_wide.cu: K5f and K5b), for
// Hopper (sm_90a).
//
// The wide route takes every shape the JAX functions take: any B, N, H and
// h >= 1, with 4-byte loads, so neither h nor H * N needs to be a multiple
// of 4. A rows block owns the N rows of h columns of each of its
// counterfactuals (group b, I); every sum over a row runs over column
// tiles of at most kTile floats, the tiles' sums added in order (the plain
// version of that arithmetic is baseline_tail.layernorm_tiled). LayerNorm
// statistics take two passes, the mean and then the mean of squared
// deviations, as the JAX package's _ln_stats does. Every sum has a fixed
// order and there are no atomics, so two calls give the same bits.
//
// A batched product, each operand read through its own strides, so that
// one kernel takes A, its transpose, B and its transpose; what the product
// does with its outputs is an epilogue: tc_gemm_kernel (tail_wide.cu) runs
// on the tensor cores in 3xTF32 (tc_common.cuh): a 256 x 8 NB tile of
// outputs (NB = 5 or 10) a block of four warpgroups, through tc_mainloop,
// which tail_wide.cu's row kernels share.
// Sums over many groups (d_bias over B) are compensated (Neumaier).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "tc_common.cuh"

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
// become d_fc = rstd * ((d_y - mean(d_y)) - y * mean(d_y * y)), with d_y
// = dy(o) on every row (the pool's backward: dout / N). s_m2 holds N
// floats and s_m1 one. The whole block calls it; it ends with a barrier.
template <class Dy>
__device__ void layernorm_backward_with(float* rows, Dy dy, int N, int h,
                                        const float* s_mu, const float* s_rstd,
                                        float* s_m2, float* s_m1) {
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const float cols = static_cast<float>(h);
  if (warp == 0) {
    const float m1 = warp_row_sum(h, [&](int o) { return dy(o); }) / cols;
    if (threadIdx.x == 0) s_m1[0] = m1;
  }
  for (int n = warp; n < N; n += nwarps) {
    const float* r = rows + static_cast<size_t>(n) * h;
    const float mu = s_mu[n], rstd = s_rstd[n];
    const float m2 = warp_row_sum(h, [&](int o) {
                       return dy(o) * ((r[o] - mu) * rstd);
                     }) / cols;
    if ((threadIdx.x & 31) == 0) s_m2[n] = m2;
  }
  __syncthreads();
  const float m1 = s_m1[0];
  for (int o = threadIdx.x; o < h; o += blockDim.x) {
    const float d = dy(o);
    for (int n = 0; n < N; ++n) {
      float* x = rows + static_cast<size_t>(n) * h + o;
      const float y = (*x - s_mu[n]) * s_rstd[n];
      *x = s_rstd[n] * ((d - m1) - y * s_m2[n]);
    }
  }
  __syncthreads();
}

// ── Operands and epilogues of the batched product ──────────────────────────

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

// ── The batched product on the tensor cores (3xTF32) ───────────────────────
//
// tc_mainloop computes, for a block of four warpgroups, one tile of
// acc(i, n) = sum_k A(i, k) B(k, n): 256 values i (M; one m64 block a
// warpgroup) by 8 NB values n (wgmma's N), K in chunks of 8 (one wgmma k8
// step) through a ring of S stages. A stage holds the chunk's 8 rows k of A
// as [k][i] (stride 256 + 8 floats: 8 mod 32, so a warp's fragment loads
// fall in 32 banks), read into registers and split there by the warpgroup
// that owns those i, then B's chunk in the core-matrix layout, split once
// into a high and a low copy that wgmma reads through descriptors. Between
// chunk c's products on the tensor cores, the block splits chunk c + 1's B
// and loads chunk c + S - 1, with one barrier a chunk (tail_forward.cu's
// pipeline). Ragged edges (i past M, n past N, k past K) are zeros in
// shared memory. No sum crosses a block and there are no atomics: two
// calls give the same bits.

constexpr int kTcChunk = 8;      // K of a stage: one wgmma k8 step
constexpr int kTcThreads = 512;  // a block: four warpgroups,
constexpr int kTcCols = 256;     // one m64 block of values i each
constexpr int kTcAStride = kTcCols + 8;

// Floats of one ring stage: the A rows, then B's high and low copies.
__host__ __device__ constexpr int tc_stage_floats(int NB) {
  return kTcChunk * kTcAStride + 2 * 64 * NB;
}

// The first of this thread's values i in a tile, relative to the tile's
// first: its acc[4 j + q] is (i = tc_row0() + 8 (q / 2),
// n = 8 j + 2 (lane % 4) + q % 2).
__device__ inline int tc_row0() {
  return threadIdx.x / 32 * 16 + threadIdx.x % 32 / 4;
}

// A's chunk: rows k < 8 of A(i, k) for i0 <= i < i0 + 256, into
// sa[k * kTcAStride + i - i0], where row(k) points at A(0, k) with i
// contiguous (nullptr for a row past K); zeros past M. `vec`: 16-byte
// copies (every row pointer 16-byte aligned), else 4-byte ones. `any` is
// a readable address for the copies that read nothing.
template <class RowPtr>
__device__ void load_a_rows(float* sa, RowPtr row, int i0, int M, bool vec, const float* any) {
  constexpr int as = kTcAStride, cols = kTcCols;
  if (vec) {
    for (int q = threadIdx.x; q < kTcChunk * cols / 4; q += blockDim.x) {
      const int k = q / (cols / 4), i = 4 * (q % (cols / 4));
      const float* p = row(k);
      const int bytes = p == nullptr ? 0 : 4 * max(0, min(4, M - i0 - i));
      tc::cp_async16(sa + k * as + i, bytes > 0 ? p + i0 + i : any, bytes);
    }
  } else {
    for (int q = threadIdx.x; q < kTcChunk * cols; q += blockDim.x) {
      const int k = q / cols, i = q % cols;
      const float* p = row(k);
      if (p != nullptr && i0 + i < M) tc::cp_async4(sa + k * as + i, p + i0 + i);
      else sa[k * as + i] = 0.f;
    }
  }
}

// A's chunk for A(i, k) = a[i * rs + k] (k contiguous), k0 <= k < k0 + 8,
// as load_a_rows lays it out; 4-byte copies, consecutive threads on
// consecutive k.
__device__ void load_a_cols(float* sa, const float* a, long long rs, int i0, int M, int k0,
                            int K) {
  constexpr int as = kTcAStride, cols = kTcCols;
  for (int q = threadIdx.x; q < kTcChunk * cols; q += blockDim.x) {
    const int k = q % kTcChunk, i = q / kTcChunk;
    if (i0 + i < M && k0 + k < K) tc::cp_async4(sa + k * as + i, a + (i0 + i) * rs + k0 + k);
    else sa[k * as + i] = 0.f;
  }
}

// B's chunk in the core-matrix layout (high copy): B(k, n) = row(n)[k]
// (k contiguous; nullptr for an n past N) for k0 <= k < k0 + 8 and
// n < 8 NB; zeros past K. `vec`: 16-byte copies (every row pointer 16-byte
// aligned), else 4-byte ones.
template <int NB, class RowPtr>
__device__ void load_b_rows(float* sb, RowPtr row, int k0, int K, bool vec, const float* any) {
  if (vec) {
    for (int q = threadIdx.x; q < 16 * NB; q += blockDim.x) {
      const int n = q / 2, k = 4 * (q % 2);
      const float* p = row(n);
      const int bytes = p == nullptr ? 0 : 4 * max(0, min(4, K - k0 - k));
      tc::cp_async16(sb + tc::b_offset<NB>(n, k), bytes > 0 ? p + k0 + k : any, bytes);
    }
  } else {
    for (int q = threadIdx.x; q < 64 * NB; q += blockDim.x) {
      const int n = q / kTcChunk, k = q % kTcChunk;
      const float* p = row(n);
      if (p != nullptr && k0 + k < K) tc::cp_async4(sb + tc::b_offset<NB>(n, k), p + k0 + k);
      else sb[tc::b_offset<NB>(n, k)] = 0.f;
    }
  }
}

// B's chunk for B(k, n) = b[k * rs + n0 + n] (n contiguous), n0 + n < Nc,
// k0 + k < K, transposed into the core-matrix layout by 4-byte copies,
// consecutive threads on consecutive n.
template <int NB>
__device__ void load_b_cols(float* sb, const float* b, long long rs, int n0, int Nc, int k0,
                            int K) {
  for (int q = threadIdx.x; q < 64 * NB; q += blockDim.x) {
    const int k = q / (8 * NB), n = q % (8 * NB);
    if (n0 + n < Nc && k0 + k < K)
      tc::cp_async4(sb + tc::b_offset<NB>(n, k), b + (k0 + k) * rs + n0 + n);
    else sb[tc::b_offset<NB>(n, k)] = 0.f;
  }
}

// The identity on B's staged values (tc_mainloop's `fix` for plain operands).
struct AsLoaded {
  __device__ float operator()(int, int, float x) const { return x; }
};

// The tensor cores' float32 accumulator does not round each sum to
// nearest: over hundreds of wgmma steps (K = 1024 takes 384 in 3xTF32) its
// error grows past phase 2h's 1e-5 of the largest output. So every
// kTcFlush chunks the accumulator is added to a float32 total on the CUDA
// cores (rounded to nearest) and restarts from zero.
constexpr int kTcFlush = 4;

// total = this thread's fragment of the block's tile over `chunks` chunks.
// load(c, stage) issues this thread's copies of chunk c into the stage (A's
// rows, and B's raw values into its high copy); fix(c, q, x) gives B's value
// at core-matrix offset q of chunk c from the staged x (a caller builds
// columns there that it does not load). The whole block calls it; it ends
// with a barrier and no copy in flight, and the ring is free again.
template <int NB, int S, class Load, class Fix>
__device__ void tc_mainloop(float (&total)[4 * NB], float* ring, int chunks, Load load,
                            Fix fix) {
  static_assert(S >= 3, "the ring splits chunk c + 1 while chunk c is multiplied");
  constexpr int as = kTcAStride, sf = tc_stage_floats(NB), bf = 64 * NB;
  float acc[4 * NB];
#pragma unroll
  for (int x = 0; x < 4 * NB; ++x) acc[x] = total[x] = 0.f;
  if (chunks <= 0) return;
  const int t = threadIdx.x % 4, row0 = tc_row0();
  auto issue = [&](int c) {
    if (c < chunks) load(c, ring + (c % S) * sf);
    tc::cp_async_commit();
  };
  auto split_b = [&](int c) {
    float* b_hi = ring + (c % S) * sf + kTcChunk * as;
    for (int q = threadIdx.x; q < bf; q += blockDim.x) {
      uint32_t hi, lo;
      tc::split_tf32(fix(c, q, b_hi[q]), hi, lo);
      b_hi[q] = __uint_as_float(hi);
      b_hi[bf + q] = __uint_as_float(lo);
    }
    tc::fence_async_shared();
  };
  for (int c = 0; c < S - 1; ++c) issue(c);
  tc::cp_async_wait<S - 3>();  // chunks 0 and 1
  __syncthreads();
  split_b(0);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const float* sa = ring + (c % S) * sf;
    const float* b_hi = sa + kTcChunk * as;
    uint32_t ah[4], al[4];
    const float* w = sa + t * as + row0;
    tc::split_tf32(w[0], ah[0], al[0]);
    tc::split_tf32(w[8], ah[1], al[1]);
    tc::split_tf32(w[4 * as], ah[2], al[2]);
    tc::split_tf32(w[4 * as + 8], ah[3], al[3]);
    tc::wgmma_fence();
    const uint64_t d_hi = tc::smem_desc<NB>(b_hi), d_lo = tc::smem_desc<NB>(b_hi + bf);
    // the small terms first: lo * hi, hi * lo, then hi * hi; the block's
    // other work for the next chunks goes between the products
    tc::wgmma_tf32(acc, al, d_hi);
    if (c + 1 < chunks) split_b(c + 1);
    tc::wgmma_tf32(acc, ah, d_lo);
    issue(c + S - 1);
    tc::wgmma_tf32(acc, ah, d_hi);
    tc::wgmma_commit();
    tc::cp_async_wait<S - 3>();  // chunk c + 2
    tc::wgmma_wait_all();
    if (c % kTcFlush == kTcFlush - 1 || c == chunks - 1) {
#pragma unroll
      for (int x = 0; x < 4 * NB; ++x) {
        total[x] += acc[x];
        acc[x] = 0.f;
      }
    }
    __syncthreads();
  }
  tc::cp_async_wait<0>();
}

constexpr int kTcStages = 5;

// out(z, i, j) = sum_k A(z, i, k) B(z, k, j) for i < M, j < Nc, in 3xTF32
// on the tensor cores, handed to the epilogue. A has i or k contiguous
// (A.rs == 1 or A.cs == 1), B k or j contiguous (B.rs == 1 or B.cs == 1).
// Blocks run z-major over tiles_m x tiles_n tiles of 256 x 8 NB outputs.
// a_vec, b_vec: the contiguous rows of A (i) or B (k) take 16-byte copies.
template <int NB, class Epilogue>
__global__ void __launch_bounds__(kTcThreads, 1) tc_gemm_kernel(
    Operand A, Operand B, int M, int Nc, int K, int tiles_m, int tiles_n, bool a_vec,
    bool b_vec, Epilogue epi) {
  extern __shared__ __align__(128) float smem[];
  const int tiles = tiles_m * tiles_n;
  const long long z = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int i0 = tile / tiles_n * kTcCols, n0 = tile % tiles_n * 8 * NB;
  const float* a = A.p + z * A.zs;
  const float* b = B.p + z * B.zs;
  auto load = [&](int c, float* stage) {
    const int k0 = c * kTcChunk;
    if (A.rs == 1)
      load_a_rows(
          stage, [&](int k) { return k0 + k < K ? a + (k0 + k) * A.cs : nullptr; }, i0, M,
          a_vec, a);
    else
      load_a_cols(stage, a, A.rs, i0, M, k0, K);
    float* sb = stage + kTcChunk * kTcAStride;
    if (B.rs == 1)
      load_b_rows<NB>(
          sb, [&](int n) { return n0 + n < Nc ? b + (n0 + n) * B.cs : nullptr; }, k0, K,
          b_vec, b);
    else
      load_b_cols<NB>(sb, b, B.rs, n0, Nc, k0, K);
  };
  float acc[4 * NB];
  tc_mainloop<NB, kTcStages>(acc, smem, (K + kTcChunk - 1) / kTcChunk, load, AsLoaded{});
  const int t = threadIdx.x % 4, row0 = tc_row0();
#pragma unroll
  for (int x = 0; x < 4 * NB; ++x) {
    const int i = i0 + row0 + 8 * (x % 4 / 2);
    const int n = n0 + 8 * (x / 4) + 2 * t + x % 2;
    if (i < M && n < Nc) epi(z, i, n, acc[x]);
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int NB, class Epilogue>
cudaError_t tc_gemm_nb(Operand A, Operand B, long long batch, int M, int Nc, int K,
                       Epilogue epi, cudaStream_t stream) {
  const int tiles_m = (M + kTcCols - 1) / kTcCols;
  const int tiles_n = (Nc + 8 * NB - 1) / (8 * NB);
  const long long blocks = batch * tiles_m * tiles_n;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kTcStages * tc_stage_floats(NB);
  cudaError_t err = allow_smem(tc_gemm_kernel<NB, Epilogue>, smem);
  if (err != cudaSuccess) return err;
  const bool a_vec = A.rs == 1 && A.cs % 4 == 0 && A.zs % 4 == 0 && aligned16(A.p);
  const bool b_vec = B.rs == 1 && B.cs % 4 == 0 && B.zs % 4 == 0 && aligned16(B.p);
  tc_gemm_kernel<NB, Epilogue><<<static_cast<unsigned>(blocks), kTcThreads, smem, stream>>>(
      A, B, M, Nc, K, tiles_m, tiles_n, a_vec, b_vec, epi);
  return cudaGetLastError();
}

// Launches tc_gemm_kernel over `batch` products of M x Nc outputs, depth K:
// 40 columns j a tile where Nc <= 40, else 80.
template <class Epilogue>
cudaError_t tc_gemm(Operand A, Operand B, long long batch, int M, int Nc, int K,
                    Epilogue epi, cudaStream_t stream) {
  if ((A.rs != 1 && A.cs != 1) || (B.rs != 1 && B.cs != 1) || M <= 0 || Nc <= 0 || K <= 0)
    return cudaErrorInvalidValue;
  return Nc <= 40 ? tc_gemm_nb<5>(A, B, batch, M, Nc, K, epi, stream)
                  : tc_gemm_nb<10>(A, B, batch, M, Nc, K, epi, stream);
}

}  // namespace wide
