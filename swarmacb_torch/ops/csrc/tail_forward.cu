// Forward (K3f) of the counterfactual-baseline tail of
// POCACritic.all_baselines, for Hopper (sm_90a).
//
// Replaces (TPU kernel): swarmacb_tpu/ops/baseline_tail.py: _fused_tail_fwd,
// its Pallas body _fwd_kernel (with _fc_rows).
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
// fc is never written to device memory, as in the TPU kernel.
//
// What bounds it on the H100: the product attn_lhs x wa (K = H*N = 80 at the
// main path's B = 1024, N = 20, H = 4, h = 512) is 33.6 of the call's 37.3
// GFLOP. On the CUDA cores in float32 (67 TFLOP/s) that alone is 0.50 ms,
// well above the 0.18 ms that the ~600 MB of inputs and outputs take at
// 3.35 TB/s. This kernel takes the products on the tensor cores in 3xTF32:
// each operand x is split into hi = tf32(x) and lo = tf32(x - hi), and a
// product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the small terms first),
// which keeps float32-level error (|x - hi - lo| <= 2^-22 |x|; the dropped
// a_lo*b_lo is below 2^-22 of the product). Three TF32 products at
// 495 TFLOP/s take 0.20 ms: the bound comes to within 15 % of the bytes'.
// It uses wgmma (warpgroup MMA): on the H100, mma.sync reaches only about
// half of the TF32 rate (scripts/probe_tf32_rates.py).
//
// Design: one block per (b, P counterfactuals), P = min(N, 80 / N), so that
// a block holds at most 80 whole fc rows (P*N rows: 4 x 20 at N = 20) and
// all h columns: LayerNorm and the pool need no other block, and wa[b]
// passes through shared memory once per block, 5 times per group at
// N = 20 (blocks are b-major, so those 5 run together and share wa[b] in
// L2). The block computes fc transposed, fc^T (h x 80) = wa^T * attn^T,
// with one warpgroup per 128 columns o (4 at h = 512), each holding its
// 128 x 80 tile in registers as two m64n80 wgmma accumulators (80 floats a
// thread). The A operand, wa^T, is loaded from shared memory into
// registers and split there, by the one warpgroup that owns those
// columns. The B operand, the attention rows, is K-major in memory, as
// wgmma wants TF32 operands: it is staged in the no-swizzle core-matrix
// layout (8 rows x 16 bytes), split once per block into a high and a low
// copy, and read by wgmma through shared-memory descriptors. K runs in
// chunks of 8 (one wgmma k-step) through a ring of 5 stages filled by
// cp.async; between chunk i's products on the tensor cores, the block
// splits chunk i + 1's B and loads chunk i + 4, with one barrier a chunk. The rank-1
// term extends K: after the H*N columns of the attention come H*P columns
// q = hd*P + p, whose A rows are dws[b, hd, I0 + p] and whose B column
// holds attn_mI[b, hd, I0 + p, n] in the N rows of counterfactual p and
// zeros elsewhere (built in shared memory from attn_mI). Ragged edges (rows
// past P*N, k past the end, columns past h) are zeros in shared memory.
// The epilogue runs in float32 on the CUDA cores from the accumulators:
// bias, x_a and the diagonal delta (staged in shared memory by cp.async
// behind the first chunks),
// then the row statistics (shuffles across the 8 lanes that hold a row's
// columns in a warp, then one pass over the warps in shared memory, each a
// fixed order), then y, and the mean over the N rows of each
// counterfactual (a sum over the rows each thread holds, then shuffles
// across the 4 lanes that hold the others). Every sum has a fixed order
// and there are no atomics: two calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"  // cp.async, the TF32 split, wgmma: shared with tail_wide.cu

namespace {

using namespace tc;

constexpr int kRows = 80;                  // fc rows per block: wgmma N
constexpr int kNBlocks = kRows / 8;        // n8 blocks of the accumulator
constexpr int kGroupCols = 128;            // columns per warpgroup
constexpr int kMBlocks = kGroupCols / 64;  // m64 accumulators per warpgroup
constexpr int kMaxH = 512;                 // hidden width the kernel takes
constexpr int kThreads = kMaxH / kGroupCols * 128;
constexpr int kMaxWarps = kThreads / 32;
constexpr int kChunk = 8;                  // K per stage: one k8 step
constexpr int kStages = 5;                 // ring of K-chunks
constexpr int kBFloats = kRows * kChunk;   // one copy of a stage's B operand
constexpr int kMaxN = 32;
constexpr float kLnEps = 1e-5f;
constexpr int kMaxSmem = 232448;           // bytes a block may use

__host__ __device__ inline int cols_pad(int h) {
  return (h + kGroupCols - 1) / kGroupCols * kGroupCols;
}
// Row strides, in floats, of wa's rows in a stage (8 mod 32: the A
// fragment loads of a warp fall in 32 banks) and of the residual rows
// (4 mod 32, for the epilogue's loads).
__host__ __device__ inline int wa_stride(int h) { return cols_pad(h) + 8; }
__host__ __device__ inline int res_stride(int h) { return cols_pad(h) + 4; }
// Floats of one ring stage: kChunk rows of wa (or dws), then the B operand's
// high and low copies.
__host__ __device__ inline int stage_floats(int h) {
  return kChunk * wa_stride(h) + 2 * kBFloats;
}
// Bytes of shared memory of a block: the ring; the residual region (x_a's
// N rows, delta's P rows, bias, attn_mI's H rows of the block's fc rows);
// the row sums; the row table.
inline size_t smem_bytes(int N, int H, int h) {
  const int per_block = N < kRows / N ? N : kRows / N;
  const size_t floats = static_cast<size_t>(kStages) * stage_floats(h) +
                        static_cast<size_t>(N + per_block + 1) * res_stride(h) +
                        static_cast<size_t>(H) * kRows +
                        static_cast<size_t>(kMaxWarps + 1) * kRows + kRows;
  return floats * sizeof(float);
}

// Sums each thread's per-row partials over the block's h columns, part[j][e]
// being this thread's partial of row 8 j + 2 t + e, and returns in part
// the mean of each of the same rows (sum / h), or with rstd set
// 1 / sqrt(sum / h + eps). Two barriers; every thread calls it.
__device__ void row_stat(float (&part)[kNBlocks][2], float* s_red,
                         float* s_tot, int h, bool rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
#pragma unroll
  for (int j = 0; j < kNBlocks; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = part[j][e];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (lane < 4) s_red[warp * kRows + 8 * j + 2 * lane + e] = x;
    }
  __syncthreads();
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    float x = 0.f;
    for (int w = 0; w < nwarps; ++w) x += s_red[w * kRows + r];
    x /= static_cast<float>(h);
    s_tot[r] = rstd ? 1.0f / sqrtf(x + kLnEps) : x;
  }
  __syncthreads();
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < kNBlocks; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) part[j][e] = s_tot[8 * j + 2 * t + e];
}

__global__ void __launch_bounds__(kThreads, 1) tail_forward_kernel(
    const float* __restrict__ attn_lhs, const float* __restrict__ attn_mI,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ out, int N, int H,
    int h, int per_block) {
  extern __shared__ __align__(128) float smem[];
  const int HM = H * N;
  const int blocks_per_group = (N + per_block - 1) / per_block;
  const int b = blockIdx.x / blocks_per_group;
  const int I0 = (blockIdx.x % blocks_per_group) * per_block;
  const int nI = min(per_block, N - I0);
  const int rows = nI * N;                 // the block's fc rows, <= 80
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's columns: col0 + 64 mb + 8 hi for mb, hi in {0, 1}
  const int col0 = threadIdx.x / 128 * kGroupCols + warp % 4 * 16 + g;
  const int hp = cols_pad(h), ws = wa_stride(h), xs = res_stride(h);
  const int sf = stage_floats(h);
  // K-chunks of the product, then of the rank-1 columns q = hd * nI + p
  const int wa_chunks = (HM + kChunk - 1) / kChunk;
  const int chunks = wa_chunks + (H * nI + kChunk - 1) / kChunk;
  // row r of the block is attn_lhs[b, I0*N + r]
  const float* a_src = attn_lhs + (static_cast<size_t>(b) * N + I0) * N * HM;
  const float* w_src = wa + static_cast<size_t>(b) * HM * h;
  // after the ring: x_a[b] (N rows), delta[b, I0 + p] (nI rows), bias, all
  // xs apart; attn_mI[b, hd, I0*N + r] as [hd][kRows]; the row sums
  // [warp][kRows] and totals; then p * 64 + n of each row r (-1 past rows)
  float* s_xa = smem + kStages * sf;
  float* s_dl = s_xa + N * xs;
  float* s_bias = s_dl + per_block * xs;
  float* s_am = s_bias + xs;
  float* s_red = s_am + H * kRows;
  float* s_tot = s_red + kMaxWarps * kRows;
  int* s_row = reinterpret_cast<int*>(s_tot + kRows);

  for (int r = threadIdx.x; r < kRows; r += blockDim.x)
    s_row[r] = r < rows ? r / N * 64 + r % N : -1;

  // Copies of 16 bytes: the block has hp threads, hp / 4 to a row of h, so
  // each thread takes column ld_o of rows ld_k, ld_k + 4, ...
  const int ld_o = threadIdx.x % (hp / 4) * 4, ld_k = threadIdx.x / (hp / 4);
  const bool ld_col = ld_o < h;

  // Chunk c into its ring stage (one commit group, empty past the end): the
  // A rows (wa, or dws for the rank-1 columns) and, for the product, the
  // raw attention columns into the high copy of B.
  auto load_chunk = [&](int c) {
    float* sa = smem + (c % kStages) * sf;
    float* sb = sa + kChunk * ws;
    if (c < wa_chunks) {
      const int k0 = c * kChunk;
#pragma unroll
      for (int k = ld_k; k < kChunk; k += 4) {
        const bool ok = ld_col && k0 + k < HM;
        cp_async16(sa + k * ws + ld_o,
                   ok ? w_src + static_cast<size_t>(k0 + k) * h + ld_o : w_src,
                   ok ? 16 : 0);
      }
      for (int q = threadIdx.x; q < kRows * (kChunk / 4); q += blockDim.x) {
        const int r = q / (kChunk / 4), k = q % (kChunk / 4) * 4;
        const bool ok = r < rows && k0 + k < HM;
        cp_async16(sb + b_offset<kNBlocks>(r, k),
                   ok ? a_src + static_cast<size_t>(r) * HM + k0 + k : a_src,
                   ok ? 16 : 0);
      }
    } else if (c < chunks) {
      const int q0 = (c - wa_chunks) * kChunk;
#pragma unroll
      for (int k = ld_k; k < kChunk; k += 4) {
        const int hd = (q0 + k) / nI, p = (q0 + k) % nI;
        const bool ok = ld_col && hd < H;
        cp_async16(sa + k * ws + ld_o,
                   ok ? dws + ((static_cast<size_t>(b) * H + hd) * N + I0 + p) * h + ld_o
                      : dws,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // The residual region, in two commit groups: attn_mI (for the rank-1
  // columns' B), and the rows of x_a, delta and bias (for the epilogue).
  auto load_am = [&]() {
    const float* am_b = attn_mI + static_cast<size_t>(b) * H * N * N + I0 * N;
    for (int q = threadIdx.x; q < H * rows; q += blockDim.x)
      cp_async4(s_am + q / rows * kRows + q % rows,
                am_b + static_cast<size_t>(q / rows) * N * N + q % rows);
    cp_async_commit();
  };
  auto load_rows = [&]() {
    for (int row = ld_k; row < N + nI + 1; row += 4) {
      const float* src = row < N ? x_a + (static_cast<size_t>(b) * N + row) * h
                       : row < N + nI
                           ? delta + (static_cast<size_t>(b) * N + I0 + row - N) * h
                           : bias;
      const int at = row < N + nI ? row : N + per_block;  // bias after delta
      cp_async16(s_xa + at * xs + ld_o, ld_col ? src + ld_o : src, ld_col ? 16 : 0);
    }
    cp_async_commit();
  };

  // B of chunk c, split into its high and low copies: the staged attention
  // columns, or the rank-1 columns q0 + k, attn_mI[b, hd, I0 + p, n] in the
  // rows of p. The caller's barrier makes them visible to wgmma.
  auto split_b = [&](int c) {
    float* b_hi = smem + (c % kStages) * sf + kChunk * ws;
    float* b_lo = b_hi + kBFloats;
    const int q0 = (c - wa_chunks) * kChunk;
    for (int q = threadIdx.x; q < kBFloats; q += blockDim.x) {
      float x;
      if (c < wa_chunks) {
        x = b_hi[q];
      } else {
        const int k = q / (kNBlocks * 32) * 4 + q % 4;  // inverse of b_offset
        const int r = q / 32 % kNBlocks * 8 + q / 4 % 8;
        const int hd = (q0 + k) / nI, p = (q0 + k) % nI;
        const int pn = s_row[r];
        x = (hd < H && pn >= 0 && pn / 64 == p) ? s_am[hd * kRows + r] : 0.f;
      }
      uint32_t hi, lo;
      split_tf32(x, hi, lo);
      b_hi[q] = __uint_as_float(hi);
      b_lo[q] = __uint_as_float(lo);
    }
    fence_async_shared();
  };

  float acc[kMBlocks][4 * kNBlocks];
#pragma unroll
  for (int mb = 0; mb < kMBlocks; ++mb)
#pragma unroll
    for (int i = 0; i < 4 * kNBlocks; ++i) acc[mb][i] = 0.f;

  // Prologue: chunk 0, attn_mI, chunks 1 .. kStages - 2, the rows of the
  // epilogue; B of chunk 0.
  load_chunk(0);
  load_am();
  for (int c = 1; c < kStages - 1; ++c) load_chunk(c);
  load_rows();
  cp_async_wait<kStages - 2>();  // chunks 0 and 1, and attn_mI
  __syncthreads();
  split_b(0);
  __syncthreads();
  // Chunk c (split, and chunk c + 1 landed, at the top): its products on
  // the tensor cores, and meanwhile chunk c + kStages - 1 is loaded into
  // the stage of chunk c - 1, chunk c + 1's B is split, and chunk c + 2
  // awaited. One barrier a chunk.
  for (int c = 0; c < chunks; ++c) {
    const float* sa = smem + (c % kStages) * sf;
    const float* b_hi = sa + kChunk * ws;
    // A fragments (wa^T at this thread's columns), split
    uint32_t ah[kMBlocks][4], al[kMBlocks][4];
#pragma unroll
    for (int mb = 0; mb < kMBlocks; ++mb) {
      const float* w = sa + t * ws + col0 + 64 * mb;
      split_tf32(w[0], ah[mb][0], al[mb][0]);
      split_tf32(w[8], ah[mb][1], al[mb][1]);
      split_tf32(w[4 * ws], ah[mb][2], al[mb][2]);
      split_tf32(w[4 * ws + 8], ah[mb][3], al[mb][3]);
    }
    wgmma_fence();
    const uint64_t d_hi = smem_desc<kNBlocks>(b_hi), d_lo = smem_desc<kNBlocks>(b_hi + kBFloats);
    // A warp waits at each wgmma until the tensor cores take it, so the
    // block's other work for the next chunks goes between the products.
#pragma unroll
    for (int mb = 0; mb < kMBlocks; ++mb) wgmma_tf32(acc[mb], al[mb], d_hi);
    if (c + 1 < chunks) split_b(c + 1);
#pragma unroll
    for (int mb = 0; mb < kMBlocks; ++mb) wgmma_tf32(acc[mb], ah[mb], d_lo);
    load_chunk(c + kStages - 1);
#pragma unroll
    for (int mb = 0; mb < kMBlocks; ++mb) wgmma_tf32(acc[mb], ah[mb], d_hi);
    wgmma_commit();
    cp_async_wait<kStages - 3>();  // chunk c + 2
    wgmma_wait_all();
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();  // the epilogue's rows have landed

  // acc[mb][4 j + q] is fc at row r = 8 j + 2 t + q % 2, column
  // col0 + 64 mb + 8 (q / 2). fc = (product + rank-1) + bias + x_a
  // + diag * delta, zero in the columns past h and the rows past the
  // block's; then each row's sum.
  bool col_ok[kMBlocks][2];
  float bias_c[kMBlocks][2];
#pragma unroll
  for (int mb = 0; mb < kMBlocks; ++mb)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      col_ok[mb][hi] = col0 + 64 * mb + 8 * hi < h;
      bias_c[mb][hi] = s_bias[col0 + 64 * mb + 8 * hi];
    }
  float part[kNBlocks][2];
#pragma unroll
  for (int j = 0; j < kNBlocks; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int pn = s_row[8 * j + 2 * t + e];
      const bool row_ok = pn >= 0;
      const int p = row_ok ? pn >> 6 : 0, n = row_ok ? pn & 63 : 0;
      const bool diag = row_ok && n == I0 + p;
      const float* xa = s_xa + n * xs + col0;
      const float* dl = s_dl + p * xs + col0;
      part[j][e] = 0.f;
#pragma unroll
      for (int mb = 0; mb < kMBlocks; ++mb)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float& v = acc[mb][4 * j + 2 * hi + e];
          const int oo = 64 * mb + 8 * hi;
          float x = (v + bias_c[mb][hi]) + xa[oo];
          if (diag) x += dl[oo];
          v = row_ok && col_ok[mb][hi] ? x : 0.f;
          part[j][e] += v;
        }
    }
  // LayerNorm, two-pass: the mean, then the centred sum of squares
  row_stat(part, s_red, s_tot, h, false);
#pragma unroll
  for (int j = 0; j < kNBlocks; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float mu = part[j][e];
      part[j][e] = 0.f;
#pragma unroll
      for (int mb = 0; mb < kMBlocks; ++mb)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float& v = acc[mb][4 * j + 2 * hi + e];
          v = col_ok[mb][hi] ? v - mu : 0.f;
          part[j][e] += v * v;
        }
    }
  row_stat(part, s_red, s_tot, h, true);  // part: rstd of each row

  // y = (fc - mean) * rstd, and the pool: out[b, I0 + p, o] = mean of y
  // over rows p*N .. p*N + N - 1; each thread sums its rows of p (only the
  // n8 blocks that meet them), then the 4 lanes t of its columns.
  const float rows_n = static_cast<float>(N);
  for (int p = 0; p < nI; ++p) {
    const int r0 = p * N, r1 = r0 + N;
    float s[kMBlocks][2] = {};
#pragma unroll
    for (int j = 0; j < kNBlocks; ++j) {
      if (8 * j + 8 <= r0 || 8 * j >= r1) continue;  // the same for the warp
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * j + 2 * t + e;
        const float w = r >= r0 && r < r1 ? part[j][e] : 0.f;
#pragma unroll
        for (int mb = 0; mb < kMBlocks; ++mb)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) s[mb][hi] += acc[mb][4 * j + 2 * hi + e] * w;
      }
    }
#pragma unroll
    for (int mb = 0; mb < kMBlocks; ++mb)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float x = s[mb][hi];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (t == 0 && col_ok[mb][hi])
          out[(static_cast<size_t>(b) * N + I0 + p) * h + col0 + 64 * mb + 8 * hi] =
              x / rows_n;
      }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for a shape the kernel does not take: it needs
// h % 4 == 0, h <= 512, N <= 32, H * N % 4 == 0 (16-byte rows of
// attn_lhs), shared memory for attn_mI's H rows of 80 floats (H <= 142 at
// N = 32, h = 512, past the backward's limit) and 16-byte aligned pointers;
// the Python wrapper checks the shape and the pointers first.
int tail_forward_launch(const float* attn_lhs, const float* attn_mI,
                        const float* wa, const float* dws, const float* x_a,
                        const float* delta, const float* bias, float* out,
                        int B, int N, int H, int h, void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxN || H <= 0 || (H * N) % 4 != 0 || h <= 0 ||
      h % 4 != 0 || h > kMaxH)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = N < kRows / N ? N : kRows / N;
  const int blocks = B * ((N + per_block - 1) / per_block);
  const int threads = cols_pad(h) / kGroupCols * 128;  // a warpgroup per 128 columns
  const size_t smem = smem_bytes(N, H, h);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      tail_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_forward_kernel<<<blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      attn_lhs, attn_mI, wa, dws, x_a, delta, bias, out, N, H, h, per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
