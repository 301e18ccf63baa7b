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
// What bounds it: at B = 1024, N = 20, H = 4, h = 1024 the forward's
// product is ~67 GFLOP and the backward's three (the fc recompute, d_wa,
// d_attn_lhs) ~200 GFLOP, against ~1 GB (forward) and ~2 GB (backward) of
// inputs and outputs, plus the backward's d_fc scratch (1.68 GB, written
// once and read three times) (chip_smoke._tail_forward_work and
// _tail_backward_work count them). On the CUDA cores in float32 the
// products alone take 1.0 and 3.0 ms at 67 TFLOP/s. So every product runs
// on the tensor cores in 3xTF32 (tc_common.cuh: three TF32 products at
// 495 TFLOP/s keep float32-level error), through wide_common.cuh's
// tc_mainloop, the pipeline of tail_forward.cu; the rest (bias, x_a,
// delta, the LayerNorm statistics and backward, the pool, d_delta, d_dws,
// d_attn_mI, the sums over I and over groups) stays float32 on the CUDA
// cores, in the order of the parent's CUDA-core route.
//
// Design:
//   rows (build_rows), for the forward and the backward's first stage: one
//     block of four warpgroups per (b, P counterfactuals), P from the
//     wrapper's plan (baseline_tail.wide_plan: the most, up to 40 rows,
//     whose P * N rows of h floats fit in shared memory; 2 at N = 20,
//     h = 1024, 213 KB). The block computes fc transposed, fc^T (h x rows)
//     = wa^T * attn^T, in tiles of 256 columns o (64 a warpgroup) by 40
//     rows (wgmma m64n40k8; row tiles of 40 past N = 40). The rank-1 term extends K: after the
//     H*N columns of the attention come H*P columns q = hd*P + p, whose A
//     rows are dws[b, hd, I0 + p] and whose B column holds
//     attn_mI[b, hd, I0 + p, n] in the rows of counterfactual p and zeros
//     elsewhere (built in the B split from attn_mI staged in shared
//     memory). Each tile's accumulators, plus
//     bias, x_a and the diagonal delta (x_a and bias loaded into registers
//     before the tile's products, which hide their latency), go to the
//     block's rows: in shared memory, or where the plan finds no room
//     (N * h past ~44,000 floats) in a (B, N*N, h) scratch in device memory
//     (the backward's d_fc).
//   forward (tail_wide_fwd_kernel): the rows, then the two-pass statistics
//     (one warp a row, column tiles of 512: layernorm_tiled is their plain
//     version) and the pool.
//   backward, three stages joined by d_fc (B, N*N, h) in device memory:
//     1. rows (tail_wide_bwd_rows_kernel): the rows, the statistics, the
//        LayerNorm backward in place, d_delta, d_dws (a thread a column,
//        summed over n) and d_attn_mI (a warp a (head, n), summed over the
//        row's tiles), then the rows out to d_fc;
//     2. d_wa^T = d_fc^T attn_lhs per group on the tensor cores
//        (tc_gemm, M = h, N = H*N, K = N*N; attn_lhs transposed while it is
//        staged), then d_xa = the sum over I of d_fc (tail_wide_sums_kernel,
//        a thread a column), its sum over n into a (B, h) partial and the
//        compensated sum of the partials over b;
//     3. d_attn_lhs = d_fc wa^T per group on the tensor cores (tc_gemm,
//        M = N*N, N = H*N, K = h; wa's rows are K-major as they lie).
// Every sum has a fixed order and there are no atomics: two calls give the
// same bits.

#include "wide_common.cuh"

namespace {

using namespace wide;

constexpr int kColTile = kTcCols;                    // columns o of a product tile
constexpr int kRowsStages = 4;
constexpr int kRowNB = 5;                            // n8 blocks of a row tile: wgmma n40
constexpr int kMaxRows = 40;                         // P * N, or N where N > 40

__host__ __device__ inline size_t round4(size_t floats) { return (floats + 3) / 4 * 4; }

// Floats of attn_mI's region: a row tile's rank-1 columns (H x 40), then
// in the backward one counterfactual's attn_mI[b, :, I, :] (H x N).
__host__ __device__ inline size_t am_floats(int N, int H) {
  return round4(static_cast<size_t>(H) * (N > 8 * kRowNB ? N : 8 * kRowNB));
}

// Floats of a rows block's shared memory before its rows: the ring; attn_mI;
// the statistics mu, rstd, m2 (P * N each) and m1 (P); bias (h; in the
// backward then dout / N); each rounded up to whole float4s. The plan's
// mirror is baseline_tail.wide_plan.
__host__ __device__ inline size_t rows_head_floats(int N, int H, int h, int P) {
  return static_cast<size_t>(kRowsStages) * tc_stage_floats(kRowNB) +
         am_floats(N, H) + round4(3 * static_cast<size_t>(P) * N + P) + round4(h);
}

inline size_t rows_smem_bytes(int N, int H, int h, int P, bool rows_in_smem) {
  size_t floats = rows_head_floats(N, H, h, P);
  if (rows_in_smem) floats += static_cast<size_t>(P) * N * h;
  return floats * sizeof(float);
}

// The fc rows r = p * N + n (n < N, p < nI) of counterfactuals I0 .. I0 +
// nI - 1 of group b into rows[r * h + o]; s_bias holds bias. Each tile's
// x_a is copied into its place in the rows before the tile's products (by
// cp.async into shared rows, where `vec_x` with 16-byte copies, so that the
// products hide its latency; by plain copies into device-memory rows), and
// the epilogue adds the accumulators and bias to it from shared memory: a
// global load between stores there serialises. delta goes last, in a pass
// over the diagonal rows. The whole block calls it; it ends with a barrier.
__device__ void build_rows(float* rows, bool rows_in_smem, float* ring, float* s_am,
                           float* s_bias, const float* __restrict__ attn_lhs,
                           const float* __restrict__ attn_mI, const float* __restrict__ wa,
                           const float* __restrict__ dws, const float* __restrict__ x_a,
                           const float* __restrict__ delta, const float* __restrict__ bias,
                           int b, int I0, int nI, int N, int H, int h, bool vec_a,
                           bool vec_b, bool vec_x) {
  constexpr int NB = kRowNB, nrows = 8 * NB;  // rows of a row tile
  const int HM = H * N, R = nI * N;
  const int wa_chunks = (HM + kTcChunk - 1) / kTcChunk;
  const int chunks = wa_chunks + (H * nI + kTcChunk - 1) / kTcChunk;
  const float* lhs = attn_lhs + (static_cast<size_t>(b) * N + I0) * N * HM;  // row r at r*HM
  const float* wa_b = wa + static_cast<size_t>(b) * HM * h;
  const float* dws_b = dws + static_cast<size_t>(b) * H * N * h;
  const float* xa_b = x_a + static_cast<size_t>(b) * N * h;
  const int t = threadIdx.x % 4, row0 = tc_row0();
  for (int o = threadIdx.x; o < h; o += blockDim.x) s_bias[o] = bias[o];
  for (int r0 = 0; r0 < R; r0 += nrows) {
    const int r1 = min(R, r0 + nrows);
    // attn_mI of the rank-1 columns: s_am[hd * nrows + rr] for row r0 + rr;
    // the mainloop's first barrier makes it visible
    for (int q = threadIdx.x; q < H * nrows; q += blockDim.x) {
      const int hd = q / nrows, r = r0 + q % nrows;
      s_am[q] = r < R ? attn_mI[((static_cast<size_t>(b) * H + hd) * N + I0 + r / N) * N + r % N]
                      : 0.f;
    }
    for (int o0 = 0; o0 < h; o0 += kColTile) {
      // x_a of rows r0 .. r1 - 1, columns o0 .. o0 + kColTile - 1, into place
      const int cols = min(kColTile, h - o0);
      if (rows_in_smem && vec_x) {
        for (int q = threadIdx.x; q < (r1 - r0) * (kColTile / 4); q += blockDim.x) {
          const int r = r0 + q / (kColTile / 4), o = 4 * (q % (kColTile / 4));
          if (o < cols)
            tc::cp_async16(rows + static_cast<size_t>(r) * h + o0 + o,
                           xa_b + static_cast<size_t>(r % N) * h + o0 + o, 16);
        }
        tc::cp_async_commit();  // landed by the mainloop's first wait
      } else {
        for (int q = threadIdx.x; q < (r1 - r0) * kColTile; q += blockDim.x) {
          const int r = r0 + q / kColTile, o = q % kColTile;
          if (o < cols)
            rows[static_cast<size_t>(r) * h + o0 + o] = xa_b[static_cast<size_t>(r % N) * h + o0 + o];
        }
      }
      auto load = [&](int c, float* stage) {
        if (c < wa_chunks) {
          const int k0 = c * kTcChunk;
          load_a_rows(
              stage, [&](int k) { return k0 + k < HM ? wa_b + (k0 + k) * h : nullptr; }, o0,
              h, vec_a, wa_b);
          load_b_rows<NB>(
              stage + kTcChunk * kTcAStride,
              [&](int n) { return r0 + n < R ? lhs + static_cast<size_t>(r0 + n) * HM : nullptr; },
              k0, HM, vec_b, lhs);
        } else {  // the rank-1 columns: dws rows; their B is built by fix
          const int q0 = (c - wa_chunks) * kTcChunk;
          load_a_rows(
              stage,
              [&](int k) {
                const int hd = (q0 + k) / nI, p = (q0 + k) % nI;
                return hd < H ? dws_b + (static_cast<size_t>(hd) * N + I0 + p) * h : nullptr;
              },
              o0, h, vec_a, dws_b);
        }
      };
      auto fix = [&](int c, int q, float x) {
        if (c < wa_chunks) return x;
        const int qq = (c - wa_chunks) * kTcChunk + tc::b_col<NB>(q);
        const int hd = qq / nI, p = qq % nI, rr = tc::b_row<NB>(q), r = r0 + rr;
        return hd < H && r < R && r / N == p ? s_am[hd * nrows + rr] : 0.f;
      };
      float acc[4 * NB];
      tc_mainloop<NB, kRowsStages>(acc, ring, chunks, load, fix);
      // fc = ((product + rank-1) + bias) + x_a, as tail_forward.cu
#pragma unroll
      for (int x = 0; x < 4 * NB; ++x) {
        const int o = o0 + row0 + 8 * (x % 4 / 2);
        const int r = r0 + 8 * (x / 4) + 2 * t + x % 2;
        if (o < h && r < R) {
          float* f = rows + static_cast<size_t>(r) * h + o;
          *f = (acc[x] + s_bias[o]) + *f;
        }
      }
    }
  }
  __syncthreads();
  // + delta on the diagonal row of each counterfactual; its loads first
  for (int p = 0; p < nI; ++p) {
    const float* dl = delta + (static_cast<size_t>(b) * N + I0 + p) * h;
    float* f = rows + (static_cast<size_t>(p) * N + I0 + p) * h;
    for (int o0 = 0; o0 < h; o0 += 4 * blockDim.x) {
      float d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = o0 + u * blockDim.x + threadIdx.x;
        d[u] = o < h ? dl[o] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = o0 + u * blockDim.x + threadIdx.x;
        if (o < h) f[o] += d[u];
      }
    }
  }
  __syncthreads();
}

// The block's (b, I0, nI) and its shared-memory regions.
struct RowsBlock {
  int b, I0, nI;
  float *ring, *s_am, *s_mu, *s_rstd, *s_m2, *s_m1, *s_bias, *rows_smem;
};

__device__ RowsBlock rows_block(float* smem, int N, int H, int h, int P) {
  const int per_group = (N + P - 1) / P;
  RowsBlock k;
  k.b = blockIdx.x / per_group;
  k.I0 = blockIdx.x % per_group * P;
  k.nI = min(P, N - k.I0);
  k.ring = smem;
  k.s_am = k.ring + kRowsStages * tc_stage_floats(kRowNB);
  k.s_mu = k.s_am + am_floats(N, H);
  k.s_rstd = k.s_mu + P * N;
  k.s_m2 = k.s_rstd + P * N;
  k.s_m1 = k.s_m2 + P * N;
  k.s_bias = k.s_mu + round4(3 * static_cast<size_t>(P) * N + P);
  k.rows_smem = smem + rows_head_floats(N, H, h, P);
  return k;
}

// Forward: pooled out[b, I] of P counterfactuals a block. `scratch` is null
// when the rows stay in shared memory, else the (B, N*N, h) rows in device
// memory.
__global__ void __launch_bounds__(kTcThreads, 1) tail_wide_fwd_kernel(
    const float* __restrict__ attn_lhs, const float* __restrict__ attn_mI,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, float* scratch, float* __restrict__ out, int N, int H,
    int h, int P, bool vec_a, bool vec_b, bool vec_x) {
  extern __shared__ __align__(128) float smem[];
  const RowsBlock k = rows_block(smem, N, H, h, P);
  const size_t bI0 = static_cast<size_t>(k.b) * N + k.I0;
  float* rows = scratch != nullptr ? scratch + bI0 * N * h : k.rows_smem;
  build_rows(rows, scratch == nullptr, k.ring, k.s_am, k.s_bias, attn_lhs, attn_mI, wa, dws,
             x_a, delta, bias, k.b, k.I0, k.nI, N, H, h, vec_a, vec_b, vec_x);
  row_stats(rows, k.nI * N, h, k.s_mu, k.s_rstd);
  for (int p = 0; p < k.nI; ++p)
    pool_rows(rows + static_cast<size_t>(p) * N * h, k.s_mu + p * N, k.s_rstd + p * N, N, h,
              out + (bI0 + p) * h);
}

// Backward, stage 1: the rows of d_fc of P counterfactuals a block, and
// d_delta, d_dws[b, :, I] and d_attn_mI[b, :, I, :] of each.
__global__ void __launch_bounds__(kTcThreads, 1) tail_wide_bwd_rows_kernel(
    const float* __restrict__ attn_lhs, const float* __restrict__ attn_mI,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, const float* __restrict__ dout, float* d_fc,
    float* __restrict__ d_attn_mI, float* __restrict__ d_dws, float* __restrict__ d_delta,
    int N, int H, int h, int P, bool rows_in_smem, bool vec_a, bool vec_b, bool vec_x) {
  extern __shared__ __align__(128) float smem[];
  const RowsBlock k = rows_block(smem, N, H, h, P);
  const size_t bI0 = static_cast<size_t>(k.b) * N + k.I0;
  const int R = k.nI * N;
  float* out_rows = d_fc + bI0 * N * h;
  float* rows = rows_in_smem ? k.rows_smem : out_rows;
  build_rows(rows, rows_in_smem, k.ring, k.s_am, k.s_bias, attn_lhs, attn_mI, wa, dws, x_a,
             delta, bias, k.b, k.I0, k.nI, N, H, h, vec_a, vec_b, vec_x);
  row_stats(rows, R, h, k.s_mu, k.s_rstd);
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const float rows_n = static_cast<float>(N);
  for (int p = 0; p < k.nI; ++p) {
    const int I = k.I0 + p;
    float* pr = rows + static_cast<size_t>(p) * N * h;
    // d_y = dout / N of counterfactual p into the bias region, and
    // attn_mI[b, :, I, :] into attn_mI's: read once, then from shared memory
    const float* dp = dout + (bI0 + p) * h;
    for (int o = threadIdx.x; o < h; o += blockDim.x) k.s_bias[o] = dp[o] / rows_n;
    for (int q = threadIdx.x; q < H * N; q += blockDim.x)
      k.s_am[q] = attn_mI[((static_cast<size_t>(k.b) * H + q / N) * N + I) * N + q % N];
    __syncthreads();
    layernorm_backward_with(pr, [&](int o) { return k.s_bias[o]; }, N, h, k.s_mu + p * N,
                            k.s_rstd + p * N, k.s_m2 + p * N, k.s_m1 + p);
    for (int o = threadIdx.x; o < h; o += blockDim.x)
      d_delta[(bI0 + p) * h + o] = pr[static_cast<size_t>(I) * h + o];
    for (int hh = 0; hh < H; ++hh) {
      const size_t row = (static_cast<size_t>(k.b) * H + hh) * N + I;
      for (int o = threadIdx.x; o < h; o += blockDim.x) {
        float s = 0.f;
        for (int n = 0; n < N; ++n) s += k.s_am[hh * N + n] * pr[static_cast<size_t>(n) * h + o];
        d_dws[row * h + o] = s;
      }
    }
    for (int q = warp; q < H * N; q += nwarps) {
      const int hh = q / N, n = q % N;
      const size_t row = (static_cast<size_t>(k.b) * H + hh) * N + I;
      const float* r = pr + static_cast<size_t>(n) * h;
      const float* v = dws + row * h;
      const float s = warp_row_sum(h, [&](int o) { return r[o] * v[o]; });
      if ((threadIdx.x & 31) == 0) d_attn_mI[row * N + n] = s;
    }
    __syncthreads();  // before the next counterfactual's d_y and attn_mI
  }
  if (!rows_in_smem) return;
  const size_t n_out = static_cast<size_t>(R) * h;
  if (h % 4 == 0) {  // whole float4s on both sides
    const float4* src = reinterpret_cast<const float4*>(rows);
    float4* dst = reinterpret_cast<float4*>(out_rows);
    for (size_t q = threadIdx.x; q < n_out / 4; q += blockDim.x) dst[q] = src[q];
  } else {
    for (size_t q = threadIdx.x; q < n_out; q += blockDim.x) out_rows[q] = rows[q];
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

// The checks and the launch configuration shared by the two rows kernels:
// the grid, the shared memory (refused past the card's), and whether the
// product operands take 16-byte copies (wa and dws rows; attention rows).
struct RowsLaunch {
  int blocks = 0;
  size_t smem = 0;
  bool vec_a = false, vec_b = false, vec_x = false;
};

inline bool rows_launch(RowsLaunch& l, const float* attn_lhs, const float* wa,
                        const float* dws, const float* x_a, int B, int N, int H, int h, int P,
                        bool rows_in_smem) {
  if (!wide_shape_ok(B, N, H, h) || P < 1 || P > N || (P > 1 && P * N > kMaxRows))
    return false;
  const long long blocks = static_cast<long long>(B) * ((N + P - 1) / P);
  if (blocks > INT_MAX) return false;
  l.blocks = static_cast<int>(blocks);
  l.smem = rows_smem_bytes(N, H, h, P, rows_in_smem);
  l.vec_a = h % 4 == 0 && aligned16(wa) && aligned16(dws);
  l.vec_b = (H * N) % 4 == 0 && aligned16(attn_lhs);
  l.vec_x = h % 4 == 0 && aligned16(x_a);
  return l.smem <= static_cast<size_t>(kMaxSmem);
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launches (0 = success), or
// cudaErrorInvalidValue for shapes or plans the route does not take. P is
// the counterfactuals a rows block takes (baseline_tail.wide_plan).

// Forward: out (B, N, h). `scratch` null keeps the rows in shared memory
// (invalid if they do not fit), else the (B, N*N, h) rows.
int tail_wide_forward_launch(const float* attn_lhs, const float* attn_mI,
                             const float* wa, const float* dws,
                             const float* x_a, const float* delta,
                             const float* bias, float* scratch, float* out,
                             int B, int N, int H, int h, int P, void* stream) {
  RowsLaunch l;
  if (!rows_launch(l, attn_lhs, wa, dws, x_a, B, N, H, h, P, scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(tail_wide_fwd_kernel, l.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_wide_fwd_kernel<<<l.blocks, kTcThreads, l.smem, s>>>(
      attn_lhs, attn_mI, wa, dws, x_a, delta, bias, scratch, out, N, H, h, P, l.vec_a,
      l.vec_b, l.vec_x);
  return static_cast<int>(cudaGetLastError());
}

// Backward, stage 1: d_fc (B, N*N, h) scratch, d_attn_mI, d_dws, d_delta.
// rows_in_smem: the rows stay in shared memory until they are d_fc's
// (invalid if they do not fit), else they are built in d_fc.
int tail_wide_bwd_rows_launch(const float* attn_lhs, const float* attn_mI,
                              const float* wa, const float* dws,
                              const float* x_a, const float* delta,
                              const float* bias, const float* dout,
                              float* d_fc, float* d_attn_mI, float* d_dws,
                              float* d_delta, int B, int N, int H, int h, int P,
                              int rows_in_smem, void* stream) {
  RowsLaunch l;
  if (!rows_launch(l, attn_lhs, wa, dws, x_a, B, N, H, h, P, rows_in_smem != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(tail_wide_bwd_rows_kernel, l.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_wide_bwd_rows_kernel<<<l.blocks, kTcThreads, l.smem, s>>>(
      attn_lhs, attn_mI, wa, dws, x_a, delta, bias, dout, d_fc, d_attn_mI, d_dws, d_delta, N,
      H, h, P, rows_in_smem != 0, l.vec_a, l.vec_b, l.vec_x);
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
  // d_wa^T: A(o, r) = d_fc[b, r, o]; B(r, m) = attn_lhs[b, r, m]; d_wa[b, m, o]
  cudaError_t err = tc_gemm(Operand{d_fc, NN * h, 1, h}, Operand{attn_lhs, NN * HM, HM, 1}, B,
                            h, static_cast<int>(HM), static_cast<int>(NN),
                            Store{d_wa, HM * h, 1, h}, s);
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
  return static_cast<int>(tc_gemm(Operand{d_fc, NN * h, h, 1}, Operand{wa, HM * h, 1, h}, B,
                                  static_cast<int>(NN), static_cast<int>(HM), h,
                                  Store{d_attn_lhs, NN * HM, HM, 1},
                                  static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
