// Backward (K3b) of the counterfactual-baseline tail of
// POCACritic.all_baselines, for Hopper (sm_90a). The forward (K3f) is
// tail_forward.cu.
//
// Replaces (TPU kernel): swarmacb_tpu/ops/baseline_tail.py: _fused_tail_bwd,
// the backward of fused_tail (Pallas body _bwd_kernel).
//
// The tail, per group b and counterfactual agent I (inputs: attn_lhs
// (B, N*N, H*N) with row I*N+n and column h*N+m, attn_mI (B, H, N, N) as
// [h, I, n], wa (B, H*N, h), dws (B, H, N, h), x_a and delta (B, N, h),
// bias (h,)):
//   fc[n, o]  = sum_m attn_lhs[b, I*N+n, m] * wa[b, m, o]
//             + sum_h attn_mI[b, h, I, n] * dws[b, h, I, o]
//             + bias[o] + x_a[b, n, o] + (n == I) * delta[b, I, o]
//   y[n, :]   = LayerNorm(fc[n, :])   (non-affine, eps 1e-5, two-pass stats)
//   out[b, I] = mean_n y[n, :]
// The backward recomputes fc in float32 on the CUDA cores (fc_rows and
// center_rows, one thread per 4 columns, kRows rows a pass over wa); K3f
// takes the product in 3xTF32 on the tensor cores, so the two y agree to
// float32 rounding, not bit for bit.
//
// Given dout (B, N, h), with d_y = dout[b, I] / N on every row n and
//   d_fc[I*N+n, :] = rstd * (d_y - mean(d_y) - y * mean(d_y * y)),
// it emits the cotangents of all seven inputs:
//   d_attn_lhs[I*N+n, m] = sum_o d_fc[I*N+n, o] wa[m, o]      (contract o)
//   d_attn_mI[h, I, n]   = sum_o d_fc[I*N+n, o] dws[h, I, o]  (contract o)
//   d_wa[m, o]           = sum_{I,n} attn_lhs[I*N+n, m] d_fc[I*N+n, o]
//   d_dws[h, I, o]       = sum_n attn_mI[h, I, n] d_fc[I*N+n, o]
//   d_xa[n, o]           = sum_I d_fc[I*N+n, o]
//   d_delta[I, o]        = d_fc[I*N+I, o]
//   d_bias[o]            = sum_{b,I,n} d_fc[I*N+n, o]
//
// What bounds it: arithmetic. Three products of the fc tile's size (the fc
// recompute, d_attn_lhs and d_wa, 2*H*N operations per fc element each) come
// to ~110 GFLOP at the main path's shapes, ~1.6 ms at 67 TFLOP/s, against
// ~1.2 GB of inputs and cotangents (~0.35 ms at 3.35 TB/s).
//
// Design: the TPU kernel walks groups in one sequential grid and carries
// d_bias from step to step; blocks on Hopper run in no order. So the
// backward is cut where its sums cross blocks, into three kernels whose
// blocks are all independent, joined by d_fc (B, N*N, h) in device memory
// (0.84 GB at the main path's shape, written once and read twice: well
// under a millisecond of bandwidth, against ~1.6 ms of arithmetic):
//   1. rows (tail_bwd_rows_kernel), one block per (b, I): fc recomputed
//      by fc_rows and center_rows, then d_fc,
//      stored with coalesced float4 stores. Every sum of this stage lies
//      inside the block: the LayerNorm statistics are block reductions,
//      d_dws[b, :, I] sums the block's own rows in shared memory, d_delta is
//      one of the rows, and the contractions over o of d_attn_mI reduce over
//      each warp (the first shuffle splits the values between the two
//      half-warps, halving the shuffles) and then over the warps, with one
//      barrier per pass of kRows rows for all heads. Bounded by the
//      recompute's operations (0.63 ms).
//   2. d_wa (tail_bwd_wa_kernel), one block per (b, 80 rows of m, 128
//      columns of o): the batched product attn_lhs[b]^T d_fc[b], K = N*N,
//      taken one counterfactual I (N rows) per K-slice, so that d_xa[n, tile]
//      adds up in registers from the same staged slice (each thread the
//      rows n = tm, tm + 20 of its own 8 columns); the block then sums
//      d_xa over n into a (B, h) d_bias partial, which
//      sum_over_groups_kernel sums in order of b. Bounded by its
//      operations (0.50 ms).
//   3. d_attn_lhs (tail_bwd_attn_kernel), one block per (b, 80 rows of
//      I*N+n, 80 columns of m): the batched product d_fc[b] wa[b]^T, K = h
//      in slices of 32. Bounded by its operations (0.50 ms).
// The two products run on the CUDA cores in float32 (TF32 would keep ~3
// decimal digits). Their operands go through shared memory by cp.async,
// 16 bytes a thread, neighbouring threads on neighbouring addresses, in two
// stages so that the next K-slice loads while this one is multiplied. Each
// thread keeps a 4 x 8 (stage 2) or 5 x 5 (stage 3) tile of outputs in
// registers and reads its operands with 16-byte shared loads, so that a
// shared load feeds 8 to 10 multiply-adds. In stage 2 a K-slice is a run of
// rows, as both operands lie in memory. In stage 3 both operands are
// K-contiguous, and cp.async cannot transpose: they are staged as rows of
// K with a stride of 36 floats (an odd number of 16 bytes), which puts the
// 16 rows that a half-warp reads in distinct bank groups. Every sum has a
// fixed order and there are no atomics: two calls give the same bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 4;   // output columns per thread (float4)
constexpr int kRows = 10;  // fc rows accumulated per pass over wa
constexpr int kRowsPad = 12;  // kRows rounded up to whole float4s
constexpr int kMaxN = 32;  // agents per group the backward takes
constexpr float kLnEps = 1e-5f;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

// Sums v[0..K) over the whole block; every thread gets the totals.
template <int K>
__device__ void block_sum(float (&v)[K], float* s_red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float x = v[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) s_red[warp * K + r] = x;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float x = 0.f;
    for (int w = 0; w < nwarps; ++w) x += s_red[w * K + r];
    v[r] = x;
  }
  __syncthreads();
}

constexpr int kHalf = kRows / 2;
static_assert(kRows % 2 == 0, "warp_sum_split halves kRows");

// Sums each of v[0..kRows) over the warp's 32 lanes with half the shuffles
// of one sum per value: the first exchange splits the values between the
// two half-warps. Lane 0 ends with the sums of v[0..kHalf) and lane 16 with
// those of v[kHalf..kRows), each in half[0..kHalf).
__device__ inline void warp_sum_split(const float (&v)[kRows],
                                      float (&half)[kHalf]) {
  const bool hi = threadIdx.x & 16;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = hi ? v[i] : v[i + kHalf];
    half[i] = (hi ? v[i + kHalf] : v[i]) +
              __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
      half[i] += __shfl_xor_sync(0xffffffffu, half[i], off);
}

__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ inline void store4(float* p, const float (&v)[kCols]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// 16-byte asynchronous copy from device to shared memory (cached in L2
// only). With src_bytes 0 nothing is read and the 16 bytes are zeros.
__device__ inline void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most Pending groups of this thread's copies are in flight.
template <int Pending>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Floats of shared memory that stage_attention fills.
__host__ __device__ inline int attention_floats(int N, int HM) {
  return (N + kRows - 1) / kRows * HM * kRowsPad;
}

// Stages the N attention rows of one counterfactual (row n, column m at
// src[n * HM + m]) in shared memory as [pass][m][row in pass]: the kRows
// rows of one pass and one column lie together, padded with zeros to
// kRowsPad, so fc_rows reads them with three 16-byte loads instead of
// kRows 4-byte ones.
__device__ void stage_attention(float* s_attn, const float* src, int N,
                                int HM) {
  for (int k = threadIdx.x; k < attention_floats(N, HM); k += blockDim.x) {
    const int r = k % kRowsPad, pm = k / kRowsPad;
    const int n = (pm / HM) * kRows + r;
    s_attn[k] = (r < kRows && n < N) ? src[n * HM + pm % HM] : 0.f;
  }
}

// fc rows n0 .. n0 + kRows - 1 of counterfactual I of group b at this
// thread's columns o0 .. o0 + 3 (rows past N hold finite values that the
// callers discard). s_attn holds the attention rows of I (stage_attention);
// bi and dl are bias and delta[b, I] at the thread's columns.
__device__ void fc_rows(float (&fc)[kRows][kCols], const float* s_attn,
                        const float* wa_b, const float* attn_mI,
                        const float* dws, const float* x_a, float4 bi,
                        float4 dl, int b, int I, int n0, int N, int H, int h,
                        int o0) {
  const int HM = H * N;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) fc[r][c] = 0.f;
  // attention x folded values
  const float* at = s_attn + (n0 / kRows) * HM * kRowsPad;
  // Blocks that share an SM work on different groups, so rows of wa come
  // from L2; unrolled, eight of them are in flight at once and the loop
  // waits on arithmetic instead of on their latency.
#pragma unroll 8
  for (int m = 0; m < HM; ++m) {
    const float4 w = load4(wa_b + static_cast<size_t>(m) * h + o0);
    const float4 a0 = load4(at + m * kRowsPad), a1 = load4(at + m * kRowsPad + 4),
                 a2 = load4(at + m * kRowsPad + 8);
    const float a_col[kRowsPad] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y,
                                   a1.z, a1.w, a2.x, a2.y, a2.z, a2.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float a = a_col[r];
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

// Non-affine LayerNorm statistics of the rows over the block's h columns,
// two-pass: centres fc in place (fc becomes fc - mean) and returns rstd.
// Every thread of the block must call it.
__device__ void center_rows(float (&fc)[kRows][kCols], float (&rstd)[kRows],
                            bool owns, int h, float* s_red) {
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
  for (int r = 0; r < kRows; ++r)
    rstd[r] = 1.0f / sqrtf(stat[r] / static_cast<float>(h) + kLnEps);
}

// ── Backward, stage 1: the rows of one (b, I) ──────────────────────────────

constexpr int kRowThreads = 128;  // threads of a rows block at most (h <= 512)

// d_fc of the N rows of counterfactual I of group b (to the scratch), and
// what needs no other block: d_delta[b, I], d_dws[b, :, I] and
// d_attn_mI[b, :, I, :]. One thread per 4 columns.
__global__ void __launch_bounds__(kRowThreads, 3) tail_bwd_rows_kernel(
    const float* __restrict__ attn_lhs, const float* __restrict__ attn_mI,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ d_fc, float* __restrict__ d_attn_mI,
    float* __restrict__ d_dws, float* __restrict__ d_delta, int N, int H,
    int h) {
  extern __shared__ float smem[];
  const int HM = H * N;
  float* s_attn = smem;                             // stage_attention
  float* s_ddws = smem + attention_floats(N, HM);   // H rows of h: d_dws[b, :, I]
  float* s_red = s_ddws + H * h;                    // (blockDim / 32) * kRows
  float* s_part = s_red + (blockDim.x / 32) * kRows;  // H * kRows * (blockDim / 32)

  const int b = blockIdx.x / N;
  const int I = blockIdx.x % N;
  const size_t bI = static_cast<size_t>(b) * N + I;
  const int o0 = threadIdx.x * kCols;
  const bool owns = o0 < h;
  const float rows = static_cast<float>(N);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;

  stage_attention(s_attn, attn_lhs + bI * N * HM, N, HM);
  __syncthreads();

  const float* wa_b = wa + static_cast<size_t>(b) * HM * h;
  float4 bi = make_float4(0.f, 0.f, 0.f, 0.f), dl = bi, go = bi;
  if (owns) {
    bi = load4(bias + o0);
    dl = load4(delta + bI * h + o0);
    go = load4(dout + bI * h + o0);
  }
  // pool backward: every row n of I gets dout[b, I] / N
  const float dy[kCols] = {go.x / rows, go.y / rows, go.z / rows, go.w / rows};
  float m1[1] = {owns ? ((dy[0] + dy[1]) + dy[2]) + dy[3] : 0.f};
  block_sum(m1, s_red);
  const float mean_dy = m1[0] / static_cast<float>(h);

  for (int n0 = 0; n0 < N; n0 += kRows) {
    float fc[kRows][kCols] = {};
    if (owns)
      fc_rows(fc, s_attn, wa_b, attn_mI, dws, x_a, bi, dl, b, I, n0, N, H, h,
              o0);
    float rstd[kRows], stat[kRows];
    center_rows(fc, rstd, owns, h, s_red);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        fc[r][c] *= rstd[r];  // y
        s += dy[c] * fc[r][c];
      }
      stat[r] = owns ? s : 0.f;
    }
    block_sum(stat, s_red);
    // fc becomes d_fc (rows past N hold finite values and are not stored)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float m2 = stat[r] / static_cast<float>(h);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        fc[r][c] = rstd[r] * ((dy[c] - mean_dy) - fc[r][c] * m2);
    }
    if (owns) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = n0 + r;
        if (n < N) {
          store4(d_fc + (bI * N + n) * h + o0, fc[r]);
          if (n == I) store4(d_delta + bI * h + o0, fc[r]);
        }
      }
    }
    // the rank-1 term's cotangents, one head at a time; the sums over o of
    // d_attn_mI go over the warp here and over the warps after the loop
    for (int hh = 0; hh < H; ++hh) {
      const size_t row = (static_cast<size_t>(b) * H + hh) * N + I;
      const float* am = attn_mI + row * N;
      const float4 dv =
          owns ? load4(dws + row * h + o0) : make_float4(0.f, 0.f, 0.f, 0.f);
      float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float a = (n0 + r < N) ? am[n0 + r] : 0.f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] += a * fc[r][c];
        stat[r] = ((fc[r][0] * dv.x + fc[r][1] * dv.y) + fc[r][2] * dv.z) +
                  fc[r][3] * dv.w;
      }
      if (owns) {
        float* s = s_ddws + hh * h + o0;  // this thread's own columns
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[c] = n0 > 0 ? s[c] + acc[c] : acc[c];
      }
      float part[kHalf];
      warp_sum_split(stat, part);
      if (lane % 16 == 0) {
#pragma unroll
        for (int i = 0; i < kHalf; ++i)
          s_part[(hh * kRows + (lane ? kHalf : 0) + i) * nwarps + warp] = part[i];
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < H * kRows; k += blockDim.x) {
      const int hh = k / kRows, n = n0 + k % kRows;
      if (n < N) {
        float x = 0.f;
        for (int w = 0; w < nwarps; ++w) x += s_part[k * nwarps + w];
        d_attn_mI[((static_cast<size_t>(b) * H + hh) * N + I) * N + n] = x;
      }
    }
  }
  if (owns) {
    for (int hh = 0; hh < H; ++hh) {
      const float* s = s_ddws + hh * h + o0;
      const float v[kCols] = {s[0], s[1], s[2], s[3]};
      store4(d_dws + ((static_cast<size_t>(b) * H + hh) * N + I) * h + o0, v);
    }
  }
}

// ── Backward, stage 2: d_wa[b] = attn_lhs[b]^T d_fc[b], d_xa, d_bias ───────

constexpr int kWaThreads = 320;  // 20 x 16 threads, 4 x 8 outputs each
constexpr int kWaRows = 80;      // rows m of d_wa per block
constexpr int kWaCols = 128;     // columns o per block, two runs of 64
constexpr int kWaTm = kWaRows / 4;  // threads down the rows: 20

// Floats of shared memory of tail_bwd_wa_kernel: two stages of the N rows
// of a K-slice of both operands (the first N * kWaCols of them hold the
// tile of d_xa at the end).
__host__ __device__ inline int wa_smem_floats(int N) {
  return 2 * N * (kWaRows + kWaCols);
}

// XaRows: rows n of d_xa per thread, ceil(N / kWaTm) (1 at N <= 20), so
// that the main path keeps 8 registers of d_xa, not 16.
template <int XaRows>
__global__ void __launch_bounds__(kWaThreads, 2) tail_bwd_wa_kernel(
    const float* __restrict__ attn_lhs, const float* __restrict__ d_fc,
    float* __restrict__ d_wa, float* __restrict__ d_xa,
    float* __restrict__ d_bias_part, int N, int HM, int h) {
  // K-slice I: the N rows I*N .. I*N+N-1 of both operands
  extern __shared__ float smem[];  // 16-byte aligned, as every dynamic base
  float* s_a = smem;                       // [stage][n][kWaRows]: attn_lhs[b]
  float* s_d = smem + 2 * N * kWaRows;     // [stage][n][kWaCols]: d_fc[b]
  const int col_tiles = (h + kWaCols - 1) / kWaCols;
  const int tiles = col_tiles * ((HM + kWaRows - 1) / kWaRows);
  const int b = blockIdx.x / tiles;
  const int m0 = (blockIdx.x % tiles) / col_tiles * kWaRows;
  const int t0 = (blockIdx.x % col_tiles) * kWaCols;
  const int tid = threadIdx.x, tn = tid % 16, tm = tid / 16;
  const size_t NN = static_cast<size_t>(N) * N;
  const float* a_b = attn_lhs + b * NN * HM;
  const float* d_b = d_fc + b * NN * h;

  const int a_chunks = N * (kWaRows / 4), all_chunks = a_chunks + N * (kWaCols / 4);
  auto load_slice = [&](int stage, int I) {
    for (int q = tid; q < all_chunks; q += kWaThreads) {
      if (q < a_chunks) {
        const int n = q / (kWaRows / 4), j = q % (kWaRows / 4) * 4;
        const bool ok = m0 + j < HM;
        cp_async16(s_a + (stage * N + n) * kWaRows + j,
                   ok ? a_b + (static_cast<size_t>(I) * N + n) * HM + m0 + j : a_b,
                   ok ? 16 : 0);
      } else {
        const int n = (q - a_chunks) / (kWaCols / 4),
                  j = (q - a_chunks) % (kWaCols / 4) * 4;
        const bool ok = t0 + j < h;
        cp_async16(s_d + (stage * N + n) * kWaCols + j,
                   ok ? d_b + (static_cast<size_t>(I) * N + n) * h + t0 + j : d_b,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[4][8] = {};  // rows tm*4 + i; columns tn*4 + j and 64 + tn*4 + j
  float xa[XaRows][8] = {};  // d_xa rows tm + kWaTm * k, the same columns
  load_slice(0, 0);
  for (int I = 0; I < N; ++I) {
    const int st = I & 1;
    if (I + 1 < N) {
      load_slice(st ^ 1, I + 1);  // over slice I - 1, done (the loop's last barrier)
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice I is in shared memory for every thread
    const float* sa = s_a + st * N * kWaRows + tm * 4;
    const float* sd = s_d + st * N * kWaCols + tn * 4;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float4 a = load4(sa + n * kWaRows);
      const float4 d0 = load4(sd + n * kWaCols), d1 = load4(sd + n * kWaCols + 64);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * dv[j];
    }
    // d_xa[n, tile] += d_fc[I*N + n, tile], from the same staged slice
#pragma unroll
    for (int k = 0; k < XaRows; ++k) {
      const int n = tm + kWaTm * k;
      if (n < N) {
        const float4 d0 = load4(sd + n * kWaCols), d1 = load4(sd + n * kWaCols + 64);
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) xa[k][j] += dv[j];
      }
    }
    __syncthreads();  // every thread is done with slice I's stage
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    float* dst = d_wa + (static_cast<size_t>(b) * HM + m) * h + t0 + tn * 4;
    const float lo[kCols] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
    const float hi[kCols] = {acc[i][4], acc[i][5], acc[i][6], acc[i][7]};
    if (m < HM && t0 + tn * 4 < h) store4(dst, lo);
    if (m < HM && t0 + 64 + tn * 4 < h) store4(dst + 64, hi);
  }
  if (m0 > 0) return;  // d_xa and d_bias come from the first row tile
  float* s_x = smem;  // [n][kWaCols]: d_xa of the tile (the stages are done)
#pragma unroll
  for (int k = 0; k < XaRows; ++k) {
    const int n = tm + kWaTm * k;
    if (n >= N) continue;
    const float lo[kCols] = {xa[k][0], xa[k][1], xa[k][2], xa[k][3]};
    const float hi[kCols] = {xa[k][4], xa[k][5], xa[k][6], xa[k][7]};
    store4(s_x + n * kWaCols + tn * 4, lo);
    store4(s_x + n * kWaCols + 64 + tn * 4, hi);
    float* dst = d_xa + (static_cast<size_t>(b) * N + n) * h + t0 + tn * 4;
    if (t0 + tn * 4 < h) store4(dst, lo);
    if (t0 + 64 + tn * 4 < h) store4(dst + 64, hi);
  }
  __syncthreads();
  if (tid < kWaCols && t0 + tid < h) {
    float s = 0.f;
    for (int n = 0; n < N; ++n) s += s_x[n * kWaCols + tid];
    d_bias_part[static_cast<size_t>(b) * h + t0 + tid] = s;
  }
}

// d_bias[o] = sum over b of part[b, o], in order of b.
__global__ void sum_over_groups_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int B, int h) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= h) return;
  float s = 0.f;
#pragma unroll 8
  for (int b = 0; b < B; ++b) s += part[static_cast<size_t>(b) * h + o];
  out[o] = s;
}

// ── Backward, stage 3: d_attn_lhs[b] = d_fc[b] wa[b]^T ─────────────────────

constexpr int kAtThreads = 256;       // 16 x 16 threads, 5 x 5 outputs each
constexpr int kAtTile = 80;           // rows I*N+n and columns m per block
constexpr int kAtK = 32;              // columns o per K-slice
constexpr int kAtStride = kAtK + 4;   // staged row: an odd number of 16 bytes
// bytes of shared memory: two stages of both operands' K-slices
constexpr int kAtSmem = 2 * 2 * kAtTile * kAtStride * sizeof(float);

__global__ void __launch_bounds__(kAtThreads, 2) tail_bwd_attn_kernel(
    const float* __restrict__ d_fc, const float* __restrict__ wa,
    float* __restrict__ d_attn_lhs, int NN, int HM, int h) {
  extern __shared__ float smem[];
  auto s_f = reinterpret_cast<float(*)[kAtTile][kAtStride]>(smem);  // d_fc rows
  auto s_w = s_f + 2;                                                // wa rows
  const int col_tiles = (HM + kAtTile - 1) / kAtTile;
  const int tiles = col_tiles * ((NN + kAtTile - 1) / kAtTile);
  const int b = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) / col_tiles * kAtTile;
  const int c0 = (blockIdx.x % col_tiles) * kAtTile;
  const int tid = threadIdx.x, tc = tid % 16, tr = tid / 16;
  const float* f_b = d_fc + static_cast<size_t>(b) * NN * h;
  const float* w_b = wa + static_cast<size_t>(b) * HM * h;

  constexpr int kChunks = kAtTile * (kAtK / 4);  // 16-byte chunks per operand
  auto load_slice = [&](int stage, int k0) {
    for (int q = tid; q < 2 * kChunks; q += kAtThreads) {
      const bool is_w = q >= kChunks;
      const int row = (q % kChunks) / (kAtK / 4), j = q % (kAtK / 4) * 4;
      const int src_row = (is_w ? c0 : r0) + row;
      const bool ok = src_row < (is_w ? HM : NN) && k0 + j < h;
      const float* base = is_w ? w_b : f_b;
      cp_async16(is_w ? &s_w[stage][row][j] : &s_f[stage][row][j],
                 ok ? base + static_cast<size_t>(src_row) * h + k0 + j : base,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[5][5] = {};  // rows tr + 16 * i, columns tc + 16 * j
  const int slices = (h + kAtK - 1) / kAtK;
  load_slice(0, 0);
  for (int s = 0; s < slices; ++s) {
    const int st = s & 1;
    if (s + 1 < slices) {
      load_slice(st ^ 1, (s + 1) * kAtK);  // over slice s - 1, done
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kAtK; k += 4) {
      float4 a[5], w[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) a[i] = load4(&s_f[st][tr + 16 * i][k]);
#pragma unroll
      for (int j = 0; j < 5; ++j) w[j] = load4(&s_w[st][tc + 16 * j][k]);
#pragma unroll
      for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          acc[i][j] += a[i].x * w[j].x;
          acc[i][j] += a[i].y * w[j].y;
          acc[i][j] += a[i].z * w[j].z;
          acc[i][j] += a[i].w * w[j].w;
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r = r0 + tr + 16 * i;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int c = c0 + tc + 16 * j;
      if (r < NN && c < HM)
        d_attn_lhs[(static_cast<size_t>(b) * NN + r) * HM + c] = acc[i][j];
    }
  }
}

int threads_for(int h) { return ((h / kCols + 31) / 32) * 32; }

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The backward's kernels take h % 4 == 0 and h <= 512 (one rows block of
// at most kRowThreads threads), N <= kMaxN, and H * N % 4 == 0 (16-byte rows
// of attn_lhs); the Python wrapper refuses other shapes first.
bool backward_shape_ok(int B, int N, int H, int h) {
  return B > 0 && N > 0 && N <= kMaxN && H > 0 && (H * N) % 4 == 0 &&
         h > 0 && h % kCols == 0 && threads_for(h) <= kRowThreads;
}

}  // namespace

extern "C" {

// The backward, in three launches on one stream (the Python wrapper makes
// them in this order). Each returns cudaGetLastError() after its launch
// (0 = success), or cudaErrorInvalidValue for shapes the kernels do not
// take (backward_shape_ok).

// Stage 1: d_fc (B, N*N, h) scratch, d_attn_mI, d_dws, d_delta.
int tail_bwd_rows_launch(const float* attn_lhs, const float* attn_mI,
                         const float* wa, const float* dws, const float* x_a,
                         const float* delta, const float* bias,
                         const float* dout, float* d_fc, float* d_attn_mI,
                         float* d_dws, float* d_delta, int B, int N, int H,
                         int h, void* stream) {
  if (!backward_shape_ok(B, N, H, h))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_for(h);
  const size_t smem = (static_cast<size_t>(attention_floats(N, H * N)) +
                       static_cast<size_t>(H) * h +
                       static_cast<size_t>(H + 1) * (threads / 32) * kRows) *
                      sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(tail_bwd_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_bwd_rows_kernel<<<B * N, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      attn_lhs, attn_mI, wa, dws, x_a, delta, bias, dout, d_fc, d_attn_mI,
      d_dws, d_delta, N, H, h);
  return static_cast<int>(cudaGetLastError());
}

// Stage 2: d_wa, d_xa, and d_bias through the (B, h) scratch d_bias_part.
int tail_bwd_wa_launch(const float* attn_lhs, const float* d_fc, float* d_wa,
                       float* d_xa, float* d_bias, float* d_bias_part, int B,
                       int N, int H, int h, void* stream) {
  if (!backward_shape_ok(B, N, H, h))
    return static_cast<int>(cudaErrorInvalidValue);
  const int HM = H * N;
  const int tiles = ((HM + kWaRows - 1) / kWaRows) * ((h + kWaCols - 1) / kWaCols);
  const size_t smem = static_cast<size_t>(wa_smem_floats(N)) * sizeof(float);
  static_assert(2 * kWaTm >= kMaxN, "two rows of d_xa a thread cover kMaxN");
  auto* kernel = N <= kWaTm ? tail_bwd_wa_kernel<1> : tail_bwd_wa_kernel<2>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<B * tiles, kWaThreads, smem, s>>>(attn_lhs, d_fc, d_wa, d_xa,
                                             d_bias_part, N, HM, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_over_groups_kernel<<<(h + 127) / 128, 128, 0, s>>>(d_bias_part, d_bias,
                                                          B, h);
  return static_cast<int>(cudaGetLastError());
}

// Stage 3: d_attn_lhs.
int tail_bwd_attn_launch(const float* d_fc, const float* wa, float* d_attn_lhs,
                         int B, int N, int H, int h, void* stream) {
  if (!backward_shape_ok(B, N, H, h))
    return static_cast<int>(cudaErrorInvalidValue);
  const int NN = N * N, HM = H * N;
  const int tiles = ((NN + kAtTile - 1) / kAtTile) * ((HM + kAtTile - 1) / kAtTile);
  const cudaError_t err = allow_smem(tail_bwd_attn_kernel, kAtSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_bwd_attn_kernel<<<B * tiles, kAtThreads, kAtSmem,
                         static_cast<cudaStream_t>(stream)>>>(d_fc, wa, d_attn_lhs,
                                                              NN, HM, h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
