// Forward (K3f) and backward (K3b) of the counterfactual-baseline tail of
// POCACritic.all_baselines, for Hopper (sm_90a).
//
// Replaces (TPU kernels): swarmacb_tpu/ops/baseline_tail.py: fused_tail, its
// forward _fused_tail_fwd (Pallas body _fwd_kernel) and its backward
// _fused_tail_bwd (Pallas body _bwd_kernel).
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
// ── Forward ────────────────────────────────────────────────────────────────
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
// read ceil(N / kRows) times per block. Blocks that share an SM belong to
// different groups, so those rows come from L2: the loop over them is
// unrolled by 8 to keep eight loads in flight. Built with -maxrregcount=168,
// three blocks share an SM. LayerNorm statistics of the rows are block
// reductions (warp shuffles, then one shared-memory step), and the pooled
// row accumulates in registers until the single store.
//
// ── Backward ───────────────────────────────────────────────────────────────
// Given dout (B, N, h), with d_y = dout[b, I] / N on every row n and
//   d_fc[I, n, :] = rstd * (d_y - mean(d_y) - y * mean(d_y * y)),
// it emits the cotangents of all seven inputs:
//   d_attn_lhs[I*N+n, m] = sum_o d_fc[I,n,o] wa[m,o]        (contract o)
//   d_attn_mI[h, I, n]   = sum_o d_fc[I,n,o] dws[h,I,o]     (contract o)
//   d_wa[m, o]           = sum_{I,n} attn_lhs[I*N+n, m] d_fc[I,n,o]
//   d_dws[h, I, o]       = sum_n attn_mI[h,I,n] d_fc[I,n,o]
//   d_xa[n, o]           = sum_I d_fc[I,n,o]
//   d_delta[I, o]        = d_fc[I,I,o]
//   d_bias[o]            = sum_{b,I,n} d_fc[I,n,o]
//
// What bounds it: arithmetic, three products of the fc tile's size (the fc
// recompute, d_attn_lhs and d_wa, 2*H*N operations per fc element each):
// ~110 GFLOP at the main path's shapes, ~1.6 ms at 67 TFLOP/s, against
// ~1.2 GB of inputs and cotangents (~0.35 ms at 3.35 TB/s).
//
// Design: the TPU kernel walks groups in one sequential grid and carries
// d_bias from step to step; blocks on Hopper run in no order. Three sums
// cross the blocks of a (b, I) split: the contractions over o, the sums
// over I (d_wa, d_xa) and the sum over groups (d_bias). So one block owns a
// whole group b and loops over I inside:
//   1. stage attention rows of I; recompute fc rows kRows at a time exactly
//      as the forward does (thread = 4 columns); LayerNorm statistics and
//      mean(d_y * y) are block reductions; d_fc goes to shared memory
//      (N x h); d_xa[b] accumulates in device memory in this thread's own
//      columns; d_delta is written; the group's d_bias partial stays in
//      registers;
//   2. with all N rows of d_fc in shared memory: d_wa[b] accumulates in
//      device memory in this thread's own columns (kM rows of wa per batch
//      of loads, written once per I), and d_dws[b, :, I] is written;
//   3. the contractions over o: one thread per row of wa[b] (and of
//      dws[b, :, I]) takes its dot products with all N rows of d_fc.
// No other thread touches a thread's columns, so the sums in device memory
// need no atomics. A second small kernel sums the (B, h) d_bias partials
// over b in a fixed order. Every sum has a fixed order: the result is the
// same on every run. fc never reaches device memory. The block uses
// ~48 KB of shared memory and (built with -maxrregcount=168) 168
// registers a thread, so three blocks of 128 threads share an SM. At the
// main-path shape step 1 takes about 40 % of the time, step 3 about a
// third and step 2 a quarter (scripts/time_tail_backward.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 4;   // output columns per thread (float4)
constexpr int kRows = 10;  // fc rows accumulated per pass over wa
constexpr int kRowsPad = 12;  // kRows rounded up to whole float4s
constexpr int kM = 16;     // rows of d_wa updated per batch of loads
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

__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ inline void store4(float* p, const float (&v)[kCols]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

// attn_lhs[b, I*N + n, m] of the staged counterfactual.
__device__ inline float attention_at(const float* s_attn, int n, int m,
                                     int HM) {
  return s_attn[((n / kRows) * HM + m) * kRowsPad + n % kRows];
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

__global__ void fused_tail_fwd_kernel(
    const float* __restrict__ attn_lhs, const float* __restrict__ attn_mI,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ out, int N, int H,
    int h) {
  extern __shared__ float smem[];
  const int HM = H * N;
  float* s_attn = smem;                                // stage_attention
  float* s_red = smem + attention_floats(N, HM);       // (blockDim / 32) * kRows

  const int b = blockIdx.x / N;
  const int I = blockIdx.x % N;
  const int o0 = threadIdx.x * kCols;
  const bool owns = o0 < h;

  stage_attention(s_attn, attn_lhs + (static_cast<size_t>(b) * N + I) * N * HM,
                  N, HM);
  __syncthreads();

  const float* wa_b = wa + static_cast<size_t>(b) * HM * h;
  float4 bi = make_float4(0.f, 0.f, 0.f, 0.f), dl = bi;
  if (owns) {
    bi = load4(bias + o0);
    dl = load4(delta + (static_cast<size_t>(b) * N + I) * h + o0);
  }
  float pooled[kCols] = {0.f, 0.f, 0.f, 0.f};

  for (int n0 = 0; n0 < N; n0 += kRows) {
    float fc[kRows][kCols] = {};
    if (owns)
      fc_rows(fc, s_attn, wa_b, attn_mI, dws, x_a, bi, dl, b, I, n0, N, H, h,
              o0);
    float rstd[kRows];
    center_rows(fc, rstd, owns, h, s_red);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (n0 + r < N) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) pooled[c] += fc[r][c] * rstd[r];
      }
    }
  }

  if (owns) {
    const float rows = static_cast<float>(N);
    const float res[kCols] = {pooled[0] / rows, pooled[1] / rows,
                              pooled[2] / rows, pooled[3] / rows};
    store4(out + (static_cast<size_t>(b) * N + I) * h + o0, res);
  }
}

__global__ void fused_tail_bwd_kernel(
    const float* __restrict__ attn_lhs, const float* __restrict__ attn_mI,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ d_attn_lhs, float* __restrict__ d_attn_mI,
    float* __restrict__ d_wa, float* __restrict__ d_dws,
    float* __restrict__ d_xa, float* __restrict__ d_delta,
    float* __restrict__ d_bias_part, int N, int H, int h) {
  extern __shared__ float smem[];
  const int HM = H * N;
  float* s_attn = smem;                             // stage_attention
  float* s_dfc = smem + attention_floats(N, HM);    // N rows of h: d_fc of I
  float* s_red = s_dfc + N * h;                     // (blockDim / 32) * kRows

  const int b = blockIdx.x;
  const int o0 = threadIdx.x * kCols;
  const bool owns = o0 < h;
  const float rows = static_cast<float>(N);
  const float* wa_b = wa + static_cast<size_t>(b) * HM * h;
  float* d_wa_b = d_wa + static_cast<size_t>(b) * HM * h;
  float* d_xa_b = d_xa + static_cast<size_t>(b) * N * h;
  const float4 bi = owns ? load4(bias + o0) : make_float4(0.f, 0.f, 0.f, 0.f);
  float bias_acc[kCols] = {0.f, 0.f, 0.f, 0.f};

  for (int I = 0; I < N; ++I) {
    const size_t bI = static_cast<size_t>(b) * N + I;
    __syncthreads();  // the previous I is done with s_attn and s_dfc
    stage_attention(s_attn, attn_lhs + bI * N * HM, N, HM);
    __syncthreads();

    float4 dl = make_float4(0.f, 0.f, 0.f, 0.f), go = dl;
    if (owns) {
      dl = load4(delta + bI * h + o0);
      go = load4(dout + bI * h + o0);
    }
    // pool backward: every row n of I gets dout[b, I] / N
    const float dy[kCols] = {go.x / rows, go.y / rows, go.z / rows,
                             go.w / rows};
    float m1[1] = {owns ? ((dy[0] + dy[1]) + dy[2]) + dy[3] : 0.f};
    block_sum(m1, s_red);
    const float mean_dy = m1[0] / static_cast<float>(h);

    // 1. d_fc of the N rows of I, kRows at a time
    for (int n0 = 0; n0 < N; n0 += kRows) {
      float fc[kRows][kCols] = {};
      if (owns)
        fc_rows(fc, s_attn, wa_b, attn_mI, dws, x_a, bi, dl, b, I, n0, N, H,
                h, o0);
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
      if (!owns) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = n0 + r;
        if (n >= N) break;
        const float m2 = stat[r] / static_cast<float>(h);
        float d[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          d[c] = rstd[r] * ((dy[c] - mean_dy) - fc[r][c] * m2);
        store4(s_dfc + n * h + o0, d);
        float xa[kCols] = {d[0], d[1], d[2], d[3]};
        if (I > 0) {
          const float4 acc = load4(d_xa_b + n * h + o0);
          xa[0] += acc.x, xa[1] += acc.y, xa[2] += acc.z, xa[3] += acc.w;
        }
        store4(d_xa_b + n * h + o0, xa);
#pragma unroll
        for (int c = 0; c < kCols; ++c) bias_acc[c] += d[c];
        if (n == I) store4(d_delta + bI * h + o0, d);
      }
    }
    __syncthreads();  // s_dfc holds all N rows of I

    // 2. this thread's columns of d_dws[b, :, I] and d_wa[b]
    if (owns) {
      for (int hh = 0; hh < H; ++hh) {
        const size_t row = (static_cast<size_t>(b) * H + hh) * N + I;
        const float* am = attn_mI + row * N;
        float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
        for (int n = 0; n < N; ++n) {
          const float a = am[n];
          const float4 d = load4(s_dfc + n * h + o0);
          acc[0] += a * d.x, acc[1] += a * d.y, acc[2] += a * d.z,
              acc[3] += a * d.w;
        }
        store4(d_dws + row * h + o0, acc);
      }
      for (int m0 = 0; m0 < HM; m0 += kM) {
        float acc[kM][kCols];
#pragma unroll
        for (int k = 0; k < kM; ++k) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (I > 0 && m0 + k < HM)
            v = load4(d_wa_b + static_cast<size_t>(m0 + k) * h + o0);
          acc[k][0] = v.x, acc[k][1] = v.y, acc[k][2] = v.z, acc[k][3] = v.w;
        }
        for (int n = 0; n < N; ++n) {
          const float4 d = load4(s_dfc + n * h + o0);
#pragma unroll
          for (int k = 0; k < kM; ++k) {
            const float a =
                (m0 + k < HM) ? attention_at(s_attn, n, m0 + k, HM) : 0.f;
            acc[k][0] += a * d.x;
            acc[k][1] += a * d.y;
            acc[k][2] += a * d.z;
            acc[k][3] += a * d.w;
          }
        }
#pragma unroll
        for (int k = 0; k < kM; ++k)
          if (m0 + k < HM)
            store4(d_wa_b + static_cast<size_t>(m0 + k) * h + o0, acc[k]);
      }
    }

    // 3. contractions over o: row j of wa[b] (j < HM) or of dws[b, :, I]
    for (int j = threadIdx.x; j < HM + H; j += blockDim.x) {
      const float* w =
          j < HM ? wa_b + static_cast<size_t>(j) * h
                 : dws + ((static_cast<size_t>(b) * H + (j - HM)) * N + I) * h;
      float acc[kMaxN];
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) acc[n] = 0.f;
      float4 wv_next = load4(w);  // the row's next float4, one step ahead
      for (int o = 0; o < h; o += kCols) {
        const float4 wv = wv_next;
        if (o + kCols < h) wv_next = load4(w + o + kCols);
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) {
          if (n < N) {
            const float4 d = load4(s_dfc + n * h + o);
            acc[n] += ((d.x * wv.x + d.y * wv.y) + d.z * wv.z) + d.w * wv.w;
          }
        }
      }
      if (j < HM) {
#pragma unroll
        for (int n = 0; n < kMaxN; ++n)
          if (n < N) d_attn_lhs[(bI * N + n) * HM + j] = acc[n];
      } else {
        float* dst = d_attn_mI + ((static_cast<size_t>(b) * H + (j - HM)) * N + I) * N;
#pragma unroll
        for (int n = 0; n < kMaxN; ++n)
          if (n < N) dst[n] = acc[n];
      }
    }
  }

  if (owns) store4(d_bias_part + static_cast<size_t>(b) * h + o0, bias_acc);
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

int threads_for(int h) { return ((h / kCols + 31) / 32) * 32; }

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success). Needs h % 4 == 0
// and 16-byte aligned pointers (checked by the Python wrapper).
int fused_tail_fwd_launch(const float* attn_lhs, const float* attn_mI,
                          const float* wa, const float* dws, const float* x_a,
                          const float* delta, const float* bias, float* out,
                          int B, int N, int H, int h, void* stream) {
  const int threads = threads_for(h);
  if (h % kCols != 0 || threads > 1024 || B <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(attention_floats(N, H * N)) + (threads / 32) * kRows) *
      sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(fused_tail_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_tail_fwd_kernel<<<B * N, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      attn_lhs, attn_mI, wa, dws, x_a, delta, bias, out, N, H, h);
  return static_cast<int>(cudaGetLastError());
}

// The cotangents of the seven inputs for dout; d_bias_part is (B, h)
// scratch. Returns cudaGetLastError() after the two launches (0 = success),
// or cudaErrorInvalidValue for shapes the kernel does not take (N > 32, or
// more shared memory than a block has: about 4 * (1.2*N*H*N + N*h) bytes).
int fused_tail_bwd_launch(const float* attn_lhs, const float* attn_mI,
                          const float* wa, const float* dws, const float* x_a,
                          const float* delta, const float* bias,
                          const float* dout, float* d_attn_lhs,
                          float* d_attn_mI, float* d_wa, float* d_dws,
                          float* d_xa, float* d_delta, float* d_bias,
                          float* d_bias_part, int B, int N, int H, int h,
                          void* stream) {
  const int threads = threads_for(h);
  if (h % kCols != 0 || threads > 1024 || B <= 0 || N <= 0 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(attention_floats(N, H * N)) +
                       static_cast<size_t>(N) * h + (threads / 32) * kRows) *
                      sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(fused_tail_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_tail_bwd_kernel<<<B, threads, smem, s>>>(
      attn_lhs, attn_mI, wa, dws, x_a, delta, bias, dout, d_attn_lhs,
      d_attn_mI, d_wa, d_dws, d_xa, d_delta, d_bias_part, N, H, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_over_groups_kernel<<<(h + 127) / 128, 128, 0, s>>>(d_bias_part, d_bias,
                                                          B, h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
