// Forward (K5f) and backward (K5b) of the fused counterfactual attention of
// POCACritic.all_baselines (fused_attention=True), for Hopper (sm_90a).
//
// Replaces (TPU kernels): swarmacb_tpu/ops/cf_attention.py:
// fused_cf_attention, its forward _cf_fwd (Pallas body _fwd_kernel) and its
// backward _cf_bwd (Pallas body _bwd_kernel).
//
// Inputs (B groups, H heads, N agents, h hidden; float32, contiguous):
//   S_aa, S_as, S_sa (B, H, N, N)  raw scores q_a.k_a, q_a.k_s, q_s.k_a
//   S_ss (B, H, N, 1)              the diagonal q_s.k_s
//   wa, dws (B, H, N, h)           W_out-folded values v_a.W, (v_s - v_a).W
//   x_a, delta (B, N, h)           residual entities x_a and x_s - x_a
//   bias (h)                       fc_out's bias
// Output: pooled (B, N, h).
//
// For counterfactual agent I the score row of agent n differs from a shared
// base row in one element (row n != I: S_aa[n, :] with m = I taken from
// S_as[n, I]; row n = I: S_sa[I, :] with m = I taken from S_ss[I]). So per
// group and head, with P = S / sqrt(d) and row maxes shared over I:
//   M[n]     = max(max_m P_aa[n, m], max_m P_as[n, m])
//   E_aa     = exp(P_aa - M),  E_as = exp(P_as - M),  Z_b[n] = sum_m E_aa[n, m]
//   zc[n, I] = E_as[n, I] - E_aa[n, I],  Z[n, I] = Z_b[n] + zc[n, I]
//   ctx[n, I, :] = ((sum_m E_aa[n, m] wa[m, :] + zc[n, I] wa[I, :])
//                   + E_as[n, I] dws[I, :]) / Z[n, I]                (n != I)
// and for the row n = I the same form with the base row E_sa[I, :] (its max
// M2 over P_sa[I, :] and P_ss[I]), zc2[I] = E_ss[I] - E_sa[I, I] in place of
// zc, E_ss[I] in place of E_as[n, I] and Z2[I] = sum_m E_sa[I, m] + zc2[I] in
// place of Z. Then
//   fc[n, I, :] = sum over heads of ctx + x_a[n] + bias + (n == I) delta[I]
//   y           = LayerNorm(fc[n, I, :])   (non-affine, eps 1e-5, two-pass)
//   pooled[I]   = mean_n y[n, I, :].
// Scores are divided by sqrt(d) and cotangents of the scores divided by it,
// as the plain version's `scores / sqrt(d)` and its autograd do.
//
// ── Forward (K5f) ─────────────────────────────────────────────────────────
// What bounds it on the H100: at the main path's B = 1024, H = 4, N = 20,
// h = 512 the function reads ~440 MB and writes ~42 MB (~0.14 ms at
// 3.35 TB/s) and needs ~10 GFLOP (~0.15 ms at the 67 TFLOP/s f32 rate):
// both about equal (chip_smoke._cf_forward_work computes the exact numbers).
//
// Design: K3f's (baseline_tail.cu). One block per (b, I), b-major, so the N
// blocks of a group run close together and L2 serves their re-reads of wa[b].
// The block first computes the softmax terms of its counterfactual for every
// head and row (one thread per (head, row), N + 1 exponentials each) into
// shared memory. Each thread owns 4 adjacent output columns and builds kRows
// rows of fc at a time in registers: per head, the base rows times wa_h (a
// loop over m of one float4 of wa_h and kRows multiply-adds per column), then
// the rank-1 corrections and the division by the row's partition. LayerNorm
// statistics are block reductions, and the pooled row accumulates in
// registers until the single store; fc never reaches device memory.
// The trade-off: every (b, I) block recomputes the base product sum_m E_aa wa
// of all N rows, so the kernel does N times the ~0.8 MFLOP per head and group
// that the algorithm needs (~34 GFLOP of multiply-adds in all, as K3f does).
// Computing it once per group would need either H*N*h floats (160 KB at
// h = 512) of shared memory in a block per group, one block and four warps
// an SM, or a round trip through device memory; both are left for a later
// version.
//
// ── Backward (K5b) ────────────────────────────────────────────────────────
// Given dout (B, N, h): d_y = dout[b, I] / N on every row n of I, and
//   d_fc = rstd * ((d_y - mean(d_y)) - y * mean(d_y * y)).
// Per head, with dctx = d_fc / Z (the row's own partition, Z2 on n = I):
//   dZ       = -sum_o ctx * dctx,   d_zc = sum_o dctx wa[I] + dZ,
//   d_Eas    = sum_o dctx dws[I] + d_zc,
//   d_num[n] = sum_{I != n} dctx[n, I]         (the base product's cotangent)
//   d_Eaa[n, m] = -d_zc[n, m] + sum_I dZ[n, I] + sum_o d_num[n, o] wa[m, o]
//   d_wa[m]  = sum_n corr[n, m] dctx[n, m] + sum_n E_aa[n, m] d_num[n]
//              + sum_I E_sa[I, m] dctx[I, I]
//   d_dws[I] = sum_n rep[n, I] dctx[n, I]
//   d_Esa[I, m] = dZ2[I] - (m == I) d_zc2[I] + sum_o dctx[I, I, o] wa[m, o]
// (corr is zc or zc2, rep is E_as or E_ss), and dS = E * d_E / sqrt(d) for
// each of the four score tensors (the row maxes are constants, as in
// jax.nn.softmax). d_xa[n] = sum_I d_fc[n, I], d_delta[I] = d_fc[I, I],
// d_bias = sum over b, I, n of d_fc.
//
// What bounds it: ~29 GFLOP (~0.43 ms at 67 TFLOP/s) against ~0.92 GB of
// inputs and cotangents (~0.28 ms at 3.35 TB/s): operations
// (chip_smoke._cf_backward_work).
//
// Design: the TPU kernel walks groups in one sequential grid and carries
// d_bias from step to step; blocks on Hopper run in no order, and the sums
// over I (d_xa, d_num, the sum of dZ), over n (d_wa, d_dws) and the
// contractions over o all cross a (b, I) split. So one block owns a group b:
//   0. the softmax terms of the whole group (E_aa, E_as, E_sa as H*N*N
//      arrays, Z_b, E_ss, zc2, Z2) go to shared memory; each thread writes
//      the base product num_h[n] = sum_m E_aa[n, m] wa_h[m] of every head
//      and row in its own columns to a (B, H, N, h) scratch, once per group,
//      and zeroes its columns of the d_num scratch;
//   1. for each I, kRowsB rows at a time: pass 1 rebuilds fc from num (row I
//      from E_sa[I, :] wa_h, computed at the start of I into shared memory),
//      LayerNorm and d_fc follow as in K3b; pass 2 walks the heads again,
//      rebuilds each head's ctx rows, and takes the three dot products over
//      o of each row (block reductions); d_num, d_xa, and this I's rows of
//      d_wa and d_dws accumulate in device memory in the thread's own
//      columns; the scalar cotangents of the rows go straight to dS_as and
//      dS_ss, or to shared memory (d_Eaa, sum of dZ);
//   2. at the end of I, the N dot products of dctx[I, I] with the rows of
//      wa_h give row I of dS_sa (one thread per head and row of wa_h);
//   3. after the loop: d_wa_h[m] gains E_aa^T d_num and E_sa^T dctx[I, I]
//      (dctx[I, I] = d_delta[I] / Z2[I], recomputed bit for bit), and
//      d_Eaa's contraction over o is taken with d_num staged in shared
//      memory, one thread per row of wa_h, as in K3b's step 3.
// No other thread touches a thread's columns, so the sums in device memory
// need no atomics. d_bias sums over n within each I, then over I, per group;
// a second small kernel sums the (B, h) partials over b in runs of 32.
// Every sum has a fixed order: the result is the same on every run. fc never
// reaches device memory.
//
// What the H100 showed (scripts/time_cf_backward.py, PERF.md): the kernel is
// bound neither by arithmetic nor by bandwidth but by latency. Each thread's
// loads from the scratch miss L2 (the 396 resident groups hold ~250 MB), so
// the row loops are written without branches and issue each chunk's loads
// together before the arithmetic; fewer resident blocks were slower, not
// faster. The body is also long (some 14,000 instructions), and the step that
// replaced a 32-wide unrolled block reduction by one loop per (head, row)
// gained the most.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 4;    // output columns per thread (float4)
constexpr int kRows = 10;   // fc rows per pass in the forward
constexpr int kRowsB = 5;   // fc rows per pass in the backward
constexpr int kM = 10;      // rows of d_wa updated per batch in step 3
constexpr int kMaxN = 32;   // agents per group the backward takes
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

__device__ inline void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ inline float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ inline float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ inline float dot4(float4 a, float4 b) {
  return ((a.x * b.x + a.y * b.y) + a.z * b.z) + a.w * b.w;
}

// The scaled score s / sqrt(d), rounded as the plain version's division.
__device__ inline float scaled(float s, float sqrt_d) {
  return __fdiv_rn(s, sqrt_d);
}

// Row max of an off-diagonal row n: over P_aa[n, :] and P_as[n, :].
__device__ float off_max(const float* s_aa, const float* s_as, int N,
                         float sqrt_d) {
  float M = -INFINITY;
  for (int m = 0; m < N; ++m)
    M = fmaxf(M, fmaxf(scaled(s_aa[m], sqrt_d), scaled(s_as[m], sqrt_d)));
  return M;
}

// E_aa[n, :] (and E_as[n, :] unless e_as is null) of an off-diagonal row
// with row max M; returns Z_b[n] = sum_m E_aa[n, m], summed in order of m.
__device__ float off_row(const float* s_aa, const float* s_as, int N,
                         float sqrt_d, float M, float* e_aa, float* e_as) {
  float zb = 0.f;
  for (int m = 0; m < N; ++m) {
    const float e = expf(scaled(s_aa[m], sqrt_d) - M);
    zb += e;
    e_aa[m] = e;
    if (e_as != nullptr) e_as[m] = expf(scaled(s_as[m], sqrt_d) - M);
  }
  return zb;
}

// Diagonal row I of one head: writes E_sa[I, :] and returns sum_m E_sa[I, m]
// (in order of m); *ess gets E_ss[I]. The row max covers P_sa[I, :] and
// P_ss[I].
__device__ float diag_row(const float* s_sa, float s_ss, int N, float sqrt_d,
                          float* e_sa, float* ess) {
  const float pss = scaled(s_ss, sqrt_d);
  float M = pss;
  for (int m = 0; m < N; ++m) M = fmaxf(M, scaled(s_sa[m], sqrt_d));
  float z = 0.f;
  for (int m = 0; m < N; ++m) {
    const float e = expf(scaled(s_sa[m], sqrt_d) - M);
    z += e;
    e_sa[m] = e;
  }
  *ess = expf(pss - M);
  return z;
}

// acc[r] = sum_m base[r][m] * wa_h[m, o0 .. o0 + 3] for R rows, in order of
// m; row r of the base starts at base[r] (the callers clamp rows past N to a
// valid one).
template <int R>
__device__ void base_product(float4 (&acc)[R], const float* const (&base)[R],
                             const float* wa_h, int N, int h, int o0) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = zero4();
#pragma unroll 4
  for (int m = 0; m < N; ++m) {
    const float4 w = load4(wa_h + static_cast<size_t>(m) * h + o0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float e = base[r][m];
      acc[r].x += e * w.x;
      acc[r].y += e * w.y;
      acc[r].z += e * w.z;
      acc[r].w += e * w.w;
    }
  }
}

// ((num + corr * waI) + rep * dwsI) / Z, columnwise.
__device__ inline float4 ctx_row(float4 num, float corr, float rep, float Z,
                                 float4 waI, float4 dwsI) {
  return make_float4(((num.x + corr * waI.x) + rep * dwsI.x) / Z,
                     ((num.y + corr * waI.y) + rep * dwsI.y) / Z,
                     ((num.z + corr * waI.z) + rep * dwsI.z) / Z,
                     ((num.w + corr * waI.w) + rep * dwsI.w) / Z);
}

// fc = ((fc + x_a[n]) + bias) + (n == I) delta[I].
__device__ inline float4 residual(float4 fc, float4 xa, float4 bi, float4 dl,
                                  bool diag) {
  const float4 r = add4(add4(fc, xa), bi);
  return diag ? add4(r, dl) : r;
}

// Non-affine LayerNorm statistics of R rows over the block's h columns,
// two-pass: centres fc in place (fc becomes fc - mean) and returns rstd.
// Every thread of the block must call it.
template <int R>
__device__ void center_rows(float4 (&fc)[R], float (&rstd)[R], bool owns,
                            int h, float* s_red) {
  float stat[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    stat[r] = owns ? ((fc[r].x + fc[r].y) + fc[r].z) + fc[r].w : 0.f;
  block_sum(stat, s_red);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float mu = stat[r] / static_cast<float>(h);
    fc[r].x -= mu;
    fc[r].y -= mu;
    fc[r].z -= mu;
    fc[r].w -= mu;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) stat[r] = owns ? dot4(fc[r], fc[r]) : 0.f;
  block_sum(stat, s_red);
#pragma unroll
  for (int r = 0; r < R; ++r)
    rstd[r] = 1.0f / sqrtf(stat[r] / static_cast<float>(h) + kLnEps);
}

// ── forward ────────────────────────────────────────────────────────────────

__global__ void cf_fwd_kernel(
    const float* __restrict__ S_aa, const float* __restrict__ S_as,
    const float* __restrict__ S_sa, const float* __restrict__ S_ss,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ out, int N, int H,
    int h, float sqrt_d) {
  extern __shared__ float smem[];
  const int HN = H * N;
  float* s_base = smem;             // H*N rows of N: the base row of (head, n)
  float* s_corr = s_base + HN * N;  // zc[n, I], or zc2[I] on n = I
  float* s_rep = s_corr + HN;       // E_as[n, I], or E_ss[I] on n = I
  float* s_Z = s_rep + HN;          // Z[n, I], or Z2[I] on n = I
  float* s_red = s_Z + HN;          // (blockDim / 32) * kRows

  const int b = blockIdx.x / N;
  const int I = blockIdx.x % N;

  // softmax terms of counterfactual I, one thread per (head, row)
  for (int t = threadIdx.x; t < HN; t += blockDim.x) {
    const int n = t % N;
    const size_t row = static_cast<size_t>(b) * HN + t;  // (b, head, n)
    float* base = s_base + t * N;
    if (n != I) {
      const float* aa = S_aa + row * N;
      const float* as = S_as + row * N;
      const float M = off_max(aa, as, N, sqrt_d);
      const float zb = off_row(aa, as, N, sqrt_d, M, base, nullptr);
      const float eas = expf(scaled(as[I], sqrt_d) - M);
      const float zc = eas - base[I];
      s_corr[t] = zc;
      s_rep[t] = eas;
      s_Z[t] = zb + zc;
    } else {
      float ess;
      const float z = diag_row(S_sa + row * N, S_ss[row], N, sqrt_d, base,
                               &ess);
      const float zc2 = ess - base[I];
      s_corr[t] = zc2;
      s_rep[t] = ess;
      s_Z[t] = z + zc2;
    }
  }
  __syncthreads();

  const int o0 = threadIdx.x * kCols;
  const bool owns = o0 < h;
  float4 bi = zero4(), dl = zero4();
  if (owns) {
    bi = load4(bias + o0);
    dl = load4(delta + (static_cast<size_t>(b) * N + I) * h + o0);
  }
  float4 pooled = zero4();

  for (int n0 = 0; n0 < N; n0 += kRows) {
    float4 fc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) fc[r] = zero4();
    if (owns) {
      for (int hh = 0; hh < H; ++hh) {
        const size_t hb = static_cast<size_t>(b) * HN + hh * N;
        const float* wa_h = wa + hb * h;
        const float* base[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          base[r] = s_base + (hh * N + min(n0 + r, N - 1)) * N;
        float4 num[kRows];
        base_product(num, base, wa_h, N, h, o0);
        const float4 waI = load4(wa_h + static_cast<size_t>(I) * h + o0);
        const float4 dwsI = load4(dws + (hb + I) * h + o0);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int t = hh * N + min(n0 + r, N - 1);
          fc[r] = add4(fc[r], ctx_row(num[r], s_corr[t], s_rep[t], s_Z[t],
                                      waI, dwsI));
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = min(n0 + r, N - 1);
        const float4 xa =
            load4(x_a + (static_cast<size_t>(b) * N + n) * h + o0);
        fc[r] = residual(fc[r], xa, bi, dl, n == I);
      }
    }
    float rstd[kRows];
    center_rows(fc, rstd, owns, h, s_red);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (n0 + r < N) {
        pooled.x += fc[r].x * rstd[r];
        pooled.y += fc[r].y * rstd[r];
        pooled.z += fc[r].z * rstd[r];
        pooled.w += fc[r].w * rstd[r];
      }
    }
  }

  if (owns) {
    const float rows = static_cast<float>(N);
    store4(out + (static_cast<size_t>(b) * N + I) * h + o0,
           make_float4(pooled.x / rows, pooled.y / rows, pooled.z / rows,
                       pooled.w / rows));
  }
}

// ── backward ───────────────────────────────────────────────────────────────

// The group's softmax terms in shared memory (step 0 of the backward).
struct GroupTerms {
  const float* Eaa;  // [head][n][m]
  const float* Eas;  // [head][n][m]
  const float* Esa;  // [head][I][m]
  const float* Zb;   // [head][n]
  const float* Ess;  // [head][I]
  const float* zc2;  // [head][I]
  const float* Z2;   // [head][I]
};

// corr, rep and Z of row n of head hh for counterfactual I (the forward's
// s_corr, s_rep and s_Z, computed with the same operations). Selects, not
// branches, so that the callers' loads of several rows issue together.
__device__ inline void row_terms(const GroupTerms& g, int hh, int n, int I,
                                 int N, float& corr, float& rep, float& Z) {
  const int t = hh * N + n;
  const bool diag = n == I;
  const float eas = g.Eas[t * N + I];
  const float zc = eas - g.Eaa[t * N + I];
  corr = diag ? g.zc2[t] : zc;
  rep = diag ? g.Ess[t] : eas;
  Z = diag ? g.Z2[t] : g.Zb[t] + zc;
}

// This thread's columns of the base product of row n of head hh for
// counterfactual I: num_h[n] in the scratch, or for n == I the row
// E_sa[I, :] wa_h in shared memory.
__device__ inline const float* num_row(const float* num, const float* s_big,
                                       size_t hb, int hh, int n, int I, int h,
                                       int o0) {
  return n == I ? s_big + hh * h + o0 : num + (hb + n) * h + o0;
}

// Offset (in floats) of the float4-aligned area after the scalar arrays.
__host__ __device__ inline int bwd_big_offset(int N, int H) {
  return (4 * H * N * N + 5 * H * N + 2 * H + 3) & ~3;
}

__global__ void cf_bwd_kernel(
    const float* __restrict__ S_aa, const float* __restrict__ S_as,
    const float* __restrict__ S_sa, const float* __restrict__ S_ss,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ dS_aa, float* __restrict__ dS_as,
    float* __restrict__ dS_sa, float* __restrict__ dS_ss,
    float* __restrict__ d_wa, float* __restrict__ d_dws,
    float* __restrict__ d_xa, float* __restrict__ d_delta,
    float* __restrict__ d_bias_part, float* __restrict__ num,
    float* __restrict__ d_num, int N, int H, int h, float sqrt_d) {
  extern __shared__ float smem[];
  const int HN = H * N, HNN = HN * N;
  float* s_Eaa = smem;            // [head][n][m]
  float* s_Eas = s_Eaa + HNN;     // [head][n][m]
  float* s_Esa = s_Eas + HNN;     // [head][I][m]
  float* s_dEaa = s_Esa + HNN;    // -d_zc at (n, m = I), 0 on n = m
  float* s_Zb = s_dEaa + HNN;     // [head][n]
  float* s_Ess = s_Zb + HN;       // [head][I]
  float* s_zc2 = s_Ess + HN;      // [head][I]
  float* s_Z2 = s_zc2 + HN;       // [head][I]
  float* s_dZ = s_Z2 + HN;        // [head][n]: sum over I of dZ[n, I]
  float* s_diag = s_dZ + HN;      // [head][2]: dZ2[I], d_zc2[I] of this I
  // in the loop over I: H rows of h, the base products E_sa[I, :] wa_h of
  // this I; after it: N rows of h, d_num of one head
  float* s_big = smem + bwd_big_offset(N, H);
  float* s_red = s_big + max(H, N) * h;  // (blockDim / 32) * kMaxN
  const GroupTerms g{s_Eaa, s_Eas, s_Esa, s_Zb, s_Ess, s_zc2, s_Z2};

  const int b = blockIdx.x;
  const int o0 = threadIdx.x * kCols;
  const bool owns = o0 < h;
  const size_t gb = static_cast<size_t>(b) * HN;  // row (b, head 0, n = 0)

  // 0. the group's softmax terms, one thread per (head, row)
  for (int t = threadIdx.x; t < HN; t += blockDim.x) {
    const int n = t % N;
    const size_t row = gb + t;
    const float* aa = S_aa + row * N;
    const float* as = S_as + row * N;
    const float M = off_max(aa, as, N, sqrt_d);
    s_Zb[t] = off_row(aa, as, N, sqrt_d, M, s_Eaa + t * N, s_Eas + t * N);
    float ess;
    const float z = diag_row(S_sa + row * N, S_ss[row], N, sqrt_d,
                             s_Esa + t * N, &ess);
    const float zc2 = ess - s_Esa[t * N + n];
    s_Ess[t] = ess;
    s_zc2[t] = zc2;
    s_Z2[t] = z + zc2;
    s_dZ[t] = 0.f;
    for (int m = 0; m < N; ++m) s_dEaa[t * N + m] = 0.f;
  }
  __syncthreads();

  // ... and the base products num_h[n] = sum_m E_aa[n, m] wa_h[m] of every
  // head and row, in this thread's columns; d_num starts at zero
  if (owns) {
    for (int hh = 0; hh < H; ++hh) {
      const size_t hb = gb + hh * N;
      for (int n0 = 0; n0 < N; n0 += kRowsB) {
        const float* base[kRowsB];
#pragma unroll
        for (int r = 0; r < kRowsB; ++r)
          base[r] = s_Eaa + (hh * N + min(n0 + r, N - 1)) * N;
        float4 acc[kRowsB];
        base_product(acc, base, wa + hb * h, N, h, o0);
#pragma unroll
        for (int r = 0; r < kRowsB; ++r) {
          if (n0 + r < N) {
            const size_t at = (hb + n0 + r) * h + o0;
            store4(num + at, acc[r]);
            store4(d_num + at, zero4());
          }
        }
      }
    }
  }

  const float rows = static_cast<float>(N);
  const float4 bi = owns ? load4(bias + o0) : zero4();
  float4 bias_acc = zero4();

  for (int I = 0; I < N; ++I) {
    const size_t bI = static_cast<size_t>(b) * N + I;
    __syncthreads();  // the previous I is done with s_diag, s_big and s_red

    // base products of the rows n = I: E_sa[I, :] wa_h, one per head
    if (owns) {
      for (int hh = 0; hh < H; ++hh) {
        const float* base[1] = {s_Esa + (hh * N + I) * N};
        float4 acc[1];
        base_product(acc, base, wa + (gb + hh * N) * h, N, h, o0);
        store4(s_big + hh * h + o0, acc[0]);
      }
    }
    float4 dl = zero4(), go = zero4();
    if (owns) {
      dl = load4(delta + bI * h + o0);
      go = load4(dout + bI * h + o0);
    }
    // pool backward: every row n of I gets dout[b, I] / N
    const float4 dy = make_float4(go.x / rows, go.y / rows, go.z / rows,
                                  go.w / rows);
    float m1[1] = {owns ? ((dy.x + dy.y) + dy.z) + dy.w : 0.f};
    block_sum(m1, s_red);
    const float mean_dy = m1[0] / static_cast<float>(h);
    float4 ddiag = zero4();   // d_fc[I, I] in this thread's columns
    float4 bias_I = zero4();  // sum over n of d_fc[n, I]

    // 1. rows n0 .. n0 + kRowsB - 1 of I
    for (int n0 = 0; n0 < N; n0 += kRowsB) {
      // pass 1: fc
      float4 fc[kRowsB];
#pragma unroll
      for (int r = 0; r < kRowsB; ++r) fc[r] = zero4();
      if (owns) {
        for (int hh = 0; hh < H; ++hh) {
          const size_t hb = gb + hh * N;
          const float4 waI = load4(wa + (hb + I) * h + o0);
          const float4 dwsI = load4(dws + (hb + I) * h + o0);
          float4 nm[kRowsB];
#pragma unroll
          for (int r = 0; r < kRowsB; ++r)
            nm[r] = load4(num_row(num, s_big, hb, hh, min(n0 + r, N - 1), I,
                                  h, o0));
#pragma unroll
          for (int r = 0; r < kRowsB; ++r) {
            float corr, rep, Z;
            row_terms(g, hh, min(n0 + r, N - 1), I, N, corr, rep, Z);
            fc[r] = add4(fc[r], ctx_row(nm[r], corr, rep, Z, waI, dwsI));
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsB; ++r) {
          const int n = min(n0 + r, N - 1);
          const float4 xa =
              load4(x_a + (static_cast<size_t>(b) * N + n) * h + o0);
          fc[r] = residual(fc[r], xa, bi, dl, n == I);
        }
      }
      // d_xa so far, loaded before the reductions hide the latency
      float4 xa_sum[kRowsB];
#pragma unroll
      for (int r = 0; r < kRowsB; ++r)
        xa_sum[r] = (owns && I > 0)
                        ? load4(d_xa + (static_cast<size_t>(b) * N +
                                        min(n0 + r, N - 1)) * h + o0)
                        : zero4();
      // LayerNorm backward; fc becomes y, then d_fc
      float rstd[kRowsB], stat[kRowsB];
      center_rows(fc, rstd, owns, h, s_red);
#pragma unroll
      for (int r = 0; r < kRowsB; ++r) {
        fc[r].x *= rstd[r];
        fc[r].y *= rstd[r];
        fc[r].z *= rstd[r];
        fc[r].w *= rstd[r];
        stat[r] = owns ? dot4(dy, fc[r]) : 0.f;
      }
      block_sum(stat, s_red);
#pragma unroll
      for (int r = 0; r < kRowsB; ++r) {
        const float m2 = stat[r] / static_cast<float>(h);
        fc[r].x = rstd[r] * ((dy.x - mean_dy) - fc[r].x * m2);
        fc[r].y = rstd[r] * ((dy.y - mean_dy) - fc[r].y * m2);
        fc[r].z = rstd[r] * ((dy.z - mean_dy) - fc[r].z * m2);
        fc[r].w = rstd[r] * ((dy.w - mean_dy) - fc[r].w * m2);
      }
      if (owns) {
#pragma unroll
        for (int r = 0; r < kRowsB; ++r) {
          const int n = n0 + r;
          if (n < N) {
            const size_t at = (static_cast<size_t>(b) * N + n) * h + o0;
            store4(d_xa + at, add4(xa_sum[r], fc[r]));
            bias_I = add4(bias_I, fc[r]);
            if (n == I) {
              store4(d_delta + bI * h + o0, fc[r]);
              ddiag = fc[r];
            }
          }
        }
      }

      // pass 2: per head, the three dot products over o of every row
      for (int hh = 0; hh < H; ++hh) {
        const size_t hb = gb + hh * N;
        float part[3 * kRowsB];
#pragma unroll
        for (int k = 0; k < 3 * kRowsB; ++k) part[k] = 0.f;
        if (owns) {
          // every load of the rows first, then the arithmetic (rows past N
          // repeat row N - 1 and add nothing)
          const size_t at_I = (hb + I) * h + o0;
          const float4 waI = load4(wa + at_I);
          const float4 dwsI = load4(dws + at_I);
          float4 nm[kRowsB], dn[kRowsB];
#pragma unroll
          for (int r = 0; r < kRowsB; ++r) {
            const int n = min(n0 + r, N - 1);
            nm[r] = load4(num_row(num, s_big, hb, hh, n, I, h, o0));
            dn[r] = load4(d_num + (hb + n) * h + o0);
          }
          // this I's rows of d_wa and d_dws so far
          const float4 gw0 = n0 == 0 ? zero4() : load4(d_wa + at_I);
          const float4 gd0 = n0 == 0 ? zero4() : load4(d_dws + at_I);
          float4 gw = zero4(), gd = zero4();
#pragma unroll
          for (int r = 0; r < kRowsB; ++r) {
            const int n = min(n0 + r, N - 1);
            const bool row = n0 + r < N;
            float corr, rep, Z;
            row_terms(g, hh, n, I, N, corr, rep, Z);
            const float4 cx = ctx_row(nm[r], corr, rep, Z, waI, dwsI);
            const float4 dc = make_float4(fc[r].x / Z, fc[r].y / Z,
                                          fc[r].z / Z, fc[r].w / Z);
            part[3 * r] = row ? dot4(cx, dc) : 0.f;
            part[3 * r + 1] = row ? dot4(dc, waI) : 0.f;
            part[3 * r + 2] = row ? dot4(dc, dwsI) : 0.f;
            const float cw = row ? corr : 0.f, cd = row ? rep : 0.f;
            gw.x += cw * dc.x;
            gw.y += cw * dc.y;
            gw.z += cw * dc.z;
            gw.w += cw * dc.w;
            gd.x += cd * dc.x;
            gd.y += cd * dc.y;
            gd.z += cd * dc.z;
            gd.w += cd * dc.w;
            if (row && n != I)
              store4(d_num + (hb + n) * h + o0, add4(dn[r], dc));
          }
          store4(d_wa + at_I, add4(gw0, gw));
          store4(d_dws + at_I, add4(gd0, gd));
        }
        block_sum(part, s_red);
        // the scalar cotangents of the rows, one thread per row
#pragma unroll
        for (int r = 0; r < kRowsB; ++r) {
          const int n = n0 + r;
          if (threadIdx.x == r && n < N) {
            const int t = hh * N + n;
            const size_t row = hb + n;
            const float dZ = -part[3 * r];
            const float d_zc = part[3 * r + 1] + dZ;
            const float d_E = part[3 * r + 2] + d_zc;
            if (n != I) {
              s_dEaa[t * N + I] = -d_zc;
              s_dZ[t] += dZ;
              dS_as[row * N + I] = (s_Eas[t * N + I] * d_E) / sqrt_d;
            } else {
              dS_as[row * N + I] = 0.f;
              dS_ss[row] = (s_Ess[t] * d_E) / sqrt_d;
              s_diag[2 * hh] = dZ;
              s_diag[2 * hh + 1] = d_zc;
            }
          }
        }
      }
    }
    bias_acc = add4(bias_acc, bias_I);

    // 2. row I of dS_sa: d_Esa[I, m] = dZ2 - (m == I) d_zc2 + dctx[I, I].wa_h[m].
    //    dctx[I, I] of every head replaces this thread's columns of the base
    //    products of I in s_big (pass 2 is done with them), and one thread
    //    per (head, m) takes the product over o.
    if (owns) {
      for (int hh = 0; hh < H; ++hh) {
        const float z2 = s_Z2[hh * N + I];
        store4(s_big + hh * h + o0, make_float4(ddiag.x / z2, ddiag.y / z2,
                                                ddiag.z / z2, ddiag.w / z2));
      }
    }
    __syncthreads();  // s_diag and s_big hold every head's terms of row I
    for (int j = threadIdx.x; j < HN; j += blockDim.x) {
      const int hh = j / N, m = j % N;
      const float* w = wa + (gb + j) * h;  // row m of wa_h
      const float* du = s_big + hh * h;
      float acc = 0.f;
#pragma unroll 4
      for (int o = 0; o < h; o += kCols) acc += dot4(load4(du + o), load4(w + o));
      const int t = hh * N + I;
      const float dE =
          (s_diag[2 * hh] - (m == I ? s_diag[2 * hh + 1] : 0.f)) + acc;
      dS_sa[(gb + t) * N + m] = (s_Esa[t * N + m] * dE) / sqrt_d;
    }
  }
  __syncthreads();  // s_dEaa and s_dZ are complete; s_big is free

  // 3. per head: d_wa_h[m] += sum_n E_aa[n, m] d_num[n]
  //                          + sum_J E_sa[J, m] dctx[J, J],
  //    then d_Eaa[n, m] = (-d_zc + sum_I dZ) + d_num[n] . wa_h[m]
  for (int hh = 0; hh < H; ++hh) {
    const size_t hb = gb + hh * N;
    if (owns) {
      for (int m0 = 0; m0 < N; m0 += kM) {
        float4 acc[kM];
#pragma unroll
        for (int k = 0; k < kM; ++k)
          acc[k] = m0 + k < N ? load4(d_wa + (hb + m0 + k) * h + o0) : zero4();
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 dn = load4(d_num + (hb + n) * h + o0);
          const float* e = s_Eaa + (hh * N + n) * N + m0;
#pragma unroll
          for (int k = 0; k < kM; ++k) {
            if (m0 + k < N) {
              acc[k].x += e[k] * dn.x;
              acc[k].y += e[k] * dn.y;
              acc[k].z += e[k] * dn.z;
              acc[k].w += e[k] * dn.w;
            }
          }
        }
#pragma unroll 4
        for (int J = 0; J < N; ++J) {
          const float z2 = s_Z2[hh * N + J];
          const float4 dd =
              load4(d_delta + (static_cast<size_t>(b) * N + J) * h + o0);
          const float4 du =
              make_float4(dd.x / z2, dd.y / z2, dd.z / z2, dd.w / z2);
          const float* e = s_Esa + (hh * N + J) * N + m0;
#pragma unroll
          for (int k = 0; k < kM; ++k) {
            if (m0 + k < N) {
              acc[k].x += e[k] * du.x;
              acc[k].y += e[k] * du.y;
              acc[k].z += e[k] * du.z;
              acc[k].w += e[k] * du.w;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kM; ++k)
          if (m0 + k < N) store4(d_wa + (hb + m0 + k) * h + o0, acc[k]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n)
        store4(s_big + n * h + o0, load4(d_num + (hb + n) * h + o0));
    }
    __syncthreads();  // s_big holds d_num of this head
    for (int m = threadIdx.x; m < N; m += blockDim.x) {
      const float* w = wa + (hb + m) * h;
      float acc[kMaxN];
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) acc[n] = 0.f;
      float4 wv_next = load4(w);  // the row's next float4, one step ahead
      for (int o = 0; o < h; o += kCols) {
        const float4 wv = wv_next;
        if (o + kCols < h) wv_next = load4(w + o + kCols);
#pragma unroll
        for (int n = 0; n < kMaxN; ++n)
          if (n < N) acc[n] += dot4(load4(s_big + n * h + o), wv);
      }
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          const int t = hh * N + n;
          const float dE = (s_dEaa[t * N + m] + s_dZ[t]) + acc[n];
          dS_aa[(hb + n) * N + m] = (s_Eaa[t * N + m] * dE) / sqrt_d;
        }
      }
    }
    __syncthreads();  // before the next head's d_num replaces s_big
  }

  if (owns) store4(d_bias_part + static_cast<size_t>(b) * h + o0, bias_acc);
}

// d_bias[o] = sum over b of part[b, o]: the sums of runs of 32 groups, in
// order of b, added in order (a fixed order that keeps the rounding of a
// sum over B * N * N rows near that of a tree).
__global__ void sum_over_groups_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int B, int h) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= h) return;
  float s = 0.f;
  for (int b0 = 0; b0 < B; b0 += 32) {
    float run = 0.f;
    const int end = min(b0 + 32, B);
#pragma unroll 8
    for (int b = b0; b < end; ++b) run += part[static_cast<size_t>(b) * h + o];
    s += run;
  }
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

bool takes(int B, int N, int H, int h, int threads) {
  return h % kCols == 0 && h > 0 && threads <= 1024 && B > 0 && N > 0 &&
         N <= kMaxN && H > 0;
}

}  // namespace

extern "C" {

// pooled (B, N, h). Returns cudaGetLastError() after the launch (0 =
// success), or cudaErrorInvalidValue for shapes the kernel does not take.
// Needs h % 4 == 0 and 16-byte aligned pointers (checked by the wrapper).
int cf_attention_fwd_launch(const float* S_aa, const float* S_as,
                            const float* S_sa, const float* S_ss,
                            const float* wa, const float* dws,
                            const float* x_a, const float* delta,
                            const float* bias, float* out, int B, int N, int H,
                            int h, float sqrt_d, void* stream) {
  const int threads = threads_for(h);
  if (!takes(B, N, H, h, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(H) * N * N +
                       3 * static_cast<size_t>(H) * N + (threads / 32) * kRows) *
                      sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(cf_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cf_fwd_kernel<<<B * N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias, out, N, H, h, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

// The cotangents of the nine inputs for dout. d_bias_part is (B, h) scratch,
// num and d_num (B, H, N, h) scratch. Returns cudaGetLastError() after the
// two launches (0 = success), or cudaErrorInvalidValue for shapes the kernel
// does not take (N > 32, or more shared memory than a block has: about
// 4 * (4*H*N*N + max(H, N)*h) bytes).
int cf_attention_bwd_launch(
    const float* S_aa, const float* S_as, const float* S_sa,
    const float* S_ss, const float* wa, const float* dws, const float* x_a,
    const float* delta, const float* bias, const float* dout, float* dS_aa,
    float* dS_as, float* dS_sa, float* dS_ss, float* d_wa, float* d_dws,
    float* d_xa, float* d_delta, float* d_bias, float* d_bias_part,
    float* num, float* d_num, int B, int N, int H, int h, float sqrt_d,
    void* stream) {
  const int threads = threads_for(h);
  if (!takes(B, N, H, h, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(bwd_big_offset(N, H)) +
       static_cast<size_t>(H > N ? H : N) * h + (threads / 32) * kMaxN) *
      sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(cf_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cf_bwd_kernel<<<B, threads, smem, s>>>(
      S_aa, S_as, S_sa, S_ss, wa, dws, x_a, delta, bias, dout, dS_aa, dS_as,
      dS_sa, dS_ss, d_wa, d_dws, d_xa, d_delta, d_bias_part, num, d_num, N, H,
      h, sqrt_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_over_groups_kernel<<<(h + 127) / 128, 128, 0, s>>>(d_bias_part, d_bias,
                                                          B, h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
