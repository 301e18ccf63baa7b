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
// 3.35 TB/s) and needs ~10 GFLOP (~0.16 ms at the 67 TFLOP/s f32 rate):
// both about equal (chip_smoke._cf_forward_work computes the exact numbers).
//
// Design: two kernels joined by scratch in device memory, launched in this
// order on one stream, each doing only the work its block owns:
//   0. base (cf_bwd_base_kernel, stage 0 of the backward as it stands), one
//      block per (b, head): the softmax terms of the group and head (terms)
//      and the base products num = E_aa wa_h and num2 = E_sa wa_h (base),
//      each once. Only column I of corr, rep and Z differs between
//      counterfactuals, so nothing here is repeated per I.
//   1. rows (cf_fwd_rows_kernel), one block per (b, P counterfactuals),
//      b-major so that L2 serves the group's blocks their re-reads of base
//      and x_a; four warps, a warp owns a whole row n, 16 columns a lane.
//      For each of the block's counterfactuals I it rebuilds fc[n, I] from
//      the base rows as stage 1 of the backward does (load_base_rows and
//      rebuild_fc, the same device functions), takes the two-pass
//      LayerNorm statistics with warp shuffles (center_row, no block
//      barrier), and adds y into the warp's pooled row of I in shared
//      memory. The base rows num_h[n] are loaded once for the block's P
//      counterfactuals; the diagonal row n = I takes num2_h[I] instead and
//      is built last. At the end the warps' pooled rows are summed in order
//      of the warp, divided by N and stored. fc never reaches device
//      memory. P = 2 (kFwdPerBlock) was the fastest of 1, 2 and 4 at the
//      main path's shapes (PERF.md): one counterfactual a block re-reads
//      the base rows from L2 twice as often, four leave two blocks an SM.
// The trade: the scratch (terms 20·B·H·N² and base 8·B·H·N·h bytes, 368 MB
// at the main path's shapes) goes through device memory, ~0.41 ms of
// bandwidth with the function's own bytes (the staged route's bound,
// chip_smoke._cf_forward_stage_work), against the N-fold recompute of the
// base products (~34 GFLOP) that a one-kernel form needs. Stage 1 re-reads
// the group's base rows from L2 once per block: ~224 KB a block at P = 1,
// fewer with more counterfactuals a block, at the price of shared memory
// (2·P·H·h floats of staged rows wa_h[I], dws_h[I] and 4·P·h of pooled
// rows) and so of blocks an SM. No atomics, fixed orders: two calls give the
// same bits.
//
// ── Backward (K5b) ────────────────────────────────────────────────────────
// Given dout (B, N, h): d_y = dout[b, I] / N on every row n of I, and
//   d_fc = rstd * ((d_y - mean(d_y)) - y * mean(d_y * y)).
// Per head, with dctx = d_fc / Z (the row's own partition, Z2 on n = I), each
// of the three sums over o that the chain needs is a dot product of the row
// d_fc[n, I] with one vector of the head:
//   A  = d_fc[n, I] . num[n]  (num2[I] on n = I),
//   Bv = d_fc[n, I] . wa[I],   C = d_fc[n, I] . dws[I],
// and then
//   dZ = -((A + corr Bv) + rep C) / Z / Z,  d_zc = Bv / Z + dZ,
//   d_E = C / Z + d_zc                      (d_Eas, or d_Ess on n = I),
//   d_num[n] = sum_{I != n} d_fc[n, I] / Z[n, I],
//   d_Eaa[n, m] = (-d_zc[n, m] (m != n) + sum_{I != n} dZ[n, I])
//                 + d_num[n] . wa[m],
//   d_Esa[I, m] = (dZ2[I] - (m == I) d_zc2[I]) + dU2[I] . wa[m],
//                 dU2[I] = d_fc[I, I] / Z2[I],
//   d_wa[m]  = sum_n corr[n, m] / Z[n, m] d_fc[n, m]
//              + sum_n E_aa[n, m] d_num[n] + sum_J E_sa[J, m] dU2[J],
//   d_dws[I] = sum_n rep[n, I] / Z[n, I] d_fc[n, I]
// (corr is zc or zc2, rep is E_as or E_ss, Z is Z or Z2 by the row), and
// dS = E * d_E / sqrt(d) for each of the four score tensors (the row maxes
// are constants, as in jax.nn.softmax; dS_as is 0 on n = I).
// d_xa[n] = sum_I d_fc[n, I], d_delta[I] = d_fc[I, I], d_bias = sum over b,
// I, n of d_fc.
//
// What bounds it: ~29 GFLOP (~0.44 ms at 67 TFLOP/s) against ~0.92 GB of
// inputs and cotangents (~0.28 ms at 3.35 TB/s): operations
// (chip_smoke._cf_backward_work). The staged route below also moves its
// scratch through device memory: the (B, N, N, h) d_fc written by stage 1
// and read by stage 2, the base products and d_num: ~4.4 GB in all, ~1.32 ms
// of bandwidth (chip_smoke._cf_backward_stage_work; stage 1 also reads its
// own rows of d_fc back, from L2).
//
// Design: the TPU kernel walks groups in one sequential grid and carries
// d_bias from step to step; blocks on Hopper run in no order. The backward is
// cut at d_fc into four kernels whose sums all lie inside a block, joined by
// scratch in device memory, launched in this order on one stream:
//   0. base (cf_bwd_base_kernel), one block per (b, head): the softmax terms
//      of the group and head, laid out per (n, I) as the rows need them
//      (terms: E_aa, E_sa, corr, rep, Z), and the base products
//      num = E_aa wa_h and num2 = E_sa wa_h (base), each once.
//   1. rows (cf_bwd_rows_kernel), one block per (b, I), b-major, four warps:
//      a warp owns a whole row (n, I), 16 columns a lane, so every sum over o
//      (the LayerNorm statistics and the 3 H dot products) is a sum over one
//      warp's shuffles, with no barrier. It rebuilds fc as
//      sum_h num_h / Z + R + x_a (+ delta on n = I), R = bias +
//      sum_h (corr / Z) wa_h[I] + (rep / Z) dws_h[I], from the base products
//      and the block's rows wa_h[I], dws_h[I] staged in shared memory
//      (rebuild_fc, shared with the forward's rows kernel); takes
//      the LayerNorm backward; stores d_fc; and turns the dot products into
//      the row's scalar cotangents: dS_as, dS_ss, and -d_zc and dZ (on the
//      diagonal -d_zc2 and dZ2) into a (B, H, 2, N, N) scratch. After one
//      barrier each thread sums its columns of the block's rows of d_fc over
//      n, read back from L2: d_dws[b, :, I], the first term of d_wa[b, :, I]
//      (stored in d_wa, completed by stage 3), and d_delta. fc never reaches
//      device memory. 128 registers and ~18 KB of shared memory a block let
//      four blocks share an SM; the rows were held in shared memory in an
//      earlier form, which fitted three and was slower (PERF.md).
//   2. sums (cf_bwd_sums_kernel), one block per group: streams d_fc[b] once;
//      each thread sums its columns over I into d_num (every head, to a
//      scratch) and d_xa, and d_xa over n into a (B, h) d_bias partial;
//      sum_over_groups_kernel then sums the partials over b.
//   3. products (cf_bwd_products_kernel), one block of 256 threads per
//      (b, head): wa_h and d_num (then dU2) staged in shared memory; the
//      (N x h)(h x N) products d_num wa_h^T and dU2 wa_h^T give dS_aa and
//      dS_sa, 2 outputs a thread; E_aa^T d_num and E_sa^T dU2 complete d_wa.
// No atomics; every sum has a fixed order, so two calls give the same bits.
// Where a sum needs a value that another block of the same stage makes, it
// waits for the next stage.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 4;          // columns a thread takes at a time (float4)
constexpr int kMaxN = 32;         // agents per group the kernels take
constexpr int kMaxH = 4;          // heads the kernels take
constexpr int kMaxCols = 512;     // columns h the kernels take
constexpr int kLaneChunks = kMaxCols / (32 * kCols);  // float4s of a row a lane
constexpr int kThreads = 128;     // threads of a base, rows or sums block
constexpr int kBaseRows = 10;     // base-product rows per pass over wa_h
constexpr int kM = 10;            // rows of d_wa per pass in stage 3
constexpr int kFwdPerBlock = 2;   // counterfactuals a forward rows block takes
constexpr float kLnEps = 1e-5f;

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

// E_aa[n, :] and E_as[n, :] of an off-diagonal row with row max M; returns
// Z_b[n] = sum_m E_aa[n, m], summed in order of m.
__device__ float off_row(const float* s_aa, const float* s_as, int N,
                         float sqrt_d, float M, float* e_aa, float* e_as) {
  float zb = 0.f;
  for (int m = 0; m < N; ++m) {
    const float e = expf(scaled(s_aa[m], sqrt_d) - M);
    zb += e;
    e_aa[m] = e;
    e_as[m] = expf(scaled(s_as[m], sqrt_d) - M);
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

// fc = ((fc + x_a[n]) + bias) + (n == I) delta[I].
__device__ inline float4 residual(float4 fc, float4 xa, float4 bi, float4 dl,
                                  bool diag) {
  const float4 r = add4(add4(fc, xa), bi);
  return diag ? add4(r, dl) : r;
}

// The per-(n, I) softmax terms of one (b, head), each N x N, in the terms
// scratch (B, H, kTerms, N, N): E_aa[n, m], E_sa[I, m], and corr, rep and Z
// of row n of counterfactual I (zc, E_as and Z_b + zc; zc2, E_ss and Z2 on
// n = I).
enum { kEaa = 0, kEsa, kCorr, kRep, kZ, kTerms };

__device__ inline float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ inline float sum4(float4 a) { return ((a.x + a.y) + a.z) + a.w; }

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sums each of the 3 * kMaxH values v over the warp's 32 lanes, halving the
// values at each of the first two exchanges: lane L ends with the sums of
// v[3 hh .. 3 hh + 2] for hh = L / 8 (the three dot products of head hh).
static_assert(kMaxH == 4, "warp_sum_heads splits four heads over lane bits 4, 3");
__device__ inline void warp_sum_heads(const float (&v)[3 * kMaxH],
                                      float (&out)[3]) {
  const bool p = threadIdx.x & 16, q = threadIdx.x & 8;
  float half[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float send = p ? v[i] : v[i + 6];
    half[i] = (p ? v[i + 6] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float send = q ? half[i] : half[i + 3];
    out[i] = (q ? half[i + 3] : half[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] += __shfl_xor_sync(0xffffffffu, out[i], off);
}

// ── The rows of one (b, I): what the forward's and the backward's share ──
// A warp owns a whole row (n, I); lane L takes the float4s c = L + 32 k,
// k < kLaneChunks, of its h columns (valid[k]: c < h / 4).

// The base rows of every head for one row, this lane's columns: base_row is
// the index of the row of head 0 in the base scratch (num[n], or num2[I] on
// the diagonal n = I), the heads follow at a stride of 2 N rows. Zeros past H
// heads and h columns.
__device__ inline void load_base_rows(float4 (&nm)[kMaxH][kLaneChunks],
                                      const float* base, size_t base_row,
                                      int N, int H, int h,
                                      const bool (&valid)[kLaneChunks],
                                      int lane) {
#pragma unroll
  for (int hh = 0; hh < kMaxH; ++hh)
#pragma unroll
    for (int k = 0; k < kLaneChunks; ++k)
      nm[hh][k] = (hh < H && valid[k])
                      ? load4(base + (base_row + 2 * hh * N) * h + (lane + 32 * k) * kCols)
                      : zero4();
}

// fc[n, I], this lane's columns, rebuilt from the base rows nm
// (load_base_rows):
//   f = sum over heads of nm_h / Z_h, then + R, + x_a[n] (+ delta[I] on n = I),
//   R = bias + sum over heads of (corr_h / Z_h) wa_h[I] + (rep_h / Z_h) dws_h[I].
// s_rz, s_wz, s_wr: 1 / Z, corr / Z and rep / Z in shared memory, those of
// the row's head hh at t + hh N; s_v: the rows wa_h[I], dws_h[I] of every
// head (2 H rows of h) and s_bias: bias, in shared memory; xa_row = b N + n
// and dl_row = b N + I: the rows of x_a and delta (read on n = I only).
// Returns the sum of the lane's columns.
__device__ inline float rebuild_fc(
    float4 (&f)[kLaneChunks], const float4 (&nm)[kMaxH][kLaneChunks],
    const float* s_rz, const float* s_wz, const float* s_wr, int t,
    const float* s_v, const float* s_bias, const float* x_a, size_t xa_row,
    const float* delta, size_t dl_row, bool diag, int N, int H, int h,
    const bool (&valid)[kLaneChunks], int lane) {
#pragma unroll
  for (int k = 0; k < kLaneChunks; ++k) f[k] = zero4();
#pragma unroll
  for (int hh = 0; hh < kMaxH; ++hh) {
    const float z = hh < H ? s_rz[t + hh * N] : 0.f;
#pragma unroll
    for (int k = 0; k < kLaneChunks; ++k)
      f[k] = make_float4(f[k].x + nm[hh][k].x * z, f[k].y + nm[hh][k].y * z,
                         f[k].z + nm[hh][k].z * z, f[k].w + nm[hh][k].w * z);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kLaneChunks; ++k) {
    if (!valid[k]) continue;
    const int o = (lane + 32 * k) * kCols;
    const float4 x = load4(x_a + xa_row * h + o);
    const float4 d = diag ? load4(delta + dl_row * h + o) : zero4();
    float4 r = load4(s_bias + o);
#pragma unroll
    for (int hh = 0; hh < kMaxH; ++hh) {
      if (hh >= H) continue;
      const float a = s_wz[t + hh * N], c = s_wr[t + hh * N];
      const float4 w = load4(s_v + (2 * hh) * h + o), u = load4(s_v + (2 * hh + 1) * h + o);
      r = make_float4((r.x + a * w.x) + c * u.x, (r.y + a * w.y) + c * u.y,
                      (r.z + a * w.z) + c * u.z, (r.w + a * w.w) + c * u.w);
    }
    f[k] = residual(add4(f[k], r), x, zero4(), d, diag);
    s += sum4(f[k]);
  }
  return s;
}

// The non-affine LayerNorm statistics of one row over the warp, two-pass: f,
// whose lane's columns sum to s, becomes f - mean (zeros past h columns);
// returns rstd.
__device__ inline float center_row(float4 (&f)[kLaneChunks], float s, int h,
                                   const bool (&valid)[kLaneChunks]) {
  const float cols = static_cast<float>(h);
  const float mu = warp_sum(s) / cols;
  s = 0.f;
#pragma unroll
  for (int k = 0; k < kLaneChunks; ++k) {
    f[k] = valid[k] ? make_float4(f[k].x - mu, f[k].y - mu, f[k].z - mu,
                                  f[k].w - mu)
                    : zero4();
    s += dot4(f[k], f[k]);
  }
  return 1.0f / sqrtf(warp_sum(s) / cols + kLnEps);
}

// ── Stage 0 of both directions: softmax terms and base products of one
// (b, head) ─────────────────────────────────────────────────────────────────

__global__ void __launch_bounds__(kThreads) cf_bwd_base_kernel(
    const float* __restrict__ S_aa, const float* __restrict__ S_as,
    const float* __restrict__ S_sa, const float* __restrict__ S_ss,
    const float* __restrict__ wa, float* __restrict__ terms,
    float* __restrict__ base, int N, int h, float sqrt_d) {
  extern __shared__ float smem[];
  const int NN = N * N;
  float* s_E = smem;            // [2N][N]: E_aa rows n, then E_sa rows I
  float* s_Eas = s_E + 2 * NN;  // [N][N]
  float* s_zb = s_Eas + NN;     // [N]: Z_b[n]
  float* s_ess = s_zb + N;      // [N]: E_ss[I]
  float* s_zc2 = s_ess + N;     // [N]: zc2[I]
  float* s_z2 = s_zc2 + N;      // [N]: Z2[I]
  const size_t row0 = static_cast<size_t>(blockIdx.x) * N;  // (b, head, 0)

  // the forward's softmax terms, one thread per row n (and diagonal row I = n)
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float* aa = S_aa + (row0 + n) * N;
    const float* as = S_as + (row0 + n) * N;
    const float M = off_max(aa, as, N, sqrt_d);
    s_zb[n] = off_row(aa, as, N, sqrt_d, M, s_E + n * N, s_Eas + n * N);
    float ess;
    const float z = diag_row(S_sa + (row0 + n) * N, S_ss[row0 + n], N, sqrt_d,
                             s_E + NN + n * N, &ess);
    const float zc2 = ess - s_E[NN + n * N + n];
    s_ess[n] = ess;
    s_zc2[n] = zc2;
    s_z2[n] = z + zc2;
  }
  __syncthreads();
  float* t = terms + static_cast<size_t>(blockIdx.x) * kTerms * NN;
  for (int k = threadIdx.x; k < NN; k += blockDim.x) {
    const int n = k / N, I = k % N;
    const bool diag = n == I;
    const float eas = s_Eas[k];
    const float zc = eas - s_E[k];
    t[kEaa * NN + k] = s_E[k];
    t[kEsa * NN + k] = s_E[NN + k];
    t[kCorr * NN + k] = diag ? s_zc2[n] : zc;
    t[kRep * NN + k] = diag ? s_ess[n] : eas;
    t[kZ * NN + k] = diag ? s_z2[n] : s_zb[n] + zc;
  }
  // base (B, H, 2N, h): rows n of E_aa wa_h, then rows I of E_sa wa_h
  const int o0 = threadIdx.x * kCols;
  if (o0 >= h) return;
  const float* wa_h = wa + row0 * h;
  float* out = base + 2 * row0 * h;
  for (int r0 = 0; r0 < 2 * N; r0 += kBaseRows) {
    const float* rows[kBaseRows];
#pragma unroll
    for (int r = 0; r < kBaseRows; ++r) rows[r] = s_E + min(r0 + r, 2 * N - 1) * N;
    float4 acc[kBaseRows];
    base_product(acc, rows, wa_h, N, h, o0);
#pragma unroll
    for (int r = 0; r < kBaseRows; ++r)
      if (r0 + r < 2 * N) store4(out + static_cast<size_t>(r0 + r) * h + o0, acc[r]);
  }
}

// ── Forward, stage 1: the rows of one (b, P counterfactuals) ─────────────

// Floats of shared memory of cf_fwd_rows_kernel.
__host__ __device__ inline int fwd_rows_smem_floats(int N, int H, int h) {
  constexpr int P = kFwdPerBlock;
  return P * 2 * H * h + h + (kThreads / 32) * P * h + 3 * P * H * N;
}

__global__ void __launch_bounds__(kThreads, 4) cf_fwd_rows_kernel(
    const float* __restrict__ terms, const float* __restrict__ base,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ out, int N, int H,
    int h) {
  extern __shared__ float smem[];
  constexpr int P = kFwdPerBlock;
  const int HN = H * N, NN = N * N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = kThreads / 32, h4 = h / kCols;
  float* s_v = smem;                     // [P][2H][h]: wa_h[I], dws_h[I]
  float* s_bias = s_v + P * 2 * H * h;   // [h]
  float* s_pool = s_bias + h;            // [nwarps][P][h]: each warp's pooled rows
  float* s_rz = s_pool + nwarps * P * h;  // [P][H][N]: 1 / Z of column I
  float* s_wz = s_rz + P * HN;           // corr / Z
  float* s_wr = s_wz + P * HN;           // rep / Z

  const int per_group = (N + P - 1) / P;
  const int b = blockIdx.x / per_group, I0 = (blockIdx.x % per_group) * P;
  const int np = min(P, N - I0);         // the block's counterfactuals I0 + p
  const size_t bh0 = static_cast<size_t>(b) * H;  // (b, head 0)

  // the rows wa_h[I], dws_h[I] of every head and counterfactual, and bias,
  // to shared memory; the pooled rows start at 0
  for (int c = threadIdx.x; c < h4; c += blockDim.x) {
    const int o = c * kCols;
    for (int p = 0; p < np; ++p) {
      float4 v[2 * kMaxH];
#pragma unroll
      for (int hh = 0; hh < kMaxH; ++hh) {
        const size_t at = ((bh0 + hh) * N + I0 + p) * h + o;
        v[2 * hh] = hh < H ? load4(wa + at) : zero4();
        v[2 * hh + 1] = hh < H ? load4(dws + at) : zero4();
      }
#pragma unroll
      for (int j = 0; j < 2 * kMaxH; ++j)
        if (j < 2 * H) store4(s_v + (p * 2 * H + j) * h + o, v[j]);
    }
    store4(s_bias + o, load4(bias + o));
    for (int r = 0; r < nwarps * P; ++r) store4(s_pool + r * h + o, zero4());
  }
  for (int k = threadIdx.x; k < np * HN; k += blockDim.x) {
    const int p = k / HN, hh = (k % HN) / N, n = k % N;
    const float* t = terms + (bh0 + hh) * kTerms * NN + n * N + I0 + p;
    const float Z = t[kZ * NN];
    s_rz[k] = 1.0f / Z;
    s_wz[k] = t[kCorr * NN] / Z;
    s_wr[k] = t[kRep * NN] / Z;
  }
  bool valid[kLaneChunks];
#pragma unroll
  for (int k = 0; k < kLaneChunks; ++k) valid[k] = lane + 32 * k < h4;
  __syncthreads();

  float* pool = s_pool + warp * P * h;
  for (int n = warp; n < N; n += nwarps) {
    const int kd = n - I0;  // the counterfactual whose diagonal row n is
    const bool has_diag = kd >= 0 && kd < np;
    float4 nm[kMaxH][kLaneChunks];
    // fc[n, I0 + p] from the base rows in nm, its LayerNorm, and its share
    // of the pool
    auto add_row = [&](int p, bool diag) {
      float4 f[kLaneChunks];
      const float s = rebuild_fc(f, nm, s_rz, s_wz, s_wr, p * HN + n, s_v + p * 2 * H * h,
                                 s_bias, x_a, static_cast<size_t>(b) * N + n, delta,
                                 static_cast<size_t>(b) * N + I0 + p, diag, N, H, h, valid,
                                 lane);
      const float rstd = center_row(f, s, h, valid);
#pragma unroll
      for (int k = 0; k < kLaneChunks; ++k) {
        if (!valid[k]) continue;
        float* at = pool + p * h + (lane + 32 * k) * kCols;
        const float4 q = load4(at);
        store4(at, make_float4(q.x + f[k].x * rstd, q.y + f[k].y * rstd,
                               q.z + f[k].z * rstd, q.w + f[k].w * rstd));
      }
    };
    // the base rows of (n, I): num_h[n] for I != n, shared by the block's
    // off-diagonal rows; num2_h[n] for the diagonal row (n = I), built last
    if (np > 1 || !has_diag) {
      load_base_rows(nm, base, 2 * bh0 * N + n, N, H, h, valid, lane);
#pragma unroll 1
      for (int p = 0; p < np; ++p)
        if (p != kd) add_row(p, false);
    }
    if (has_diag) {
      load_base_rows(nm, base, 2 * bh0 * N + N + n, N, H, h, valid, lane);
      add_row(kd, true);
    }
  }
  __syncthreads();

  // pooled[b, I] = (sum over the warps, in order) / N
  const float rows = static_cast<float>(N);
  for (int k = threadIdx.x; k < np * h4; k += blockDim.x) {
    const int p = k / h4, o = (k % h4) * kCols;
    float4 acc = load4(s_pool + p * h + o);
    for (int w = 1; w < nwarps; ++w) acc = add4(acc, load4(s_pool + (w * P + p) * h + o));
    store4(out + (static_cast<size_t>(b) * N + I0 + p) * h + o,
           make_float4(acc.x / rows, acc.y / rows, acc.z / rows, acc.w / rows));
  }
}

// ── Backward, stage 1: the rows of one (b, I) ─────────────────────────────

__global__ void __launch_bounds__(kThreads, 4) cf_bwd_rows_kernel(
    const float* __restrict__ terms, const float* __restrict__ base,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ d_fc, float* __restrict__ dS_as,
    float* __restrict__ dS_ss, float* __restrict__ d_wa,
    float* __restrict__ d_dws, float* __restrict__ d_delta,
    float* __restrict__ d_scores, int N, int H, int h, float sqrt_d) {
  extern __shared__ float smem[];
  const int HN = H * N, NN = N * N;
  float* s_v = smem;              // [2H][h]: wa_h[I], dws_h[I] of every head
  float* s_bias = s_v + 2 * H * h;  // [h]
  float* s_corr = s_bias + h;     // [H][N], column I of each term
  float* s_rep = s_corr + HN;
  float* s_Z = s_rep + HN;
  float* s_rz = s_Z + HN;         // 1 / Z
  float* s_wz = s_rz + HN;        // corr / Z
  float* s_wr = s_wz + HN;        // rep / Z

  const int b = blockIdx.x / N, I = blockIdx.x % N;
  const size_t bI = static_cast<size_t>(b) * N + I;
  const size_t bh0 = static_cast<size_t>(b) * H;  // (b, head 0)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32, h4 = h / kCols;
  const float rows = static_cast<float>(N), cols = static_cast<float>(h);

  // the rows wa_h[I], dws_h[I] of every head, and bias, to shared memory
  // (loaded first, so that their loads overlap those of the terms)
  const int c = threadIdx.x;
  float4 v_in[2 * kMaxH + 1];
  if (c < h4) {
#pragma unroll
    for (int hh = 0; hh < kMaxH; ++hh) {
      const size_t at = ((bh0 + hh) * N + I) * h + c * kCols;
      v_in[2 * hh] = hh < H ? load4(wa + at) : zero4();
      v_in[2 * hh + 1] = hh < H ? load4(dws + at) : zero4();
    }
    v_in[2 * kMaxH] = load4(bias + c * kCols);
  }
  for (int k = threadIdx.x; k < HN; k += blockDim.x) {
    const int hh = k / N, n = k % N;
    const float* t = terms + (bh0 + hh) * kTerms * NN + n * N + I;
    const float corr = t[kCorr * NN], rep = t[kRep * NN], Z = t[kZ * NN];
    s_corr[k] = corr;
    s_rep[k] = rep;
    s_Z[k] = Z;
    s_rz[k] = 1.0f / Z;
    s_wz[k] = corr / Z;
    s_wr[k] = rep / Z;
  }
  if (c < h4) {
#pragma unroll
    for (int hh = 0; hh < kMaxH; ++hh) {
      if (hh >= H) continue;
      store4(s_v + (2 * hh) * h + c * kCols, v_in[2 * hh]);
      store4(s_v + (2 * hh + 1) * h + c * kCols, v_in[2 * hh + 1]);
    }
    store4(s_bias + c * kCols, v_in[2 * kMaxH]);
  }

  // this lane's columns: the float4s c = lane + 32 k, k < kLaneChunks
  bool valid[kLaneChunks];
  float4 dy[kLaneChunks];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kLaneChunks; ++k) {
    valid[k] = lane + 32 * k < h4;
    // pool backward: every row n of I gets dout[b, I] / N
    const float4 go = valid[k] ? load4(dout + bI * h + (lane + 32 * k) * kCols) : zero4();
    dy[k] = make_float4(go.x / rows, go.y / rows, go.z / rows, go.w / rows);
    s += sum4(dy[k]);
  }
  const float mean_dy = warp_sum(s) / cols;
  __syncthreads();  // the terms of I, wa_h[I], dws_h[I] and bias are in shared memory

  for (int n = warp; n < N; n += nwarps) {
    const bool diag = n == I;
    // fc[n, I] from the base rows (num[n], num2[I] on n = I), then the
    // LayerNorm backward, two-pass statistics: f becomes y, then d_fc
    float4 f[kLaneChunks], nm[kMaxH][kLaneChunks];
    load_base_rows(nm, base, 2 * bh0 * N + (diag ? N + I : n), N, H, h, valid, lane);
    s = rebuild_fc(f, nm, s_rz, s_wz, s_wr, n, s_v, s_bias, x_a, static_cast<size_t>(b) * N + n,
                   delta, bI, diag, N, H, h, valid, lane);
    const float rstd = center_row(f, s, h, valid);
    s = 0.f;
#pragma unroll
    for (int k = 0; k < kLaneChunks; ++k) {
      f[k] = scale4(f[k], rstd);
      s += dot4(dy[k], f[k]);
    }
    const float m2 = warp_sum(s) / cols;
    float* out = d_fc + (bI * N + n) * h;
#pragma unroll
    for (int k = 0; k < kLaneChunks; ++k) {
      if (!valid[k]) continue;
      const int o = (lane + 32 * k) * kCols;
      f[k] = make_float4(rstd * ((dy[k].x - mean_dy) - f[k].x * m2),
                         rstd * ((dy[k].y - mean_dy) - f[k].y * m2),
                         rstd * ((dy[k].z - mean_dy) - f[k].z * m2),
                         rstd * ((dy[k].w - mean_dy) - f[k].w * m2));
      store4(out + o, f[k]);
    }
    // the three dot products of every head (invalid columns hold zeros)
    float v[3 * kMaxH];
#pragma unroll
    for (int hh = 0; hh < kMaxH; ++hh) {
      v[3 * hh] = v[3 * hh + 1] = v[3 * hh + 2] = 0.f;
#pragma unroll
      for (int k = 0; k < kLaneChunks; ++k) {
        if (hh >= H || !valid[k]) continue;
        const int o = (lane + 32 * k) * kCols;
        v[3 * hh] += dot4(f[k], nm[hh][k]);
        v[3 * hh + 1] += dot4(f[k], load4(s_v + (2 * hh) * h + o));
        v[3 * hh + 2] += dot4(f[k], load4(s_v + (2 * hh + 1) * h + o));
      }
    }
    float tri[3];
    warp_sum_heads(v, tri);
    const int hh = lane / 8;
    if (lane % 8 == 0 && hh < H) {
      const int t = hh * N + n;
      const float Z = s_Z[t], corr = s_corr[t], rep = s_rep[t];
      const float dZ = -((((tri[0] + corr * tri[1]) + rep * tri[2]) / Z) / Z);
      const float d_zc = tri[1] / Z + dZ;
      const float d_E = tri[2] / Z + d_zc;
      const size_t at = (bh0 + hh) * N + n;  // row (b, hh, n)
      dS_as[at * N + I] = diag ? 0.f : (rep * d_E) / sqrt_d;
      if (diag) dS_ss[at] = (rep * d_E) / sqrt_d;
      float* sc = d_scores + (bh0 + hh) * 2 * NN + n * N + I;
      sc[0] = -d_zc;  // -d_zc2 on n = I
      sc[NN] = dZ;    // dZ2 on n = I
    }
  }
  __syncthreads();  // every row of d_fc is written (a barrier orders the
                    // block's stores to device memory before its loads)

  // sums over n of this thread's columns of the rows just stored (L2):
  // d_dws[b, :, I], d_wa's first term, d_delta
  if (c >= h4) return;
  const float* rows_I = d_fc + bI * N * h + c * kCols;
  float4 gw[kMaxH], gd[kMaxH];
#pragma unroll
  for (int hh = 0; hh < kMaxH; ++hh) gw[hh] = gd[hh] = zero4();
  for (int n = 0; n < N; ++n) {
    const float4 dv = load4(rows_I + static_cast<size_t>(n) * h);
#pragma unroll
    for (int hh = 0; hh < kMaxH; ++hh) {
      if (hh >= H) continue;
      const float wz = s_wz[hh * N + n], wr = s_wr[hh * N + n];
      gw[hh] = make_float4(gw[hh].x + wz * dv.x, gw[hh].y + wz * dv.y,
                           gw[hh].z + wz * dv.z, gw[hh].w + wz * dv.w);
      gd[hh] = make_float4(gd[hh].x + wr * dv.x, gd[hh].y + wr * dv.y,
                           gd[hh].z + wr * dv.z, gd[hh].w + wr * dv.w);
    }
  }
#pragma unroll
  for (int hh = 0; hh < kMaxH; ++hh) {
    if (hh >= H) continue;
    const size_t at = ((bh0 + hh) * N + I) * h + c * kCols;
    store4(d_wa + at, gw[hh]);
    store4(d_dws + at, gd[hh]);
  }
  store4(d_delta + bI * h + c * kCols, load4(rows_I + static_cast<size_t>(I) * h));
}

// ── Backward, stage 2: the sums over I of one group ───────────────────────

__global__ void __launch_bounds__(kThreads) cf_bwd_sums_kernel(
    const float* __restrict__ terms, const float* __restrict__ d_fc,
    float* __restrict__ d_num, float* __restrict__ d_xa,
    float* __restrict__ d_bias_part, int N, int H, int h) {
  extern __shared__ float smem[];  // [H][n][I]: 1 / Z[n, I], 0 on I = n
  const int NN = N * N;
  const int b = blockIdx.x;
  const size_t bh0 = static_cast<size_t>(b) * H;
  for (int k = threadIdx.x; k < H * NN; k += blockDim.x) {
    const int hh = k / NN, nI = k % NN;
    const float Z = terms[((bh0 + hh) * kTerms + kZ) * NN + nI];
    smem[k] = nI / N == nI % N ? 0.f : 1.0f / Z;
  }
  __syncthreads();
  const int o = threadIdx.x * kCols;
  if (o >= h) return;
  const float* src = d_fc + static_cast<size_t>(b) * NN * h + o;  // [I][n][o]
  float4 bsum = zero4();
  for (int n = 0; n < N; ++n) {
    float4 xa = zero4(), dn[kMaxH];
#pragma unroll
    for (int hh = 0; hh < kMaxH; ++hh) dn[hh] = zero4();
#pragma unroll 4
    for (int I = 0; I < N; ++I) {
      const float4 dv = load4(src + static_cast<size_t>(I * N + n) * h);
      xa = add4(xa, dv);
#pragma unroll
      for (int hh = 0; hh < kMaxH; ++hh) {
        if (hh >= H) continue;
        const float w = smem[(hh * N + n) * N + I];
        dn[hh] = make_float4(dn[hh].x + w * dv.x, dn[hh].y + w * dv.y,
                             dn[hh].z + w * dv.z, dn[hh].w + w * dv.w);
      }
    }
#pragma unroll
    for (int hh = 0; hh < kMaxH; ++hh)
      if (hh < H) store4(d_num + ((bh0 + hh) * N + n) * h + o, dn[hh]);
    store4(d_xa + (static_cast<size_t>(b) * N + n) * h + o, xa);
    bsum = add4(bsum, xa);
  }
  store4(d_bias_part + static_cast<size_t>(b) * h + o, bsum);
}

// d_bias[o] = sum over b of part[b, o]: a block of 32 columns x kSumLanes
// lanes; lane j sums b = j, j + kSumLanes, ... in order, then the lanes'
// sums are added in order of j (runs of 32 at the main path's B = 1024,
// which keeps the rounding of the sum near that of a tree).
constexpr int kSumLanes = 32;

__global__ void __launch_bounds__(32 * kSumLanes) sum_over_groups_kernel(
    const float* __restrict__ part, float* __restrict__ out, int B, int h) {
  __shared__ float s_part[kSumLanes][32];
  const int tx = threadIdx.x % 32, j = threadIdx.x / 32;
  const int o = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (o < h) {
#pragma unroll 4
    for (int b = j; b < B; b += kSumLanes) acc += part[static_cast<size_t>(b) * h + o];
  }
  s_part[j][tx] = acc;
  __syncthreads();
  if (j == 0 && o < h) {
    float x = 0.f;
#pragma unroll
    for (int k = 0; k < kSumLanes; ++k) x += s_part[k][tx];
    out[o] = x;
  }
}

// ── Backward, stage 3: the products of one (b, head) ──────────────────────

constexpr int kProductThreads = 256;  // threads of a products block

// out(n, m) = x[n] . w[m] over h columns, for n, m < N, from rows staged at
// a stride of hs floats; each thread takes rows n and n + P of x against
// row m of w (P = ceil(N / 2); neighbouring threads read neighbouring rows
// of w, in distinct banks), and hands each output to epilogue(n, m, value).
template <typename Epilogue>
__device__ void staged_products(const float* s_x, const float* s_w, int N,
                                int h, int hs, Epilogue epilogue) {
  const int P = (N + 1) / 2;
  for (int t = threadIdx.x; t < P * N; t += blockDim.x) {
    const int n0 = t / N, m = t % N;
    const int n1 = min(n0 + P, N - 1);
    const float* x0 = s_x + n0 * hs;
    const float* x1 = s_x + n1 * hs;
    const float* w = s_w + m * hs;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int o = 0; o < h; o += kCols) {
      const float4 q = load4(w + o);
      a0 += dot4(load4(x0 + o), q);
      a1 += dot4(load4(x1 + o), q);
    }
    epilogue(n0, m, a0);
    if (n0 + P < N) epilogue(n0 + P, m, a1);
  }
}

// d_wa[b, hh, m] += sum_n E[n, m] u[n] for every m (E an N x N term in
// shared memory, u staged rows): one thread per 4 columns and kM rows m.
__device__ void add_transposed_product(float* d_wa_h, const float* s_e,
                                       const float* s_u, int N, int h, int hs) {
  const int h4 = h / kCols, jobs = h4 * ((N + kM - 1) / kM);
  for (int job = threadIdx.x; job < jobs; job += blockDim.x) {
    const int o = (job % h4) * kCols, m0 = (job / h4) * kM;
    float4 acc[kM];
#pragma unroll
    for (int k = 0; k < kM; ++k)
      acc[k] = m0 + k < N ? load4(d_wa_h + static_cast<size_t>(m0 + k) * h + o)
                          : zero4();
    for (int n = 0; n < N; ++n) {
      const float4 u = load4(s_u + n * hs + o);
#pragma unroll
      for (int k = 0; k < kM; ++k) {
        const float e = s_e[n * N + min(m0 + k, N - 1)];
        acc[k] = make_float4(acc[k].x + e * u.x, acc[k].y + e * u.y,
                             acc[k].z + e * u.z, acc[k].w + e * u.w);
      }
    }
#pragma unroll
    for (int k = 0; k < kM; ++k)
      if (m0 + k < N) store4(d_wa_h + static_cast<size_t>(m0 + k) * h + o, acc[k]);
  }
}

// Copies R rows of h floats (src row r at src + r * h) to shared memory at a
// row stride of hs floats, scaled by scale[r] if scale is not null; each
// thread has kStageLoads 16-byte loads in flight at a time.
constexpr int kStageLoads = 8;

__device__ void stage_rows(float* dst, const float* src, const float* scale,
                           int R, int h, int hs) {
  const int h4 = h / kCols, total = R * h4;
  for (int k0 = threadIdx.x; k0 < total; k0 += kStageLoads * blockDim.x) {
    float4 v[kStageLoads];
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const int k = k0 + j * blockDim.x;
      v[j] = k < total ? load4(src + static_cast<size_t>(k / h4) * h + (k % h4) * kCols)
                       : zero4();
    }
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const int k = k0 + j * blockDim.x;
      if (k >= total) continue;
      const int r = k / h4;
      float4 x = v[j];
      if (scale != nullptr)
        x = make_float4(x.x / scale[r], x.y / scale[r], x.z / scale[r], x.w / scale[r]);
      store4(dst + r * hs + (k % h4) * kCols, x);
    }
  }
}

// Floats of shared memory of cf_bwd_products_kernel.
__host__ __device__ inline int products_smem_floats(int N, int h) {
  return 2 * N * (h + kCols) + 4 * N * N + 2 * N;
}

__global__ void __launch_bounds__(kProductThreads) cf_bwd_products_kernel(
    const float* __restrict__ terms, const float* __restrict__ wa,
    const float* __restrict__ d_num, const float* __restrict__ d_delta,
    const float* __restrict__ d_scores, float* __restrict__ dS_aa,
    float* __restrict__ dS_sa, float* __restrict__ d_wa, int N, int H, int h,
    float sqrt_d) {
  extern __shared__ float smem[];
  const int NN = N * N, hs = h + kCols;
  float* s_w = smem;            // [N][hs]: wa_h
  float* s_u = s_w + N * hs;    // [N][hs]: d_num, then dU2
  float* s_Eaa = s_u + N * hs;  // [N][N]
  float* s_Esa = s_Eaa + NN;    // [N][N]
  float* s_a = s_Esa + NN;      // [N][N]: -d_zc (-d_zc2 on the diagonal)
  float* s_dz = s_a + NN;       // [N][N]: dZ (dZ2 on the diagonal)
  float* s_sdz = s_dz + NN;     // [N]: sum over I != n of dZ[n, I]
  float* s_z2 = s_sdz + N;      // [N]: Z2[I]
  const size_t bh = blockIdx.x;  // (b, head)
  const size_t b = bh / H;
  const float* t = terms + bh * kTerms * NN;
  const float* sc = d_scores + bh * 2 * NN;
  stage_rows(s_w, wa + bh * N * h, nullptr, N, h, hs);
  stage_rows(s_u, d_num + bh * N * h, nullptr, N, h, hs);
  for (int k = threadIdx.x; k < NN; k += blockDim.x) {
    s_Eaa[k] = t[kEaa * NN + k];
    s_Esa[k] = t[kEsa * NN + k];
    s_a[k] = sc[k];
    s_dz[k] = sc[NN + k];
  }
  if (threadIdx.x < N) s_z2[threadIdx.x] = t[kZ * NN + threadIdx.x * (N + 1)];
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float x = 0.f;
    for (int I = 0; I < N; ++I)
      if (I != n) x += s_dz[n * N + I];
    s_sdz[n] = x;
  }
  __syncthreads();
  float* dwa_h = d_wa + bh * N * h;
  // d_wa_h[m] += sum_n E_aa[n, m] d_num[n]
  add_transposed_product(dwa_h, s_Eaa, s_u, N, h, hs);
  // dS_aa: d_Eaa[n, m] = (-d_zc[n, m] (m != n) + sum_I dZ[n, I]) + d_num[n].wa[m]
  float* ds = dS_aa + bh * NN;
  staged_products(s_u, s_w, N, h, hs, [&](int n, int m, float g) {
    const float dE = ((n == m ? 0.f : s_a[n * N + m]) + s_sdz[n]) + g;
    ds[n * N + m] = (s_Eaa[n * N + m] * dE) / sqrt_d;
  });
  __syncthreads();  // every thread is done with d_num
  // dU2[J] = d_delta[b, J] / Z2[J]
  stage_rows(s_u, d_delta + b * N * h, s_z2, N, h, hs);
  __syncthreads();  // s_u holds dU2
  // d_wa_h[m] += sum_J E_sa[J, m] dU2[J]
  add_transposed_product(dwa_h, s_Esa, s_u, N, h, hs);
  // dS_sa: d_Esa[I, m] = (dZ2[I] - (m == I) d_zc2[I]) + dU2[I].wa[m]
  ds = dS_sa + bh * NN;
  staged_products(s_u, s_w, N, h, hs, [&](int I, int m, float g) {
    const float dE = (s_dz[I * N + I] + (m == I ? s_a[I * N + I] : 0.f)) + g;
    ds[I * N + m] = (s_Esa[I * N + m] * dE) / sqrt_d;
  });
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The kernels take h % 4 == 0 and h <= 512 (one row a warp, 16 columns a
// lane; one block of kThreads threads of 4 columns), N <= 32 and H <= 4 (the
// heads' dot products share one warp reduction); the Python wrapper refuses
// other shapes first.
bool shape_ok(int B, int N, int H, int h) {
  return B > 0 && N > 0 && N <= kMaxN && H > 0 && H <= kMaxH && h > 0 &&
         h % kCols == 0 && h <= kMaxCols;
}

}  // namespace

extern "C" {

// Both directions start with stage 0, then the forward takes one launch
// (stage 1, rows) and the backward three (rows, sums, products), on one
// stream in that order (the Python wrapper makes them). Each entry point
// returns cudaGetLastError() after its launches (0 = success), or
// cudaErrorInvalidValue for shapes the kernels do not take (shape_ok). Needs
// 16-byte aligned pointers (checked by the wrapper). Scratch: terms
// (B, H, 5, N, N), base (B, H, 2N, h); the backward's also d_fc
// (B, N, N, h) as [b, I, n, o], d_scores (B, H, 2, N, N), d_num
// (B, H, N, h), d_bias_part (B, h).

// Stage 0 of both: terms and base.
int cf_bwd_base_launch(const float* S_aa, const float* S_as, const float* S_sa,
                       const float* S_ss, const float* wa, float* terms,
                       float* base, int B, int N, int H, int h, float sqrt_d,
                       void* stream) {
  if (!shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(3 * N * N + 4 * N) * sizeof(float);
  cf_bwd_base_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      S_aa, S_as, S_sa, S_ss, wa, terms, base, N, h, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

// The forward's stage 1: pooled (B, N, h) into out.
int cf_fwd_rows_launch(const float* terms, const float* base, const float* wa,
                       const float* dws, const float* x_a, const float* delta,
                       const float* bias, float* out, int B, int N, int H, int h,
                       void* stream) {
  if (!shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(fwd_rows_smem_floats(N, H, h)) * sizeof(float);
  const cudaError_t err = allow_smem(cf_fwd_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = B * ((N + kFwdPerBlock - 1) / kFwdPerBlock);
  cf_fwd_rows_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      terms, base, wa, dws, x_a, delta, bias, out, N, H, h);
  return static_cast<int>(cudaGetLastError());
}

// The backward's stages 1 to 3.

// Stage 1: d_fc, dS_as, dS_ss, d_dws, d_delta, d_scores, and d_wa's first term.
int cf_bwd_rows_launch(const float* terms, const float* base, const float* wa,
                       const float* dws, const float* x_a, const float* delta,
                       const float* bias, const float* dout, float* d_fc,
                       float* dS_as, float* dS_ss, float* d_wa, float* d_dws,
                       float* d_delta, float* d_scores, int B, int N, int H,
                       int h, float sqrt_d, void* stream) {
  if (!shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>((2 * H + 1) * h + 6 * H * N) * sizeof(float);
  cudaError_t err = allow_smem(cf_bwd_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cf_bwd_rows_kernel<<<B * N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      terms, base, wa, dws, x_a, delta, bias, dout, d_fc, dS_as, dS_ss, d_wa,
      d_dws, d_delta, d_scores, N, H, h, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

// Stage 2: d_num, d_xa, and d_bias through the partial d_bias_part.
int cf_bwd_sums_launch(const float* terms, const float* d_fc, float* d_num,
                       float* d_xa, float* d_bias_part, float* d_bias, int B,
                       int N, int H, int h, void* stream) {
  if (!shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(H * N * N) * sizeof(float);
  cf_bwd_sums_kernel<<<B, kThreads, smem, s>>>(terms, d_fc, d_num, d_xa,
                                                  d_bias_part, N, H, h);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_over_groups_kernel<<<(h + 31) / 32, 32 * kSumLanes, 0, s>>>(d_bias_part,
                                                                  d_bias, B, h);
  return static_cast<int>(cudaGetLastError());
}

// Stage 3: dS_aa, dS_sa, and d_wa completed in place.
int cf_bwd_products_launch(const float* terms, const float* wa,
                           const float* d_num, const float* d_delta,
                           const float* d_scores, float* dS_aa, float* dS_sa,
                           float* d_wa, int B, int N, int H, int h, float sqrt_d,
                           void* stream) {
  if (!shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(products_smem_floats(N, h)) * sizeof(float);
  cudaError_t err = allow_smem(cf_bwd_products_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cf_bwd_products_kernel<<<B * H, kProductThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      terms, wa, d_num, d_delta, d_scores, dS_aa, dS_sa, d_wa, N, H, h, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
