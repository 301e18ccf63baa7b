// The wide route of the fused counterfactual attention of
// POCACritic.all_baselines (K5f forward, K5b backward), for Hopper
// (sm_90a): every shape the JAX function takes, where the tuned kernels
// (cf_attention.cu) take h <= 512 with h % 4 == 0, N <= 32 and H <= 4.
// ops/cf_attention.py picks the route by shape alone (route()).
//
// Replaces (TPU kernels): swarmacb_tpu/ops/cf_attention.py: _cf_fwd
// (Pallas body _fwd_kernel) and _cf_bwd (Pallas body _bwd_kernel), at the
// widths whose _pick_G shrinks the groups per block until a block fits.
//
// The algebra is cf_attention.cu's (a score row of counterfactual I differs
// from a shared base row in one element, so the softmax and the value
// contraction are a base term plus a rank-1 correction), and the stages are
// those of the plain versions cf_forward_reference and
// cf_backward_reference, formula for formula. fc of row (n, I) is rebuilt
// from the base products as
//   fc = ((sum_h num_h / Z + sum_h (corr / Z) wa_h[I] + (rep / Z) dws_h[I])
//         + bias) + x_a[n]  (+ delta[I] on n = I),
// num_h the base row num_h[n] (num2_h[I] on n = I), the heads summed four
// at a time.
//
// What bounds it: bytes. At B = 1024, N = 20, H = 4, h = 1024 the staged
// route moves 2.67 GB forward and 8.71 GB backward with its scratch (0.80
// and 2.60 ms at 3.35 TB/s; chip_smoke._cf_forward_stage_work and
// _cf_backward_stage_work), against ~25 and ~62 GFLOP (0.37 and 0.93 ms on
// the CUDA cores). The first form of this route took 16.3 and 29.5 ms: its
// rows re-read the group's base rows from L2 once per counterfactual and
// waited out each load's latency, and its products ran 64 x 64 tiles over
// outputs of 20 rows. A rows block here is bound by its own latency (a
// block takes as long at B = 16 as at B = 1024), so the design keeps loads
// in flight ahead of their use and tables on chip.
//
// Design, every kernel float32 on the CUDA cores:
//   0. base (both directions): cf_wide_terms_kernel, a thread a row
//      (b, head, n): the softmax terms (E_aa, E_sa, corr, rep, Z, laid out
//      [5][n][I]) and the coefficients of each rows block (coef, laid out
//      [b][I][n][3][Hp], Hp = H in whole float4s: 1/Z, corr/Z, rep/Z of
//      every head, zeros past H). cf_wide_base_kernel, a block per
//      (b, head): E_aa wa_h and E_sa wa_h, a thread a column, 16 rows at a
//      time, [E_aa; E_sa] transposed in shared memory so that one float4
//      serves four rows (in blocks of rows past N = 6,144); wa_h is read
//      from memory once per block of rows.
//   rows (both directions): a block of 512 threads per (b, P
//      counterfactuals), P from the plan (cf_attention.cf_wide_plan, which
//      mirrors rows_head_floats below: two where the block's P N rows of
//      h floats fit in shared memory beside its coefficients and dout / N;
//      else one; where not even one counterfactual's rows fit, two, with the
//      rows in device memory: the forward's (B, N*N, h) scratch, the
//      backward's d_fc, and their statistics in a scratch beside them).
//      The kernels are templated on where the rows live,
//      so that the shared-memory form addresses them as such. build_rows
//      takes a thread a column: each base row num_h[n] is read once per
//      block and serves its P counterfactuals, the next chunk of rows'
//      loads in flight while a chunk is summed; wa_h[I], dws_h[I],
//      num2_h[I] and delta[I] of the column wait in registers and the
//      block's coefficients in shared memory. fc is written once, to the
//      block's rows, and stays there.
//   forward: the two-pass statistics (a warp a row, column tiles of 512:
//      layernorm_tiled is their plain version), then the pool.
//   backward, three more stages:
//   1. rows (cf_wide_bwd_rows_kernel): the rows, the statistics, the
//      LayerNorm backward in place (dout / N in shared memory), a thread a
//      column: d_fc out to device memory once, d_delta, and the sums over n
//      into d_dws[b, :, I] and the first term of d_wa[b, :, I]; then the
//      three dot products of each row and head (A with the base row, Bv
//      with wa_h[I], C with dws_h[I]), a quarter of the block a head, a
//      thread eight columns with wa_h[I] and dws_h[I] in registers, walking
//      the rows n with the next row's base values in flight: each warp's
//      sums by shuffles, then the quarter's warps' in order through shared
//      memory, eight rows at a time; the last column block turns them into
//      dS_as, dS_ss and the score scratch (-d_zc, dZ) (the sums of a longer
//      row pass through a (B, N, N, 3, H) scratch, dots).
//   2. sums (cf_wide_sums_kernel), a thread a column of group b: d_xa (the
//      sum over I of d_fc), its sum over n into a (B, h) partial, and
//      d_num (the sum over I != n of d_fc / Z) of four heads, from one read
//      of d_fc, 1 / Z in shared memory where the group's table fits; then
//      the compensated sum of the partials over b.
//   3. products (cf_wide_products_kernel), a block per (b, head), the
//      columns in tiles of 128 copied by cp.async into a double buffer: the
//      rows of d_num, d_delta (made dU2 = d_delta / Z2 in place: no dU2
//      scratch), wa_h and d_wa; a thread a (column, four rows) completes
//      d_wa += E_aa^T d_num + E_sa^T dU2, and a thread a block of 2 rows x
//      4 columns of d_num wa_h^T and dU2 wa_h^T (four columns a float4; the
//      columns split among groups of threads where the blocks leave
//      threads over) sums them over the tiles; the epilogue makes dS_aa and
//      dS_sa. E_aa and E_sa are read as float4s from shared memory where
//      the group's tables fit, else from the terms in device memory. Past
//      N = 880, where no tile of the 4N rows fits, the same sums read
//      their rows from device memory (cf_wide_products_dwa_kernel,
//      cf_wide_products_ds_kernel).
// No sum crosses a block and there are no atomics; every sum has a fixed
// order, so two calls give the same bits.

#include <algorithm>

#include "wide_common.cuh"

namespace {

using namespace wide;

constexpr int kRowThreads = 512;  // threads of a rows block
constexpr int kMaxPer = 2;      // counterfactuals a rows block takes at most (P)
constexpr int kHeadChunk = 4;   // heads a pass of the rows kernels takes
constexpr int kRowChunk = 4;    // rows n a thread rebuilds at a time
constexpr int kBaseRows = 16;   // base-product rows a thread sums at a time
constexpr int kDotCols = 8;     // columns a thread holds in the dot products
constexpr int kRedRows = 8;     // rows n whose dot products meet in shared memory at a time
constexpr int kCoef = 3;        // coefficient tables: 1 / Z, corr / Z, rep / Z
constexpr int kDots = 3;        // dot products of a row and head: A, Bv, C
constexpr int kProductTile = 128;  // columns of a products tile, at most
constexpr int kProductSmem = 120 * 1024;  // bytes of a products block's shared memory, at most
constexpr int kBaseSmem = 48 * 1024;      // bytes of a base block's shared memory, at most

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

__device__ inline float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ inline float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ inline float dot4(float4 a, float4 b) {
  return ((a.x * b.x + a.y * b.y) + a.z * b.z) + a.w * b.w;
}

// ── Stage 0: softmax terms and coefficients ───────────────────────────────

// The softmax terms of row n of one (b, head) z (cf_backward_base): with
// P = S / sqrt_d, M = max(max_m P_aa[n, :], max_m P_as[n, :]) and
// M2 = max(max_m P_sa[n, :], P_ss[n]),
//   terms[0][n][m] = E_aa = exp(P_aa - M),  terms[1][n][m] = E_sa = exp(P_sa - M2),
//   and for each I: corr, rep and Z of row n of counterfactual I:
//   (zc, E_as, Z_b + zc) at n != I, with zc = E_as - E_aa and Z_b the sum of
//   E_aa over the row, and (zc2, E_ss, Z2) at n = I, with zc2 = E_ss - E_sa
//   and Z2 = sum of E_sa over the row + zc2; sums in order of m. The
//   coefficients of the rows kernels: coef[b][I][n][t][hh] for t = 1 / Z,
//   corr / Z, rep / Z; the last head's thread writes the zeros past H.
__global__ void cf_wide_terms_kernel(const float* __restrict__ S_aa,
                                     const float* __restrict__ S_as,
                                     const float* __restrict__ S_sa,
                                     const float* __restrict__ S_ss,
                                     float* terms, float* __restrict__ coef,
                                     long long rows_total, int N, int H, float sqrt_d) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows_total) return;
  const long long z = t / N;
  const int n = static_cast<int>(t % N);
  const long long b = z / H;
  const int hh = static_cast<int>(z % H), Hp = round4(H);
  const size_t NN = static_cast<size_t>(N) * N;
  const size_t row = z * NN + static_cast<size_t>(n) * N;
  const float* aa = S_aa + row;
  const float* as = S_as + row;
  const float* sa = S_sa + row;
  float* T = terms + z * 5 * NN;
  float* e_aa = T + static_cast<size_t>(n) * N;
  float* e_sa = T + NN + static_cast<size_t>(n) * N;
  float M = -INFINITY;
  for (int m = 0; m < N; ++m) M = fmaxf(M, fmaxf(aa[m] / sqrt_d, as[m] / sqrt_d));
  float zb = 0.f;
  for (int m = 0; m < N; ++m) {
    e_aa[m] = expf(aa[m] / sqrt_d - M);
    zb += e_aa[m];
  }
  const float pss = S_ss[z * N + n] / sqrt_d;
  float M2 = pss;
  for (int m = 0; m < N; ++m) M2 = fmaxf(M2, sa[m] / sqrt_d);
  float z2 = 0.f;
  for (int m = 0; m < N; ++m) {
    e_sa[m] = expf(sa[m] / sqrt_d - M2);
    z2 += e_sa[m];
  }
  const float ess = expf(pss - M2);
  const float zc2 = ess - e_sa[n];
  for (int I = 0; I < N; ++I) {
    const float rep = I == n ? ess : expf(as[I] / sqrt_d - M);
    const float corr = I == n ? zc2 : rep - e_aa[I];
    const float Z = I == n ? z2 + zc2 : zb + corr;
    const size_t e = static_cast<size_t>(n) * N + I;
    T[2 * NN + e] = corr;
    T[3 * NN + e] = rep;
    T[4 * NN + e] = Z;
    float* c = coef + ((static_cast<size_t>(b) * N + I) * N + n) * kCoef * Hp;
    c[hh] = 1.0f / Z;
    c[Hp + hh] = corr / Z;
    c[2 * Hp + hh] = rep / Z;
    if (hh == H - 1)
      for (int k = H; k < Hp; ++k) c[k] = c[Hp + k] = c[2 * Hp + k] = 0.f;
  }
}

// Base products of one (b, head) z a block: base[z][r] = sum_m Ecat[r][m]
// wa_h[m] for the rows r < 2N of Ecat = [E_aa; E_sa] (rows n, then rows I).
// The block takes the rows in blocks of Rc (2N in whole kBaseRows where
// that fits kBaseSmem, which it does up to N = 6,144), and stages mc
// columns m of a row block at a time, transposed, at a row stride of Rc
// with zeros past 2N; a thread takes a column o and kBaseRows rows at a
// time, summed in order of m (the chunks of m, where there are several,
// added in order through base).
__global__ void __launch_bounds__(kThreads) cf_wide_base_kernel(
    const float* __restrict__ terms, const float* __restrict__ wa, float* base, int N, int h,
    int Rc, int mc) {
  extern __shared__ __align__(16) float smem[];  // [m - m0][Rc]
  const int R = 2 * N;
  const size_t z = blockIdx.x, NN = static_cast<size_t>(N) * N;
  const float* E = terms + z * 5 * NN;  // row r of Ecat at E + r N
  const float* w = wa + z * N * h;
  float* out = base + z * 2 * N * h;
  for (int rb = 0; rb < R; rb += Rc) {
    const int re = min(R, rb + Rc);
    for (int m0 = 0; m0 < N; m0 += mc) {
      const int m1 = min(N, m0 + mc);
      __syncthreads();  // the previous chunk's columns are used
      for (int q = threadIdx.x; q < (m1 - m0) * Rc; q += blockDim.x) {
        const int m = m0 + q / Rc, r = rb + q % Rc;
        smem[q] = r < R ? E[static_cast<size_t>(r) * N + m] : 0.f;
      }
      __syncthreads();
      for (int o = threadIdx.x; o < h; o += blockDim.x) {
        for (int r0 = rb; r0 < re; r0 += kBaseRows) {
          float acc[kBaseRows];
#pragma unroll
          for (int j = 0; j < kBaseRows; ++j) acc[j] = 0.f;
#pragma unroll 8
          for (int m = m0; m < m1; ++m) {
            const float x = w[static_cast<size_t>(m) * h + o];
            const float* e = smem + (m - m0) * Rc + (r0 - rb);
#pragma unroll
            for (int q = 0; q < kBaseRows / 4; ++q) {
              const float4 ev = ld4(e + 4 * q);
              acc[4 * q] += ev.x * x;
              acc[4 * q + 1] += ev.y * x;
              acc[4 * q + 2] += ev.z * x;
              acc[4 * q + 3] += ev.w * x;
            }
          }
#pragma unroll
          for (int j = 0; j < kBaseRows; ++j) {
            if (r0 + j >= R) continue;
            float* p = out + static_cast<size_t>(r0 + j) * h + o;
            *p = m0 == 0 ? acc[j] : *p + acc[j];
          }
        }
      }
    }
  }
}

// ── The rows of (b, P counterfactuals), both directions ──────────────────

// Floats of a rows block's shared memory before its rows: the warps' dot
// product sums (two buffers of kRedRows rows, 32 a warp and row), the
// statistics (mu, rstd, m2: P N each; m1: P) where the rows are there too
// (else they live in the stats scratch), the block's
// coefficients (P N 3 Hp) where they fit beside the rest, then in the
// backward d_y = dout / N of each counterfactual (P h) where the plan
// keeps it there; each rounded to whole float4s. The plan's mirror is
// cf_attention.cf_wide_plan.
__host__ __device__ inline size_t rows_head_floats(int N, int H, int h, int P, bool stats_in_smem,
                                                   bool coef_in_smem, bool dy_in_smem) {
  size_t f = 2 * kRedRows * kRowThreads;
  if (stats_in_smem) f += round4(3 * P * N + P);
  if (coef_in_smem) f += static_cast<size_t>(P) * N * kCoef * round4(H);
  if (dy_in_smem) f += static_cast<size_t>(P) * round4(h);
  return f;
}

// Whether a rows block keeps its coefficients in shared memory: wherever
// they fit beside the warps' sums and the statistics (the rows and dout / N,
// where the plan keeps them there, always fit beside them too).
__host__ __device__ inline bool coef_fits(int N, int H, int h, int P, bool stats_in_smem) {
  return rows_head_floats(N, H, h, P, stats_in_smem, true, false) * sizeof(float) <= kMaxSmem;
}

struct RowsBlock {
  int b, I0, nI;
  // the statistics s_mu .. s_m1 lie in shared memory, or in the block's
  // part of the stats scratch where the rows are in device memory
  float *s_red, *s_mu, *s_rstd, *s_m2, *s_m1, *s_dy, *s_cf, *rows_smem;
  const float* cf;  // the block's coefficients [p][n][3][Hp]: s_cf where they fit, else in
                    // device memory
};

// The block's (b, I0, nI) and its shared-memory regions; copies the
// block's coefficients from `coef` into shared memory where they fit (the
// copy ends with a barrier). The statistics live where the rows do: in
// shared memory (kRowsSmem), else in the block's 3 P N + P floats of the
// `stats` scratch.
template <bool kRowsSmem>
__device__ RowsBlock rows_block(float* smem, const float* __restrict__ coef, float* stats, int N,
                                int H, int h, int P, bool dy_in_smem) {
  const int per_group = (N + P - 1) / P, n_stats = 3 * P * N + P;
  constexpr bool stats_in_smem = kRowsSmem;
  const bool coef_in_smem = coef_fits(N, H, h, P, stats_in_smem);
  RowsBlock k;
  k.b = blockIdx.x / per_group;
  k.I0 = blockIdx.x % per_group * P;
  k.nI = min(P, N - k.I0);
  k.s_red = smem;
  float* head = smem + 2 * kRedRows * kRowThreads;
  k.s_mu = stats_in_smem ? head : stats + static_cast<size_t>(blockIdx.x) * n_stats;
  if (stats_in_smem) head += round4(n_stats);
  k.s_rstd = k.s_mu + P * N;
  k.s_m2 = k.s_rstd + P * N;
  k.s_m1 = k.s_m2 + P * N;
  float* s_cf = k.s_cf = head;
  const size_t table = static_cast<size_t>(P) * N * kCoef * round4(H);
  const float* g_cf = coef + (static_cast<size_t>(k.b) * N + k.I0) * N * kCoef * round4(H);
  k.cf = coef_in_smem ? s_cf : g_cf;
  k.s_dy = dy_in_smem ? s_cf + (coef_in_smem ? table : 0) : nullptr;
  k.rows_smem = smem + rows_head_floats(N, H, h, P, stats_in_smem, coef_in_smem, dy_in_smem);
  if (coef_in_smem) {
    const int n_cf = k.nI * N * kCoef * round4(H);
    for (int q = threadIdx.x; q < n_cf; q += blockDim.x) s_cf[q] = g_cf[q];
    __syncthreads();
  }
  return k;
}

// The sum of f(o) over the columns o < h, a warp: tile by tile as
// wide::warp_row_sum (tiles of kTile columns, the tiles' sums added in
// order), each lane's columns of a tile in four running sums, so that four
// of its loads are in flight at once. The whole warp calls it.
template <class F>
__device__ inline float row_sum4(int h, F f) {
  const int lane = threadIdx.x & 31;
  float total = 0.f;
  for (int c0 = 0; c0 < h; c0 += kTile) {
    const int c1 = min(c0 + kTile, h);
    float s[4] = {};
    for (int o = c0 + lane; o < c1; o += 128) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (o + 32 * u < c1) s[u] += f(o + 32 * u);
    }
    total += warp_sum((s[0] + s[1]) + (s[2] + s[3]));
  }
  return total;
}

// The two-pass LayerNorm statistics of rows[q h .. q h + h) for q < R, a
// warp a row: mu[q], then rstd[q] from the mean of squared deviations. The
// whole block calls it; it ends with a barrier.
__device__ void stats4(const float* rows, int R, int h, float* s_mu, float* s_rstd) {
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const float cols = static_cast<float>(h);
  for (int q = warp; q < R; q += nwarps) {
    const float* r = rows + static_cast<size_t>(q) * h;
    const float mu = row_sum4(h, [&](int o) { return r[o]; }) / cols;
    const float var = row_sum4(h, [&](int o) {
                        const float x = r[o] - mu;
                        return x * x;
                      }) / cols;
    if ((threadIdx.x & 31) == 0) {
      s_mu[q] = mu;
      s_rstd[q] = 1.0f / sqrtf(var + kLnEps);
    }
  }
  __syncthreads();
}

// The base rows num_h[n] of the chunk's heads and x_a[n] (on the last
// chunk of heads) for rows n0 .. n0 + kRowChunk - 1, column o; zeros past N
// and H.
struct RowChunk {
  float nm[kHeadChunk][kRowChunk], xa[kRowChunk];
  __device__ void load(const float* __restrict__ base, const float* __restrict__ xa_b,
                       int b, int c0, int n0, bool last, int N, int H, int h, int o) {
#pragma unroll
    for (int r = 0; r < kRowChunk; ++r) {
      const int n = n0 + r;
#pragma unroll
      for (int i = 0; i < kHeadChunk; ++i) {
        const size_t z = static_cast<size_t>(b) * H + c0 + i;
        nm[i][r] = n < N && c0 + i < H ? base[(z * 2 * N + n) * h + o] : 0.f;
      }
      xa[r] = last && n < N ? xa_b[static_cast<size_t>(n) * h + o] : 0.f;
    }
  }
};

// The fc rows r = p N + n (n < N, p < nI) of counterfactuals I0 .. I0 + nI
// - 1 of group b into rows[r h + o] (see the top). A thread takes a column
// o, four heads at a time: the heads' wa_h[I], dws_h[I] and num2_h[I] of
// the block's counterfactuals, and delta[I], into registers first, then
// kRowChunk rows n at a time: their base rows num_h[n] of the four heads
// and x_a[n], the next chunk's loads in flight while a chunk is summed;
// each row is written once per four heads (once where H <= 4). The whole
// block calls it; it ends with a barrier.
__device__ void build_rows(float* __restrict__ rows, const float* __restrict__ cf_b,
                           const float* __restrict__ base, const float* __restrict__ wa,
                           const float* __restrict__ dws, const float* __restrict__ x_a,
                           const float* __restrict__ delta, const float* __restrict__ bias,
                           int b, int I0, int nI, int N, int H, int h) {
  const int Hp = round4(H);
  const float* xa_b = x_a + static_cast<size_t>(b) * N * h;
  for (int o = threadIdx.x; o < h; o += blockDim.x) {
    const float bias_o = bias[o];
    for (int c0 = 0; c0 < H; c0 += kHeadChunk) {
      const bool first = c0 == 0, last = c0 + kHeadChunk >= H;
      float w[kMaxPer][kHeadChunk], dv[kMaxPer][kHeadChunk], n2[kMaxPer][kHeadChunk];
      float dl[kMaxPer];
#pragma unroll
      for (int p = 0; p < kMaxPer; ++p) {
        const size_t I = static_cast<size_t>(I0 + p);
#pragma unroll
        for (int i = 0; i < kHeadChunk; ++i) {
          const bool ok = p < nI && c0 + i < H;
          const size_t z = static_cast<size_t>(b) * H + c0 + i;
          w[p][i] = ok ? wa[(z * N + I) * h + o] : 0.f;
          dv[p][i] = ok ? dws[(z * N + I) * h + o] : 0.f;
          n2[p][i] = ok ? base[(z * 2 * N + N + I) * h + o] : 0.f;
        }
        dl[p] = last && p < nI ? delta[(static_cast<size_t>(b) * N + I) * h + o] : 0.f;
      }
      // fc of rows n0 .. n0 + kRowChunk - 1 from the chunk's loads
      auto sum_chunk = [&](const RowChunk& ch, int n0) {
#pragma unroll
        for (int p = 0; p < kMaxPer; ++p) {
          if (p >= nI) continue;
#pragma unroll
          for (int r = 0; r < kRowChunk; ++r) {
            const int n = n0 + r;
            if (n >= N) continue;
            const bool diag = n == I0 + p;
            const float* cf = cf_b + (static_cast<size_t>(p) * N + n) * kCoef * Hp + c0;
            const float4 rz = ld4(cf), wz = ld4(cf + Hp), wr = ld4(cf + 2 * Hp);
            float s1 = 0.f, s2 = 0.f;
#pragma unroll
            for (int i = 0; i < kHeadChunk; ++i) {
              s1 += (diag ? n2[p][i] : ch.nm[i][r]) * get(rz, i);
              s2 += get(wz, i) * w[p][i] + get(wr, i) * dv[p][i];
            }
            float* f = rows + (static_cast<size_t>(p) * N + n) * h + o;
            float v = first ? s1 + s2 : *f + (s1 + s2);
            if (last) {
              v = (v + bias_o) + ch.xa[r];
              if (diag) v += dl[p];
            }
            *f = v;
          }
        }
      };
      RowChunk a, c;
      a.load(base, xa_b, b, c0, 0, last, N, H, h, o);
      for (int n0 = 0; n0 < N; n0 += 2 * kRowChunk) {
        if (n0 + kRowChunk < N) c.load(base, xa_b, b, c0, n0 + kRowChunk, last, N, H, h, o);
        sum_chunk(a, n0);
        if (n0 + 2 * kRowChunk < N) a.load(base, xa_b, b, c0, n0 + 2 * kRowChunk, last, N, H, h, o);
        if (n0 + kRowChunk < N) sum_chunk(c, n0 + kRowChunk);
      }
    }
  }
  __syncthreads();
}

// Forward: pooled out[b, I] of P counterfactuals a block, the rows in
// shared memory (kRowsSmem: the compiler then knows them, and the
// coefficients, there) or in the (B, N*N, h) scratch; the statistics as
// rows_block says.
template <bool kRowsSmem>
__global__ void __launch_bounds__(kRowThreads, 1) cf_wide_fwd_rows_kernel(
    const float* __restrict__ coef, const float* __restrict__ base,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, float* scratch, float* stats, float* __restrict__ pooled,
    int N, int H, int h, int P) {
  extern __shared__ __align__(16) float smem[];
  const RowsBlock k = rows_block<kRowsSmem>(smem, coef, stats, N, H, h, P, false);
  const size_t bI0 = static_cast<size_t>(k.b) * N + k.I0;
  float* rows = kRowsSmem ? k.rows_smem : scratch + bI0 * N * h;
  build_rows(rows, kRowsSmem ? k.s_cf : k.cf, base, wa, dws, x_a, delta, bias, k.b, k.I0, k.nI,
             N, H, h);
  stats4(rows, k.nI * N, h, k.s_mu, k.s_rstd);
  // pooled[b, I] = mean over n of y, a thread a column, four rows in flight
  const float rows_n = static_cast<float>(N);
  for (int o = threadIdx.x; o < h; o += blockDim.x)
    for (int p = 0; p < k.nI; ++p) {
      const float* pr = rows + static_cast<size_t>(p) * N * h + o;
      const float* mu = k.s_mu + p * N;
      const float* rstd = k.s_rstd + p * N;
      float s[4] = {};
      for (int n0 = 0; n0 < N; n0 += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = n0 + u;
          if (n < N) s[u] += (pr[static_cast<size_t>(n) * h] - mu[n]) * rstd[n];
        }
      pooled[(bI0 + p) * h + o] = ((s[0] + s[1]) + (s[2] + s[3])) / rows_n;
    }
}

// The sum over the warp of each of 8 values: lane L ends with the sum of
// v[(L / 4) % 8] (each exchange halves the values a lane keeps; 9 exchanges
// in all, where 8 warp sums take 40).
template <int kHalf>
__device__ inline void fold8(float (&v)[8], int lane) {
  const bool up = lane & (4 * kHalf);
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = up ? v[j] : v[j + kHalf];
    v[j] = (up ? v[j + kHalf] : v[j]) + __shfl_xor_sync(0xffffffffu, send, 4 * kHalf);
  }
}

__device__ inline float warp_sum8(float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  fold8<4>(v, lane);
  fold8<2>(v, lane);
  fold8<1>(v, lane);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// The LayerNorm backward of the block's rows, with d_y = dout / N on every
// row of a counterfactual (k.s_dy, or dout itself where not staged): m1 =
// mean(d_y) per counterfactual and m2 = mean(d_y y) per row (a warp a row),
// then a thread a column turns each row into d_fc = rstd ((d_y - m1) - y
// m2) in place, four rows' loads at a time, writes it to `out` (the rows of
// d_fc in device memory; null where the rows are d_fc's) and d_delta, and
// sums it over n into d_dws and the first term of d_wa, four heads at a
// time. The whole block calls it; it ends with a barrier.
__device__ void ln_backward_sums(float* __restrict__ rows, float* __restrict__ out,
                                 const RowsBlock& k, const float* __restrict__ dout,
                                 float* __restrict__ d_wa, float* __restrict__ d_dws,
                                 float* __restrict__ d_delta, int b, int I0, int nI, int N,
                                 int H, int h, bool dy_in_smem) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const int Hp = round4(H);
  const size_t bI0 = static_cast<size_t>(b) * N + I0, Nh = static_cast<size_t>(N) * h;
  const float rows_n = static_cast<float>(N), cols = static_cast<float>(h);
  const float* __restrict__ cf_b = k.cf;
  auto dy = [&](int p, int o) {
    return dy_in_smem ? k.s_dy[p * round4(h) + o] : dout[(bI0 + p) * h + o] / rows_n;
  };
  if (warp < nI) {
    const float m1 = row_sum4(h, [&](int o) { return dy(warp, o); }) / cols;
    if (lane == 0) k.s_m1[warp] = m1;
  }
  for (int q = warp; q < nI * N; q += nwarps) {
    const int p = q / N;
    const float* r = rows + static_cast<size_t>(q) * h;
    const float mu = k.s_mu[q], rstd = k.s_rstd[q];
    const float m2 = row_sum4(h, [&](int o) { return dy(p, o) * ((r[o] - mu) * rstd); }) / cols;
    if (lane == 0) k.s_m2[q] = m2;
  }
  __syncthreads();
  constexpr int kBatch = 4;
  for (int o = threadIdx.x; o < h; o += blockDim.x) {
    for (int p = 0; p < nI; ++p) {
      float* pr = rows + p * Nh + o;
      const float d = dy(p, o), m1 = k.s_m1[p];
      for (int c0 = 0; c0 < H; c0 += kHeadChunk) {
        float sw[kHeadChunk] = {}, sd[kHeadChunk] = {};
        for (int n0 = 0; n0 < N; n0 += kBatch) {
          float x[kBatch];
          float4 wz[kBatch], wr[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int n = min(n0 + u, N - 1);
            x[u] = pr[static_cast<size_t>(n) * h];
            const float* cf = cf_b + (static_cast<size_t>(p) * N + n) * kCoef * Hp + c0;
            wz[u] = ld4(cf + Hp);
            wr[u] = ld4(cf + 2 * Hp);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int n = n0 + u;
            if (n >= N) continue;
            if (c0 == 0) {  // the row's d_fc, once
              const int q = p * N + n;
              const float y = (x[u] - k.s_mu[q]) * k.s_rstd[q];
              x[u] = k.s_rstd[q] * ((d - m1) - y * k.s_m2[q]);
              pr[static_cast<size_t>(n) * h] = x[u];
              if (out != nullptr) out[p * Nh + static_cast<size_t>(n) * h + o] = x[u];
              if (n == I0 + p) d_delta[(bI0 + p) * h + o] = x[u];
            }
#pragma unroll
            for (int i = 0; i < kHeadChunk; ++i) {
              sw[i] += get(wz[u], i) * x[u];
              sd[i] += get(wr[u], i) * x[u];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kHeadChunk; ++i) {
          if (c0 + i >= H) continue;
          const size_t at = ((static_cast<size_t>(b) * H + c0 + i) * N + I0 + p) * h + o;
          d_wa[at] = sw[i];
          d_dws[at] = sd[i];
        }
      }
    }
  }
  __syncthreads();  // every row holds d_fc
}

// Backward, stage 1: the rows of d_fc of P counterfactuals a block, and
// d_delta, d_dws[b, :, I], the first term of d_wa[b, :, I], dS_as, dS_ss
// and the score scratch of each (see the top); the rows in shared memory
// (kRowsSmem) or built in d_fc.
template <bool kRowsSmem>
__global__ void __launch_bounds__(kRowThreads, 1) cf_wide_bwd_rows_kernel(
    const float* __restrict__ terms, const float* __restrict__ coef,
    const float* __restrict__ base, const float* __restrict__ wa,
    const float* __restrict__ dws, const float* __restrict__ x_a,
    const float* __restrict__ delta, const float* __restrict__ bias,
    const float* __restrict__ dout, float* d_fc, float* dots, float* stats,
    float* __restrict__ dS_as,
    float* __restrict__ dS_ss, float* __restrict__ d_wa, float* __restrict__ d_dws,
    float* __restrict__ d_delta, float* __restrict__ d_scores, int N, int H, int h, int P,
    bool dy_in_smem, float sqrt_d) {
  extern __shared__ __align__(16) float smem[];
  const RowsBlock k = rows_block<kRowsSmem>(smem, coef, stats, N, H, h, P, dy_in_smem);
  const int b = k.b, I0 = k.I0, nI = k.nI, Hp = round4(H);
  const size_t bI0 = static_cast<size_t>(b) * N + I0;
  const size_t NN = static_cast<size_t>(N) * N;
  const size_t Nh = static_cast<size_t>(N) * h;
  float* out_rows = d_fc + bI0 * Nh;
  float* rows = kRowsSmem ? k.rows_smem : out_rows;
  RowsBlock kk = k;
  if (kRowsSmem) kk.cf = k.s_cf;
  const float rows_n = static_cast<float>(N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  build_rows(rows, kk.cf, base, wa, dws, x_a, delta, bias, b, I0, nI, N, H, h);
  stats4(rows, nI * N, h, k.s_mu, k.s_rstd);
  // dout / N on chip where the plan keeps it there, then the LayerNorm
  // backward, d_fc out, d_delta and the column sums
  if (dy_in_smem) {
    for (int p = 0; p < nI; ++p)
      for (int o = threadIdx.x; o < h; o += blockDim.x)
        k.s_dy[p * round4(h) + o] = dout[(bI0 + p) * h + o] / rows_n;
    __syncthreads();
  }
  ln_backward_sums(rows, kRowsSmem ? out_rows : nullptr, kk, dout, d_wa, d_dws, d_delta, b, I0,
                   nI, N, H, h, dy_in_smem);

  // The three dot products of each row (n, I) and head: A = d_fc . num_h[n]
  // (num2_h[I] on n = I), Bv = d_fc . wa_h[I] and C = d_fc . dws_h[I]. A
  // quarter of the block takes one head of a chunk of four, a thread
  // kDotCols columns of a column block with those columns of wa_h[I] and
  // dws_h[I] in registers; it walks the rows n, the next row's base values
  // in flight while a row is summed. Per row the 6 values (P x 3) are
  // summed over the warp (warp_sum8), then over the quarter's warps in a
  // fixed order, and added in order of the column blocks (through
  // dots[b, I, n, t, hh], t = 0: A, 1: Bv, 2: C, where a row has several);
  // the last column block turns them into the scalar cotangents. The
  // warps' sums of kRedRows rows meet in one of two buffers, so one barrier
  // a kRedRows rows keeps them apart.
  const int quarter = blockDim.x / kHeadChunk, g = threadIdx.x / quarter;
  const int lt = threadIdx.x % quarter, qwarps = quarter / 32;
  int step = 0, buf = 0;  // rows summed into the current buffer; which buffer
  for (int c0 = 0; c0 < H; c0 += kHeadChunk) {
    const int hh = c0 + g;  // this quarter's head
    const size_t z = static_cast<size_t>(b) * H + min(hh, H - 1);
    for (int cb = 0; cb < h; cb += kDotCols * quarter) {
      float w[kDotCols][kMaxPer], dv[kDotCols][kMaxPer];
      float nm[kDotCols], nx[kDotCols];
      // this thread's columns of the base row num_h[n] (num2_h[n] where `diag`)
      auto load_num = [&](float (&dst)[kDotCols], int n, bool diag) {
#pragma unroll
        for (int c = 0; c < kDotCols; ++c) {
          const int o = cb + lt + c * quarter;
          dst[c] = o < h && hh < H ? base[(z * 2 * N + (diag ? N : 0) + n) * h + o] : 0.f;
        }
      };
#pragma unroll
      for (int c = 0; c < kDotCols; ++c) {
        const int o = cb + lt + c * quarter;
#pragma unroll
        for (int p = 0; p < kMaxPer; ++p) {
          const bool ok = o < h && p < nI && hh < H;
          const size_t at = (z * N + I0 + p) * h + o;
          w[c][p] = ok ? wa[at] : 0.f;
          dv[c][p] = ok ? dws[at] : 0.f;
        }
      }
      load_num(nx, 0, false);
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int c = 0; c < kDotCols; ++c) nm[c] = nx[c];
        if (n + 1 < N) load_num(nx, n + 1, false);
        const int kd = n - I0;  // the counterfactual whose diagonal row n is, if in [0, nI)
        float n2[kDotCols];
        if (kd >= 0 && kd < nI) load_num(n2, n, true);
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = 0.f;
#pragma unroll
        for (int c = 0; c < kDotCols; ++c) {
          const int o = cb + lt + c * quarter;
          if (o >= h) continue;
#pragma unroll
          for (int p = 0; p < kMaxPer; ++p) {
            if (p >= nI) continue;
            const float x = rows[p * Nh + static_cast<size_t>(n) * h + o];
            v[p * kDots] += x * (p == kd ? n2[c] : nm[c]);
            v[p * kDots + 1] += x * w[c][p];
            v[p * kDots + 2] += x * dv[c][p];
          }
        }
        float* red = k.s_red + buf * kRedRows * kRowThreads;
        red[(step * nwarps + warp) * 32 + lane] = warp_sum8(v);
        if (++step < kRedRows && n + 1 < N) continue;
        __syncthreads();
        const int rows_here = step, n0 = n + 1 - rows_here;
        const bool last_cb = cb + kDotCols * quarter >= h;
        for (int q = threadIdx.x; q < rows_here * kHeadChunk * kMaxPer; q += blockDim.x) {
          const int r = q / (kHeadChunk * kMaxPer), gg = q / kMaxPer % kHeadChunk;
          const int p = q % kMaxPer, hq = c0 + gg;
          if (p >= nI || hq >= H) continue;
          // value t of (p, t) of warp w sits in its lanes 4 (3 p + t) .. + 3
          // (warp_sum8); the sums of a longer row pass through dots
          float abc[kDots];
          float* d3 = dots + ((bI0 + p) * N + n0 + r) * kDots * H + hq;
#pragma unroll
          for (int t = 0; t < kDots; ++t) {
            const float* red_r = red + (r * nwarps + gg * qwarps) * 32 + 4 * (p * kDots + t);
            float sum = 0.f;
            for (int wi = 0; wi < qwarps; ++wi) sum += red_r[wi * 32];
            abc[t] = cb == 0 ? sum : d3[t * H] + sum;
            if (!last_cb) d3[t * H] = abc[t];
          }
          if (!last_cb) continue;
          // the row's scalar cotangents
          const int nn = n0 + r, I = I0 + p;
          const size_t zq = static_cast<size_t>(b) * H + hq, e = static_cast<size_t>(nn) * N + I;
          const float* T = terms + zq * 5 * NN;
          const float corr = T[2 * NN + e], rep = T[3 * NN + e], Z = T[4 * NN + e];
          const float dZ = -((((abc[0] + corr * abc[1]) + rep * abc[2]) / Z) / Z);
          const float d_zc = abc[1] / Z + dZ;
          const float d_E = abc[2] / Z + d_zc;
          const float dS = (rep * d_E) / sqrt_d;
          dS_as[zq * NN + e] = nn == I ? 0.f : dS;
          if (nn == I) dS_ss[zq * N + I] = dS;
          d_scores[zq * 2 * NN + e] = -d_zc;
          d_scores[(zq * 2 + 1) * NN + e] = dZ;
        }
        step = 0;
        buf ^= 1;
      }
    }
  }
}

// ── Backward, stage 2: the sums over I of one group ───────────────────────

// A thread a column o of group b (blocks b-major): for each n, d_xa[b, n] =
// sum over I of d_fc[b, I, n] and d_num[b, hh, n] = sum over I != n of
// d_fc[b, I, n] / Z[hh][n, I] for four heads, from one read of d_fc (heads
// past four read it again); d_xa summed over n into part[b]. `staged`: the
// group's 1 / Z (0 on I = n) in shared memory, [n][I][Hp].
__global__ void __launch_bounds__(kThreads) cf_wide_sums_kernel(
    const float* __restrict__ terms, const float* __restrict__ d_fc, float* __restrict__ d_num,
    float* __restrict__ d_xa, float* __restrict__ part, int N, int H, int h, int col_blocks,
    bool staged) {
  extern __shared__ __align__(16) float s_inv[];
  const int b = blockIdx.x / col_blocks;
  const int o = (blockIdx.x % col_blocks) * blockDim.x + threadIdx.x;
  const int Hp = round4(H);
  const size_t NN = static_cast<size_t>(N) * N;
  const float* Tb = terms + static_cast<size_t>(b) * H * 5 * NN;  // head hh's Z at Tb + (5 hh + 4) NN
  if (staged) {
    for (int q = threadIdx.x; q < static_cast<int>(NN) * Hp; q += blockDim.x) {
      const int nI = q / Hp, hh = q % Hp;
      s_inv[q] = hh < H && nI / N != nI % N ? 1.0f / Tb[(5 * static_cast<size_t>(hh) + 4) * NN + nI]
                                            : 0.f;
    }
    __syncthreads();
  }
  if (o >= h) return;
  const float* f = d_fc + static_cast<size_t>(b) * NN * h + o;  // [I][n][o]
  float bp = 0.f;
  for (int c0 = 0; c0 < H; c0 += kHeadChunk) {
    for (int n = 0; n < N; ++n) {
      float acc[kHeadChunk] = {}, s = 0.f;
#pragma unroll 4
      for (int I = 0; I < N; ++I) {
        const float x = f[(static_cast<size_t>(I) * N + n) * h];
        s += x;
        const size_t nI = static_cast<size_t>(n) * N + I;
        float4 iv;
        if (staged) {
          iv = ld4(s_inv + nI * Hp + c0);
        } else {
          float r[kHeadChunk];
#pragma unroll
          for (int i = 0; i < kHeadChunk; ++i)
            r[i] = c0 + i < H && I != n ? 1.0f / Tb[(5 * static_cast<size_t>(c0 + i) + 4) * NN + nI]
                                        : 0.f;
          iv = make_float4(r[0], r[1], r[2], r[3]);
        }
#pragma unroll
        for (int i = 0; i < kHeadChunk; ++i) acc[i] += get(iv, i) * x;
      }
#pragma unroll
      for (int i = 0; i < kHeadChunk; ++i)
        if (c0 + i < H)
          d_num[((static_cast<size_t>(b) * H + c0 + i) * N + n) * h + o] = acc[i];
      if (c0 == 0) {
        d_xa[(static_cast<size_t>(b) * N + n) * h + o] = s;
        bp += s;
      }
    }
  }
  part[static_cast<size_t>(b) * h + o] = bp;
}

// ── Backward, stage 3: the products of one (b, head) ──────────────────────

// Shared memory of a products block (floats): sdz[n] = sum over I != n of
// dZ[n, I], and Z2[I] (N each, in whole float4s); E_aa and E_sa at a row
// stride of round4(N), zeros past N (where kStagedE); then the tiles: the
// rows of [d_num; dU2] (2N), of wa_h (N) and of d_wa (N), T columns each at
// a row stride of T + 4, two such tiles (the next one's copies in flight
// while a tile is used); then, where a block's output blocks leave threads
// over, the column groups' partial sums (at most kThreads x 16).
__host__ __device__ inline size_t products_head_floats(int N, bool staged_e) {
  return 2 * static_cast<size_t>(round4(N)) +
         (staged_e ? 2 * static_cast<size_t>(N) * round4(N) : 0);
}

// Output blocks (2 rows n x 4 columns m of both dS products) of a products
// block, and the column groups that share each: blockDim / blocks where
// that is more than one (the groups' partial sums then meet in shared
// memory), else one.
__host__ __device__ inline int product_blocks(int N) { return (N + 1) / 2 * ((N + 3) / 4); }
__host__ __device__ inline int product_groups(int N) {
  return product_blocks(N) < kThreads ? kThreads / product_blocks(N) : 1;
}

__host__ __device__ inline size_t products_smem_floats(int N, int T, bool staged_e) {
  const int G = product_groups(N);
  return products_head_floats(N, staged_e) + 8 * static_cast<size_t>(N) * (T + 4) +
         (G > 1 ? static_cast<size_t>(G) * product_blocks(N) * 16 : 0);
}

// E[n][m0 .. m0 + 3] of one of the tables (zeros past N): from shared
// memory (kStagedE, row stride round4(N)) or from the terms.
template <bool kStagedE>
__device__ inline float4 e_row4(const float* E, int N, int n, int m0) {
  if (kStagedE) return ld4(E + static_cast<size_t>(n) * round4(N) + m0);
  const float* e = E + static_cast<size_t>(n) * N + m0;
  return make_float4(e[0], m0 + 1 < N ? e[1] : 0.f, m0 + 2 < N ? e[2] : 0.f,
                     m0 + 3 < N ? e[3] : 0.f);
}

template <bool kStagedE>
__device__ inline float e_at(const float* E, int N, int n, int m) {
  return E[static_cast<size_t>(n) * (kStagedE ? round4(N) : N) + m];
}

template <bool kStagedE>
__global__ void __launch_bounds__(kThreads) cf_wide_products_kernel(
    const float* __restrict__ terms, const float* __restrict__ wa,
    const float* __restrict__ d_num, const float* __restrict__ d_delta,
    const float* __restrict__ d_scores, float* __restrict__ dS_aa, float* __restrict__ dS_sa,
    float* __restrict__ d_wa, int N, int H, int h, int T, bool vec, float sqrt_d) {
  extern __shared__ __align__(16) float smem[];
  const size_t z = blockIdx.x, b = z / H, NN = static_cast<size_t>(N) * N;
  const int Np = round4(N), ts = T + 4;
  float* s_sdz = smem;
  float* s_z2 = s_sdz + Np;
  const float* tz = terms + z * 5 * NN;
  const float* sc = d_scores + z * 2 * NN;  // -d_zc, then dZ, [n][I]
  float* s_e = s_z2 + Np;                   // E_aa, then E_sa (kStagedE)
  const float* Eaa = kStagedE ? s_e : tz;
  const float* Esa = kStagedE ? s_e + static_cast<size_t>(N) * Np : tz + NN;
  // two tiles, each the rows [d_num; dU2] (2N), wa_h (N) and d_wa (N)
  const size_t tile_floats = 4 * static_cast<size_t>(N) * ts;
  float* s_tiles = smem + products_head_floats(N, kStagedE);
  float* s_comb = s_tiles + 2 * tile_floats;  // [G][blocks][16]
  // row r of a tile's source, column 0: d_num[z, r], d_delta[b, r - N]
  // (dU2 once divided by Z2), wa_h[r - 2N], d_wa[z, r - 3N]
  auto src_row = [&](int r) -> const float* {
    return r < N       ? d_num + (z * N + r) * h
           : r < 2 * N ? d_delta + (b * N + r - N) * h
           : r < 3 * N ? wa + (z * N + r - 2 * N) * h
                       : d_wa + (z * N + r - 3 * N) * h;
  };
  // the copies of the tile at column o0 (its first `rows` rows) into dst;
  // zeros past h to a whole float4
  auto issue = [&](int o0, float* dst, int rows) {
    const int tc = min(T, h - o0), tc4 = round4(tc);
    if (vec) {  // 16-byte copies: h, and so tc, a multiple of 4
      for (int q = threadIdx.x; q < rows * (tc / 4); q += blockDim.x) {
        const int r = q / (tc / 4), j = 4 * (q % (tc / 4));
        tc::cp_async16(dst + static_cast<size_t>(r) * ts + j, src_row(r) + o0 + j, 16);
      }
    } else {
      for (int q = threadIdx.x; q < rows * tc4; q += blockDim.x) {
        const int r = q / tc4, j = q % tc4;
        if (j < tc) tc::cp_async4(dst + static_cast<size_t>(r) * ts + j, src_row(r) + o0 + j);
        else dst[static_cast<size_t>(r) * ts + j] = 0.f;
      }
    }
    tc::cp_async_commit();
  };
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float x = 0.f;
    for (int I = 0; I < N; ++I)
      if (I != n) x += sc[NN + static_cast<size_t>(n) * N + I];
    s_sdz[n] = x;
    s_z2[n] = tz[4 * NN + static_cast<size_t>(n) * (N + 1)];
  }
  if (kStagedE)
    for (int q = threadIdx.x; q < 2 * N * Np; q += blockDim.x) {
      const int t = q / (N * Np), n = q / Np % N, m = q % Np;
      s_e[q] = m < N ? tz[t * NN + static_cast<size_t>(n) * N + m] : 0.f;
    }
  __syncthreads();

  // output blocks of 2 rows n x 4 columns m of both products, a thread a
  // block and a column group (the float4 columns j / 4 = g mod G of each
  // tile), blockDim.x / G blocks a pass over the tiles
  const int mq = (N + 3) / 4, blocks = product_blocks(N), G = product_groups(N);
  const int g = threadIdx.x / (blockDim.x / G), slots = blockDim.x / G;
  for (int pass = 0; pass < blocks; pass += slots) {
    const int bi = pass + threadIdx.x % slots;
    const bool mine = bi < blocks && g < G;
    const int n0 = mine ? 2 * (bi / mq) : 0, m0 = mine ? 4 * (bi % mq) : 0;
    float acc[2][4][2] = {};
    // the tiles, each one's copies issued while the one before is used (the
    // d_wa rows on the first pass only)
    const int rows = (pass == 0 ? 4 : 3) * N, tiles = (h + T - 1) / T;
    __syncthreads();  // the previous pass's tiles are used
    issue(0, s_tiles, rows);
    for (int t = 0; t < tiles; ++t) {
      const int o0 = t * T, tc = min(T, h - o0), tc4 = round4(tc);
      float* s_u = s_tiles + (t & 1) * tile_floats;
      float* s_w = s_u + 2 * static_cast<size_t>(N) * ts;
      float* s_d = s_w + static_cast<size_t>(N) * ts;
      if (t + 1 < tiles) {
        issue(o0 + T, s_tiles + ((t + 1) & 1) * tile_floats, rows);
        tc::cp_async_wait<1>();
      } else {
        tc::cp_async_wait<0>();
      }
      __syncthreads();  // the tile is in place
      for (int q = threadIdx.x; q < N * tc; q += blockDim.x) {  // dU2 = d_delta / Z2
        float* x = s_u + static_cast<size_t>(N + q / tc) * ts + q % tc;
        *x = *x / s_z2[q / tc];
      }
      __syncthreads();
      if (pass == 0) {
        // d_wa[m, o] = (d_wa + sum_n E_aa[n, m] d_num[n, o]) + sum_n E_sa[n, m] dU2[n, o],
        // a thread a (column, four rows m)
        for (int job = threadIdx.x; job < tc * mq; job += blockDim.x) {
          const int j = job % tc, c0 = 4 * (job / tc);
          {
            float* dw = d_wa + (z * N + c0) * h + o0 + j;
            float old[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              old[q] = c0 + q < N ? s_d[static_cast<size_t>(c0 + q) * ts + j] : 0.f;
            float s1[4] = {}, s2[4] = {};
            for (int n = 0; n < N; ++n) {
              const float u1 = s_u[static_cast<size_t>(n) * ts + j];
              const float u2 = s_u[static_cast<size_t>(N + n) * ts + j];
              const float4 e1 = e_row4<kStagedE>(Eaa, N, n, c0), e2 = e_row4<kStagedE>(Esa, N, n, c0);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                s1[q] += get(e1, q) * u1;
                s2[q] += get(e2, q) * u2;
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (c0 + q < N) dw[static_cast<size_t>(q) * h] = (old[q] + s1[q]) + s2[q];
          }
        }
      }
      if (mine) {
        const float* un[2] = {s_u + static_cast<size_t>(n0) * ts,
                              s_u + static_cast<size_t>(min(n0 + 1, N - 1)) * ts};
        const float* ud[2] = {un[0] + static_cast<size_t>(N) * ts, un[1] + static_cast<size_t>(N) * ts};
        const float* wr[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wr[q] = s_w + static_cast<size_t>(min(m0 + q, N - 1)) * ts;
        // the tile's sums, then added to the totals: a long row (h in the
        // thousands) rounds as a blocked sum
        float part[2][4][2] = {};
        for (int j = 4 * g; j < tc4; j += 4 * G) {
          float4 wv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) wv[q] = ld4(wr[q] + j);
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const float4 x1 = ld4(un[a] + j), x2 = ld4(ud[a] + j);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              part[a][q][0] += dot4(x1, wv[q]);
              part[a][q][1] += dot4(x2, wv[q]);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[a][q][0] += part[a][q][0];
            acc[a][q][1] += part[a][q][1];
          }
      }
      __syncthreads();  // the tile is used: its buffer takes tile t + 2
    }
    if (G > 1) {  // the column groups' sums, added in order of the group
      if (mine)
#pragma unroll
        for (int x = 0; x < 16; ++x) s_comb[(g * blocks + bi) * 16 + x] = acc[x / 8][x / 2 % 4][x % 2];
      __syncthreads();
      if (mine && g == 0)
        for (int gg = 1; gg < G; ++gg)
#pragma unroll
          for (int x = 0; x < 16; ++x) acc[x / 8][x / 2 % 4][x % 2] += s_comb[(gg * blocks + bi) * 16 + x];
    }
    if (!mine || g != 0) continue;
    // dS_aa[n, m] = E_aa[n, m] ((where(n = m, 0, -d_zc[n, m]) + sdz[n]) + d_num[n] . wa_h[m]) / sqrt_d
    // dS_sa[I, m] = E_sa[I, m] ((dZ[I, I] + where(m = I, -d_zc[I, I], 0)) + dU2[I] . wa_h[m]) / sqrt_d
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int n = n0 + a;
      if (n >= N) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + q;
        if (m >= N) continue;
        const size_t e = static_cast<size_t>(n) * N + m, d = static_cast<size_t>(n) * (N + 1);
        const float dEaa = ((m == n ? 0.f : sc[e]) + s_sdz[n]) + acc[a][q][0];
        dS_aa[z * NN + e] = (e_at<kStagedE>(Eaa, N, n, m) * dEaa) / sqrt_d;
        const float dEsa = (sc[NN + d] + (m == n ? sc[d] : 0.f)) + acc[a][q][1];
        dS_sa[z * NN + e] = (e_at<kStagedE>(Esa, N, n, m) * dEsa) / sqrt_d;
      }
    }
  }
}

// The products where no tile of the 4 N rows fits in shared memory
// (products_plan finds none past N = 880): the same sums, their operands
// read from device memory, in two kernels. First d_wa += E_aa^T d_num +
// E_sa^T dU2, a thread a (column o, four rows m) of one (b, head), summed
// in order of n as above: consecutive threads take consecutive columns,
// and E_aa and E_sa come from the terms.
__global__ void __launch_bounds__(kThreads) cf_wide_products_dwa_kernel(
    const float* __restrict__ terms, const float* __restrict__ d_num,
    const float* __restrict__ d_delta, float* __restrict__ d_wa, int N, int H, int h,
    long long jobs) {
  const long long job = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (job >= jobs) return;
  const int mq = (N + 3) / 4, o = static_cast<int>(job % h);
  const long long r = job / h;
  const int c0 = 4 * static_cast<int>(r % mq);
  const size_t z = static_cast<size_t>(r / mq), b = z / H, NN = static_cast<size_t>(N) * N;
  const float* tz = terms + z * 5 * NN;
  float s1[4] = {}, s2[4] = {};
  for (int n = 0; n < N; ++n) {
    const float u1 = d_num[(z * N + n) * h + o];
    const float u2 = d_delta[(b * N + n) * h + o] / tz[4 * NN + static_cast<size_t>(n) * (N + 1)];
    const float4 e1 = e_row4<false>(tz, N, n, c0), e2 = e_row4<false>(tz + NN, N, n, c0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s1[q] += get(e1, q) * u1;
      s2[q] += get(e2, q) * u2;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float* dw = d_wa + (z * N + c0 + q) * h + o;
    if (c0 + q < N) *dw = (*dw + s1[q]) + s2[q];
  }
}

// Then d_num wa_h^T and dU2 wa_h^T and the epilogue: a block per (b, head,
// rows n0 and n0 + 1), a thread a block of 4 columns m, the sums over the
// columns o in tiles of kProductTile as above (one column group); sdz and
// Z2 of the two rows in shared memory.
__global__ void __launch_bounds__(kThreads) cf_wide_products_ds_kernel(
    const float* __restrict__ terms, const float* __restrict__ wa,
    const float* __restrict__ d_num, const float* __restrict__ d_delta,
    const float* __restrict__ d_scores, float* __restrict__ dS_aa, float* __restrict__ dS_sa,
    int N, int H, int h, bool vec, float sqrt_d) {
  __shared__ float s_sdz[2], s_z2[2];
  const int pairs = (N + 1) / 2, mq = (N + 3) / 4;
  const size_t z = blockIdx.x / pairs, b = z / H, NN = static_cast<size_t>(N) * N;
  const int n0 = 2 * static_cast<int>(blockIdx.x % pairs);
  const float* tz = terms + z * 5 * NN;
  const float* sc = d_scores + z * 2 * NN;  // -d_zc, then dZ, [n][I]
  for (int r = threadIdx.x; r < 2; r += blockDim.x) {
    const int n = min(n0 + r, N - 1);
    float x = 0.f;
    for (int I = 0; I < N; ++I)
      if (I != n) x += sc[NN + static_cast<size_t>(n) * N + I];
    s_sdz[r] = x;
    s_z2[r] = tz[4 * NN + static_cast<size_t>(n) * (N + 1)];
  }
  __syncthreads();
  // four floats of a row from column j (< h), zeros past h
  auto at4 = [&](const float* row, int j) -> float4 {
    if (vec) return ld4(row + j);
    return make_float4(row[j], j + 1 < h ? row[j + 1] : 0.f, j + 2 < h ? row[j + 2] : 0.f,
                       j + 3 < h ? row[j + 3] : 0.f);
  };
  const float* un[2];
  const float* ud[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int n = min(n0 + a, N - 1);
    un[a] = d_num + (z * N + n) * h;
    ud[a] = d_delta + (b * N + n) * h;
  }
  for (int mb = threadIdx.x; mb < mq; mb += blockDim.x) {
    const int m0 = 4 * mb;
    const float* wr[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wr[q] = wa + (z * N + min(m0 + q, N - 1)) * h;
    float acc[2][4][2] = {};
    for (int t0 = 0; t0 < h; t0 += kProductTile) {
      const int t1 = min(h, t0 + kProductTile);
      float part[2][4][2] = {};
      for (int j = t0; j < t1; j += 4) {
        float4 wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = at4(wr[q], j);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float4 x1 = at4(un[a], j), d = at4(ud[a], j);
          const float4 x2 = make_float4(d.x / s_z2[a], d.y / s_z2[a], d.z / s_z2[a],
                                        d.w / s_z2[a]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            part[a][q][0] += dot4(x1, wv[q]);
            part[a][q][1] += dot4(x2, wv[q]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[a][q][0] += part[a][q][0];
          acc[a][q][1] += part[a][q][1];
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int n = n0 + a;
      if (n >= N) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + q;
        if (m >= N) continue;
        const size_t e = static_cast<size_t>(n) * N + m, d = static_cast<size_t>(n) * (N + 1);
        const float dEaa = ((m == n ? 0.f : sc[e]) + s_sdz[a]) + acc[a][q][0];
        dS_aa[z * NN + e] = (tz[e] * dEaa) / sqrt_d;
        const float dEsa = (sc[NN + d] + (m == n ? sc[d] : 0.f)) + acc[a][q][1];
        dS_sa[z * NN + e] = (tz[NN + e] * dEsa) / sqrt_d;
      }
    }
  }
}

// Columns of a products tile, and whether E_aa and E_sa stay in shared
// memory: the widest tile (a multiple of 32, at most kProductTile) whose
// block fits kProductSmem bytes with the tables staged, else without them,
// else the widest multiple of 4 that fits the card. 0: nothing fits (the
// products then read their rows from device memory).
inline void products_plan(int N, int h, int& T, bool& staged_e) {
  const int want = std::min(kProductTile, round4(h));
  for (int pass = 0; pass < 3; ++pass) {
    staged_e = pass == 0;
    const size_t limit = (pass < 2 ? std::min(kProductSmem, kMaxSmem) : kMaxSmem) / sizeof(float);
    const int G = product_groups(N);
    const size_t head = products_head_floats(N, staged_e) +
                        (G > 1 ? static_cast<size_t>(G) * product_blocks(N) * 16 : 0);
    if (head >= limit) continue;
    const size_t cols = (limit - head) / (8 * static_cast<size_t>(N));
    if (cols < 8) continue;
    const int step = pass < 2 ? 32 : 4;
    T = static_cast<int>(std::min<size_t>(want, (cols - 4) / step * step));
    if (T >= 4) return;
  }
  T = 0;
}

// The rows kernels' launch: the grid, the shared memory (refused past the
// card's), and the plan's checks.
inline bool rows_launch(int& blocks, size_t& smem, int B, int N, int H, int h, int P,
                        bool rows_in_smem, bool has_stats, bool dy_in_smem) {
  if (!wide_shape_ok(B, N, H, h) || P < 1 || P > kMaxPer || P > N) return false;
  if (rows_in_smem == has_stats) return false;  // the stats scratch goes with rows in device memory
  const long long n_blocks = static_cast<long long>(B) * ((N + P - 1) / P);
  if (n_blocks > INT_MAX) return false;
  blocks = static_cast<int>(n_blocks);
  smem = rows_head_floats(N, H, h, P, rows_in_smem, coef_fits(N, H, h, P, rows_in_smem),
                          dy_in_smem) * sizeof(float);
  if (rows_in_smem) smem += static_cast<size_t>(P) * N * h * sizeof(float);
  return smem <= static_cast<size_t>(kMaxSmem);
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launches (0 = success), or
// cudaErrorInvalidValue for shapes or plans the route does not take. P,
// rows_in_smem and dy_in_smem are the plan's (cf_attention.cf_wide_plan);
// `stats` is null where the rows stay in shared memory, else a scratch of
// B ceil(N / P) (3 P N + P) floats for their statistics.

// Stage 0 of both directions: terms (B, H, 5, N, N), coef (B, N, N, 3, Hp),
// base (B, H, 2, N, h).
int cf_wide_base_launch(const float* S_aa, const float* S_as, const float* S_sa,
                        const float* S_ss, const float* wa, float* terms, float* coef,
                        float* base, int B, int N, int H, int h, float sqrt_d,
                        void* stream) {
  if (!wide_shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long BH = static_cast<long long>(B) * H;
  const long long rows = BH * N, blocks = (rows + 127) / 128;
  if (blocks > INT_MAX || BH > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cf_wide_terms_kernel<<<static_cast<unsigned>(blocks), 128, 0, s>>>(
      S_aa, S_as, S_sa, S_ss, terms, coef, rows, N, H, sqrt_d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int most = kBaseSmem / static_cast<int>(sizeof(float));  // floats of the staged columns
  const int Rc = std::min((2 * N + kBaseRows - 1) / kBaseRows * kBaseRows,
                          most / kBaseRows * kBaseRows);
  const int mc = std::min(N, std::max(1, most / Rc));
  const size_t smem = static_cast<size_t>(mc) * Rc * sizeof(float);
  err = allow_smem(cf_wide_base_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cf_wide_base_kernel<<<static_cast<unsigned>(BH), kThreads, smem, s>>>(terms, wa, base, N, h,
                                                                        Rc, mc);
  return static_cast<int>(cudaGetLastError());
}

// Forward, rows: pooled (B, N, h). `scratch` null keeps the rows in shared
// memory (invalid if they do not fit), else the (B, N*N, h) rows.
int cf_wide_fwd_rows_launch(const float* coef, const float* base, const float* wa,
                            const float* dws, const float* x_a, const float* delta,
                            const float* bias, float* scratch, float* stats, float* pooled,
                            int B, int N, int H, int h, int P, void* stream) {
  int blocks;
  size_t smem;
  if (!rows_launch(blocks, smem, B, N, H, h, P, scratch == nullptr, stats != nullptr, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (scratch == nullptr) {
    err = allow_smem(cf_wide_fwd_rows_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cf_wide_fwd_rows_kernel<true><<<blocks, kRowThreads, smem, s>>>(
        coef, base, wa, dws, x_a, delta, bias, scratch, stats, pooled, N, H, h, P);
  } else {
    err = allow_smem(cf_wide_fwd_rows_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cf_wide_fwd_rows_kernel<false><<<blocks, kRowThreads, smem, s>>>(
        coef, base, wa, dws, x_a, delta, bias, scratch, stats, pooled, N, H, h, P);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, stage 1: d_fc (B, N, N, h), the dots scratch (B, N, N, 3, H),
// dS_as, dS_ss, the first term of d_wa, d_dws, d_delta, and the score
// scratch (B, H, 2, N, N).
int cf_wide_bwd_rows_launch(const float* terms, const float* coef, const float* base,
                            const float* wa, const float* dws, const float* x_a,
                            const float* delta, const float* bias, const float* dout,
                            float* d_fc, float* dots, float* stats, float* dS_as, float* dS_ss,
                            float* d_wa, float* d_dws, float* d_delta, float* d_scores, int B,
                            int N, int H, int h, int P, int rows_in_smem, int dy_in_smem,
                            float sqrt_d, void* stream) {
  int blocks;
  size_t smem;
  if (!rows_launch(blocks, smem, B, N, H, h, P, rows_in_smem != 0, stats != nullptr,
                   dy_in_smem != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows_in_smem != 0) {
    err = allow_smem(cf_wide_bwd_rows_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cf_wide_bwd_rows_kernel<true><<<blocks, kRowThreads, smem, s>>>(
        terms, coef, base, wa, dws, x_a, delta, bias, dout, d_fc, dots, stats, dS_as, dS_ss,
        d_wa, d_dws, d_delta, d_scores, N, H, h, P, dy_in_smem != 0, sqrt_d);
  } else {
    err = allow_smem(cf_wide_bwd_rows_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cf_wide_bwd_rows_kernel<false><<<blocks, kRowThreads, smem, s>>>(
        terms, coef, base, wa, dws, x_a, delta, bias, dout, d_fc, dots, stats, dS_as, dS_ss,
        d_wa, d_dws, d_delta, d_scores, N, H, h, P, dy_in_smem != 0, sqrt_d);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, stage 2: d_num (B, H, N, h) scratch, d_xa, and d_bias through
// the (B, h) scratch part.
int cf_wide_bwd_sums_launch(const float* terms, const float* d_fc, float* d_num, float* d_xa,
                            float* part, float* d_bias, int B, int N, int H, int h,
                            void* stream) {
  if (!wide_shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (h + kThreads - 1) / kThreads;
  if (static_cast<long long>(B) * col_blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t table = static_cast<size_t>(N) * N * round4(H) * sizeof(float);
  const bool staged = table <= static_cast<size_t>(kMaxSmem);
  const size_t smem = staged ? table : 0;
  cudaError_t err = allow_smem(cf_wide_sums_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cf_wide_sums_kernel<<<B * col_blocks, kThreads, smem, s>>>(terms, d_fc, d_num, d_xa, part, N,
                                                             H, h, col_blocks, staged);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_over_groups(part, d_bias, B, h, s));
}

// Backward, stage 3: dS_aa, dS_sa, and d_wa completed in place.
int cf_wide_bwd_products_launch(const float* terms, const float* wa, const float* d_num,
                                const float* d_delta, const float* d_scores, float* dS_aa,
                                float* dS_sa, float* d_wa, int B, int N, int H, int h,
                                float sqrt_d, void* stream) {
  if (!wide_shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const long long BH = static_cast<long long>(B) * H;
  if (BH > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int T;
  bool staged_e;
  products_plan(N, h, T, staged_e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = h % 4 == 0 && aligned16(d_num) && aligned16(d_delta) && aligned16(wa) &&
                   aligned16(d_wa);
  cudaError_t err;
  if (T < 4) {  // no tile fits: from device memory
    const long long jobs = BH * ((N + 3) / 4) * h, pairs = BH * ((N + 1) / 2);
    const long long blocks = (jobs + kThreads - 1) / kThreads;
    if (blocks > INT_MAX || pairs > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    cf_wide_products_dwa_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        terms, d_num, d_delta, d_wa, N, H, h, jobs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cf_wide_products_ds_kernel<<<static_cast<unsigned>(pairs), kThreads, 0, s>>>(
        terms, wa, d_num, d_delta, d_scores, dS_aa, dS_sa, N, H, h, vec, sqrt_d);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = products_smem_floats(N, T, staged_e) * sizeof(float);
  if (staged_e) {
    err = allow_smem(cf_wide_products_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cf_wide_products_kernel<true><<<static_cast<unsigned>(BH), kThreads, smem, s>>>(
        terms, wa, d_num, d_delta, d_scores, dS_aa, dS_sa, d_wa, N, H, h, T, vec, sqrt_d);
  } else {
    err = allow_smem(cf_wide_products_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cf_wide_products_kernel<false><<<static_cast<unsigned>(BH), kThreads, smem, s>>>(
        terms, wa, d_num, d_delta, d_scores, dS_aa, dS_sa, d_wa, N, H, h, T, vec, sqrt_d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
