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
// cf_backward_reference, formula for formula:
//   0. base: the softmax terms of each (b, head) (cf_wide_terms_kernel, a
//      thread a row n: E_aa, E_sa, corr, rep and Z, laid out [5][n][I]) and
//      the base products E_aa wa_h and E_sa wa_h (two gemms). The partition
//      of row (n, I) is Z_b + zc, as the numerator is the base product plus
//      zc wa_h[I]: the two cancel alike where E_aa[n, I] dominates the row
//      (a partition summed afresh made the ratio less accurate on the card);
//   forward, rows (cf_wide_fwd_rows_kernel), one block of 256 threads per
//      (b, I): fc rebuilt from the base products as
//      sum_h num_h / Z + (bias + sum_h (corr / Z) wa_h[I] + (rep / Z) dws_h[I])
//      + x_a (+ delta on n = I), kRows rows and a 512-column tile at a time,
//      the rows in shared memory where N * h floats fit the wrapper's
//      budget, else in a (B, N*N, h) scratch; the two-pass statistics, one
//      warp a row; the pool.
//   backward, after stage 0:
//   1. rows (cf_wide_bwd_rows_kernel), one block per (b, I): fc rebuilt
//      into its rows of d_fc ([b, I, n, o]), the LayerNorm backward in
//      place, d_delta; one warp a (head, n) takes the three dot products of
//      the row with num (num2 on n = I), wa_h[I] and dws_h[I] over the
//      row's tiles and turns them into dZ, d_zc, dS_as, dS_ss and the score
//      scratch (-d_zc, dZ); a thread a column sums d_dws[b, :, I] and the
//      first term of d_wa[b, :, I] over n;
//   2. sums (cf_wide_sums_kernel), a thread a column of group b: d_xa (the
//      sum over I), its sum over n into a (B, h) partial, d_num (the sum over
//      I != n of d_fc / Z, four heads a pass over d_fc), and
//      dU2 = d_delta / Z2; then the sum of the partials over b;
//   3. products (four gemms, per (b, head)): d_num wa_h^T and dU2 wa_h^T,
//      whose epilogues make dS_aa and dS_sa; d_wa += E_aa^T d_num and
//      d_wa += E_sa^T dU2.
// What bounds it: as the tuned kernels, arithmetic and the scratch's bytes
// (chip_smoke._cf_forward_work, _cf_backward_work). Float32 on the CUDA
// cores, 4-byte loads; no atomics, fixed orders.

#include "wide_common.cuh"

namespace {

using namespace wide;

// The softmax terms of row n of one (b, head) z (cf_backward_base): with
// P = S / sqrt_d, M = max(max_m P_aa[n, :], max_m P_as[n, :]) and
// M2 = max(max_m P_sa[n, :], P_ss[n]),
//   terms[0][n][m] = E_aa = exp(P_aa - M),  terms[1][n][m] = E_sa = exp(P_sa - M2),
//   and for each I: corr, rep and Z of row n of counterfactual I:
//   (zc, E_as, Z_b + zc) at n != I, with zc = E_as - E_aa and Z_b the sum of
//   E_aa over the row, and (zc2, E_ss, Z2) at n = I, with zc2 = E_ss - E_sa
//   and Z2 = sum of E_sa over the row + zc2; sums in order of m.
__global__ void cf_wide_terms_kernel(const float* __restrict__ S_aa,
                                     const float* __restrict__ S_as,
                                     const float* __restrict__ S_sa,
                                     const float* __restrict__ S_ss,
                                     float* terms, long long rows_total, int N,
                                     float sqrt_d) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows_total) return;
  const long long z = t / N;
  const int n = static_cast<int>(t % N);
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
  }
}

// fc of counterfactual I of group b into rows[n * h + o], rebuilt from the
// terms and the base products (cf_attention._rebuild_fc). The whole block
// calls it; it ends with a barrier.
__device__ void rebuild_fc(float* rows, const float* terms, const float* base,
                           const float* wa, const float* dws, const float* x_a,
                           const float* delta, const float* bias, int b, int I,
                           int N, int H, int h) {
  const size_t NN = static_cast<size_t>(N) * N;
  const size_t Nh = static_cast<size_t>(N) * h;
  for (int c0 = 0; c0 < h; c0 += kTile) {
    for (int n0 = 0; n0 < N; n0 += kRows) {
      float s1[kRows][kCpt] = {}, s2[kRows][kCpt] = {};
      for (int hh = 0; hh < H; ++hh) {
        const size_t z = static_cast<size_t>(b) * H + hh;
        const float* T = terms + z * 5 * NN;
        const float* num_n = base + z * 2 * Nh;       // E_aa wa_h, rows n
        const float* num_I = num_n + Nh + static_cast<size_t>(I) * h;  // E_sa wa_h, row I
        const size_t v = (z * N + I) * h;
        float w[kCpt], dv[kCpt];
#pragma unroll
        for (int k = 0; k < kCpt; ++k) {
          const int o = c0 + threadIdx.x + k * kThreads;
          w[k] = o < h ? wa[v + o] : 0.f;
          dv[k] = o < h ? dws[v + o] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int n = n0 + r;
          if (n >= N) continue;
          const size_t e = static_cast<size_t>(n) * N + I;
          const float Z = T[4 * NN + e];
          const float inv = 1.0f / Z, cz = T[2 * NN + e] / Z, rz = T[3 * NN + e] / Z;
          const float* num = n == I ? num_I : num_n + static_cast<size_t>(n) * h;
#pragma unroll
          for (int k = 0; k < kCpt; ++k) {
            const int o = c0 + threadIdx.x + k * kThreads;
            if (o < h) {
              s1[r][k] += num[o] * inv;
              s2[r][k] += cz * w[k] + rz * dv[k];
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = n0 + r;
        if (n >= N) continue;
#pragma unroll
        for (int k = 0; k < kCpt; ++k) {
          const int o = c0 + threadIdx.x + k * kThreads;
          if (o >= h) continue;
          float fc = (s1[r][k] + (bias[o] + s2[r][k])) +
                     x_a[(static_cast<size_t>(b) * N + n) * h + o];
          if (n == I) fc += delta[(static_cast<size_t>(b) * N + I) * h + o];
          rows[static_cast<size_t>(n) * h + o] = fc;
        }
      }
    }
  }
  __syncthreads();
}

// Forward, rows: pooled[b, I] of one (b, I) a block. `scratch` is null when
// the rows stay in shared memory, else the (B, N*N, h) rows.
__global__ void __launch_bounds__(kThreads) cf_wide_fwd_rows_kernel(
    const float* __restrict__ terms, const float* __restrict__ base,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, float* scratch,
    float* __restrict__ pooled, int N, int H, int h) {
  extern __shared__ __align__(16) float smem[];
  float* s_mu = smem;
  float* s_rstd = s_mu + N;
  const int b = blockIdx.x / N, I = blockIdx.x % N;
  const size_t bI = static_cast<size_t>(b) * N + I;
  float* rows = scratch != nullptr ? scratch + bI * N * h : s_rstd + N;
  rebuild_fc(rows, terms, base, wa, dws, x_a, delta, bias, b, I, N, H, h);
  row_stats(rows, N, h, s_mu, s_rstd);
  pool_rows(rows, s_mu, s_rstd, N, h, pooled + bI * h);
}

// Backward, stage 1: the rows of one (b, I) a block (see the top).
__global__ void __launch_bounds__(kThreads) cf_wide_bwd_rows_kernel(
    const float* __restrict__ terms, const float* __restrict__ base,
    const float* __restrict__ wa, const float* __restrict__ dws,
    const float* __restrict__ x_a, const float* __restrict__ delta,
    const float* __restrict__ bias, const float* __restrict__ dout,
    float* d_fc, float* __restrict__ dS_as, float* __restrict__ dS_ss,
    float* __restrict__ d_wa, float* __restrict__ d_dws,
    float* __restrict__ d_delta, float* __restrict__ d_scores, int N, int H,
    int h, float sqrt_d) {
  extern __shared__ __align__(16) float smem[];
  float* s_mu = smem;
  float* s_rstd = s_mu + N;
  float* s_m2 = s_rstd + N;
  float* s_m1 = s_m2 + N;
  const int b = blockIdx.x / N, I = blockIdx.x % N;
  const size_t bI = static_cast<size_t>(b) * N + I;
  const size_t NN = static_cast<size_t>(N) * N;
  const size_t Nh = static_cast<size_t>(N) * h;
  float* rows = d_fc + bI * Nh;
  rebuild_fc(rows, terms, base, wa, dws, x_a, delta, bias, b, I, N, H, h);
  row_stats(rows, N, h, s_mu, s_rstd);
  layernorm_backward(rows, dout + bI * h, N, h, s_mu, s_rstd, s_m2, s_m1);
  for (int o = threadIdx.x; o < h; o += blockDim.x)
    d_delta[bI * h + o] = rows[static_cast<size_t>(I) * h + o];

  // the dot products of each row with num, wa_h[I] and dws_h[I]
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  for (int p = warp; p < H * N; p += nwarps) {
    const int hh = p / N, n = p % N;
    const size_t z = static_cast<size_t>(b) * H + hh;
    const float* T = terms + z * 5 * NN;
    const float* num = n == I ? base + (z * 2 + 1) * Nh + static_cast<size_t>(I) * h
                              : base + z * 2 * Nh + static_cast<size_t>(n) * h;
    const float* w = wa + (z * N + I) * h;
    const float* dv = dws + (z * N + I) * h;
    const float* r = rows + static_cast<size_t>(n) * h;
    const float A = warp_row_sum(h, [&](int o) { return r[o] * num[o]; });
    const float Bv = warp_row_sum(h, [&](int o) { return r[o] * w[o]; });
    const float C = warp_row_sum(h, [&](int o) { return r[o] * dv[o]; });
    if ((threadIdx.x & 31) == 0) {
      const size_t e = static_cast<size_t>(n) * N + I;
      const float corr = T[2 * NN + e], rep = T[3 * NN + e], Z = T[4 * NN + e];
      const float dZ = -((((A + corr * Bv) + rep * C) / Z) / Z);
      const float d_zc = Bv / Z + dZ;
      const float d_E = C / Z + d_zc;
      const float dS = (rep * d_E) / sqrt_d;
      dS_as[z * NN + e] = n == I ? 0.f : dS;
      if (n == I) dS_ss[z * N + I] = dS;
      d_scores[z * 2 * NN + e] = -d_zc;
      d_scores[(z * 2 + 1) * NN + e] = dZ;
    }
  }

  // d_dws[b, :, I] and the first term of d_wa[b, :, I]: sums over n
  for (int hh = 0; hh < H; ++hh) {
    const size_t z = static_cast<size_t>(b) * H + hh;
    const float* T = terms + z * 5 * NN;
    const size_t v = (z * N + I) * h;
    for (int o = threadIdx.x; o < h; o += blockDim.x) {
      float sd = 0.f, sw = 0.f;
      for (int n = 0; n < N; ++n) {
        const size_t e = static_cast<size_t>(n) * N + I;
        const float Z = T[4 * NN + e];
        const float x = rows[static_cast<size_t>(n) * h + o];
        sd += (T[3 * NN + e] / Z) * x;
        sw += (T[2 * NN + e] / Z) * x;
      }
      d_dws[v + o] = sd;
      d_wa[v + o] = sw;
    }
  }
}

constexpr int kHeadsPass = 4;  // heads of d_num summed in one pass over d_fc

// Backward, stage 2: one thread a column o of group b (blocks b-major).
__global__ void cf_wide_sums_kernel(const float* __restrict__ terms,
                                    const float* __restrict__ d_fc,
                                    const float* __restrict__ d_delta,
                                    float* __restrict__ d_num,
                                    float* __restrict__ dU2,
                                    float* __restrict__ d_xa,
                                    float* __restrict__ part, int N, int H,
                                    int h, int col_blocks) {
  const int b = blockIdx.x / col_blocks;
  const int o = (blockIdx.x % col_blocks) * blockDim.x + threadIdx.x;
  if (o >= h) return;
  const size_t NN = static_cast<size_t>(N) * N;
  const float* f = d_fc + static_cast<size_t>(b) * NN * h;  // [I][n][o]
  float bp = 0.f;
  for (int n = 0; n < N; ++n) {
    float s = 0.f;
    for (int I = 0; I < N; ++I) s += f[(static_cast<size_t>(I) * N + n) * h + o];
    d_xa[(static_cast<size_t>(b) * N + n) * h + o] = s;
    bp += s;
  }
  part[static_cast<size_t>(b) * h + o] = bp;
  for (int h0 = 0; h0 < H; h0 += kHeadsPass) {
    const int heads = min(kHeadsPass, H - h0);
    for (int n = 0; n < N; ++n) {
      float acc[kHeadsPass] = {};
      for (int I = 0; I < N; ++I) {
        const float x = f[(static_cast<size_t>(I) * N + n) * h + o];
        const size_t e = static_cast<size_t>(n) * N + I;
#pragma unroll
        for (int k = 0; k < kHeadsPass; ++k) {
          if (k < heads) {
            const float Z = terms[((static_cast<size_t>(b) * H + h0 + k) * 5 + 4) * NN + e];
            acc[k] += (I == n ? 0.f : 1.0f / Z) * x;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kHeadsPass; ++k)
        if (k < heads)
          d_num[((static_cast<size_t>(b) * H + h0 + k) * N + n) * h + o] = acc[k];
    }
  }
  for (int I = 0; I < N; ++I) {
    const float x = d_delta[(static_cast<size_t>(b) * N + I) * h + o];
    const size_t e = static_cast<size_t>(I) * N + I;
    for (int hh = 0; hh < H; ++hh) {
      const size_t z = static_cast<size_t>(b) * H + hh;
      dU2[(z * N + I) * h + o] = x / terms[(z * 5 + 4) * NN + e];
    }
  }
}

// Stage 3's epilogues, on output (z, row, column) of a (b, head) z.
// dS_aa[n, m] = E_aa[n, m] * ((where(n = m, 0, -d_zc[n, m]) + sum_{I != n} dZ[n, I])
//               + (d_num wa_h^T)[n, m]) / sqrt_d
struct DsAa {
  const float* terms;
  const float* d_scores;
  float* dS_aa;
  int N;
  float sqrt_d;
  __device__ void operator()(long long z, int n, int m, float v) const {
    const size_t NN = static_cast<size_t>(N) * N;
    const float* ds = d_scores + z * 2 * NN;
    float sdz = 0.f;
    for (int I = 0; I < N; ++I)
      sdz += I == n ? 0.f : ds[NN + static_cast<size_t>(n) * N + I];
    const size_t e = static_cast<size_t>(n) * N + m;
    const float d_E = ((m == n ? 0.f : ds[e]) + sdz) + v;
    dS_aa[z * NN + e] = (terms[z * 5 * NN + e] * d_E) / sqrt_d;
  }
};

// dS_sa[I, m] = E_sa[I, m] * ((dZ[I, I] + where(m = I, -d_zc[I, I], 0))
//               + (dU2 wa_h^T)[I, m]) / sqrt_d
struct DsSa {
  const float* terms;
  const float* d_scores;
  float* dS_sa;
  int N;
  float sqrt_d;
  __device__ void operator()(long long z, int I, int m, float v) const {
    const size_t NN = static_cast<size_t>(N) * N;
    const float* ds = d_scores + z * 2 * NN;
    const size_t d = static_cast<size_t>(I) * N + I;
    const float d_E = (ds[NN + d] + (m == I ? ds[d] : 0.f)) + v;
    const size_t e = static_cast<size_t>(I) * N + m;
    dS_sa[z * NN + e] = (terms[z * 5 * NN + NN + e] * d_E) / sqrt_d;
  }
};

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launches (0 = success), or
// cudaErrorInvalidValue for shapes the route does not take.

// Stage 0 of both directions: terms (B, H, 5, N, N), base (B, H, 2, N, h).
int cf_wide_base_launch(const float* S_aa, const float* S_as, const float* S_sa,
                        const float* S_ss, const float* wa, float* terms,
                        float* base, int B, int N, int H, int h, float sqrt_d,
                        void* stream) {
  if (!wide_shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long BH = static_cast<long long>(B) * H;
  const long long rows = BH * N, blocks = (rows + 127) / 128;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cf_wide_terms_kernel<<<static_cast<unsigned>(blocks), 128, 0, s>>>(
      S_aa, S_as, S_sa, S_ss, terms, rows, N, sqrt_d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long NN = static_cast<long long>(N) * N, Nh = static_cast<long long>(N) * h;
  const Operand values{wa, Nh, h, 1};
  for (int which = 0; which < 2; ++which) {  // E_aa wa_h, then E_sa wa_h
    err = gemm(Operand{terms + which * NN, 5 * NN, N, 1}, values, BH, N, h, N,
               Store{base + which * Nh, 2 * Nh, h, 1}, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Forward, rows: pooled (B, N, h). `scratch` null keeps the rows in shared
// memory (invalid if N * h floats do not fit), else the (B, N*N, h) rows.
int cf_wide_fwd_rows_launch(const float* terms, const float* base,
                            const float* wa, const float* dws, const float* x_a,
                            const float* delta, const float* bias,
                            float* scratch, float* pooled, int B, int N, int H,
                            int h, void* stream) {
  if (!wide_shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  size_t floats = 2 * static_cast<size_t>(N);
  if (scratch == nullptr) floats += static_cast<size_t>(N) * h;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = allow_smem(cf_wide_fwd_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cf_wide_fwd_rows_kernel<<<B * N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      terms, base, wa, dws, x_a, delta, bias, scratch, pooled, N, H, h);
  return static_cast<int>(cudaGetLastError());
}

// Backward, stage 1: d_fc (B, N, N, h), dS_as, dS_ss, the first term of
// d_wa, d_dws, d_delta, and the score scratch (B, H, 2, N, N).
int cf_wide_bwd_rows_launch(const float* terms, const float* base,
                            const float* wa, const float* dws, const float* x_a,
                            const float* delta, const float* bias,
                            const float* dout, float* d_fc, float* dS_as,
                            float* dS_ss, float* d_wa, float* d_dws,
                            float* d_delta, float* d_scores, int B, int N, int H,
                            int h, float sqrt_d, void* stream) {
  if (!wide_shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (3 * static_cast<size_t>(N) + 1) * sizeof(float);
  cudaError_t err = allow_smem(cf_wide_bwd_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cf_wide_bwd_rows_kernel<<<B * N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      terms, base, wa, dws, x_a, delta, bias, dout, d_fc, dS_as, dS_ss, d_wa, d_dws,
      d_delta, d_scores, N, H, h, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

// Backward, stage 2: d_num and dU2 (B, H, N, h) scratch, d_xa, and d_bias
// through the (B, h) scratch part.
int cf_wide_bwd_sums_launch(const float* terms, const float* d_fc,
                            const float* d_delta, float* d_num, float* dU2,
                            float* d_xa, float* part, float* d_bias, int B, int N,
                            int H, int h, void* stream) {
  if (!wide_shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (h + kThreads - 1) / kThreads;
  if (static_cast<long long>(B) * col_blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cf_wide_sums_kernel<<<B * col_blocks, kThreads, 0, s>>>(terms, d_fc, d_delta, d_num,
                                                          dU2, d_xa, part, N, H, h,
                                                          col_blocks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_over_groups(part, d_bias, B, h, s));
}

// Backward, stage 3: dS_aa, dS_sa, and d_wa completed in place.
int cf_wide_bwd_products_launch(const float* terms, const float* wa,
                                const float* d_num, const float* dU2,
                                const float* d_scores, float* dS_aa,
                                float* dS_sa, float* d_wa, int B, int N, int H,
                                int h, float sqrt_d, void* stream) {
  if (!wide_shape_ok(B, N, H, h)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long BH = static_cast<long long>(B) * H;
  const long long NN = static_cast<long long>(N) * N, Nh = static_cast<long long>(N) * h;
  const Operand wa_t{wa, Nh, 1, h};  // (o, m) = wa_h[m, o]
  cudaError_t err = gemm(Operand{d_num, Nh, h, 1}, wa_t, BH, N, N, h,
                         DsAa{terms, d_scores, dS_aa, N, sqrt_d}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = gemm(Operand{dU2, Nh, h, 1}, wa_t, BH, N, N, h,
             DsSa{terms, d_scores, dS_sa, N, sqrt_d}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Accumulate into_d_wa{d_wa, Nh, h, 1};
  // (m, n) = E_aa[n, m], then E_sa[J, m]: the terms transposed
  err = gemm(Operand{terms, 5 * NN, 1, N}, Operand{d_num, Nh, h, 1}, BH, N, h, N,
             into_d_wa, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gemm(Operand{terms + NN, 5 * NN, 1, N},
                               Operand{dU2, Nh, h, 1}, BH, N, h, N, into_d_wa, s));
}

}  // extern "C"
