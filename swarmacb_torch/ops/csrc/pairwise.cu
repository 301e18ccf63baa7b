// Env kernels of the Directional Gate step, for Hopper (sm_90a).
//
// Replaces (TPU kernels):
//   pairwise_sensors_kernel  <- swarmacb_tpu/ops/pairwise.py: pairwise_sensors
//                               (Pallas body _sensor_kernel)
//   robot_collisions_kernel  <- swarmacb_tpu/ops/pairwise.py: resolve_robot_collisions
//                               (Pallas body _collision_kernel)
//
// What bounds it on the H100: neither bytes nor arithmetic. At the main
// path's E = 1024 arenas of N = 20 robots the sensor pass moves ~1.5 MB and
// does ~50 MFLOP, the collision pass ~0.3 MB and ~4 MFLOP; each is worth
// under a microsecond of the card at its peak rates. Latency bounds them:
// the launch, and each thread's serial loop over the other robots and the
// wall segments, with only E * N threads to hide it. The design therefore
// is one launch per pass,
// nothing staged through device memory between the sub-passes, and a
// mapping that needs no cross-block traffic: one warp per arena, one thread
// per robot (N <= 32), the arena's positions and yaw cos/sin in shared
// memory. Each thread loops over the other robots, the 8 sensors and the
// wall segments itself and writes its outputs straight into the (E, N, .)
// layout; the TPU kernel's arena-on-lanes transposes do not carry over.
//
// Numerics: every formula mirrors the plain PyTorch version operation by
// operation (swarmacb_torch/env/sensors.py, physics.py), with the same
// epsilons, atan2 for the bearing, IEEE sqrt and division (no fast math) and
// FMA contraction off (-fmad=false), so that each product and sum rounds as
// PyTorch's separate operations do. Max-reductions (the prox readings) are
// order-free and come out equal; the sums over neighbours run in index order
// and may differ from PyTorch's reduction order in the last bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 32;           // robots per arena: one warp
constexpr int kArenasPerBlock = 4;  // 4 warps per block
constexpr int kMaxSeg = 64;         // wall segments
constexpr int kSensors = 8;
constexpr int kRabProj = 4;
// consts layout: cos_a[8] sin_a[8] rab_cos[4] rab_sin[4] then per segment
// (ax, ay, sx, sy) with (sx, sy) = b - a
constexpr int kConstHead = 2 * kSensors + 2 * kRabProj;

__global__ void pairwise_sensors_kernel(
    const float* __restrict__ pos, const float* __restrict__ yaw,
    const float* __restrict__ consts, int n_seg,
    float* __restrict__ prox, float* __restrict__ ztilde,
    float* __restrict__ rab_proj, float* __restrict__ attr_x,
    float* __restrict__ attr_y, int E, int N, float prox_range,
    float prox_plus_r, float rab_range, float alpha) {
  __shared__ float s_x[kArenasPerBlock][kMaxN];
  __shared__ float s_y[kArenasPerBlock][kMaxN];
  __shared__ float s_c[kConstHead + 4 * kMaxSeg];

  const int warp = threadIdx.x / 32;
  const int i = threadIdx.x % 32;
  const int e = blockIdx.x * kArenasPerBlock + warp;
  const bool active = (e < E) && (i < N);

  for (int k = threadIdx.x; k < kConstHead + 4 * n_seg; k += blockDim.x)
    s_c[k] = consts[k];
  float xi = 0.f, yi = 0.f, cy = 0.f, sy = 0.f;
  if (active) {
    const int r = e * N + i;
    xi = pos[2 * r];
    yi = pos[2 * r + 1];
    const float th = yaw[r];
    cy = cosf(th);
    sy = sinf(th);
    s_x[warp][i] = xi;
    s_y[warp][i] = yi;
  }
  __syncthreads();
  if (!active) return;

  const float* cos_a = s_c;
  const float* sin_a = s_c + kSensors;
  const float* rab_cos = s_c + 2 * kSensors;
  const float* rab_sin = s_c + 2 * kSensors + kRabProj;
  const float* seg = s_c + kConstHead;

  float wdx[kSensors], wdy[kSensors], reading[kSensors];
#pragma unroll
  for (int s = 0; s < kSensors; ++s) {
    wdx[s] = cos_a[s] * cy - sin_a[s] * sy;
    wdy[s] = cos_a[s] * sy + sin_a[s] * cy;
    reading[s] = 0.f;
  }

  // ── other robots: proximity cone test and range-and-bearing ──
  float count = 0.f, w_x = 0.f, w_y = 0.f, a_x = 0.f, a_y = 0.f;
  for (int j = 0; j < N; ++j) {
    const float dx = s_x[warp][j] - xi;  // x_j - x_i
    const float dy = s_y[warp][j] - yi;
    const float d2 = dx * dx + dy * dy;

    // proximity (sensors.detect_robots_proximity)
    const float dist_p = sqrtf(d2 + 1e-12f);
    if (dist_p < prox_plus_r && !(dist_p < 1e-4f)) {
      const float val = fminf(fmaxf(1.0f - dist_p / prox_plus_r, 0.f), 1.f);
      const float den = dist_p + 1e-8f;
#pragma unroll
      for (int s = 0; s < kSensors; ++s) {
        const float dot = wdx[s] * dx + wdy[s] * dy;
        if (dot / den > 0.9659f) reading[s] = fmaxf(reading[s], val);
      }
    }

    // range and bearing (sensors.compute_rab)
    const float dist_r = sqrtf(d2 + 1e-8f);
    if (j != i && dist_r < rab_range) {
      count += 1.f;
      const float inv_dist = 1.0f / (dist_r + 1e-8f);
      const float body_x = dx * cy + dy * sy;
      const float body_y = (-dx) * sy + dy * cy;
      const float bearing = atan2f(body_y, body_x);
      const float cb = cosf(bearing);
      const float sb = sinf(bearing);
      w_x += inv_dist * cb;
      w_y += inv_dist * sb;
      const float alpha_w = alpha / (1.0f + dist_r);
      a_x += alpha_w * cb;
      a_y += alpha_w * sb;
    }
  }

  // ── walls: 8 rays x n_seg segments (sensors.raycast_segments) ──
  for (int k = 0; k < n_seg; ++k) {
    const float ax = seg[4 * k], ay = seg[4 * k + 1];
    const float sx = seg[4 * k + 2], sy_s = seg[4 * k + 3];
    const float rel_x = ax - xi;
    const float rel_y = ay - yi;
#pragma unroll
    for (int s = 0; s < kSensors; ++s) {
      const float denom = wdx[s] * sy_s - wdy[s] * sx;
      const float den = denom + 1e-12f;
      const float t = (rel_x * sy_s - rel_y * sx) / den;
      const float u = (rel_x * wdy[s] - rel_y * wdx[s]) / den;
      if (fabsf(denom) > 1e-8f && t >= 0.f && t <= prox_range && u >= 0.f &&
          u <= 1.f)
        reading[s] = fmaxf(reading[s], 1.0f - t / prox_range);
    }
  }

  const int r = e * N + i;
#pragma unroll
  for (int s = 0; s < kSensors; ++s) prox[r * kSensors + s] = reading[s];
  ztilde[r] = 1.0f - 2.0f / (1.0f + expf(count));
#pragma unroll
  for (int k = 0; k < kRabProj; ++k)
    rab_proj[r * kRabProj + k] = w_x * rab_cos[k] + w_y * rab_sin[k];
  attr_x[r] = a_x;
  attr_y[r] = a_y;
}

// Single Jacobi pass of elastic push-out (physics.resolve_robot_collisions).
// Thread i reads only pre-push positions and writes out of place:
//   out_i = (x_i + sum_{j>i} half(i, j)) - sum_{j<i} half(j, i),
//   half(a, b) = 0.5 * max(2r - d_ab, 0) * (x_a - x_b) / (d_ab + 1e-8).
__global__ void robot_collisions_kernel(const float* __restrict__ pos,
                                        float* __restrict__ out, int E, int N,
                                        float min_dist) {
  __shared__ float s_x[kArenasPerBlock][kMaxN];
  __shared__ float s_y[kArenasPerBlock][kMaxN];
  const int warp = threadIdx.x / 32;
  const int i = threadIdx.x % 32;
  const int e = blockIdx.x * kArenasPerBlock + warp;
  const bool active = (e < E) && (i < N);
  float xi = 0.f, yi = 0.f;
  if (active) {
    xi = pos[2 * (e * N + i)];
    yi = pos[2 * (e * N + i) + 1];
    s_x[warp][i] = xi;
    s_y[warp][i] = yi;
  }
  __syncthreads();
  if (!active) return;

  float hx_own = 0.f, hy_own = 0.f;  // pairs (i, j), j > i
  for (int j = i + 1; j < N; ++j) {
    const float dx = xi - s_x[warp][j];
    const float dy = yi - s_y[warp][j];
    const float dist = sqrtf(dx * dx + dy * dy + 1e-8f);
    const float overlap = fmaxf(min_dist - dist, 0.f);
    const float nx = dx / (dist + 1e-8f);
    const float ny = dy / (dist + 1e-8f);
    hx_own += overlap * nx * 0.5f;
    hy_own += overlap * ny * 0.5f;
  }
  float hx_other = 0.f, hy_other = 0.f;  // pairs (j, i), j < i
  for (int j = 0; j < i; ++j) {
    const float dx = s_x[warp][j] - xi;
    const float dy = s_y[warp][j] - yi;
    const float dist = sqrtf(dx * dx + dy * dy + 1e-8f);
    const float overlap = fmaxf(min_dist - dist, 0.f);
    const float nx = dx / (dist + 1e-8f);
    const float ny = dy / (dist + 1e-8f);
    hx_other += overlap * nx * 0.5f;
    hy_other += overlap * ny * 0.5f;
  }
  out[2 * (e * N + i)] = (xi + hx_own) - hx_other;
  out[2 * (e * N + i) + 1] = (yi + hy_own) - hy_other;
}

inline int blocks_for(int E) {
  return (E + kArenasPerBlock - 1) / kArenasPerBlock;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success).
int pairwise_sensors_launch(const float* pos, const float* yaw,
                            const float* consts, int n_seg, float* prox,
                            float* ztilde, float* rab_proj, float* attr_x,
                            float* attr_y, int E, int N, float prox_range,
                            float prox_plus_r, float rab_range, float alpha,
                            void* stream) {
  if (N > kMaxN || n_seg > kMaxSeg) return static_cast<int>(cudaErrorInvalidValue);
  pairwise_sensors_kernel<<<blocks_for(E), 32 * kArenasPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      pos, yaw, consts, n_seg, prox, ztilde, rab_proj, attr_x, attr_y, E, N,
      prox_range, prox_plus_r, rab_range, alpha);
  return static_cast<int>(cudaGetLastError());
}

int robot_collisions_launch(const float* pos, float* out, int E, int N,
                            float min_dist, void* stream) {
  if (N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  robot_collisions_kernel<<<blocks_for(E), 32 * kArenasPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      pos, out, E, N, min_dist);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
