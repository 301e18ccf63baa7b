// The env's pairwise passes at any robot count, for Hopper (sm_90a): the
// wide route of K1 and K2, which ``ops/pairwise.py:route`` takes where an
// arena holds more robots than the tuned kernels of pairwise.cu take
// (N > 32: their neighbour masks are one 32-bit word a robot).
//
// Replaces (TPU kernels), at those robot counts:
//   pairwise_sensors_wide_kernel  <- swarmacb_tpu/ops/pairwise.py: pairwise_sensors
//                                    (Pallas body _sensor_kernel)
//   robot_collisions_wide_kernel  <- swarmacb_tpu/ops/pairwise.py: resolve_robot_collisions
//                                    (Pallas body _collision_kernel)
//
// A simple design: a block works on one arena (blockIdx.x), its robots
// split over blockIdx.y and, past the grid, looped. Each thread reads the
// arena's positions, 8 bytes a robot, straight from global memory, where L1
// and L2 serve the re-reads (staging them in shared memory was no faster at
// (1024, 64) or (32768, 64); PERF.md); nothing refuses an N >= 1.
//
// pairwise_sensors_wide_kernel: eight lanes a robot, one a sensor ray, 32
// robots a block. Lane (i, s) takes the range-and-bearing terms of the
// neighbours j = s, s + 8, ... and the eight partial sums meet by three xor
// shuffles (the tuned kernel's order, so every lane gets the same bits);
// then it runs the cone test of ray s against every robot and the raycast
// against every wall segment. No pair or segment is skipped: the tuned
// kernel's skips are exact, so evaluating every one gives the same reading.
//
// robot_collisions_wide_kernel: one thread a robot, 128 a block, a loop over
// every neighbour in ascending j. Each pair is evaluated in full: the push
// of a pair that cannot touch is +0 or -0 and leaves an accumulator that
// started at +0 as it was (the proof is at robot_collisions_kernel in
// pairwise.cu), so the sums are the tuned kernel's bits.
//
// Numerics as in pairwise.cu and the plain PyTorch version
// (swarmacb_torch/env/sensors.py, physics.py): every formula operation by
// operation, the same epsilons, atan2 for the bearing, IEEE sqrtf and
// division (no fast math), FMA contraction off (-fmad=false).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSensors = 8;           // rays, and lanes per robot
constexpr int kRabProj = 4;
constexpr int kMaxSeg = 64;           // wall segments
constexpr int kConstHead = 2 * kSensors + 2 * kRabProj;
constexpr int kSensorRobots = 32;     // robots a block of the sensor pass
constexpr int kCollisionThreads = 128;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kSensorRobots * kSensors) pairwise_sensors_wide_kernel(
    const float* __restrict__ pos, const float* __restrict__ yaw,
    const float* __restrict__ consts, int n_seg, float* __restrict__ prox,
    float* __restrict__ ztilde, float* __restrict__ rab_proj,
    float* __restrict__ attr_x, float* __restrict__ attr_y, int N,
    float prox_range, float prox_plus_r, float rab_range, float alpha) {
  __shared__ float s_c[kConstHead + 4 * kMaxSeg];

  const size_t e = blockIdx.x;
  for (int k = threadIdx.x; k < kConstHead + 4 * n_seg; k += blockDim.x) s_c[k] = consts[k];
  const float* arena = pos + e * N * 2;  // (x, y) of robot j at arena[2j], arena[2j + 1]
  __syncthreads();

  const int s = threadIdx.x % kSensors;                          // this lane's ray
  const unsigned group = 0xffu << (threadIdx.x % 32 & ~(kSensors - 1));
  const float* seg = s_c + kConstHead;
  for (int i = blockIdx.y * kSensorRobots + threadIdx.x / kSensors; i < N;
       i += gridDim.y * kSensorRobots) {  // whole groups of eight lanes leave together
    const size_t r = e * N + i;
    const float xi = arena[2 * i], yi = arena[2 * i + 1];
    const float th = yaw[r];
    const float cy = cosf(th);
    const float sy = sinf(th);
    const float wdx = s_c[s] * cy - s_c[kSensors + s] * sy;
    const float wdy = s_c[s] * sy + s_c[kSensors + s] * cy;

    // ── the neighbours j = s (mod 8): range and bearing (sensors.compute_rab)
    float count = 0.f, w_x = 0.f, w_y = 0.f, a_x = 0.f, a_y = 0.f;
    for (int j = s; j < N; j += kSensors) {
      const float dx = arena[2 * j] - xi;  // x_j - x_i
      const float dy = arena[2 * j + 1] - yi;
      const float d2 = dx * dx + dy * dy;
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
#pragma unroll
    for (int off = 1; off < kSensors; off <<= 1) {
      count += __shfl_xor_sync(group, count, off);
      w_x += __shfl_xor_sync(group, w_x, off);
      w_y += __shfl_xor_sync(group, w_y, off);
      a_x += __shfl_xor_sync(group, a_x, off);
      a_y += __shfl_xor_sync(group, a_y, off);
    }

    // ── ray s against every robot (sensors.detect_robots_proximity) ──
    float reading = 0.f;
    for (int j = 0; j < N; ++j) {
      const float dx = arena[2 * j] - xi;
      const float dy = arena[2 * j + 1] - yi;
      const float dist_p = sqrtf(dx * dx + dy * dy + 1e-12f);
      if (dist_p < prox_plus_r && !(dist_p < 1e-4f)) {
        const float dot = wdx * dx + wdy * dy;
        if (dot / (dist_p + 1e-8f) > 0.9659f)
          reading = fmaxf(reading, fminf(fmaxf(1.0f - dist_p / prox_plus_r, 0.f), 1.f));
      }
    }

    // ── ray s against the walls (sensors.raycast_segments) ──
    for (int k = 0; k < n_seg; ++k) {
      const float ax = seg[4 * k], ay = seg[4 * k + 1];
      const float sx = seg[4 * k + 2], sy_s = seg[4 * k + 3];
      const float rel_x = ax - xi;
      const float rel_y = ay - yi;
      const float denom = wdx * sy_s - wdy * sx;
      if (!(fabsf(denom) > 1e-8f)) continue;
      const float den = denom + 1e-12f;
      const float t = (rel_x * sy_s - rel_y * sx) / den;
      if (!(t >= 0.f && t <= prox_range)) continue;
      const float u = (rel_x * wdy - rel_y * wdx) / den;
      if (u >= 0.f && u <= 1.f) reading = fmaxf(reading, 1.0f - t / prox_range);
    }

    prox[r * kSensors + s] = reading;
    if (s < kRabProj)
      rab_proj[r * kRabProj + s] =
          w_x * s_c[2 * kSensors + s] + w_y * s_c[2 * kSensors + kRabProj + s];
    else if (s == 4)
      ztilde[r] = 1.0f - 2.0f / (1.0f + expf(count));
    else if (s == 5)
      attr_x[r] = a_x;
    else if (s == 6)
      attr_y[r] = a_y;
  }
}

// Single Jacobi pass of elastic push-out (physics.resolve_robot_collisions):
//   out_i = (x_i + sum_{j>i} half(i, j)) - sum_{j<i} half(j, i),
// each sum in ascending j, half(j, i) taken as -half(i, j) (exact).
__global__ void __launch_bounds__(kCollisionThreads) robot_collisions_wide_kernel(
    const float* __restrict__ pos, float* __restrict__ out, int N, float min_dist) {
  const size_t e = blockIdx.x;
  const float* arena = pos + e * N * 2;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < N; i += gridDim.y * blockDim.x) {
    const float xi = arena[2 * i], yi = arena[2 * i + 1];
    float hx_own = 0.f, hy_own = 0.f;      // pairs (i, j), j > i
    float hx_other = 0.f, hy_other = 0.f;  // pairs (j, i), j < i
    for (int j = 0; j < N; ++j) {
      if (j == i) continue;
      const float dx = xi - arena[2 * j];
      const float dy = yi - arena[2 * j + 1];
      const float dist = sqrtf(dx * dx + dy * dy + 1e-8f);
      const float overlap = fmaxf(min_dist - dist, 0.f);
      const float nx = dx / (dist + 1e-8f);
      const float ny = dy / (dist + 1e-8f);
      const float tx = overlap * nx * 0.5f;
      const float ty = overlap * ny * 0.5f;
      if (j > i) {
        hx_own += tx;
        hy_own += ty;
      } else {
        hx_other -= tx;
        hy_other -= ty;
      }
    }
    // the pair (i, i) of the plain version's dense matrix: zero where x_i
    // and y_i are finite, NaN in both coordinates where either is not
    if (!(fabsf(xi) <= FLT_MAX && fabsf(yi) <= FLT_MAX)) hx_own = hy_own = NAN;
    out[2 * (e * N + i)] = (xi + hx_own) - hx_other;
    out[2 * (e * N + i) + 1] = (yi + hy_own) - hy_other;
  }
}

inline int grid_y(int N, int per_block) {
  const int blocks = (N + per_block - 1) / per_block;
  return blocks < kMaxGridY ? blocks : kMaxGridY;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success).
int pairwise_sensors_wide_launch(const float* pos, const float* yaw, const float* consts,
                                 int n_seg, float* prox, float* ztilde, float* rab_proj,
                                 float* attr_x, float* attr_y, int E, int N,
                                 float prox_range, float prox_plus_r, float rab_range,
                                 float alpha, void* stream) {
  if (N < 1 || E < 1 || n_seg > kMaxSeg || n_seg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(E, grid_y(N, kSensorRobots));
  pairwise_sensors_wide_kernel<<<grid, kSensorRobots * kSensors, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      pos, yaw, consts, n_seg, prox, ztilde, rab_proj, attr_x, attr_y, N, prox_range,
      prox_plus_r, rab_range, alpha);
  return static_cast<int>(cudaGetLastError());
}

int robot_collisions_wide_launch(const float* pos, float* out, int E, int N,
                                 float min_dist, void* stream) {
  if (N < 1 || E < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(E, grid_y(N, kCollisionThreads));
  robot_collisions_wide_kernel<<<grid, kCollisionThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(pos, out, N, min_dist);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
