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
// the launch, and each thread's serial chain of square roots, IEEE
// divisions and transcendentals, with too few threads to hide it. The
// design therefore is one launch per pass, nothing staged through device
// memory between the sub-passes, no cross-block traffic, and as many
// independent threads as the work allows.
//
// pairwise_sensors_kernel: eight lanes per robot, one per sensor ray, so a
// warp holds four robots and no lane idles (but at the ragged end of the
// grid). The eight lanes first share out the neighbours j = s, s + 8, ...:
// each takes the range-and-bearing terms of its own, and a ballot gathers
// which robots lie within the proximity test's reach; the eight partial
// sums meet by three xor shuffles inside the eight lanes, an order in which
// every lane gets the same bits. Then lane (i, s) turns ray s into the
// world frame and runs the cone test against the robots in reach and the
// raycast against every wall segment, for that ray alone; its reading is a
// max, order-free, so it keeps the bits of one thread doing all eight rays.
// What is skipped is only what cannot pass: a pair beyond the proximity
// reach by its squared distance, a segment whose hit distance exceeds the
// range by its numerator's magnitude (both tests are proved below). A block
// holds whole arenas, as few as make its robot count a multiple of four
// (one arena of 160 threads at N = 20), with the block's positions and the
// constants in shared memory. The lanes of a warp write prox as one
// contiguous 128-byte run; ztilde, the projections and the attraction
// vector come from lanes 4, 0-3, 5 and 6.
//
// robot_collisions_kernel: one warp per arena, one thread per robot
// (N <= 32), the arena's positions in shared memory, four arenas a block.
//
// Numerics: every formula mirrors the plain PyTorch version operation by
// operation (swarmacb_torch/env/sensors.py, physics.py), with the same
// epsilons, atan2 for the bearing, IEEE sqrt and division (no fast math) and
// FMA contraction off (-fmad=false), so that each product and sum rounds as
// PyTorch's separate operations do. Max-reductions (the prox readings) are
// order-free and come out equal; the sums over neighbours run in another
// order than PyTorch's reductions and may differ in the last bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 32;           // robots per arena
constexpr int kArenasPerBlock = 4;  // collision pass: 4 warps per block
constexpr int kMaxSeg = 64;         // wall segments
constexpr int kSensors = 8;         // rays, and lanes per robot
constexpr int kRabProj = 4;
constexpr int kMaxBlockRobots = 1024 / kSensors;
// consts layout: cos_a[8] sin_a[8] rab_cos[4] rab_sin[4] then per segment
// (ax, ay, sx, sy) with (sx, sy) = b - a
constexpr int kConstHead = 2 * kSensors + 2 * kRabProj;

// Arenas per block of the sensor pass: the fewest whole arenas whose robot
// count is a multiple of four (whole warps), doubled up to 128 threads.
inline int sensor_arenas_per_block(int N) {
  int A = (N % 4 == 0) ? 1 : (N % 2 == 0) ? 2 : 4;
  while (A * N * kSensors < 128) A *= 2;
  return A;
}

__global__ void __launch_bounds__(1024) pairwise_sensors_kernel(
    const float* __restrict__ pos, const float* __restrict__ yaw,
    const float* __restrict__ consts, int n_seg,
    float* __restrict__ prox, float* __restrict__ ztilde,
    float* __restrict__ rab_proj, float* __restrict__ attr_x,
    float* __restrict__ attr_y, int E, int N, int A, float prox_range,
    float prox_plus_r, float prox_d2, float t_reach, float rab_range,
    float alpha) {
  __shared__ float s_p[2 * kMaxBlockRobots];  // (x, y) of the block's robots
  __shared__ float s_c[kConstHead + 4 * kMaxSeg];

  const int s = threadIdx.x % kSensors;       // this lane's ray
  const int rb = threadIdx.x / kSensors;      // robot within the block
  const int a = rb / N;                       // arena within the block
  const int i = rb - a * N;
  const int e0 = blockIdx.x * A;
  const int n_arenas = min(A, E - e0);
  const bool active = a < n_arenas;
  const size_t r = static_cast<size_t>(e0 + a) * N + i;
  const float th = active ? yaw[r] : 0.f;
  for (int k = threadIdx.x; k < kConstHead + 4 * n_seg; k += blockDim.x)
    s_c[k] = consts[k];
  const float* block_pos = pos + static_cast<size_t>(e0) * N * 2;
  for (int k = threadIdx.x; k < 2 * n_arenas * N; k += blockDim.x)
    s_p[k] = block_pos[k];
  __syncthreads();
  if (!active) return;  // whole robots, so whole groups of eight lanes

  const int base = threadIdx.x % 32 & ~(kSensors - 1);  // the robot's first lane
  const unsigned group = 0xffu << base;
  const float* arena = s_p + 2 * a * N;
  const float xi = arena[2 * i], yi = arena[2 * i + 1];
  const float cy = cosf(th);
  const float sy = sinf(th);
  const float* seg = s_c + kConstHead;
  const float wdx = s_c[s] * cy - s_c[kSensors + s] * sy;
  const float wdy = s_c[s] * sy + s_c[kSensors + s] * cy;

  // ── the neighbours j = s (mod 8): range and bearing (sensors.compute_rab),
  // and which robots the proximity test can see. A pair with
  // d2 > prox_d2 >= prox_plus_r^2 has dist_p >= prox_plus_r (the sum and
  // sqrtf both round monotonically onto floats), so its test is false for
  // every ray; the eight lanes gather the others in `near`, one bit a robot.
  unsigned near = 0;
  float count = 0.f, w_x = 0.f, w_y = 0.f, a_x = 0.f, a_y = 0.f;
  for (int j0 = 0; j0 < N; j0 += kSensors) {
    const int j = j0 + s;
    bool maybe = false;
    if (j < N) {
      const float dx = arena[2 * j] - xi;  // x_j - x_i
      const float dy = arena[2 * j + 1] - yi;
      const float d2 = dx * dx + dy * dy;
      maybe = d2 <= prox_d2;
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
    near |= ((__ballot_sync(group, maybe) >> base) & 0xffu) << j0;
  }
  // the eight partial sums: each step adds the same two operands in every
  // lane (in swapped order, which IEEE addition ignores), so all eight lanes
  // end with the same bits
#pragma unroll
  for (int off = 1; off < kSensors; off <<= 1) {
    count += __shfl_xor_sync(group, count, off);
    w_x += __shfl_xor_sync(group, w_x, off);
    w_y += __shfl_xor_sync(group, w_y, off);
    a_x += __shfl_xor_sync(group, a_x, off);
    a_y += __shfl_xor_sync(group, a_y, off);
  }

  // ── ray s against the robots in reach (sensors.detect_robots_proximity) ──
  float reading = 0.f;
  for (; near != 0; near &= near - 1) {
    const int j = __ffs(near) - 1;
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
  // t and u are the two IEEE divisions of the plain version, taken where
  // they can decide a hit. Where |num| > fl(|den|·t_reach), t_reach >=
  // prox_range·(1 + 2^-20)·(1 - 2^-24), the quotient exceeds prox_range in
  // magnitude even after its rounding, so t fails 0 <= t <= prox_range and
  // is not divided out; u is divided out only where t passes.
  for (int k = 0; k < n_seg; ++k) {
    const float ax = seg[4 * k], ay = seg[4 * k + 1];
    const float sx = seg[4 * k + 2], sy_s = seg[4 * k + 3];
    const float rel_x = ax - xi;
    const float rel_y = ay - yi;
    const float denom = wdx * sy_s - wdy * sx;
    if (!(fabsf(denom) > 1e-8f)) continue;
    const float den = denom + 1e-12f;
    const float num = rel_x * sy_s - rel_y * sx;
    if (fabsf(num) > fabsf(den) * t_reach) continue;
    const float t = num / den;
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
  if (N > kMaxN || N < 1 || n_seg > kMaxSeg || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int A = sensor_arenas_per_block(N);
  // the least float at or above prox_plus_r^2 (the double product is exact)
  const double p2 = static_cast<double>(prox_plus_r) * prox_plus_r;
  float prox_d2 = static_cast<float>(p2);
  if (prox_d2 < p2) prox_d2 = nextafterf(prox_d2, INFINITY);
  const float t_reach = prox_range * (1.0f + 0x1p-20f);
  pairwise_sensors_kernel<<<(E + A - 1) / A, A * N * kSensors, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      pos, yaw, consts, n_seg, prox, ztilde, rab_proj, attr_x, attr_y, E, N, A,
      prox_range, prox_plus_r, prox_d2, t_reach, rab_range, alpha);
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
