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
// Each thread reads the arena's positions, 8 bytes a robot, straight from
// global memory, where L1 and L2 serve the re-reads (staging them in shared
// memory was slower); nothing refuses an N >= 1.
//
// pairwise_sensors_wide_kernel: eight lanes a robot, one a sensor ray, 32
// robots of one arena a block, the blocks of an arena side by side in a
// one-dimensional grid, so that they meet its positions in L2 together;
// each robot's pose is loaded before the block's barrier. A form that evaluated every pair spent its
// time on arithmetic that cannot count: on spread poses ~2 of 63
// neighbours lie within the RAB range (0.2 m) and ~1 within the proximity
// reach (0.135 m), and a robot is within the proximity range of the lines
// of few wall segments. So each pair's squared distance is taken once, by
// one of the eight lanes, and decides exactly what the pair can count
// (what is left to wait on is each warp's first loads, PERF.md §6):
//   - the RAB terms, where j != i and d2 < rab_d2, the least float q with
//     sqrtf(q + 1e-8) >= rab_range (``pairwise.least_d2``): the sum and
//     sqrtf round monotonically, so this is the range test dist_r <
//     rab_range itself. Lane (i, s) takes j = s, s + 8, ... of each word of
//     64 neighbours in one branch-free loop, an OR over the eight lanes
//     (__reduce_or_sync) gathers the ones in range, and lane (i, s) then
//     takes the terms of those of rank s, s + 8, ... in ascending j,
//     so that a warp runs the terms about once a word and not once for
//     each j where any of its lanes has one, and the eight partial sums
//     meet by three xor shuffles (every lane gets the same bits). The
//     bearing's cosine and sine are the TPU kernel's, the body offset times
//     nr_rsqrt(d2) (rsqrt and one Newton step), within a few 2^-24 of
//     cosf(atan2f(.)) and sinf(.); below d2 = 2^-100, where the squares
//     lose their precision, they are taken by atan2f;
//   - the proximity cone test, where j != i and d2 < prox_d2, the least
//     float q with sqrtf(q + 1e-12) >= prox_plus_r (``pairwise.least_d2``):
//     for any other pair dist_p >= prox_plus_r or dist_p < 1e-4 (j = i,
//     d2 = 0), and the test fails. The same loop and OR
//     gather these robots, and lane (i, s) tests its ray against each; its
//     reading is a max, order-free;
//   - the walls: lane (i, s) tests segments k = s, s + 8, ...: where
//     |num_k| > s_wall[k] no ray can hit (proved at the loop), and an OR
//     gathers the others; then each lane runs its ray against those,
//     with the tuned kernel's exact range test |num| > |den|·t_reach before
//     the divisions.
// The readings, ztilde and the range count are the bits of the form that
// evaluates every pair and segment; the RAB sums take their terms in
// another order than the plain version's, each term within a few 2^-24 of
// its atan2 form (``chip_smoke.py`` holds them to 1e-5 + 1e-5·Σ|term|).
//
// robot_collisions_wide_kernel: a block works on one arena (blockIdx.x),
// its robots split over blockIdx.y and, past the grid, looped; one thread a
// robot, 128 a block, a loop over every neighbour in ascending j. Each pair
// is evaluated in full: the push
// of a pair that cannot touch is +0 or -0 and leaves an accumulator that
// started at +0 as it was (the proof is at robot_collisions_kernel in
// pairwise.cu), so the sums are the tuned kernel's bits.
//
// Numerics as in pairwise.cu and the plain PyTorch version
// (swarmacb_torch/env/sensors.py, physics.py): every formula operation by
// operation, the same epsilons, IEEE sqrtf and division (no fast math),
// FMA contraction off (-fmad=false); the bearing as above.

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
constexpr int kChunk = 64;            // neighbours a mask word
constexpr int kCollisionThreads = 128;
constexpr int kMaxGridY = 65535;
constexpr float kMinHyp2 = 0x1p-100f; // below it, the bearing by atan2f

__device__ __forceinline__ float nr_rsqrt(float x) {
  const float r0 = rsqrtf(x);
  return r0 * (1.5f - 0.5f * x * r0 * r0);
}

__global__ void __launch_bounds__(kSensorRobots * kSensors) pairwise_sensors_wide_kernel(
    const float* __restrict__ pos, const float* __restrict__ yaw,
    const float* __restrict__ consts, int n_seg, float* __restrict__ prox,
    float* __restrict__ ztilde, float* __restrict__ rab_proj,
    float* __restrict__ attr_x, float* __restrict__ attr_y, int N,
    float prox_range, float prox_plus_r, float rab_range, float alpha, float prox_d2,
    float rab_d2, float t_reach) {
  __shared__ float s_c[kConstHead + 4 * kMaxSeg];
  __shared__ float s_wall[kMaxSeg];

  const int blocks = (N + kSensorRobots - 1) / kSensorRobots;  // an arena's, side by side
  const size_t e = blockIdx.x / blocks;
  const int i = blockIdx.x % blocks * kSensorRobots + threadIdx.x / kSensors;
  const size_t r = e * N + i;
  const float* arena = pos + e * N * 2;  // (x, y) of robot j at arena[2j], arena[2j + 1]
  // the robot's pose, loaded before the barrier so that its latency
  // overlaps the constants'
  float xi = 0.f, yi = 0.f, th = 0.f;
  if (i < N) {
    xi = arena[2 * i];
    yi = arena[2 * i + 1];
    th = yaw[r];
  }
  for (int k = threadIdx.x; k < kConstHead + 4 * n_seg; k += blockDim.x) s_c[k] = consts[k];
  for (int k = threadIdx.x; k < n_seg; k += blockDim.x) {
    const float sx = consts[kConstHead + 4 * k + 2], sy = consts[kConstHead + 4 * k + 3];
    s_wall[k] = (sqrtf(sx * sx + sy * sy) * 1.001f) * t_reach;
  }
  __syncthreads();
  if (i >= N) return;  // whole groups of eight lanes, after the only barrier

  const int s = threadIdx.x % kSensors;                    // this lane's ray
  const unsigned group = 0xffu << (threadIdx.x % 32 & ~(kSensors - 1));  // the robot's lanes
  const float* seg = s_c + kConstHead;
  float cy, sy;
  sincosf(th, &sy, &cy);
  const float wdx = s_c[s] * cy - s_c[kSensors + s] * sy;
  const float wdy = s_c[s] * sy + s_c[kSensors + s] * cy;

  int count = 0;  // neighbours in RAB range, the same in all eight lanes
  float w_x = 0.f, w_y = 0.f, a_x = 0.f, a_y = 0.f, reading = 0.f;
  const unsigned lane_bit = 1u << s;
  for (int j0 = 0; j0 < N; j0 += kChunk) {
    // ── the squared distances of this word's neighbours, lane s taking
    // j = j0 + 8k + s into bit 8k + s of its words (past N, robot N - 1,
    // masked off below); an OR over the eight lanes gathers which ones
    // the cone test can see and which lie in RAB range
    unsigned near_lo = 0, near_hi = 0, in_lo = 0, in_hi = 0;
#pragma unroll
    for (int k = 0; k < kChunk / kSensors; ++k) {
      const int j = min(j0 + kSensors * k + s, N - 1);
      const float dx = arena[2 * j] - xi;  // x_j - x_i
      const float dy = arena[2 * j + 1] - yi;
      const float d2 = dx * dx + dy * dy;
      const unsigned bit = lane_bit << (kSensors * (k % 4));
      if (d2 < prox_d2) (k < 4 ? near_lo : near_hi) |= bit;
      if (d2 < rab_d2) (k < 4 ? in_lo : in_hi) |= bit;
    }
    uint64_t valid = N - j0 >= kChunk ? ~0ull : (1ull << (N - j0)) - 1;
    if (i >= j0 && i < j0 + kChunk) valid &= ~(1ull << (i - j0));  // the pair (i, i)
    uint64_t near = (static_cast<uint64_t>(__reduce_or_sync(group, near_hi)) << 32 |
                     __reduce_or_sync(group, near_lo)) & valid;
    uint64_t in_range = (static_cast<uint64_t>(__reduce_or_sync(group, in_hi)) << 32 |
                         __reduce_or_sync(group, in_lo)) & valid;
    count += __popcll(static_cast<long long>(in_range));

    // ── range and bearing (sensors.compute_rab): lane s takes the
    // neighbours in range of rank s, s + 8, ... in this word, so a warp
    // runs the terms about once a word where a robot has up to eight
    for (int t = 0; t < s && in_range != 0; ++t) in_range &= in_range - 1;
    while (in_range != 0) {
      const int j = j0 + __ffsll(static_cast<long long>(in_range)) - 1;
      const float dx = arena[2 * j] - xi;
      const float dy = arena[2 * j + 1] - yi;
      const float d2 = dx * dx + dy * dy;
      const float dist_r = sqrtf(d2 + 1e-8f);
      const float inv_dist = 1.0f / (dist_r + 1e-8f);
      const float body_x = dx * cy + dy * sy;
      const float body_y = (-dx) * sy + dy * cy;
      float cb, sb;
      if (d2 >= kMinHyp2) {
        const float inv_hyp = nr_rsqrt(d2);
        cb = body_x * inv_hyp;
        sb = body_y * inv_hyp;
      } else {
        const float bearing = atan2f(body_y, body_x);
        cb = cosf(bearing);
        sb = sinf(bearing);
      }
      w_x += inv_dist * cb;
      w_y += inv_dist * sb;
      const float alpha_w = alpha / (1.0f + dist_r);
      a_x += alpha_w * cb;
      a_y += alpha_w * sb;
      for (int t = 0; t < kSensors && in_range != 0; ++t) in_range &= in_range - 1;
    }

    // ── ray s against the robots in reach (sensors.detect_robots_proximity) ──
    for (; near != 0; near &= near - 1) {
      const int j = j0 + __ffsll(static_cast<long long>(near)) - 1;
      const float dx = arena[2 * j] - xi;
      const float dy = arena[2 * j + 1] - yi;
      const float dist_p = sqrtf(dx * dx + dy * dy + 1e-12f);
      if (dist_p < prox_plus_r && !(dist_p < 1e-4f)) {
        const float dot = wdx * dx + wdy * dy;
        if (dot / (dist_p + 1e-8f) > 0.9659f)
          reading = fmaxf(reading, fminf(fmaxf(1.0f - dist_p / prox_plus_r, 0.f), 1.f));
      }
    }
  }
  // the eight partial sums: each step adds the same two operands in every
  // lane (in swapped order, which IEEE addition ignores), so all eight
  // lanes end with the same bits
#pragma unroll
  for (int off = 1; off < kSensors; off <<= 1) {
    w_x += __shfl_xor_sync(group, w_x, off);
    w_y += __shfl_xor_sync(group, w_y, off);
    a_x += __shfl_xor_sync(group, a_x, off);
    a_y += __shfl_xor_sync(group, a_y, off);
  }

  // ── ray s against the walls (sensors.raycast_segments) ──
  // Which segments a ray can hit: s_wall[k] = fl(fl(1.001·|s_k|)·t_reach),
  // t_reach = prox_range·(1 + 2^-20). A ray with |denom| <= 1e-8 cannot
  // hit; for any other, |den| = |denom + 1e-12| <= |s_k|·|w|·(1 + 2^-22)
  // ·(1 + 1e-4) <= 1.00011·|s_k| (|w| <= 1 + 2^-20, the unit ray as
  // rounded), so |num| > s_wall[k] gives |num| > fl(|den|·t_reach), the
  // range test below that proves t out of range, for every ray. A NaN num
  // fails the test and the segment is tested ray by ray.
  unsigned segs_lo = 0, segs_hi = 0;  // bit k: segment k, n_seg <= 64
  for (int k = s; k < n_seg; k += kSensors) {
    const float num = (seg[4 * k] - xi) * seg[4 * k + 3] - (seg[4 * k + 1] - yi) * seg[4 * k + 2];
    if (!(fabsf(num) > s_wall[k])) (k < 32 ? segs_lo : segs_hi) |= 1u << (k % 32);
  }
  uint64_t segs = static_cast<uint64_t>(__reduce_or_sync(group, segs_hi)) << 32 |
                  __reduce_or_sync(group, segs_lo);
  // t and u are the two IEEE divisions of the plain version, taken where
  // they can decide a hit. Where |num| > fl(|den|·t_reach), the quotient
  // exceeds prox_range in magnitude even after its rounding, so t fails
  // 0 <= t <= prox_range and is not divided out; u is divided out only
  // where t passes.
  for (; segs != 0; segs &= segs - 1) {
    const int k = __ffsll(static_cast<long long>(segs)) - 1;
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
    ztilde[r] = 1.0f - 2.0f / (1.0f + expf(static_cast<float>(count)));
  else if (s == 5)
    attr_x[r] = a_x;
  else if (s == 6)
    attr_y[r] = a_y;
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
// prox_d2 and rab_d2: the skip thresholds (``pairwise.least_d2``), both
// positive. The grid's 2^31 - 1 blocks
// hold 2^36 robots, more than the card's memory.
int pairwise_sensors_wide_launch(const float* pos, const float* yaw, const float* consts,
                                 int n_seg, float* prox, float* ztilde, float* rab_proj,
                                 float* attr_x, float* attr_y, int E, int N,
                                 float prox_range, float prox_plus_r, float rab_range,
                                 float alpha, float prox_d2, float rab_d2, void* stream) {
  if (N < 1 || E < 1 || n_seg > kMaxSeg || n_seg < 0 || !(prox_d2 > 0.f) || !(rab_d2 > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(E) * ((N + kSensorRobots - 1) / kSensorRobots);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float t_reach = prox_range * (1.0f + 0x1p-20f);
  pairwise_sensors_wide_kernel<<<static_cast<unsigned>(blocks), kSensorRobots * kSensors, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      pos, yaw, consts, n_seg, prox, ztilde, rab_proj, attr_x, attr_y, N, prox_range,
      prox_plus_r, rab_range, alpha, prox_d2, rab_d2, t_reach);
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
