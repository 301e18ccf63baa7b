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
// robot_collisions_kernel: one thread a robot, a block holding whole arenas
// laid flat, as few as make whole warps (8 arenas, 160 threads, at N = 20),
// their positions staged in shared memory by 16-byte loads. Each thread runs
// one branch-free loop over all N neighbours, the same length in every lane,
// that marks the pairs that can touch; the square root and the divisions
// are taken only for those, in a second loop, since the push of any other
// pair is exactly zero (proved below). On the main path's spread robots
// that is nearly no pair. Each robot's result is one 8-byte store.
//
// Numerics: every formula mirrors the plain PyTorch version operation by
// operation (swarmacb_torch/env/sensors.py, physics.py), with the same
// epsilons, atan2 for the bearing, IEEE sqrt and division (no fast math) and
// FMA contraction off (-fmad=false), so that each product and sum rounds as
// PyTorch's separate operations do. Max-reductions (the prox readings) are
// order-free and come out equal; the sums over neighbours run in another
// order than PyTorch's reductions and may differ in the last bits.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 32;           // robots per arena
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

// Arenas per block of the collision pass: the fewest whole arenas whose
// robot count is a multiple of 32, lcm(N, 32) / N, so that every lane of
// every warp holds a robot (but in the last block of a ragged E).
inline int collision_arenas_per_block(int N) {
  int a = 32, b = N;
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return 32 / a;  // 32 / gcd(N, 32)
}

// Single Jacobi pass of elastic push-out (physics.resolve_robot_collisions).
// Thread i reads only pre-push positions and writes out of place:
//   out_i = (x_i + sum_{j>i} half(i, j)) - sum_{j<i} half(j, i),
//   half(a, b) = 0.5 * max(2r - d_ab, 0) * (x_a - x_b) / (d_ab + 1e-8),
//   d_ab = sqrt(|x_a - x_b|^2 + 1e-8).
// Thread i computes t = half(i, j) from dx = x_i - x_j and adds it to `own`
// where j > i, or takes it from `other` where j < i. Both give the bits of
// the two sums above: (-dx)^2 = dx^2, so d_ij = d_ji; negation is exact, so
// half(i, j) = -half(j, i) bit for bit; acc - (-h) = acc + h in IEEE
// arithmetic; and each sum still takes its terms in ascending j.
//
// Two loops. The first runs over all j = 0..N-1, the same trip count in
// every lane and no branch: it computes q = dx*dx + dy*dy + 1e-8 (rounded
// as above) and sets bit j of `near` for each pair that must be evaluated
// (bit i, set by the pair (i, i), is cleared after it).
// The second takes the bits of `near` from the lowest up, so in ascending
// j, and computes those pairs in full. A warp runs the second loop as often
// as its lane with the most such pairs: at most twice in an untrained
// rollout, ~6 times where all robots crowd at the gate. A single loop
// with the test inside would take the full path at every j where any
// lane has such a pair, which in that crowd is every j.
//
// The skip. Let m = fl32(2r) and skip_d2 the least float at or above m^2
// (computed exactly by the wrapper). A pair whose q has
// skip_d2 <= q <= FLT_MAX is not evaluated, nor is j = i. The test is one
// unsigned comparison of bit patterns: q is positive or NaN (a sum of
// squares and 1e-8), positive floats order as their bit patterns do, and
// bits(q) - bits(skip_d2) lies in [0, bits(FLT_MAX) - bits(skip_d2)] exactly
// where q does in [skip_d2, FLT_MAX] (below it the difference wraps; +inf
// and NaN of either sign lie above). For the skipped pairs:
//   - q >= skip_d2 >= m^2, so sqrt(q) >= m; sqrtf rounds correctly and
//     monotonically and m is a float, so d = sqrtf(q) >= m and m - d is +0
//     or negative (x - x is +0 in round-to-nearest), and the overlap
//     fmaxf(m - d, 0) is +0;
//   - q is finite, so dx and dy are, d + 1e-8 >= m > 0 and the normal
//     dx / (d + 1e-8) is finite: the term (+0 * n) * 0.5 is +0 or -0;
//   - an accumulator starts at +0 and is never -0 (in round-to-nearest a
//     sum is -0 only when both addends are, a difference x - y only when x
//     is -0 and y is +0), and adding or taking away a zero leaves such a
//     value as it was.
// So the skipped term changes no bit. A NaN q fails the test and takes the
// full path, where NaN propagates as in the plain version; so does an
// infinite q, where an infinite offset makes the normal inf / inf = NaN.
// The pair j = i has a zero term but for a robot off the finite plane,
// which is handled after the loops.
__global__ void __launch_bounds__(1024) robot_collisions_kernel(
    const float* __restrict__ pos, float* __restrict__ out, int E, int N,
    int A, float min_dist, float skip_d2) {
  __shared__ float2 s_p[1024];  // (x, y) of the block's robots
  const int a = threadIdx.x / N;  // arena within the block
  const int i = threadIdx.x - a * N;
  const int e0 = blockIdx.x * A;
  const int n_arenas = min(A, E - e0);
  // the block's robots are one contiguous run of float2 (pos is 8-byte
  // aligned, which the launcher checks), one coalesced load a thread
  const float2* src = reinterpret_cast<const float2*>(pos) + static_cast<size_t>(e0) * N;
  if (threadIdx.x < n_arenas * N) s_p[threadIdx.x] = src[threadIdx.x];
  __syncthreads();
  if (a >= n_arenas) return;  // the idle lanes of a ragged last block

  const float2* arena = s_p + a * N;
  const float2 pi = arena[i];
  const unsigned skip_bits = __float_as_uint(skip_d2);
  const unsigned skip_span = 0x7f7fffffu - skip_bits;  // up to FLT_MAX's bits
  unsigned near = 0;  // bit j: the pair (i, j) is evaluated
#pragma unroll 4
  for (int j = 0; j < N; ++j) {
    const float2 pj = arena[j];
    const float dx = pi.x - pj.x;
    const float dy = pi.y - pj.y;
    const float q = dx * dx + dy * dy + 1e-8f;
    if (__float_as_uint(q) - skip_bits > skip_span) near |= 1u << j;
  }
  near &= ~(1u << i);
  float hx_own = 0.f, hy_own = 0.f;      // pairs (i, j), j > i
  float hx_other = 0.f, hy_other = 0.f;  // pairs (j, i), j < i
  for (; near != 0; near &= near - 1) {
    const int j = __ffs(near) - 1;
    const float2 pj = arena[j];
    const float dx = pi.x - pj.x;
    const float dy = pi.y - pj.y;
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
  // The pair (i, i), which the plain version's dense matrix holds with a
  // zero weight: a zero term where x_i and y_i are finite, NaN in both
  // coordinates where either is not (x_i - x_i is NaN there).
  if (!(fabsf(pi.x) <= FLT_MAX && fabsf(pi.y) <= FLT_MAX)) hx_own = hy_own = NAN;
  reinterpret_cast<float2*>(out)[static_cast<size_t>(e0 + a) * N + i] =
      make_float2((pi.x + hx_own) - hx_other, (pi.y + hy_own) - hy_other);
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
                            float min_dist, float skip_d2, void* stream) {
  if (N > kMaxN || N < 1 || E < 1 ||
      reinterpret_cast<uintptr_t>(pos) % alignof(float2) != 0 ||
      reinterpret_cast<uintptr_t>(out) % alignof(float2) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int A = collision_arenas_per_block(N);
  robot_collisions_kernel<<<(E + A - 1) / A, A * N, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      pos, out, E, N, A, min_dist, skip_d2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
