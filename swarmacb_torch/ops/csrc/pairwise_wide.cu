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
// memory was slower for both kernels); nothing refuses an N >= 1.
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
// robot_collisions_wide_kernel: one thread a robot. Where an arena fits a
// block (N <= kCollisionRobots), a block takes the most whole arenas it
// holds, kCollisionRobots / N, so that few lanes idle (the tuned kernel's
// idea; at N = 64, E = 1024 that is 512 blocks of 128 threads); past that,
// the arena's robots span ceil(N / kCollisionRobots) blocks, side by side in
// a one-dimensional grid. On spread poses about 0.2 of a robot's 63
// neighbours touch it, so each word of 32 neighbours takes two loops, as in
// the tuned kernel: a fully unrolled one that marks the pairs that can
// touch by one comparison of bit patterns, then the marked pairs, lowest
// first, through the pair's full arithmetic; each sum keeps its terms in
// ascending j, and the skip is exact (the proof is at the kernel), so the
// outputs are the bits of the form that evaluates every pair. Where every
// pair touches (robots packed in a crowd) the marks are overhead on the
// full arithmetic, and such inputs run slower than that form (PERF.md §6).
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
constexpr int kCollisionRobots = 128;  // robots a block of the push-out
constexpr int kWord = 32;             // neighbours a mark word of the push-out
constexpr unsigned kFltMaxBits = 0x7f7fffffu;
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

// True where q is a float in [lo, FLT_MAX], lo > 0 given by its bits: one
// unsigned comparison. q is a sum of squares and 1e-8, so it is positive,
// +inf or NaN; positive floats order as their bit patterns do, and
// bits(q) - bits(lo) lies in [0, bits(FLT_MAX) - bits(lo)] exactly where q
// does in [lo, FLT_MAX]: below lo the difference wraps, and +inf and NaN of
// either sign lie above.
__device__ __forceinline__ bool finite_at_least(float q, unsigned lo_bits) {
  return __float_as_uint(q) - lo_bits <= kFltMaxBits - lo_bits;
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
// arithmetic; and each sum takes its terms in ascending j, since the words
// and the marked pairs within a word go in ascending j.
//
// The skip. Let m = fl32(2r) (min_dist) and skip_d2 the least float at or
// above m^2 (``pairwise.collision_skip_d2``, exact). For each word of 32
// neighbours, a fully unrolled loop computes q = dx*dx + dy*dy + 1e-8,
// rounded as the pair's full arithmetic rounds it (-fmad=false), and marks
// the pair unless skip_d2 <= q <= FLT_MAX (``finite_at_least``); the pair
// (i, i) is not marked; then the marked pairs, lowest first, take the full
// path. For an unmarked pair j != i:
//   - q >= skip_d2 >= m^2, so sqrt(q) >= m; sqrtf rounds correctly and
//     monotonically and m is a float, so dist = sqrtf(q) >= m and m - dist
//     is +0 or negative (x - x is +0 in round-to-nearest), and the overlap
//     fmaxf(m - dist, 0) is +0;
//   - q is finite, so dx and dy are, dist + 1e-8 >= m > 0 and the normal
//     dx / (dist + 1e-8) is finite: the term (+0 * n) * 0.5 is +0 or -0;
//   - an accumulator starts at +0 and is never -0 (in round-to-nearest a
//     sum is -0 only when both addends are, a difference x - y only when x
//     is -0 and y is +0), and adding or taking away a zero leaves such a
//     value as it was.
// So the skipped term changes no bit. A NaN q fails the test and is marked,
// and NaN propagates through the full path as in the plain version; so
// does an infinite q, where an infinite offset makes the normal inf / inf =
// NaN. The pair (i, i), which the plain version's dense matrix holds with a
// zero weight, gives a zero term where x_i and y_i are finite, NaN in both
// coordinates where either is not (x_i - x_i is NaN there): handled after
// the loops, as it is in the form that evaluates every pair.
//
// blockDim.x: the block's robots rounded up to whole warps (where arenas
// fit a block: A = kCollisionRobots / N arenas; else kCollisionRobots
// robots of one arena). pos and out are 8-byte aligned (the launch checks),
// so that each robot is one float2 load.
__global__ void __launch_bounds__(kCollisionRobots) robot_collisions_wide_kernel(
    const float* __restrict__ pos, float* __restrict__ out, int E, int N, float min_dist,
    float skip_d2) {
  // the block's robots: whole arenas e0 .. e0 + A - 1 (robot i of arena
  // e0 + a), or robots i0 .. i0 + kCollisionRobots - 1 of one arena e0
  const bool whole = N <= kCollisionRobots;
  const int A = whole ? kCollisionRobots / N : 1;
  const int spans = whole ? 1 : (N + kCollisionRobots - 1) / kCollisionRobots;
  const long long e0 = static_cast<long long>(blockIdx.x / spans) * A;
  const int a = whole ? threadIdx.x / N : 0;
  const int i = whole ? threadIdx.x - a * N : (blockIdx.x % spans) * kCollisionRobots + threadIdx.x;
  if (!(a < A && e0 + a < E && i < N)) return;  // a lane past the block's robots
  const float2* arena = reinterpret_cast<const float2*>(pos) + (e0 + a) * N;
  const float2 pi = arena[i];
  const unsigned skip_bits = __float_as_uint(skip_d2);
  float2 own = make_float2(0.f, 0.f);    // pairs (i, j), j > i
  float2 other = make_float2(0.f, 0.f);  // pairs (j, i), j < i
  for (int j0 = 0; j0 < N; j0 += kWord) {
    unsigned mark = 0;  // bit k: the pair (i, j0 + k) can touch
    if (j0 + kWord <= N) {
#pragma unroll
      for (int k = 0; k < kWord; ++k) {
        const float2 pj = arena[j0 + k];
        const float dx = pi.x - pj.x;
        const float dy = pi.y - pj.y;
        const float q = dx * dx + dy * dy + 1e-8f;
        if (!finite_at_least(q, skip_bits)) mark |= 1u << k;
      }
    } else {  // the arena's last, partial word: past N, robot N - 1, masked off
#pragma unroll
      for (int k = 0; k < kWord; ++k) {
        const float2 pj = arena[min(j0 + k, N - 1)];
        const float dx = pi.x - pj.x;
        const float dy = pi.y - pj.y;
        const float q = dx * dx + dy * dy + 1e-8f;
        if (!finite_at_least(q, skip_bits)) mark |= 1u << k;
      }
      mark &= (1u << (N - j0)) - 1;
    }
    if (i >= j0 && i < j0 + kWord) mark &= ~(1u << (i - j0));  // the pair (i, i)
    for (; mark != 0; mark &= mark - 1) {
      const int j = j0 + __ffs(mark) - 1;
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
        own.x += tx;
        own.y += ty;
      } else {
        other.x -= tx;
        other.y -= ty;
      }
    }
  }
  if (!(fabsf(pi.x) <= FLT_MAX && fabsf(pi.y) <= FLT_MAX)) own.x = own.y = NAN;
  reinterpret_cast<float2*>(out)[(e0 + a) * N + i] =
      make_float2((pi.x + own.x) - other.x, (pi.y + own.y) - other.y);
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

// skip_d2: ``pairwise.collision_skip_d2(robot_radius)``, positive. Where
// arenas fit a block, ceil(E / A) blocks of A arenas; else
// ceil(N / kCollisionRobots) blocks an arena.
int robot_collisions_wide_launch(const float* pos, float* out, int E, int N, float min_dist,
                                 float skip_d2, void* stream) {
  if (N < 1 || E < 1 || !(skip_d2 > 0.f) ||
      reinterpret_cast<uintptr_t>(pos) % alignof(float2) != 0 ||
      reinterpret_cast<uintptr_t>(out) % alignof(float2) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool whole = N <= kCollisionRobots;
  const int A = whole ? kCollisionRobots / N : 1;
  const long long blocks = whole ? (static_cast<long long>(E) + A - 1) / A
                                 : static_cast<long long>(E) *
                                       ((N + kCollisionRobots - 1) / kCollisionRobots);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = whole ? (A * N + 31) / 32 * 32 : kCollisionRobots;
  robot_collisions_wide_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(pos, out, E, N, min_dist,
                                                                      skip_d2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
