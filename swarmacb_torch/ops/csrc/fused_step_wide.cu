// K4 at any robot count, for Hopper (sm_90a): the wide route of one whole
// env control tick, which ``ops/fused_step.py:route`` takes where an arena
// holds more robots than the tuned kernel of fused_step.cu takes (N > 32:
// its block holds every robot of its arenas at once, a thread each).
//
// Replaces (TPU kernel), at those robot counts:
//   fused_step_wide_kernel <- swarmacb_tpu/ops/fused_step.py: fused_env_step
//                             (Pallas body _step_kernel)
//
// The tick is the tuned kernel's, computed by its own device functions
// (the sensors' pieces, steer, avoidance, ground and the constants table,
// included from fused_step.cu below), and its layout: (N, Ep) tiles with
// Ep % 128 == 0, a block of 8 neighbouring arenas, lane = 8·(row mod 4) +
// arena, so the 8 lanes of a robot row read and write 32 contiguous bytes
// of each tile.
//
// What bounds it: at N = 64 each robot meets 63 others in the sensors and
// again in the push-out, and a thread that runs the full pair arithmetic
// for each (two square roots, three divisions, an rsqrt and the 8-ray cone
// test) is a serial chain of latency. Yet on spread poses only ~2 of 63
// pairs lie within the RAB range (0.2 m) and fewer within the proximity
// reach or touching, and a robot is within the proximity range of the
// lines of only a few wall segments. So:
//   - a block holds up to kMaxRows = 64 robot rows (512 threads), a thread
//     a robot where N <= 64 (rows of about N / passes past that, each
//     thread taking robots row, row + rows, ... in turn);
//   - each sum over neighbours runs two loops over each 32 of them: a
//     branch-free one that computes the pair's squared distance and marks
//     the pairs whose terms can count, then the marked ones, lowest first,
//     through the pair arithmetic of the parent form (the tuned kernel's
//     sensor_pair, its push-out loop), so the sums keep their index order;
//   - the walls: a segment whose hit distance exceeds the range for every
//     ray (|num| > s_wall[k], below) is passed over without a division.
// Every skip is exact: a skipped term is +0 or -0, or a reading that a max
// over non-negative readings ignores (the proofs are at each skip), so the
// outputs are the bits of the form that evaluates every pair and segment.
//
// A robot's values cannot wait in registers across the block barriers that
// separate the phases where a thread takes several robots, so the phases
// hand over through [robot][arena] buffers of the block and through the
// output tiles:
//   A  the pre-step positions into x0, y0;
//   B  [discrete] sensors on x0, y0, behaviours, machines and observation
//      tiles written; [both] integrate, wall push-out, gate clamp into
//      x1, y1; the new yaw (the spawn's where the arena resets) written;
//   C  robot push-out from x1, y1, the colour-transition term into rw, the
//      reset, positions and ground colour written; [continuous, with
//      observations] the post-reset positions into x0, y0;
//   D  [continuous, with observations] sensors on x0, y0, observation tiles
//      written; robot 0's lanes sum rw over the arena in index order and
//      write the arena's outputs.
// The five buffers take 5·8·N floats a block: in shared memory up to
// kMaxStaged = 256 robots (40 KB), past that in a global scratch that the
// launch allocates (160·N bytes for each block of 8 arenas). Nothing
// refuses an N >= 1.
//
// Numerics: the tuned kernel's, operation by operation (-fmad=false, IEEE
// sqrtf and division, no fast math); the reward terms are small integers,
// so their sum is exact in any order.

#include <float.h>

#include "fused_step.cu"

namespace {

constexpr int kMaxRows = 64;                    // robot rows a block
constexpr int kMaxThreads = kGroup * kMaxRows;  // 512
constexpr int kBuffers = 5;                     // x0, y0, x1, y1, rw
constexpr int kMaxStaged = 256;                 // robots a block's buffers hold in shared memory
constexpr int kChunk = 32;                      // neighbours a mask word
constexpr unsigned kFltMaxBits = 0x7f7fffffu;

// True where q is a float in [lo, FLT_MAX], lo > 0 given by its bits: one
// unsigned comparison. q is a sum of squares (and a positive epsilon), so
// it is +0, positive, +inf or NaN; positive floats order as their bit
// patterns do, and bits(q) - bits(lo) lies in [0, bits(FLT_MAX) - bits(lo)]
// exactly where q does in [lo, FLT_MAX]: below lo the difference wraps,
// and +inf and NaN of either sign lie above.
__device__ __forceinline__ bool finite_at_least(float q, unsigned lo_bits) {
  return __float_as_uint(q) - lo_bits <= kFltMaxBits - lo_bits;
}

// Bit k set where the pair (i, j0 + k), j0 + k < N, is to be evaluated:
// its q = (x_j - x_i)² + (y_j - y_i)² (+ 1e-8 with kEps), rounded as the
// pair's own arithmetic rounds it ((-a)² = a²), lies outside [lo, FLT_MAX].
// Robot j at s_x[j * kGroup]. One fully unrolled loop of kChunk, its loads
// at fixed offsets where the word is whole; in the last, partial word the
// index stops at N - 1 and the bits past N are cleared.
template <bool kEps>
__device__ __forceinline__ unsigned mark_pairs(const float* s_x, const float* s_y, int j0,
                                               int N, float xi, float yi, unsigned lo_bits) {
  unsigned mark = 0;
  if (j0 + kChunk <= N) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float dx = s_x[(j0 + k) * kGroup] - xi;
      const float dy = s_y[(j0 + k) * kGroup] - yi;
      const float q = kEps ? dx * dx + dy * dy + 1e-8f : dx * dx + dy * dy;
      if (!finite_at_least(q, lo_bits)) mark |= 1u << k;
    }
    return mark;
  }
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int j = min(j0 + k, N - 1);
    const float dx = s_x[j * kGroup] - xi;
    const float dy = s_y[j * kGroup] - yi;
    const float q = kEps ? dx * dx + dy * dy + 1e-8f : dx * dx + dy * dy;
    if (!finite_at_least(q, lo_bits)) mark |= 1u << k;
  }
  return mark & ((1u << (N - j0)) - 1);
}

// All sensors of robot i (fused_step.cu: sensor_block, from the same
// pieces: sensor_rays, sensor_pair, sensor_segment, sensor_finish), its
// pose (xi, yi, cy, sy) and its arena's positions in the block buffers,
// robot j at s_x[j * kGroup]; the same outputs, bit for bit, with the
// pairs and segments that cannot count passed over.
//
// The pairs. ``pair_d2`` is the least float q with both
// sqrtf(q + 1e-12) >= prox_plus_r and sqrtf(q + 1e-8) >= rab_range
// (``ops/fused_step.py:sensor_skip_d2``); the sum and sqrtf round
// monotonically, so a pair whose d2 = dx·dx + dy·dy lies in
// [pair_d2, FLT_MAX] fails the proximity test (dist_p >= prox_plus_r) and
// the RAB range (in_f = 0). Its proximity term is then no update, and each
// RAB term is (finite)·0: d2 finite makes dx, dy, dist_r, 1 / (dist_r +
// 1e-8), nr_rsqrt(d2 + 1e-12) and alpha / (1 + dist_r) finite, and with
// cy, sy finite so are the bearing's cosine and sine. A sum that starts at
// +0 is never -0 (in round-to-nearest a sum is -0 only when both addends
// are), and adding +0 or -0 leaves such a value as it was. The pair (i, i)
// has d2 = 0 and in_f = 0, and its term is +-0 where x_i, y_i, cy and sy
// are finite; elsewhere it is marked, and NaN reaches the sums as it does
// in the full form. A NaN or infinite d2 is always marked.
__device__ __forceinline__ void sensor_block_sparse(const Consts& c, const float* s_x,
                                                    const float* s_y,
                                                    const float* s_wall, int i, int N,
                                                    int n_seg, float xi, float yi, float cy,
                                                    float sy, unsigned pair_bits, Sensors& o) {
  float wdx[kSensors], wdy[kSensors];
  sensor_rays(c, cy, sy, wdx, wdy, o);
  const bool self_zero = fabsf(xi) <= FLT_MAX && fabsf(yi) <= FLT_MAX &&
                         fabsf(cy) <= FLT_MAX && fabsf(sy) <= FLT_MAX;

  // other robots: proximity cone test and range-and-bearing
  float count = 0.f, w_x = 0.f, w_y = 0.f, a_x = 0.f, a_y = 0.f;
  for (int j0 = 0; j0 < N; j0 += kChunk) {
    unsigned mark = mark_pairs<false>(s_x, s_y, j0, N, xi, yi, pair_bits);
    if (self_zero && i >= j0 && i < j0 + kChunk) mark &= ~(1u << (i - j0));
    for (; mark != 0; mark &= mark - 1) {
      const int j = j0 + __ffs(mark) - 1;
      sensor_pair(c, wdx, wdy, s_x[j * kGroup] - xi, s_y[j * kGroup] - yi, j != i, cy, sy, o,
                  count, w_x, w_y, a_x, a_y);
    }
  }

  // walls: 8 rays x the segments some ray can hit. s_wall[k] is
  // fl(fl(1.001·|s_k|)·t_reach), t_reach = prox_range·(1 + 2^-20). A ray
  // with |denom| <= 1e-8 cannot hit; for any other, |den| = |denom + 1e-12|
  // <= |s_k|·|w|·(1 + 2^-22)·(1 + 1e-4) <= 1.00011·|s_k| (|w| <= 1 + 2^-20,
  // the unit ray as rounded), so |num| > s_wall[k] gives |num| / |den| >
  // t_reach·(1 + 2^-12), and t = num·fl(1 / den), two roundings of 2^-24
  // each, exceeds prox_range in magnitude: t fails 0 <= t <= prox_range
  // for every ray, each reading is 0, and a max over readings >= +0 keeps
  // its value. A NaN num fails the test and the segment is evaluated.
  unsigned segs = 0;  // n_seg <= kMaxSeg = 32
  for (int k = 0; k < n_seg; ++k) {
    const float rel_x = c.seg[4 * k] - xi;
    const float rel_y = c.seg[4 * k + 1] - yi;
    const float num = rel_x * c.seg[4 * k + 3] - rel_y * c.seg[4 * k + 2];
    segs |= static_cast<unsigned>(!(fabsf(num) > s_wall[k])) << k;
  }
  for (; segs != 0; segs &= segs - 1) sensor_segment(c, wdx, wdy, __ffs(segs) - 1, xi, yi, o);

  sensor_finish(c, wdx, wdy, xi, yi, count, w_x, w_y, a_x, a_y, o);
}

// Robot i's observation tiles from its sensors (the tuned kernel's last
// stores): ztilde, and for 24-dim variants the prox, light and RAB rows.
__device__ void write_obs(const Consts& c, const Ptrs& P, const Flags& F, const Sensors& sb,
                          int i, size_t r, int e) {
  const size_t Ep = F.Ep;
  st_<float>(P, kZt, r, sb.ztilde);
  if (!F.obs24) return;
#pragma unroll
  for (int s = 0; s < kSensors; ++s) {
    const size_t row = static_cast<size_t>(s * F.N + i) * Ep + e;
    st_<float>(P, kPv, row, sb.prox[s]);
    st_<float>(P, kLv, row, sb.light[s]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    st_<float>(P, kRp, static_cast<size_t>(k * F.N + i) * Ep + e,
               sb.w_x * c.rab_cos[k] + sb.w_y * c.rab_sin[k]);
}

// blockDim.x = kGroup * rows (rows % 4 == 0, rows <= kMaxRows): robot rows
// row, row + rows, ... of the block's 8 arenas. pair_d2 and touch_d2 are
// the sensors' and the push-out's skip thresholds, t_reach the walls'. Two
// blocks an SM (64 registers a thread): at E = 32768 that was faster than
// one block of 86 registers with no spill, 0.43 against 0.60 ms.
__global__ void __launch_bounds__(kMaxThreads, 2)
fused_step_wide_kernel(const __grid_constant__ Consts c, const __grid_constant__ Ptrs P,
                       const Flags F, float* __restrict__ scratch, float pair_d2,
                       float touch_d2, float t_reach) {
  extern __shared__ float s_buf[];
  __shared__ float s_wall[kMaxSeg];
  const int N = F.N;
  const int rows = blockDim.x / kGroup;
  const size_t span = static_cast<size_t>(N) * kGroup;  // one [robot][arena] buffer
  float* const buf = scratch != nullptr ? scratch + blockIdx.x * kBuffers * span : s_buf;
  float* const x0 = buf;
  float* const y0 = buf + span;
  float* const x1 = buf + 2 * span;
  float* const y1 = buf + 3 * span;
  float* const rw = buf + 4 * span;

  const int lane = threadIdx.x % 32;
  const int a = lane % kGroup;                                  // arena in the block
  const int row = (threadIdx.x / 32) * kRows + lane / kGroup;   // first robot
  const int e = blockIdx.x * kGroup + a;  // < Ep: the grid is Ep / kGroup blocks
  const size_t Ep = F.Ep;
  const unsigned pair_bits = __float_as_uint(pair_d2);
  const unsigned touch_bits = __float_as_uint(touch_d2);
  int sc = ld<int>(P, kSc, e) + 1;
  const bool done = sc >= F.max_episode_length - 1;

  // A: the pre-step positions; each segment's reach (sensor_block_sparse)
  for (int k = threadIdx.x; k < F.n_seg; k += blockDim.x) {
    const float sx_s = c.seg[4 * k + 2], sy_s = c.seg[4 * k + 3];
    s_wall[k] = (sqrtf(sx_s * sx_s + sy_s * sy_s) * 1.001f) * t_reach;
  }
  for (int i = row; i < N; i += rows) {
    const size_t r = static_cast<size_t>(i) * Ep + e;
    x0[i * kGroup + a] = ld<float>(P, kPx, r);
    y0[i * kGroup + a] = ld<float>(P, kPy, r);
  }
  __syncthreads();

  // B: sensors and behaviours (discrete), integration, walls, gate
  for (int i = row; i < N; i += rows) {
    const size_t r = static_cast<size_t>(i) * Ep + e;
    const float px = x0[i * kGroup + a], py = y0[i * kGroup + a];
    const float yaw = ld<float>(P, kYaw, r);
    const float cy = cosf(yaw);
    const float sy = sinf(yaw);
    float left, right;
    if (F.discrete) {
      Sensors sb;
      sensor_block_sparse(c, x0 + a, y0 + a, s_wall, i, N, F.n_seg, px, py, cy, sy,
                          pair_bits, sb);
      const int mod = ld<int>(P, kMod, r);
      int es = ld<int>(P, kEs, r), ek = ld<int>(P, kEk, r);
      float ed = ld<float>(P, kEd, r);
      int pa = ld<int>(P, kPa, r), pk = ld<int>(P, kPk, r);
      float pd = ld<float>(P, kPd, r);
      int aa = ld<int>(P, kAa, r), ak = ld<int>(P, kAk, r);
      float ad = ld<float>(P, kAd, r);
      const int de = ld<int>(P, kDe, r), dp = ld<int>(P, kDp, r), da = ld<int>(P, kDa, r);
      const float ms = c.max_speed;

      const bool in_front = sb.psum_x * 16777216.0f > -fabsf(sb.psum_y);
      const bool obstacle = (sb.pval >= c.prox_threshold) && in_front;
      const float turn = sb.psum_y < 0.f ? -1.f : 1.f;

      // exploration machine: trigger first, THEN decrement
      const bool active0 = mod == 0;
      if (es == 0 && active0 && obstacle) {
        ed = turn;
        ek = de;
        es = 1;
      }
      const bool avoiding0 = (es == 1) && active0;
      if (avoiding0) ek = ek - 1;
      if (avoiding0 && ek <= 0) es = 0;
      const bool is_avoid0 = (es == 1) && active0;
      const float lv0 = is_avoid0 ? ed * ms : ms;
      const float rv0 = is_avoid0 ? (-ed) * ms : ms;

      const bool p_turn = avoidance(pa, pk, pd, mod == 2, dp, obstacle, turn);
      const bool a_turn = avoidance(aa, ak, ad, mod == 3, da, obstacle, turn);

      float l, rr;
      left = right = 0.f;
      switch (mod) {
        case 0: left = lv0; right = rv0; break;
        case 2:
          steer(sb.lvx - 0.5f * sb.pvx, sb.lvy - 0.5f * sb.pvy, ms, l, rr);
          left = p_turn ? pd * ms : l;
          right = p_turn ? (-pd) * ms : rr;
          break;
        case 3:
          steer((-sb.lvx) - 0.5f * sb.pvx, (-sb.lvy) - 0.5f * sb.pvy, ms, l, rr);
          left = a_turn ? ad * ms : l;
          right = a_turn ? (-ad) * ms : rr;
          break;
        case 4:
          steer(sb.rab_x - 0.6f * sb.pvx, sb.rab_y - 0.6f * sb.pvy, ms, left, right);
          break;
        case 5:
          steer((-c.alpha) * sb.rab_x - 0.5f * sb.pvx,
                (-c.alpha) * sb.rab_y - 0.5f * sb.pvy, ms, left, right);
          break;
        default: break;  // Stop, or an id out of range
      }
      if (done) {
        es = ek = pa = pk = aa = ak = 0;
        ed = pd = ad = 0.f;
      }
      st_<int>(P, kOEs, r, es);
      st_<int>(P, kOEk, r, ek);
      st_<float>(P, kOEd, r, ed);
      st_<int>(P, kOPa, r, pa);
      st_<int>(P, kOPk, r, pk);
      st_<float>(P, kOPd, r, pd);
      st_<int>(P, kOAa, r, aa);
      st_<int>(P, kOAk, r, ak);
      st_<float>(P, kOAd, r, ad);
      if (F.want_obs) write_obs(c, P, F, sb, i, r, e);
    } else {
      left = ld<float>(P, kLeft, r);
      right = ld<float>(P, kRight, r);
    }

    // differential drive + branchless yaw wrap
    const float v = 0.5f * (left + right);
    float npx = px + v * cy * c.dt;
    float npy = py + v * sy * c.dt;
    float nyaw = yaw + (right - left) * c.dt_wb;
    if (nyaw > kPi) nyaw = nyaw - kTwoPi;
    if (nyaw < -kPi) nyaw = nyaw + kTwoPi;

    // wall push-out, summed over the faces
    float push_x = 0.f, push_y = 0.f;
    for (int f = 0; f < F.n_face; ++f) {
      const float fnx = c.face[4 * f], fny = c.face[4 * f + 1];
      const float fpx = c.face[4 * f + 2], fpy = c.face[4 * f + 3];
      const float pen = fmaxf(c.robot_radius - ((npx - fpx) * fnx + (npy - fpy) * fny), 0.f);
      push_x = push_x + pen * fnx;
      push_y = push_y + pen * fny;
    }
    npx = npx + push_x;
    npy = npy + push_y;

    // gate side-wall clamp (left first, right reads the updated x)
    const bool in_wall_y = (npy > c.gate_south) && (npy < c.wall_top);
    const float dx_l = npx + c.gate_hw;
    if ((c.robot_radius - fabsf(dx_l) > 0.f) && in_wall_y && (npx < 0.f))
      npx = (-c.gate_hw) + (dx_l > 0.f ? 1.f : -1.f) * c.robot_radius;
    const float dx_r = npx - c.gate_hw;
    if ((c.robot_radius - fabsf(dx_r) > 0.f) && in_wall_y && (npx > 0.f))
      npx = c.gate_hw + (dx_r < 0.f ? -1.f : 1.f) * c.robot_radius;

    x1[i * kGroup + a] = npx;
    y1[i * kGroup + a] = npy;
    st_<float>(P, kOYaw, r, done ? ld<float>(P, kSw, r) : nyaw);
  }
  __syncthreads();

  // C: robot push-out (one Jacobi pass from the clamped positions), the
  // reward term, the reset. ``touch_d2`` is the least float at or above
  // fl32(2r)² (``pairwise.collision_skip_d2``): a pair whose q = cdx² +
  // cdy² + 1e-8 lies in [touch_d2, FLT_MAX] has cdist = sqrtf(q) >= 2r, an
  // overlap of +0, a finite cdx and 1 / (cdist + 1e-8), so each of its
  // terms is +-0 and leaves the sums (which start at +0) as they were, as
  // at robot_collisions_kernel in pairwise.cu. (-cdx)² = cdx², so the mark
  // takes x_j - x_i for every j.
  const float* arena_x = x1 + a;  // robot j at arena_x[j * kGroup]
  const float* arena_y = y1 + a;
  for (int i = row; i < N; i += rows) {
    const size_t r = static_cast<size_t>(i) * Ep + e;
    float npx = arena_x[i * kGroup], npy = arena_y[i * kGroup];
    float own_x = 0.f, own_y = 0.f, oth_x = 0.f, oth_y = 0.f;
    for (int j0 = 0; j0 < N; j0 += kChunk) {
      unsigned mark = mark_pairs<true>(arena_x, arena_y, j0, N, npx, npy, touch_bits);
      if (i >= j0 && i < j0 + kChunk) mark &= ~(1u << (i - j0));  // the pair (i, i)
      for (; mark != 0; mark &= mark - 1) {
        const int j = j0 + __ffs(mark) - 1;
        const int lo = j > i ? i : j;  // the pair (lo, hi), lo < hi
        const int hi = j > i ? j : i;
        const float cdx = arena_x[lo * kGroup] - arena_x[hi * kGroup];
        const float cdy = arena_y[lo * kGroup] - arena_y[hi * kGroup];
        const float cdist = sqrtf(cdx * cdx + cdy * cdy + 1e-8f);
        const float overlap = fmaxf(c.two_r - cdist, 0.f);
        const float cinv = 1.0f / (cdist + 1e-8f);
        const float hx = overlap * cdx * cinv * 0.5f;
        const float hy = overlap * cdy * cinv * 0.5f;
        if (j > i) {
          own_x += hx;
          own_y += hy;
        } else {
          oth_x += hx;
          oth_y += hy;
        }
      }
    }
    npx = npx + own_x - oth_x;
    npy = npy + own_y - oth_y;

    const float prev = ld<float>(P, kPrev, r);
    const float curr = ground(c, npx, npy);
    rw[i * kGroup + a] = ((prev < 0.25f && curr > 0.75f) ? 1.f : 0.f) -
                         ((prev > 0.75f && curr < 0.25f) ? 1.f : 0.f);
    if (done) {
      npx = ld<float>(P, kSx, r);
      npy = ld<float>(P, kSy, r);
    }
    st_<float>(P, kOPx, r, npx);
    st_<float>(P, kOPy, r, npy);
    st_<float>(P, kOPrev, r, ground(c, npx, npy));
    if (!F.discrete && F.want_obs) {  // every read of x0, y0 ended in B
      x0[i * kGroup + a] = npx;
      y0[i * kGroup + a] = npy;
    }
  }
  __syncthreads();

  // D: fresh observations from the post-reset poses (continuous)
  if (!F.discrete && F.want_obs) {
    for (int i = row; i < N; i += rows) {
      const size_t r = static_cast<size_t>(i) * Ep + e;
      const float nyaw = ld<float>(P, kOYaw, r);  // this thread's own store in B
      Sensors sb;
      sensor_block_sparse(c, x0 + a, y0 + a, s_wall, i, N, F.n_seg, x0[i * kGroup + a],
                          y0[i * kGroup + a], cosf(nyaw), sinf(nyaw), pair_bits, sb);
      write_obs(c, P, F, sb, i, r, e);
    }
  }
  if (row == 0) {  // the arena's outputs, once
    float rew = 0.f;
    for (int j = 0; j < N; ++j) rew += rw[j * kGroup + a];
    float er = ld<float>(P, kEr, e) + rew;
    float cg = ld<float>(P, kCg, e);
    if (done) {
      cg = er;
      er = 0.f;
      sc = 0;
    }
    st_<int>(P, kOSc, e, sc);
    st_<float>(P, kOEr, e, er);
    st_<float>(P, kOCg, e, cg);
    st_<float>(P, kReward, e, rew);
    st_<int>(P, kDone, e, done ? 1 : 0);
  }
}

}  // namespace

extern "C" {

// As fused_step_launch, with the skip thresholds (``sensor_skip_d2``,
// ``collision_skip_d2``, both positive). A block takes the fewest passes
// of at most kMaxRows robot rows, the rows as even as whole warps allow.
// Past kMaxStaged robots the launch takes the block buffers' global
// scratch from the stream's pool and hands it back after the kernel, both
// in stream order.
int fused_step_wide_launch(void* const* ptrs, const float* consts, int n_consts, int n_seg,
                           int n_face, int Ep, int N, int discrete, int obs24, int want_obs,
                           int max_episode_length, float pair_d2, float touch_d2,
                           void* stream) {
  if (n_consts * sizeof(float) != sizeof(Consts) || N < 1 || n_seg > kMaxSeg ||
      n_face > kMaxFace || Ep < 1 || Ep % kGroup || !(pair_d2 > 0.f) || !(touch_d2 > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const int passes = (N + kMaxRows - 1) / kMaxRows;
  const int rows = ((N + passes - 1) / passes + kRows - 1) / kRows * kRows;
  Consts c;
  memcpy(&c, consts, sizeof(Consts));
  Ptrs P;
  for (int k = 0; k < kNumSlots; ++k) P.p[k] = ptrs[k];
  const Flags F{Ep, N, n_seg, n_face, discrete, obs24, want_obs, max_episode_length};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t buffers = static_cast<size_t>(kBuffers) * kGroup * N * sizeof(float);
  float* scratch = nullptr;
  if (N > kMaxStaged) {
    const cudaError_t err = cudaMallocAsync(reinterpret_cast<void**>(&scratch),
                                            buffers * (Ep / kGroup), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float t_reach = c.prox_range * (1.0f + 0x1p-20f);
  fused_step_wide_kernel<<<Ep / kGroup, kGroup * rows, scratch ? 0 : buffers, s>>>(
      c, P, F, scratch, pair_d2, touch_d2, t_reach);
  const cudaError_t err = cudaGetLastError();
  if (scratch != nullptr) cudaFreeAsync(scratch, s);
  return static_cast<int>(err);
}

}  // extern "C"
