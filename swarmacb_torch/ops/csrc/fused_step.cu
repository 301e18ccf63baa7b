// K4: one whole env control tick of the Directional Gate, for Hopper (sm_90a).
//
// Replaces (TPU kernel):
//   fused_step_kernel <- swarmacb_tpu/ops/fused_step.py: fused_env_step
//                        (Pallas body _step_kernel)
//
// Per arena: [discrete] sensors on the pre-step poses, the six behaviour
// modules and three avoidance state machines; [both] differential drive and
// the branchless yaw wrap, wall push-out, gate clamp, one Jacobi pass of
// robot push-out, colour-transition reward, time-limit done and the folded
// auto-reset from pre-drawn spawns; [continuous] sensors on the post-reset
// poses; then the observation tiles. The plain version is
// swarmacb_torch/ops/fused_step.py:fused_env_step_plain, and this file
// follows it operation by operation.
//
// What bounds it on the H100: neither bytes nor arithmetic at the main
// path's E = 1024 arenas of N = 20 robots (~4.5 MB with observations and
// ~0.1 GFLOP a step, a few microseconds of the card at its peaks), where
// the launch and each thread's serial loops over the other robots, the 8
// sensors and the wall segments set the time. At bench.py's E = 32768 the
// same step moves ~144 MB and does ~3.2 GFLOP, and then how the lanes and
// the tile rows meet decides it. The design keeps the whole tick in one
// launch with nothing staged through device memory between its phases, one
// thread per robot, and puts neighbouring arenas on neighbouring lanes, the
// TPU kernel's arenas-on-lanes put onto warps: a warp is 8 arenas × 4
// robots, lane = 8·(i mod 4) + a, so the 8 lanes of one robot row read and
// write 32 contiguous bytes of each (rows, Ep) tile, a whole sector. A
// block is 8 arenas × N robots (N rounded up to whole warps: 5 full warps
// at N = 20), so no lane idles where 4 | N, and Ep % 128 == 0 means no
// block straddles the end. (A form with 32 arenas a warp row, whole
// 128-byte lines in a block of N warps held to 64 registers a thread, was
// slower at E = 1024, where it fills a quarter as many SMs, and at
// E = 32768.) The block's poses sit in shared memory as [robot][arena],
// read conflict-free, behind block barriers; the team reward is summed
// through shared memory over the arena's robots in index order (integer
// counts, exact in float32), and the per-arena outputs are written by
// robot 0's lanes.
//
// Why not one shared header with pairwise.cu: the formulae differ in each
// place they overlap. K4 tests the proximity cone as dot > 0.9659 * (d +
// 1e-8) (K1: dot / (d + 1e-8) > 0.9659), intersects the walls with a
// reciprocal of the denominator (K1: two divisions), and takes the RAB
// bearing's cosine and sine by rsqrt (K1: atan2), each as its own TPU kernel
// did. The build hashes each source alone, so a header would also go unseen.
//
// Numerics: IEEE sqrtf and division, rsqrtf as torch.rsqrt takes it on the
// card, cosf/sinf/expf from libdevice as PyTorch does, FMA contraction off
// (-fmad=false) and no fast math, so each product and sum rounds as the
// plain version's separate operations do. Sums over the 8 sensors are left
// folds in sensor order in both. The sums over the other robots (RAB
// vectors, push-outs) run in index order here and in PyTorch's reduction
// order there, and may differ in the last bits.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kMaxN = 32;  // robots per arena
constexpr int kGroup = 8;  // arenas a warp row
constexpr int kRows = 32 / kGroup;  // robot rows a warp
constexpr int kMaxSeg = 32;
constexpr int kMaxFace = 16;
constexpr int kSensors = 8;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// The constants table (ops/fused_step.py: Constants.table), float32.
struct Consts {
  float dt, dt_wb, max_speed, alpha, prox_threshold, prox_range, prox_plus_r,
      inv_range, robot_radius, two_r, rab_range, light_threshold, light_x,
      light_y, gate_hw, gate_south, wall_top, ni, corr_south, corr_hw,
      gate_zone_hw;
  float cos_a[kSensors], sin_a[kSensors], rab_cos[4], rab_sin[4];
  float seg[4 * kMaxSeg];    // (ax, ay, bx - ax, by - ay)
  float face[4 * kMaxFace];  // (nx, ny, px, py)
};

// Pointer slots (ops/fused_step.py: IN_SLOTS then OUT_SLOTS).
enum Slot {
  kPx, kPy, kYaw, kPrev, kMod, kEs, kEk, kEd, kPa, kPk, kPd, kAa, kAk, kAd,
  kDe, kDp, kDa, kLeft, kRight, kSx, kSy, kSw, kSc, kEr, kCg,
  kOPx, kOPy, kOYaw, kOPrev, kOEs, kOEk, kOEd, kOPa, kOPk, kOPd, kOAa, kOAk,
  kOAd, kOSc, kOEr, kOCg, kReward, kDone, kPv, kLv, kZt, kRp, kNumSlots
};

struct Ptrs {
  void* p[kNumSlots];
};

struct Flags {
  int Ep, N, n_seg, n_face, discrete, obs24, want_obs, max_episode_length;
};

__device__ __forceinline__ float nr_rsqrt(float x) {
  const float r0 = rsqrtf(x);
  return r0 * (1.5f - 0.5f * x * r0 * r0);
}

struct Sensors {
  float prox[kSensors], light[kSensors];
  float psum_x, psum_y, pval, pvx, pvy, lvx, lvy, ztilde, w_x, w_y, rab_x, rab_y;
};

// The pieces of sensor_block, each inlined where it is used: the tuned
// form below runs them over every pair and segment, fused_step_wide.cu's
// sensor_block_sparse over those that can count.

// The 8 ray directions of heading (cy, sy); every reading starts at 0.
__device__ __forceinline__ void sensor_rays(const Consts& c, float cy, float sy, float* wdx,
                                            float* wdy, Sensors& o) {
#pragma unroll
  for (int s = 0; s < kSensors; ++s) {
    wdx[s] = c.cos_a[s] * cy - c.sin_a[s] * sy;
    wdy[s] = c.cos_a[s] * sy + c.sin_a[s] * cy;
    o.prox[s] = 0.f;
  }
}

// The pair (i, j), offset (dx, dy) = robot j's position less robot i's,
// ``other`` = (j != i): its proximity cone test into o.prox and its RAB
// terms into the range count and the four sums.
__device__ __forceinline__ void sensor_pair(const Consts& c, const float* wdx, const float* wdy,
                                            float dx, float dy, bool other, float cy, float sy,
                                            Sensors& o, float& count, float& w_x, float& w_y,
                                            float& a_x, float& a_y) {
  const float d2 = dx * dx + dy * dy;

  const float dist_p = sqrtf(d2 + 1e-12f);
  const bool base = (dist_p < c.prox_plus_r) && !(dist_p < 1e-4f);
  const float reading_val = fminf(fmaxf(1.0f - dist_p / c.prox_plus_r, 0.f), 1.f);
  const float cone_rhs = 0.9659f * (dist_p + 1e-8f);
#pragma unroll
  for (int s = 0; s < kSensors; ++s) {
    const float dot = wdx[s] * dx + wdy[s] * dy;
    if (base && dot > cone_rhs) o.prox[s] = fmaxf(o.prox[s], reading_val);
  }

  const float dist_r = sqrtf(d2 + 1e-8f);
  const float in_f = (dist_r < c.rab_range && other) ? 1.f : 0.f;
  count += in_f;
  const float inv_dist = 1.0f / (dist_r + 1e-8f);
  const float body_x = dx * cy + dy * sy;
  const float body_y = (-dx) * sy + dy * cy;
  const float inv_hyp = nr_rsqrt(d2 + 1e-12f);
  const float cos_b = body_x * inv_hyp;
  const float sin_b = body_y * inv_hyp;
  w_x += inv_dist * cos_b * in_f;
  w_y += inv_dist * sin_b * in_f;
  const float alpha_w = c.alpha / (1.0f + dist_r);
  a_x += alpha_w * cos_b * in_f;
  a_y += alpha_w * sin_b * in_f;
}

// Wall segment k against the 8 rays from (xi, yi), into o.prox.
__device__ __forceinline__ void sensor_segment(const Consts& c, const float* wdx,
                                               const float* wdy, int k, float xi, float yi,
                                               Sensors& o) {
  const float ax = c.seg[4 * k], ay = c.seg[4 * k + 1];
  const float sx_s = c.seg[4 * k + 2], sy_s = c.seg[4 * k + 3];
  const float rel_x = ax - xi;
  const float rel_y = ay - yi;
#pragma unroll
  for (int s = 0; s < kSensors; ++s) {
    const float denom = wdx[s] * sy_s - wdy[s] * sx_s;
    const bool valid = fabsf(denom) > 1e-8f;
    const float inv_denom = 1.0f / (denom + 1e-12f);
    const float t = (rel_x * sy_s - rel_y * sx_s) * inv_denom;
    const float u = (rel_x * wdy[s] - rel_y * wdx[s]) * inv_denom;
    const bool hit = valid && t >= 0.f && t <= c.prox_range && u >= 0.f && u <= 1.f;
    const float w_read = hit ? 1.0f - t * c.inv_range : 0.f;
    o.prox[s] = fmaxf(o.prox[s], w_read);
  }
}

// The light sensor from (xi, yi), the aggregates of the readings and the
// RAB outputs from the pair sums.
__device__ __forceinline__ void sensor_finish(const Consts& c, const float* wdx,
                                              const float* wdy, float xi, float yi, float count,
                                              float w_x, float w_y, float a_x, float a_y,
                                              Sensors& o) {
  // light
  const float lxr = c.light_x - xi;
  const float lyr = c.light_y - yi;
  const float ldist = sqrtf(lxr * lxr + lyr * lyr + 1e-6f);
  const float lint = 1.0f / ldist;
  const float lnx = lxr / (ldist + 1e-8f);
  const float lny = lyr / (ldist + 1e-8f);
#pragma unroll
  for (int s = 0; s < kSensors; ++s) {
    const float ldot = fmaxf(wdx[s] * lnx + wdy[s] * lny, 0.f);
    o.light[s] = fminf(fmaxf(lint * ldot, 0.f), 1.f);
  }

  // aggregates: left folds in sensor order, as Python's sum starts at 0
  float psx = 0.f, psy = 0.f, lsx = 0.f, lsy = 0.f, lmax = o.light[0];
#pragma unroll
  for (int s = 0; s < kSensors; ++s) {
    psx = psx + o.prox[s] * c.cos_a[s];
    psy = psy + o.prox[s] * c.sin_a[s];
    lsx = lsx + o.light[s] * c.cos_a[s];
    lsy = lsy + o.light[s] * c.sin_a[s];
    if (s > 0) lmax = fmaxf(lmax, o.light[s]);
  }
  const float phyp2 = psx * psx + psy * psy;
  const float pinv = nr_rsqrt(phyp2 + 1e-12f);
  const float pval = fminf(phyp2 * pinv, 1.0f);
  o.psum_x = psx;
  o.psum_y = psy;
  o.pval = pval;
  o.pvx = pval * psx * pinv;
  o.pvy = pval * psy * pinv;
  const float linv = nr_rsqrt(lsx * lsx + lsy * lsy + 1e-12f);
  const bool above = lmax > c.light_threshold;
  o.lvx = above ? lmax * lsx * linv : 0.f;
  o.lvy = above ? lmax * lsy * linv : 0.f;

  o.ztilde = 1.0f - 2.0f / (1.0f + expf(count));
  o.w_x = w_x;
  o.w_y = w_y;
  o.rab_x = a_x;
  o.rab_y = a_y;
}

// All sensors of robot i, its pose (xi, yi, cy, sy) and its arena's
// positions in shared memory, robot j at s_x[j * kGroup]
// (ops/fused_step.py: sensor_block).
__device__ void sensor_block(const Consts& c, const float* s_x, const float* s_y,
                             int i, int N, int n_seg, float xi, float yi,
                             float cy, float sy, Sensors& o) {
  float wdx[kSensors], wdy[kSensors];
  sensor_rays(c, cy, sy, wdx, wdy, o);

  // other robots: proximity cone test and range-and-bearing
  float count = 0.f, w_x = 0.f, w_y = 0.f, a_x = 0.f, a_y = 0.f;
  for (int j = 0; j < N; ++j)
    sensor_pair(c, wdx, wdy, s_x[j * kGroup] - xi, s_y[j * kGroup] - yi, j != i, cy, sy, o,
                count, w_x, w_y, a_x, a_y);

  // walls: 8 rays x n_seg segments
  for (int k = 0; k < n_seg; ++k) sensor_segment(c, wdx, wdy, k, xi, yi, o);

  sensor_finish(c, wdx, wdy, xi, yi, count, w_x, w_y, a_x, a_y, o);
}

__device__ void wheels_from_vector(float vx, float vy, float ms, float& l, float& r) {
  const bool near_zero = fabsf(vx) < 1e-5f && fabsf(vy) < 1e-5f;
  const float inv = nr_rsqrt(vx * vx + vy * vy + 1e-12f);
  const float cos_t = vx * inv;
  const bool front = (vy > 0.f) || (vy == 0.f && vx > 0.f);
  const float left = front ? cos_t : 1.f;
  const float right = front ? 1.f : cos_t;
  const float max_val = fmaxf(fmaxf(fabsf(left), fabsf(right)), 1e-5f);
  const float scale = ms / max_val;
  l = near_zero ? 0.f : left * scale;
  r = near_zero ? 0.f : right * scale;
}

__device__ void steer(float vx, float vy, float ms, float& l, float& r) {
  const bool small = (vx * vx + vy * vy) < 0.01f;
  wheels_from_vector(small ? 1.f : vx, small ? 0.f : vy, ms, l, r);
}

// photo/antiphoto machine: decrement first, THEN trigger; returns turning
__device__ bool avoidance(int& av, int& st, float& dr, bool active, int dur,
                          bool obstacle, float turn) {
  const bool currently = (av != 0) && active;
  if (currently) st = st - 1;
  if (currently && st <= 0) av = 0;
  if (av == 0 && active && obstacle) {
    dr = turn;
    st = dur;
    av = 1;
  }
  return (av != 0) && active;
}

__device__ __forceinline__ float ground(const Consts& c, float x, float y) {
  float color = 0.5f;
  const float ax = fabsf(x);
  if (ax < c.gate_zone_hw && y > c.gate_south && y < c.corr_south) color = 1.f;
  if (ax < c.corr_hw && y >= c.corr_south && y < c.ni) color = 0.f;
  return color;
}

template <typename T>
__device__ __forceinline__ T ld(const Ptrs& P, int slot, size_t k) {
  return static_cast<const T*>(P.p[slot])[k];
}

template <typename T>
__device__ __forceinline__ void st_(const Ptrs& P, int slot, size_t k, T v) {
  static_cast<T*>(P.p[slot])[k] = v;
}

// The block is kGroup arenas × N robots.
__global__ void __launch_bounds__(kGroup * kMaxN)
fused_step_kernel(const __grid_constant__ Consts c, const __grid_constant__ Ptrs P,
                  const Flags F) {
  __shared__ float s_x[kMaxN * kGroup];  // [robot][arena]
  __shared__ float s_y[kMaxN * kGroup];
  __shared__ float s_rew[kMaxN * kGroup];

  const int lane = threadIdx.x % 32;
  const int a = lane % kGroup;                               // arena in the block
  const int i = (threadIdx.x / 32) * kRows + lane / kGroup;  // robot
  const int e = blockIdx.x * kGroup + a;  // < Ep: the grid is Ep / kGroup blocks
  const int N = F.N;
  const bool active = i < N;  // false only in a last, partial warp row
  const size_t Ep = F.Ep;
  const size_t r = static_cast<size_t>(active ? i : 0) * Ep + e;  // (row i, arena e)
  const float* arena_x = s_x + a;  // robot j at arena_x[j * kGroup]
  const float* arena_y = s_y + a;

  float px = 0.f, py = 0.f, yaw = 0.f, prev = 0.f;
  if (active) {
    px = ld<float>(P, kPx, r);
    py = ld<float>(P, kPy, r);
    yaw = ld<float>(P, kYaw, r);
    prev = ld<float>(P, kPrev, r);
    s_x[i * kGroup + a] = px;
    s_y[i * kGroup + a] = py;
  }
  __syncthreads();
  const float cy = cosf(yaw);
  const float sy = sinf(yaw);

  Sensors sb;
  float left = 0.f, right = 0.f;
  int es = 0, ek = 0, pa = 0, pk = 0, aa = 0, ak = 0;
  float ed = 0.f, pd = 0.f, ad = 0.f;
  if (F.discrete) {
    if (active) {
      sensor_block(c, arena_x, arena_y, i, N, F.n_seg, px, py, cy, sy, sb);
      const int mod = ld<int>(P, kMod, r);
      es = ld<int>(P, kEs, r);
      ek = ld<int>(P, kEk, r);
      ed = ld<float>(P, kEd, r);
      pa = ld<int>(P, kPa, r);
      pk = ld<int>(P, kPk, r);
      pd = ld<float>(P, kPd, r);
      aa = ld<int>(P, kAa, r);
      ak = ld<int>(P, kAk, r);
      ad = ld<float>(P, kAd, r);
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
    }
  } else if (active) {
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

  // robot push-out: one Jacobi pass from the clamped positions
  __syncthreads();  // every sensor read of the pre-step poses is done
  if (active) {
    s_x[i * kGroup + a] = npx;
    s_y[i * kGroup + a] = npy;
  }
  __syncthreads();
  if (active) {
    float own_x = 0.f, own_y = 0.f, oth_x = 0.f, oth_y = 0.f;
    for (int j = 0; j < N; ++j) {
      if (j == i) continue;
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
    npx = npx + own_x - oth_x;
    npy = npy + own_y - oth_y;
  }

  // colour-transition team reward: small integer counts, exact in f32, so
  // the sum over the arena's robots gives the same value in any order
  const float curr = ground(c, npx, npy);
  if (active)
    s_rew[i * kGroup + a] = ((prev < 0.25f && curr > 0.75f) ? 1.f : 0.f) -
                       ((prev > 0.75f && curr < 0.25f) ? 1.f : 0.f);
  __syncthreads();  // also ends every push-out read of s_x, s_y

  // time-limit done + folded auto-reset
  int sc = ld<int>(P, kSc, e) + 1;
  const bool done = sc >= F.max_episode_length - 1;
  if (done && active) {
    npx = ld<float>(P, kSx, r);
    npy = ld<float>(P, kSy, r);
    nyaw = ld<float>(P, kSw, r);
  }
  const float nprev = ground(c, npx, npy);

  if (!F.discrete && F.want_obs) {
    // fresh observations from the post-reset poses
    if (active) {
      s_x[i * kGroup + a] = npx;
      s_y[i * kGroup + a] = npy;
    }
    __syncthreads();
    if (active)
      sensor_block(c, arena_x, arena_y, i, N, F.n_seg, npx, npy, cosf(nyaw),
                   sinf(nyaw), sb);
  }

  if (i == 0) {  // the arena's outputs, once
    float rew = 0.f;
    for (int j = 0; j < N; ++j) rew += s_rew[j * kGroup + a];
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
  if (!active) return;  // after the last barrier
  st_<float>(P, kOPx, r, npx);
  st_<float>(P, kOPy, r, npy);
  st_<float>(P, kOYaw, r, nyaw);
  st_<float>(P, kOPrev, r, nprev);
  if (F.discrete) {
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
  }
  if (F.want_obs) {
    st_<float>(P, kZt, r, sb.ztilde);
    if (F.obs24) {
#pragma unroll
      for (int s = 0; s < kSensors; ++s) {
        const size_t row = static_cast<size_t>(s * N + i) * Ep + e;
        st_<float>(P, kPv, row, sb.prox[s]);
        st_<float>(P, kLv, row, sb.light[s]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        st_<float>(P, kRp, static_cast<size_t>(k * N + i) * Ep + e,
                   sb.w_x * c.rab_cos[k] + sb.w_y * c.rab_sin[k]);
    }
  }
}

}  // namespace

extern "C" {

// ptrs: host array of kNumSlots device pointers (null where unused);
// consts: host array of the Consts table. Returns cudaGetLastError() after
// the launch (0 = success).
int fused_step_launch(void* const* ptrs, const float* consts, int n_consts,
                      int n_seg, int n_face, int Ep, int N, int discrete, int obs24,
                      int want_obs, int max_episode_length, void* stream) {
  if (n_consts * sizeof(float) != sizeof(Consts) || N > kMaxN || N < 1 ||
      n_seg > kMaxSeg || n_face > kMaxFace || Ep < 1 || Ep % kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  Consts c;
  memcpy(&c, consts, sizeof(Consts));
  Ptrs P;
  for (int k = 0; k < kNumSlots; ++k) P.p[k] = ptrs[k];
  const Flags F{Ep, N, n_seg, n_face, discrete, obs24, want_obs, max_episode_length};
  const int warps = (N + kRows - 1) / kRows;
  fused_step_kernel<<<Ep / kGroup, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(
      c, P, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
