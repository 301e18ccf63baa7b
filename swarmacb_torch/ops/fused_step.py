"""K4: one whole env control tick as one kernel, and its plain version.

Counterpart of ``swarmacb_tpu/ops/fused_step.py:fused_env_step`` (the Pallas
body ``_step_kernel``). Per call, for every arena of an arena-on-lanes
state (``env/lanes.py``):

  [discrete] sensors (pre-step poses) → behaviour dispatch (3 avoidance
  state machines) → differential-drive integrate + yaw wrap → wall
  push-out (12 faces) → gate-wall clamp → robot push-out (N²) →
  colour-transition team reward → time-limit done → folded auto-reset;
  observations reuse the pre-step sensor block (the reference's stale
  sensor-cache contract, directional_gate_env.py:495-504,657-662).

  [continuous] integrate from input wheels first, sensors once on the
  post-reset poses for fresh observations.

Layout: the JAX package's tiles, (R, Ep) with robots on rows and arenas on
columns (Ep = arenas padded to a multiple of 128); per-arena scalars (step
count, rewards, done) are (1, Ep) tiles. Pad arenas are zero-filled: every
value is arena-local, so they stay finite and never touch a real arena.

The plain version follows the Pallas *kernel* body, not the composed step
(``env/directional_gate.py``), because the kernel computes without atan2:

  - obstacle in front: the band test ``psum_x·2²⁴ > −|psum_y|``, the
    replication of the TPU's f32 ``|atan2| ≤ π/2`` (fused_step.py:284-306);
  - turn direction ``sign(psum_y)``, and the wheels' front hemisphere
    ``(vy > 0) | (vy == 0 ∧ vx > 0)``;
  - cosines as ``x·rsqrt(x² + y²)`` with one Newton step (``_nr_rsqrt``);
  - the branchless ±2π yaw wrap;
  - the light aggregate ``lmax·lsum·rsqrt`` and the sums over the 8 sensors
    as left folds in sensor order (Python ``sum``).

Integer and boolean outputs (machine counters and latches, step count,
reward counts, done) depend on the floats only through threshold tests.

``check_atan2_band`` (fused_step.py:68-132) is not ported. It guards the
XLA-on-TPU lowering of atan2 against the band test above; K4 has no atan2,
and the band test is here a plain predicate that the CUDA kernel and the
plain version evaluate alike. (Its bracket is also inconsistent with
itself, ADVICE.md:6.)

The CUDA kernel is ``csrc/fused_step.cu``, tuned for arenas of up to 32
robots; past that an arena takes the wide route, ``csrc/fused_step_wide.cu``
(the same tick, up to 64 robot rows a block; the pairs beyond
``sensor_skip_d2`` and ``pairwise.collision_skip_d2`` and the wall segments
no ray can reach passed over, exactly), by N alone (``route``). The wrapper
dispatches by the device of the tiles: a CPU tile takes the plain version, a
CUDA tile the kernel, or it raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..env import geometry
from ..numerics import sqrt_rn
from . import _cuda
from .pairwise import collision_skip_d2, least_d2, route

LANES = 128
# Wall segments and faces of the constants table. The env's arena is the
# mission's polygon of ``arena_num_sides`` faces and the gate's two side
# walls; no YAML, script or loader sets another side count than the
# dodecagon's 12, so the kernels see 14 segments and 12 faces.
MAX_SEGMENTS = 32
MAX_FACES = 16

# the nine behaviour-machine tiles (discrete variants), in the JAX order
MACHINE_TILES = ("es", "ek", "ed", "pa", "pk", "pd", "aa", "ak", "ad")
MACHINE_FLOAT = ("ed", "pd", "ad")

# scalar slots at the head of the constants table (csrc/fused_step.cu: Consts)
_SCALARS = ("dt", "dt_wb", "max_speed", "alpha", "prox_threshold",
            "prox_range", "prox_plus_r", "inv_range", "robot_radius", "two_r",
            "rab_range", "light_threshold", "light_x", "light_y", "gate_hw",
            "gate_south", "wall_top", "ni", "corr_south", "corr_hw",
            "gate_zone_hw")

# pointer slots of the kernel (csrc/fused_step.cu: Slot), inputs then outputs
IN_SLOTS = ("px", "py", "yaw", "prev", "mod", *MACHINE_TILES, "de", "dp", "da",
            "left", "right", "sx", "sy", "sw", "sc", "er", "cg")
OUT_SLOTS = ("o_px", "o_py", "o_yaw", "o_prev", *(f"o_{n}" for n in MACHINE_TILES),
             "o_sc", "o_er", "o_cg", "reward", "done", "pv", "lv", "zt", "rp")


class Constants:
    """Every constant of the step, as float32 — the values the Pallas
    kernel's Python floats take (computed in float64, then rounded) — in
    one table that the plain version reads and the CUDA kernel receives."""

    def __init__(self, cfg):
        arena = geometry.wall_segments(cfg.arena_circumradius, cfg.arena_num_sides)
        gate = geometry.gate_wall_segments(cfg.corridor_width, cfg.gate_south_y,
                                           cfg.side_wall_length)
        seg = np.concatenate([arena, gate], axis=0).astype(np.float64)
        normals, points = geometry.wall_faces(
            cfg.arena_circumradius, cfg.arena_num_sides, fixed=cfg.fixed_wall_faces)
        if len(seg) > MAX_SEGMENTS or len(normals) > MAX_FACES:
            raise ValueError(f"fused_env_step takes <= {MAX_SEGMENTS} segments "
                             f"and <= {MAX_FACES} faces")
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        s = dict(
            dt=cfg.dt, dt_wb=cfg.dt / cfg.wheelbase, max_speed=cfg.max_wheel_speed,
            alpha=cfg.alpha_parameter, prox_threshold=cfg.prox_threshold,
            prox_range=cfg.prox_range, prox_plus_r=cfg.prox_range + cfg.robot_radius,
            inv_range=1.0 / cfg.prox_range, robot_radius=cfg.robot_radius,
            two_r=2.0 * cfg.robot_radius, rab_range=cfg.rab_range,
            light_threshold=cfg.light_threshold,
            light_x=float(cfg.light_position[0]), light_y=float(cfg.light_position[1]),
            gate_hw=cfg.corridor_width / 2.0, gate_south=cfg.gate_south_y,
            wall_top=cfg.gate_south_y + cfg.side_wall_length, ni=cfg.north_inradius,
            corr_south=cfg.corridor_south_y, corr_hw=cfg.corridor_width / 2.0,
            gate_zone_hw=cfg.gate_width / 2.0)
        for name in _SCALARS:
            setattr(self, name, f32(s[name]))
        # np.cos of the float32 angle tables, as the Pallas kernel takes them
        self.cos_a = [float(c) for c in np.cos(geometry.EPUCK_SENSOR_ANGLES)]
        self.sin_a = [float(c) for c in np.sin(geometry.EPUCK_SENSOR_ANGLES)]
        self.rab_cos = [float(c) for c in np.cos(geometry.RAB_PROJ_ANGLES)]
        self.rab_sin = [float(c) for c in np.sin(geometry.RAB_PROJ_ANGLES)]
        self.segments = [tuple(f32(v) for v in (a[0], a[1], a[2] - a[0], a[3] - a[1]))
                         for a in seg]
        self.faces = [tuple(f32(float(v)) for v in (n[0], n[1], p[0], p[1]))
                      for n, p in zip(normals, points)]
        self.max_episode_length = cfg.max_episode_length
        self.table = self._table()

    def _table(self) -> np.ndarray:
        """The flat float32 layout of ``struct Consts`` in fused_step.cu."""
        seg = np.zeros((MAX_SEGMENTS, 4))
        seg[:len(self.segments)] = self.segments
        face = np.zeros((MAX_FACES, 4))
        face[:len(self.faces)] = self.faces
        return np.concatenate([
            [getattr(self, k) for k in _SCALARS], self.cos_a, self.sin_a,
            self.rab_cos, self.rab_sin, seg.reshape(-1), face.reshape(-1),
        ]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def constants(cfg) -> Constants:
    return Constants(cfg)


def sensor_skip_d2(k: Constants) -> float:
    """K4-wide's sensor threshold: a pair whose float32 d2 = dx² + dy² lies
    in [it, FLT_MAX] fails both the proximity test (sqrt(d2 + 1e-12) <
    prox_range + r) and the RAB range (sqrt(d2 + 1e-8) < rab_range), the
    larger of their two ``least_d2``."""
    return max(least_d2(k.prox_plus_r, 1e-12), least_d2(k.rab_range, 1e-8))


# ── the plain version ─────────────────────────────────────────────────────

def _nr_rsqrt(x):
    """rsqrt + one Newton–Raphson step (fused_step.py:135-138)."""
    r0 = torch.rsqrt(x)
    return r0 * (1.5 - 0.5 * x * r0 * r0)


def _div_by(x, c: float):
    """x / c as a true division. (PyTorch on CUDA multiplies by the
    reciprocal of a Python-scalar divisor, which may round differently from
    the kernel's division; a 0-dim tensor on x's device is divided by.)"""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _over(c: float, x):
    """c / x as one IEEE division, as the kernels and the JAX package take
    it. (PyTorch takes a Python scalar over a tensor as the tensor's
    reciprocal times the scalar: two roundings.)"""
    return torch.full_like(x, c) / x


def sensor_block(px, py, cos_y, sin_y, k: Constants, N: int):
    """All sensors of (N, Ep) pose tiles (fused_step.py:141-247); returns a
    dict of tiles. Pair tensors are (N, N, Ep), indexed [i, j]."""
    dx = px[None, :, :] - px[:, None, :]
    dy = py[None, :, :] - py[:, None, :]
    d2 = dx * dx + dy * dy

    # robot proximity + fused wall raycast (epuck_sensors.py:178-284)
    dist_p = sqrt_rn(d2 + 1e-12)
    is_self = dist_p < 1e-4
    in_range_p = dist_p < k.prox_plus_r
    reading_val = torch.clamp(1.0 - _div_by(dist_p, k.prox_plus_r), 0.0, 1.0)
    cone_rhs = 0.9659 * (dist_p + 1e-8)
    base_mask = in_range_p & ~is_self

    prox_vals, light_vals = [], []
    lxr = k.light_x - px
    lyr = k.light_y - py
    ldist = sqrt_rn(lxr * lxr + lyr * lyr + 1e-6)
    lint = 1.0 / ldist
    lnx = lxr / (ldist + 1e-8)
    lny = lyr / (ldist + 1e-8)

    for s in range(8):
        wdx = k.cos_a[s] * cos_y - k.sin_a[s] * sin_y
        wdy = k.cos_a[s] * sin_y + k.sin_a[s] * cos_y
        dot = wdx[:, None, :] * dx + wdy[:, None, :] * dy
        hit = base_mask & (dot > cone_rhs)
        reading = torch.where(hit, reading_val, torch.zeros_like(reading_val))
        out = reading.amax(dim=1)
        for ax_s, ay_s, sx_s, sy_s in k.segments:
            denom = wdx * sy_s - wdy * sx_s
            valid = torch.abs(denom) > 1e-8
            inv_denom = 1.0 / (denom + 1e-12)
            rel_x = ax_s - px
            rel_y = ay_s - py
            t = (rel_x * sy_s - rel_y * sx_s) * inv_denom
            u = (rel_x * wdy - rel_y * wdx) * inv_denom
            w_hit = valid & (t >= 0) & (t <= k.prox_range) & (u >= 0) & (u <= 1)
            w_read = torch.where(w_hit, 1.0 - t * k.inv_range, torch.zeros_like(t))
            out = torch.maximum(out, w_read)
        prox_vals.append(out)
        # light reading for the same sensor dir (epuck_sensors.py:310-329)
        ldot = torch.clamp(wdx * lnx + wdy * lny, min=0.0)
        light_vals.append(torch.clamp(lint * ldot, 0.0, 1.0))

    # prox aggregate in vector form (epuck_sensors.py:128-136)
    psum_x = sum(v * c for v, c in zip(prox_vals, k.cos_a))
    psum_y = sum(v * c for v, c in zip(prox_vals, k.sin_a))
    phyp2 = psum_x * psum_x + psum_y * psum_y
    pinv = _nr_rsqrt(phyp2 + 1e-12)
    pval = torch.clamp(phyp2 * pinv, max=1.0)          # = clip(hyp, max=1)
    pvx = pval * psum_x * pinv
    pvy = pval * psum_y * pinv

    lmax = light_vals[0]
    for v in light_vals[1:]:
        lmax = torch.maximum(lmax, v)
    lsum_x = sum(v * c for v, c in zip(light_vals, k.cos_a))
    lsum_y = sum(v * c for v, c in zip(light_vals, k.sin_a))
    linv = _nr_rsqrt(lsum_x * lsum_x + lsum_y * lsum_y + 1e-12)
    above = lmax > k.light_threshold
    zeros = torch.zeros_like(lmax)
    lvx = torch.where(above, lmax * lsum_x * linv, zeros)
    lvy = torch.where(above, lmax * lsum_y * linv, zeros)

    # RAB (epuck_sensors.py:374-442), bearing by rsqrt
    dist_r = sqrt_rn(d2 + 1e-8)
    idx = torch.arange(N, device=px.device)
    not_self = (idx[:, None] != idx[None, :])[..., None]
    in_f = ((dist_r < k.rab_range) & not_self).to(px.dtype)

    ztilde = 1.0 - 2.0 / (1.0 + torch.exp(in_f.sum(dim=1)))
    inv_dist = 1.0 / (dist_r + 1e-8)
    body_x = dx * cos_y[:, None, :] + dy * sin_y[:, None, :]
    body_y = -dx * sin_y[:, None, :] + dy * cos_y[:, None, :]
    inv_hyp = _nr_rsqrt(d2 + 1e-12)
    cos_b = body_x * inv_hyp
    sin_b = body_y * inv_hyp
    w_x = (inv_dist * cos_b * in_f).sum(dim=1)
    w_y = (inv_dist * sin_b * in_f).sum(dim=1)
    alpha_w = _over(k.alpha, 1.0 + dist_r)
    rab_x = (alpha_w * cos_b * in_f).sum(dim=1)
    rab_y = (alpha_w * sin_b * in_f).sum(dim=1)

    return dict(prox_vals=prox_vals, light_vals=light_vals,
                psum_x=psum_x, psum_y=psum_y, pval=pval, pvx=pvx, pvy=pvy,
                lvx=lvx, lvy=lvy, lmax=lmax, ztilde=ztilde, w_x=w_x, w_y=w_y,
                rab_x=rab_x, rab_y=rab_y)


def _wheels_from_vector(vx, vy, max_speed):
    """behavior_modules.py:50-90 without atan2 (fused_step.py:250-266)."""
    near_zero = (torch.abs(vx) < 1e-5) & (torch.abs(vy) < 1e-5)
    inv = _nr_rsqrt(vx * vx + vy * vy + 1e-12)
    cos_t = vx * inv
    front = (vy > 0) | ((vy == 0) & (vx > 0))
    ones = torch.ones_like(cos_t)
    left = torch.where(front, cos_t, ones)
    right = torch.where(front, ones, cos_t)
    max_val = torch.clamp(torch.maximum(torch.abs(left), torch.abs(right)), min=1e-5)
    scale = _over(max_speed, max_val)
    zeros = torch.zeros_like(cos_t)
    return (torch.where(near_zero, zeros, left * scale),
            torch.where(near_zero, zeros, right * scale))


def _steer(vx, vy, max_speed):
    """Forward fallback |v| < 0.1 → (1, 0), then wheel conversion."""
    small = (vx * vx + vy * vy) < 0.01          # mag < 0.1, squared
    vx = torch.where(small, torch.ones_like(vx), vx)
    vy = torch.where(small, torch.zeros_like(vy), vy)
    return _wheels_from_vector(vx, vy, max_speed)


def behaviours(sb, mod, machines, durations, k: Constants):
    """The 6 behaviour modules + 3 avoidance machines on tiles
    (fused_step.py:278-370). ``machines``: the nine tiles of
    ``MACHINE_TILES`` (latches as int32); ``durations``: (de, dp, da).
    Returns (left, right, new machines)."""
    es, ek, ed, pa, pk, pd, aa, ak, ad = machines
    de, dp, da = durations
    ms = k.max_speed
    pvx, pvy = sb["pvx"], sb["pvy"]
    in_front = sb["psum_x"] * 16777216.0 > -torch.abs(sb["psum_y"])
    obstacle = (sb["pval"] >= k.prox_threshold) & in_front
    fones = torch.ones_like(pvx)
    turn = torch.where(sb["psum_y"] < 0, -fones, fones)

    # exploration machine: trigger first, THEN decrement
    active0 = mod == 0
    trig0 = (es == 0) & active0 & obstacle
    ed = torch.where(trig0, turn, ed)
    ek = torch.where(trig0, de, ek)
    es = torch.where(trig0, torch.ones_like(es), es)
    avoiding0 = (es == 1) & active0
    ek = torch.where(avoiding0, ek - 1, ek)
    es = torch.where(avoiding0 & (ek <= 0), torch.zeros_like(es), es)
    is_avoid0 = (es == 1) & active0
    lv0 = torch.where(is_avoid0, ed * ms, ms * fones)
    rv0 = torch.where(is_avoid0, -ed * ms, ms * fones)

    def avoidance(av, st, dr, active, dur):
        # photo/antiphoto machine: decrement first, THEN trigger
        currently = (av != 0) & active
        st = torch.where(currently, st - 1, st)
        av = torch.where(currently & (st <= 0), torch.zeros_like(av), av)
        trig = (av == 0) & active & obstacle
        dr = torch.where(trig, turn, dr)
        st = torch.where(trig, dur, st)
        av = torch.where(trig, torch.ones_like(av), av)
        return av, st, dr, (av != 0) & active

    def taxis(sign, dr, turning):
        lv_s, rv_s = _steer(sign * sb["lvx"] - 0.5 * pvx,
                            sign * sb["lvy"] - 0.5 * pvy, ms)
        return (torch.where(turning, dr * ms, lv_s),
                torch.where(turning, -dr * ms, rv_s))

    pa, pk, pd, p_turn = avoidance(pa, pk, pd, mod == 2, dp)
    lv2, rv2 = taxis(1.0, pd, p_turn)
    aa, ak, ad, a_turn = avoidance(aa, ak, ad, mod == 3, da)
    lv3, rv3 = taxis(-1.0, ad, a_turn)
    lv4, rv4 = _steer(sb["rab_x"] - 0.6 * pvx, sb["rab_y"] - 0.6 * pvy, ms)
    lv5, rv5 = _steer(-k.alpha * sb["rab_x"] - 0.5 * pvx,
                      -k.alpha * sb["rab_y"] - 0.5 * pvy, ms)

    left = torch.zeros_like(pvx)
    right = torch.zeros_like(pvx)
    for m, lv, rv in ((0, lv0, rv0), (2, lv2, rv2), (3, lv3, rv3),
                      (4, lv4, rv4), (5, lv5, rv5)):
        left = torch.where(mod == m, lv, left)
        right = torch.where(mod == m, rv, right)
    return left, right, (es, ek, ed, pa, pk, pd, aa, ak, ad)


def _ground(px, py, k: Constants):
    """Ground colour scalar (env/sensors.py:ground_color)."""
    color = torch.full_like(px, 0.5)
    ax = torch.abs(px)
    in_gate = (ax < k.gate_zone_hw) & (py > k.gate_south) & (py < k.corr_south)
    color = torch.where(in_gate, torch.ones_like(color), color)
    in_corr = (ax < k.corr_hw) & (py >= k.corr_south) & (py < k.ni)
    return torch.where(in_corr, torch.zeros_like(color), color)


def _obs_tiles(sb, k: Constants, obs24: bool):
    if not obs24:
        return (sb["ztilde"],)
    rp = [sb["w_x"] * k.rab_cos[j] + sb["w_y"] * k.rab_sin[j] for j in range(4)]
    return (torch.cat(sb["prox_vals"]), torch.cat(sb["light_vals"]),
            sb["ztilde"], torch.cat(rp))


def drive(px, py, yaw, cos_y, sin_y, left, right, k: Constants):
    """A step's motion before the robots meet: differential drive with the
    branchless yaw wrap, the wall push-out and the gate clamp. Returns the
    positions the robot push-out starts from and the new yaw."""
    # differential drive + branchless yaw wrap (per-step |Δyaw| < 0.5 rad)
    v = 0.5 * (left + right)
    npx = px + v * cos_y * k.dt
    npy = py + v * sin_y * k.dt
    nyaw = yaw + (right - left) * k.dt_wb
    nyaw = torch.where(nyaw > math.pi, nyaw - 2.0 * math.pi, nyaw)
    nyaw = torch.where(nyaw < -math.pi, nyaw + 2.0 * math.pi, nyaw)

    # wall push-out, summed over the faces (env/physics.py:44-60)
    push_x = torch.zeros_like(npx)
    push_y = torch.zeros_like(npy)
    for fnx, fny, fpx, fpy in k.faces:
        pen = k.robot_radius - ((npx - fpx) * fnx + (npy - fpy) * fny)
        pen = torch.clamp(pen, min=0.0)
        push_x = push_x + pen * fnx
        push_y = push_y + pen * fny
    npx = npx + push_x
    npy = npy + push_y

    # gate side-wall clamp (left first, right reads the updated x)
    in_wall_y = (npy > k.gate_south) & (npy < k.wall_top)
    dx_l = npx + k.gate_hw
    near_l = (k.robot_radius - torch.abs(dx_l) > 0) & in_wall_y & (npx < 0)
    sign_l = torch.where(dx_l > 0, 1.0, -1.0)        # sign with 0 → −1 (ref)
    npx = torch.where(near_l, -k.gate_hw + sign_l * k.robot_radius, npx)
    dx_r = npx - k.gate_hw
    near_r = (k.robot_radius - torch.abs(dx_r) > 0) & in_wall_y & (npx > 0)
    sign_r = torch.where(dx_r < 0, -1.0, 1.0)        # sign with 0 → +1 (ref)
    npx = torch.where(near_r, k.gate_hw + sign_r * k.robot_radius, npx)
    return npx, npy, nyaw


def fused_env_step_plain(lanes, actions, draws, spawn, cfg, *, want_obs=True):
    """The plain version of K4 (fused_step.py:384-528); the arguments and
    results of ``fused_env_step``."""
    k = constants(cfg)
    N = cfg.num_agents
    discrete = cfg.discrete_actions
    px, py, yaw, prev = lanes["px"], lanes["py"], lanes["yaw"], lanes["prev"]
    cos_y = torch.cos(yaw)
    sin_y = torch.sin(yaw)

    if discrete:
        sb = sensor_block(px, py, cos_y, sin_y, k, N)
        left, right, machines = behaviours(
            sb, actions, [lanes[n] for n in MACHINE_TILES], draws, k)
    else:
        left, right = actions

    npx, npy, nyaw = drive(px, py, yaw, cos_y, sin_y, left, right, k)

    # robot push-out: one Jacobi pass over the pairs j > i
    cdx = npx[:, None, :] - npx[None, :, :]
    cdy = npy[:, None, :] - npy[None, :, :]
    cdist = sqrt_rn(cdx * cdx + cdy * cdy + 1e-8)
    idx = torch.arange(N, device=px.device)
    triu = (idx[None, :] > idx[:, None]).to(npx.dtype)[..., None]
    overlap = torch.clamp(k.two_r - cdist, min=0.0) * triu
    cinv = 1.0 / (cdist + 1e-8)
    half_x = overlap * cdx * cinv * 0.5
    half_y = overlap * cdy * cinv * 0.5
    npx = npx + half_x.sum(dim=1) - half_x.sum(dim=0)
    npy = npy + half_y.sum(dim=1) - half_y.sum(dim=0)

    # colour-transition team reward: small integer counts, exact in f32
    curr = _ground(npx, npy, k)
    b2w = ((prev < 0.25) & (curr > 0.75)).to(npx.dtype)
    w2b = ((prev > 0.75) & (curr < 0.25)).to(npx.dtype)
    reward = (b2w - w2b).sum(dim=0, keepdim=True)     # (1, Ep)
    er = lanes["er"] + reward

    # time-limit done + folded auto-reset (directional_gate_env.py:744-792)
    sc = lanes["sc"] + 1
    done = sc >= (k.max_episode_length - 1)           # (1, Ep) bool
    npx = torch.where(done, spawn[0], npx)
    npy = torch.where(done, spawn[1], npy)
    nyaw = torch.where(done, spawn[2], nyaw)
    nprev = _ground(npx, npy, k)      # == where(done, ground(spawn), curr)
    cg = torch.where(done, er, lanes["cg"])
    er = torch.where(done, torch.zeros_like(er), er)
    sc = torch.where(done, torch.zeros_like(sc), sc)

    new = dict(px=npx, py=npy, yaw=nyaw, prev=nprev, sc=sc, er=er, cg=cg)
    if discrete:
        for name, t in zip(MACHINE_TILES, machines):
            new[name] = torch.where(done, torch.zeros_like(t), t)
    elif want_obs:
        # fresh observations from the post-reset poses
        sb = sensor_block(npx, npy, torch.cos(nyaw), torch.sin(nyaw), k, N)
    obs = _obs_tiles(sb, k, cfg.variant in ("dandelion", "daisy")) if want_obs else ()
    return new, reward, done.to(torch.int32), obs


# ── the kernel ────────────────────────────────────────────────────────────

def _check_tiles(lanes, actions, draws, spawn, cfg):
    """Device, type, shape and contiguity of every input tile."""
    N = cfg.num_agents
    px = lanes["px"]
    dev = px.device
    if dev.type != "cuda":
        raise ValueError(f"fused_env_step: tiles must lie on the CPU or a CUDA "
                         f"device, got {dev}")
    Ep = px.shape[1]
    if px.dim() != 2 or px.shape[0] != N or Ep % LANES or N < 1:
        raise ValueError(f"fused_env_step: px must be (N, Ep % {LANES} == 0) with "
                         f"N={N} >= 1, got {tuple(px.shape)}")
    f32, i32 = torch.float32, torch.int32
    want = {"px": (N, f32), "py": (N, f32), "yaw": (N, f32), "prev": (N, f32),
            "sc": (1, i32), "er": (1, f32), "cg": (1, f32),
            "sx": (N, f32), "sy": (N, f32), "sw": (N, f32)}
    tiles = dict(lanes, sx=spawn[0], sy=spawn[1], sw=spawn[2])
    if cfg.discrete_actions:
        want.update({n: (N, f32 if n in MACHINE_FLOAT else i32) for n in MACHINE_TILES})
        want.update(mod=(N, i32), de=(N, i32), dp=(N, i32), da=(N, i32))
        tiles.update(mod=actions, de=draws[0], dp=draws[1], da=draws[2])
    else:
        want.update(left=(N, f32), right=(N, f32))
        tiles.update(left=actions[0], right=actions[1])
    for name, (rows, dtype) in want.items():
        t = tiles[name]
        if t.device != dev:
            raise ValueError(f"fused_env_step: {name} must be on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"fused_env_step: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != (rows, Ep):
            raise ValueError(f"fused_env_step: {name} must be ({rows}, {Ep}), "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_env_step: {name} must be contiguous")
    return tiles


def _launch(lanes, actions, draws, spawn, cfg, want_obs):
    tiles = _check_tiles(lanes, actions, draws, spawn, cfg)
    N, Ep = lanes["px"].shape
    discrete = cfg.discrete_actions
    obs24 = cfg.variant in ("dandelion", "daisy")
    dev = lanes["px"].device
    empty = lambda rows, dtype=torch.float32: torch.empty(  # noqa: E731
        (rows, Ep), dtype=dtype, device=dev)
    out = {"o_px": empty(N), "o_py": empty(N), "o_yaw": empty(N), "o_prev": empty(N),
           "o_sc": empty(1, torch.int32), "o_er": empty(1), "o_cg": empty(1),
           "reward": empty(1), "done": empty(1, torch.int32)}
    if discrete:
        for n in MACHINE_TILES:
            out[f"o_{n}"] = empty(N, torch.float32 if n in MACHINE_FLOAT else torch.int32)
    if want_obs:
        out["zt"] = empty(N)
        if obs24:
            out.update(pv=empty(8 * N), lv=empty(8 * N), rp=empty(4 * N))
    slots = {**tiles, **out}
    ptrs = (ctypes.c_void_p * (len(IN_SLOTS) + len(OUT_SLOTS)))(
        *(slots[n].data_ptr() if n in slots else None for n in IN_SLOTS + OUT_SLOTS))
    k = constants(cfg)
    table = k.table
    args = (ctypes.cast(ptrs, ctypes.c_void_p), table.ctypes.data, table.size,
            len(k.segments), len(k.faces), Ep, N, int(discrete), int(obs24),
            int(want_obs), k.max_episode_length)
    if route(N) == "wide":
        lib = _cuda.library("fused_step_wide")
        _cuda.launch(lanes["px"], "fused_env_step_wide", lib.fused_step_wide_launch, *args,
                     sensor_skip_d2(k), collision_skip_d2(cfg.robot_radius))
        _cuda.launches["fused_env_step_wide"] += 1
    else:
        lib = _cuda.library("fused_step")
        _cuda.launch(lanes["px"], "fused_env_step", lib.fused_step_launch, *args)
        _cuda.launches["fused_env_step"] += 1
    new = {n: out[f"o_{n}"] for n in ("px", "py", "yaw", "prev", "sc", "er", "cg")}
    if discrete:
        new.update({n: out[f"o_{n}"] for n in MACHINE_TILES})
    if not want_obs:
        obs = ()
    elif obs24:
        obs = (out["pv"], out["lv"], out["zt"], out["rp"])
    else:
        obs = (out["zt"],)
    return new, out["reward"], out["done"], obs


def fused_env_step(lanes, actions, draws, spawn, cfg, *, want_obs=True):
    """One fully fused env step on an arena-on-lanes state.

    Args:
        lanes: dict of (R, Ep) tiles — px, py, yaw, prev (N, Ep) f32; for
            discrete variants also the nine behaviour-machine tiles
            (``MACHINE_TILES``: int32, the directions float32); sc (1, Ep)
            int32; er, cg (1, Ep) f32. Other keys are ignored.
        actions: discrete → module ids (N, Ep) int32; continuous →
            (left, right) tuple of (N, Ep) f32 (already clamped/scaled).
        draws: discrete → (dur_e, dur_p, dur_a) (N, Ep) int32; continuous
            → ().
        spawn: (spawn_px, spawn_py, spawn_yaw) (N, Ep) f32.
        cfg: DirectionalGateEnvCfg.
        want_obs: also emit the observation tiles.

    Returns (new_lanes, reward (1, Ep) f32, done (1, Ep) int32, obs_tiles)
    where obs_tiles is (prox (8N, Ep), light (8N, Ep), ztilde (N, Ep),
    rab_proj (4N, Ep)) for 24-dim variants, (ztilde,) for 4-dim ones (the
    ground channel is the returned ``prev`` tile), or () when ``want_obs``
    is False. CPU tiles take the plain version; CUDA tiles the kernel.
    """
    if lanes["px"].device.type == "cpu":
        return fused_env_step_plain(lanes, actions, draws, spawn, cfg,
                                    want_obs=want_obs)
    return _launch(lanes, actions, draws, spawn, cfg, want_obs)
