"""The 6 ACB behaviour modules as branchless batched PyTorch.

Counterpart of ``swarmacb_tpu/env/behaviors.py``. Module IDs
(behavior_modules.py:36-43):
  0 Exploration, 1 Stop, 2 Phototaxis, 3 Anti-phototaxis, 4 Attraction,
  5 Repulsion.

The three per-robot obstacle-avoidance state machines live in a
``BehaviorState`` (``env/state.py``). Every module's wheels are computed
densely and then selected with masks, so no control flow depends on the
data.

RNG: the reference draws ``torch.randint(1, 5)`` turn durations only on
steps where some robot triggers (behavior_modules.py:291-297,369-377). Here
an (E, N) batch is drawn every step from an explicit ``torch.Generator``
and latched only where a robot triggers: the same per-robot distribution.
``dispatch`` also takes injected duration tensors, for replay against the
JAX package.
"""

from __future__ import annotations

import math

import torch

from ..numerics import sqrt_rn
from .state import BehaviorState

EXPLORATION, STOP, PHOTOTAXIS, ANTI_PHOTOTAXIS, ATTRACTION, REPULSION = range(6)

_TURN_LO, _TURN_HI = 1, 5  # Unity Random.Range(1, 5) → {1,2,3,4}


def draw_durations(generator: torch.Generator, shape, device):
    """One batch of turn durations in {1, 2, 3, 4}, int32."""
    return torch.randint(_TURN_LO, _TURN_HI, tuple(shape), generator=generator,
                         device=device, dtype=torch.int32)


def compute_wheels_from_vector(dx, dy, max_speed: float):
    """Body-frame direction → (left, right) wheel velocities.

    Unity ``ComputeWheelsVelocityFromVector`` (behavior_modules.py:50-90):
    angle forced into [0, 2π); front hemisphere → (L=cosθ, R=1), back →
    (L=1, R=cosθ); rescaled so max(|L|,|R|) = max_speed; near-zero input →
    (0, 0).
    """
    near_zero = (torch.abs(dx) < 1e-5) & (torch.abs(dy) < 1e-5)
    angle = torch.atan2(dy, dx)
    angle = torch.where(angle < 0, angle + 2.0 * math.pi, angle)
    cos_a = torch.cos(angle)
    front = angle < math.pi
    ones = torch.ones_like(cos_a)
    left = torch.where(front, cos_a, ones)
    right = torch.where(front, ones, cos_a)
    max_val = torch.clamp(torch.maximum(torch.abs(left), torch.abs(right)),
                          min=1e-5)
    # one IEEE division (a Python scalar over a tensor is PyTorch's
    # reciprocal times the scalar)
    scale = torch.full_like(max_val, max_speed) / max_val
    left = left * scale
    right = right * scale
    left = torch.where(near_zero, torch.zeros_like(left), left)
    right = torch.where(near_zero, torch.zeros_like(right), right)
    return left, right


def _is_obstacle_in_front(prox_value, prox_angle, prox_threshold: float):
    """Unity IsObstacleInFront (behavior_modules.py:237-243)."""
    return (prox_value >= prox_threshold) & (torch.abs(prox_angle) <= math.pi * 0.5)


def _turn_direction(prox_angle):
    """Latch turn dir: angle<0 → LEFT(−1) else RIGHT(+1) (behavior_modules.py:245-256)."""
    ones = torch.ones_like(prox_angle)
    return torch.where(prox_angle < 0, -ones, ones)


def _steer_from_vector(rx, ry, max_speed: float):
    """Forward fallback (|v|<0.1 → (1,0)) then wheel conversion
    (behavior_modules.py:423-429 et al.)."""
    mag = sqrt_rn(rx * rx + ry * ry)
    small = mag < 0.1
    rx = torch.where(small, torch.ones_like(rx), rx)
    ry = torch.where(small, torch.zeros_like(ry), ry)
    return compute_wheels_from_vector(rx, ry, max_speed)


def _exploration(state: BehaviorState, prox_value, prox_angle, active, durations,
                 prox_threshold: float, max_speed: float):
    """Exploration state machine (behavior_modules.py:258-334).

    Trigger check first, then the decrement (unlike the photo/antiphoto
    machine): a newly triggered robot burns one step at once and turns for
    (duration − 1) steps.
    """
    st, steps, adir = state.explore_state, state.explore_steps, state.explore_dir

    walking = (st == 0) & active
    trigger = walking & _is_obstacle_in_front(prox_value, prox_angle, prox_threshold)
    adir = torch.where(trigger, _turn_direction(prox_angle), adir)
    steps = torch.where(trigger, durations, steps)
    st = torch.where(trigger, torch.ones_like(st), st)

    avoiding = (st == 1) & active
    steps = torch.where(avoiding, steps - 1, steps)
    done = avoiding & (steps <= 0)
    st = torch.where(done, torch.zeros_like(st), st)

    ms = max_speed
    lv_walk = torch.full_like(prox_value, ms)
    rv_walk = torch.full_like(prox_value, ms)
    lv_avoid = adir * ms
    rv_avoid = -adir * ms
    is_avoiding = (st == 1) & active
    lv = torch.where(is_avoiding, lv_avoid, lv_walk)
    rv = torch.where(is_avoiding, rv_avoid, rv_walk)
    return lv, rv, (st, steps, adir)


def _avoidance_machine(avoiding, steps, adir, prox_value, prox_angle, active,
                       durations, prox_threshold: float):
    """Shared photo/antiphoto machine (behavior_modules.py:336-380).

    Decrement the robots that are avoiding first, THEN trigger new
    avoidance: a newly triggered robot turns for the full duration.
    """
    currently = avoiding & active
    steps = torch.where(currently, steps - 1, steps)
    done = currently & (steps <= 0)
    avoiding = torch.where(done, torch.zeros_like(avoiding), avoiding)

    not_avoiding = ~avoiding & active
    trigger = not_avoiding & _is_obstacle_in_front(prox_value, prox_angle, prox_threshold)
    adir = torch.where(trigger, _turn_direction(prox_angle), adir)
    steps = torch.where(trigger, durations, steps)
    avoiding = torch.where(trigger, torch.ones_like(avoiding), avoiding)

    is_turning = avoiding & active
    return avoiding, steps, adir, is_turning


def _taxis(light_value, light_angle, prox_value, prox_angle, turn_dir, is_turning,
           sign: float, max_speed: float):
    """Shared phototaxis (+1) / anti-phototaxis (−1) steering
    (behavior_modules.py:382-483): vec = sign·light − 0.5·prox."""
    lx = light_value * torch.cos(light_angle)
    ly = light_value * torch.sin(light_angle)
    px = prox_value * torch.cos(prox_angle)
    py = prox_value * torch.sin(prox_angle)
    rx = sign * lx - 0.5 * px
    ry = sign * ly - 0.5 * py
    lv_steer, rv_steer = _steer_from_vector(rx, ry, max_speed)
    lv = torch.where(is_turning, turn_dir * max_speed, lv_steer)
    rv = torch.where(is_turning, -turn_dir * max_speed, rv_steer)
    return lv, rv


def _attraction(rab_x, rab_y, prox_value, prox_angle, max_speed: float):
    """vec = rab − 0.6·prox (behavior_modules.py:485-512)."""
    px = prox_value * torch.cos(prox_angle)
    py = prox_value * torch.sin(prox_angle)
    return _steer_from_vector(rab_x - 0.6 * px, rab_y - 0.6 * py, max_speed)


def _repulsion(rab_x, rab_y, prox_value, prox_angle, alpha: float, max_speed: float):
    """vec = −α·rab − 0.5·prox (behavior_modules.py:514-541).

    rab already carries the α/(1+d) weighting of the RAB sensor, so
    repulsion is effectively α²-weighted, as in the reference.
    """
    px = prox_value * torch.cos(prox_angle)
    py = prox_value * torch.sin(prox_angle)
    return _steer_from_vector(-alpha * rab_x - 0.5 * px, -alpha * rab_y - 0.5 * py,
                              max_speed)


def select_module(module_ids, per_module):
    """Per-robot pick of ``per_module[m]`` where ``module_ids == m``; zero
    for a module whose entry is None (Stop) or an id out of range."""
    out = torch.zeros_like(next(v for v in per_module if v is not None))
    for m, v in enumerate(per_module):
        if v is not None:
            out = torch.where(module_ids == m, v, out)
    return out


def dispatch(
    module_ids,          # (E, N) int in {0..5}
    state: BehaviorState,
    prox_value, prox_angle,
    light_value, light_angle,
    rab_vec_x, rab_vec_y,
    durations,           # dict {explore, photo, antiphoto}: (E, N) int32 in {1..4}
    max_speed: float,
    alpha_parameter: float,
    prox_threshold: float = 0.1,
):
    """Run all 6 behaviour modules densely and select per-robot wheels.

    Replaces the reference's masked Python dispatch loop
    (behavior_modules.py:177-233). The turn durations a triggered machine
    latches are drawn by the caller (``DirectionalGateEnv.step``, with
    ``draw_durations``). Returns (left, right, new_state).
    """
    dur_e = durations["explore"]
    dur_p = durations["photo"]
    dur_a = durations["antiphoto"]

    active0 = module_ids == EXPLORATION
    active2 = module_ids == PHOTOTAXIS
    active3 = module_ids == ANTI_PHOTOTAXIS

    lv0, rv0, (es, ek, ed) = _exploration(
        state, prox_value, prox_angle, active0, dur_e, prox_threshold, max_speed
    )

    pav, pst, pdir, p_turn = _avoidance_machine(
        state.photo_avoiding, state.photo_steps, state.photo_dir,
        prox_value, prox_angle, active2, dur_p, prox_threshold,
    )
    lv2, rv2 = _taxis(light_value, light_angle, prox_value, prox_angle,
                      pdir, p_turn, +1.0, max_speed)

    aav, ast, adir, a_turn = _avoidance_machine(
        state.antiphoto_avoiding, state.antiphoto_steps, state.antiphoto_dir,
        prox_value, prox_angle, active3, dur_a, prox_threshold,
    )
    lv3, rv3 = _taxis(light_value, light_angle, prox_value, prox_angle,
                      adir, a_turn, -1.0, max_speed)

    new_state = BehaviorState(
        explore_state=es, explore_steps=ek, explore_dir=ed,
        photo_avoiding=pav, photo_steps=pst, photo_dir=pdir,
        antiphoto_avoiding=aav, antiphoto_steps=ast, antiphoto_dir=adir,
    )

    lv4, rv4 = _attraction(rab_vec_x, rab_vec_y, prox_value, prox_angle, max_speed)
    lv5, rv5 = _repulsion(rab_vec_x, rab_vec_y, prox_value, prox_angle,
                          alpha_parameter, max_speed)

    left = select_module(module_ids, [lv0, None, lv2, lv3, lv4, lv5])
    right = select_module(module_ids, [rv0, None, rv2, rv3, rv4, rv5])
    return left, right, new_state
