#!/usr/bin/env python3
"""Interactive manual control of the PyTorch port: the sensor and physics
test harness, counterpart of ``scripts/manual_control.py``.

One daisy arena of ``--num_agents`` robots: robot 0 is driven by the
keyboard, the others run a selectable behaviour module. The world is the
port's env (``swarmacb_torch.env``), composed as the JAX script composes
the JAX package's: once a control tick, every sensor through the fused
pairwise pass (``env._compute_sensor_block``, kernel K1 on the card) and
the behaviour dispatch; then ``substeps`` physics sub-steps of dt/substeps
with the wheels held, each one integration, wall push-out, gate clamp,
robot push-out (``ops.resolve_robot_collisions``, kernel K2 on the card)
and colour-transition count.

It runs on the card unless ``--device cpu`` is given; without a card it
raises. K⁺, K⁻ and the HUD's sensor values stay on the device and come to
the host in one copy a frame.

Randomness: one ``torch.Generator`` seeded from ``--seed`` draws the
resets and, every frame, the turn durations (``behaviors.draw_durations``,
explore, photo, antiphoto). The JAX script's key stream is not reproduced:
the tests hold ``mixed_step`` against the JAX composition with the same
durations injected on both sides.

The simulation core (``build``, ``draw_durations``, ``mixed_step``,
``read_hud``) imports no pygame; ``main`` imports it.

Controls:
    arrows / WASD   drive robot 0 (up/down = both wheels, left/right = turn)
    0-5             set behaviour module for the other robots
                    (0 explore, 1 stop, 2 photo, 3 anti-photo, 4 attract,
                     5 repel)
    R               reset episode
    ESC / window ×  quit

Headless smoke test:  SDL_VIDEODRIVER=dummy python scripts/manual_control_torch.py
                      --device cpu --smoke-frames 20
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from swarmacb_torch import ops  # noqa: E402
from swarmacb_torch.config import DirectionalGateEnvCfg  # noqa: E402
from swarmacb_torch.device import resolve_device  # noqa: E402
from swarmacb_torch.env import DirectionalGateEnv, behaviors, physics, sensors  # noqa: E402

DURATIONS = ("explore", "photo", "antiphoto")
MOD_NAMES = ["EXPLORE", "STOP", "PHOTO", "ANTI-PHOTO", "ATTRACT", "REPEL"]


def substeps_for(hz: float, sim_hz: float) -> int:
    """Physics sub-steps a control tick (manual_control_isaac.py:49-52): the
    sim at ``sim_hz`` under behaviours at ``hz``; 0 means one dt a tick."""
    return max(1, round(sim_hz / hz)) if sim_hz else 1


def build(num_agents: int = 20, device=None, seed: int = 0):
    """The daisy env of one arena on ``device`` (the card by default), a
    generator on it seeded with ``seed``, and a reset state drawn from it."""
    env = DirectionalGateEnv(DirectionalGateEnvCfg(variant="daisy", num_envs=1,
                                                   num_agents=num_agents), device=device)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    state, _ = env.reset(gen)
    return env, gen, state


def draw_durations(env, gen):
    """One frame's turn durations, (1, N) int32 each, in the env's order."""
    shape = (1, env.num_agents)
    return {n: behaviors.draw_durations(gen, shape, env.device) for n in DURATIONS}


def mixed_step(env, state, wheels0, module_id: int, durations, substeps: int, dt_sub: float,
               path=None):
    """One mixed-control tick: robot 0 on ``wheels0`` = (left, right), the
    others on module ``module_id`` with the turn ``durations``; then
    ``substeps`` physics sub-steps of ``dt_sub`` (the JAX script's closure,
    scripts/manual_control.py:75-111, its ``lax.scan`` a loop here).
    Returns (state, sensor cache, K⁺, K⁻), the counts as 0-dim tensors on
    the env's device. A list given as ``path`` receives each sub-step's
    positions."""
    cfg = env.cfg
    cache = env._compute_sensor_block(state.pos, state.yaw)
    module_ids = torch.full((1, cfg.num_agents), module_id, dtype=torch.int32,
                            device=env.device)
    left, right, bstate = behaviors.dispatch(
        module_ids, state.behavior, cache["prox_value"], cache["prox_angle"],
        cache["light_value"], cache["light_angle"], cache["rab_x"], cache["rab_y"],
        durations, cfg.max_wheel_speed, cfg.alpha_parameter, cfg.prox_threshold)
    left[0, 0] = wheels0[0]
    right[0, 0] = wheels0[1]
    pos, yaw, prev = state.pos, state.yaw, state.prev_ground
    kp = torch.zeros((), device=env.device)
    km = torch.zeros((), device=env.device)
    for _ in range(substeps):
        pos, yaw = physics.integrate_and_wrap(pos, yaw, left, right, cfg.wheelbase, dt_sub)
        pos = physics.resolve_wall_collisions(pos, env.face_normals, env.face_points,
                                              cfg.robot_radius)
        pos = physics.resolve_gate_wall_collisions(
            pos, cfg.robot_radius, cfg.corridor_width / 2.0, cfg.gate_south_y,
            cfg.side_wall_length)
        pos = ops.resolve_robot_collisions(pos, cfg.robot_radius)
        if path is not None:
            path.append(pos)
        curr = sensors.ground_color(pos, cfg)
        kp = kp + ((prev < 0.25) & (curr > 0.75)).to(torch.float32).sum()
        km = km + ((prev > 0.75) & (curr < 0.25)).to(torch.float32).sum()
        prev = curr
    state = dataclasses.replace(state, pos=pos, yaw=yaw, prev_ground=prev, behavior=bstate)
    return state, cache, kp, km


# the HUD's values, in the order of read_hud's one copy: name → width
HUD = (("k_plus", 1), ("k_minus", 1), ("prox_vals", 8), ("prox_value", 1),
       ("prox_angle", 1), ("light_vals", 8), ("light_value", 1), ("light_angle", 1),
       ("ground", 1), ("ztilde", 1), ("rab_proj", 4), ("rab_x", 1), ("rab_y", 1))


def read_hud(state, cache, k_plus, k_minus) -> dict:
    """Robot 0's sensor values, the running K⁺ and K⁻, and every robot's
    pose, in one copy to the host: numpy arrays keyed by ``HUD``'s names
    and "pos" (N, 2), "yaw" (N,)."""
    parts = {"k_plus": k_plus, "k_minus": k_minus, "ground": state.prev_ground[0, 0]}
    parts.update({n: cache[n][0, 0] for n, _ in HUD if n not in parts})
    flat = torch.cat([parts[n].reshape(-1).to(torch.float32) for n, _ in HUD]
                     + [state.pos[0].reshape(-1), state.yaw[0]]).cpu().numpy()
    out, k = {}, 0
    for n, width in HUD:
        out[n] = flat[k:k + width] if width > 1 else float(flat[k])
        k += width
    N = state.yaw.shape[1]
    out["pos"] = flat[k:k + 2 * N].reshape(N, 2)
    out["yaw"] = flat[k + 2 * N:]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="SwarmACB manual control (PyTorch port)")
    p.add_argument("--num_agents", type=int, default=20)
    p.add_argument("--smoke-frames", type=int, default=0,
                   help="run N frames without keyboard then exit (smoke test)")
    p.add_argument("--hz", type=float, default=10.0, help="control frequency")
    p.add_argument("--sim-hz", type=float, default=0.0,
                   help="physics sub-step frequency (reference "
                        "manual_control_isaac.py:49-52 runs sim at 60 Hz "
                        "while behaviours re-evaluate at the 10 Hz control "
                        "rate; 0 = no sub-stepping, one dt per control tick)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    import pygame

    env, gen, state = build(args.num_agents, device, args.seed)
    cfg = env.cfg
    N, ms = cfg.num_agents, cfg.max_wheel_speed
    substeps = substeps_for(args.hz, args.sim_hz)
    dt_sub = cfg.dt / substeps

    pygame.init()
    W, H = 1100, 760
    screen = pygame.display.set_mode((W, H))
    pygame.display.set_caption("SwarmACB (PyTorch) — Directional Gate manual control")
    font = pygame.font.SysFont("monospace", 14)
    clock = pygame.time.Clock()

    SCALE = 270.0
    CX, CY = 390, H // 2

    def w2s(x, y):
        return int(CX + x * SCALE), int(CY - y * SCALE)

    R = cfg.arena_circumradius
    verts = [w2s(R * math.cos(2 * math.pi * i / 12 + math.pi / 12),
                 R * math.sin(2 * math.pi * i / 12 + math.pi / 12))
             for i in range(12)]
    ni, cs, gs = cfg.north_inradius, cfg.corridor_south_y, cfg.gate_south_y
    ghw, chw = cfg.gate_width / 2, cfg.corridor_width / 2

    module_id = 0
    zero = torch.zeros((), device=device)
    k_plus_total = k_minus_total = zero
    frame = 0
    hud = {}

    running = True
    while running:
        for ev in pygame.event.get():
            if ev.type == pygame.QUIT:
                running = False
            elif ev.type == pygame.KEYDOWN:
                if ev.key == pygame.K_ESCAPE:
                    running = False
                elif ev.key == pygame.K_r:
                    state, _ = env.reset(gen)
                    k_plus_total = k_minus_total = zero
                elif pygame.K_0 <= ev.key <= pygame.K_5:
                    module_id = ev.key - pygame.K_0
                elif pygame.K_KP0 <= ev.key <= pygame.K_KP5:
                    module_id = ev.key - pygame.K_KP0

        keys = pygame.key.get_pressed()
        fwd = (keys[pygame.K_UP] or keys[pygame.K_w]) - (
            keys[pygame.K_DOWN] or keys[pygame.K_s])
        turn = (keys[pygame.K_RIGHT] or keys[pygame.K_d]) - (
            keys[pygame.K_LEFT] or keys[pygame.K_a])
        lw = max(-ms, min(ms, ms * (fwd + 0.7 * turn)))
        rw = max(-ms, min(ms, ms * (fwd - 0.7 * turn)))

        state, cache, kp, km = mixed_step(env, state, (lw, rw), module_id,
                                          draw_durations(env, gen), substeps, dt_sub)
        k_plus_total = k_plus_total + kp
        k_minus_total = k_minus_total + km
        hud = read_hud(state, cache, k_plus_total, k_minus_total)

        # ── draw ──────────────────────────────────────────────────
        screen.fill((60, 60, 60))
        pygame.draw.polygon(screen, (115, 115, 115), verts)
        gate_rect = (*w2s(-ghw, cs), int(2 * ghw * SCALE), int((cs - gs) * SCALE))
        pygame.draw.rect(screen, (240, 240, 240), gate_rect)
        corr_rect = (*w2s(-chw, ni), int(2 * chw * SCALE), int((ni - cs) * SCALE))
        pygame.draw.rect(screen, (20, 20, 20), corr_rect)
        pygame.draw.polygon(screen, (200, 180, 100), verts, 3)
        for sx in (-chw, chw):
            pygame.draw.line(screen, (220, 100, 50), w2s(sx, gs),
                             w2s(sx, gs + cfg.side_wall_length), 3)
        pygame.draw.circle(screen, (230, 40, 40), w2s(*env.light_pos), 9)

        pos, yaw = hud["pos"], hud["yaw"]
        for i in range(N):
            col = (90, 200, 90) if i == 0 else (80, 140, 220)
            cx, cy = w2s(pos[i, 0], pos[i, 1])
            pygame.draw.circle(screen, col, (cx, cy), max(3, int(cfg.robot_radius * SCALE)))
            hx = pos[i, 0] + 1.6 * cfg.robot_radius * math.cos(yaw[i])
            hy = pos[i, 1] + 1.6 * cfg.robot_radius * math.sin(yaw[i])
            pygame.draw.line(screen, (255, 255, 120), (cx, cy), w2s(hx, hy), 2)

        # ── HUD (robot 0 sensors) ─────────────────────────────────
        kpt, kmt = hud["k_plus"], hud["k_minus"]
        lines = [
            f"frame {frame}   module[others]: {module_id} {MOD_NAMES[module_id]}",
            f"wheels0: L={lw:+.3f} R={rw:+.3f}",
            f"K+ = {kpt:.0f}   K- = {kmt:.0f}   r = {kpt - kmt:+.0f}",
            "",
            "prox[8]: " + " ".join(f"{v:.2f}" for v in hud["prox_vals"]),
            f"prox agg: v={hud['prox_value']:.3f} a={hud['prox_angle']:+.2f}",
            "light[8]: " + " ".join(f"{v:.2f}" for v in hud["light_vals"]),
            f"light agg: v={hud['light_value']:.3f} a={hud['light_angle']:+.2f}",
            f"ground: {hud['ground']:.1f}   ztilde: {hud['ztilde']:.3f}",
            "rab proj: " + " ".join(f"{v:+.2f}" for v in hud["rab_proj"]),
            f"rab attr: ({hud['rab_x']:+.2f}, {hud['rab_y']:+.2f})",
            "",
            "keys: arrows/WASD drive | 0-5 module | R reset | ESC quit",
        ]
        for i, line in enumerate(lines):
            screen.blit(font.render(line, True, (230, 230, 230)), (790, 30 + 18 * i))

        pygame.display.flip()
        clock.tick(args.hz)
        frame += 1
        if args.smoke_frames and frame >= args.smoke_frames:
            print(f"[manual_control] smoke OK: {frame} frames, "
                  f"K+={hud['k_plus']:.0f} K-={hud['k_minus']:.0f}")
            running = False

    pygame.quit()


if __name__ == "__main__":
    main()
