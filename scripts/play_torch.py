#!/usr/bin/env python3
"""Evaluate a POCA policy trained with the PyTorch port, on the card.

The port's counterpart of ``scripts/play.py``. It rebuilds the actor from
the checkpoint's metadata alone (reference play.py:114-143), rolls out
episodes on the composed env step with stochastic or deterministic actions
(argmax for the discrete variants, the mean for dandelion), applies the
same clamp(−3, 3)/3 wheel preprocessing (play.py:193), carries the LSTM
actor's state from step to step and zeroes an arena's once its episode
ended (play.py:216-220), accounts episodes per env, and prints the returns' mean, std, min, max and median
(play.py:215-223) in the block that ``scripts/eval_checkpoints_torch.py``
parses.

Usage:
    python scripts/play_torch.py --checkpoint checkpoints/DirGate_dandelion/poca_final \
        --num_episodes 10 [--deterministic] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from swarmacb_torch.agents import Checkpointer  # noqa: E402
from swarmacb_torch.agents.checkpoint import actor_from_metadata  # noqa: E402
from swarmacb_torch.device import resolve_device  # noqa: E402
from swarmacb_torch.env import make_env  # noqa: E402
from swarmacb_torch.models.networks import Actor, DiscreteActor  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SwarmACB POCA evaluation (PyTorch port)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Checkpoint directory (state.pt + metadata.json)")
    p.add_argument("--task", type=str, default="SwarmACB-DirectionalGate-v0")
    p.add_argument("--num_envs", type=int, default=5)
    p.add_argument("--num_episodes", type=int, default=10)
    p.add_argument("--deterministic", action="store_true",
                   help="argmax (discrete) / mean (continuous) actions")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--episode_length", type=float, default=None,
                   help="Override episode length in seconds (default: the "
                        "mission's 120 s; shorter is useful for smoke tests)")
    p.add_argument("--render", action="store_true",
                   help="pygame viewer of arena 0 while evaluating")
    p.add_argument("--hz", type=float, default=10.0,
                   help="render frame rate (with --render)")
    return p


def make_viewer(env, variant, hz, status):
    """A pygame window over arena 0; returns draw(state, step, return0).
    ``status()`` gives the episode count for the heads-up line."""
    import pygame

    cfg = env.cfg
    N = env.num_agents
    pygame.init()
    W, H = 780, 760
    screen = pygame.display.set_mode((W, H))
    pygame.display.set_caption(f"SwarmACB — play {variant}")
    font = pygame.font.SysFont("monospace", 14)
    clock = pygame.time.Clock()
    SCALE, CX, CY = 270.0, W // 2, H // 2

    def w2s(x, y):
        return int(CX + x * SCALE), int(CY - y * SCALE)

    R0 = cfg.arena_circumradius
    verts = [w2s(R0 * math.cos(2 * math.pi * i / 12 + math.pi / 12),
                 R0 * math.sin(2 * math.pi * i / 12 + math.pi / 12))
             for i in range(12)]
    ni, cs, gs = cfg.north_inradius, cfg.corridor_south_y, cfg.gate_south_y
    ghw, chw = cfg.gate_width / 2, cfg.corridor_width / 2

    def draw(state, step_i, ret0):
        for ev in pygame.event.get():
            if ev.type == pygame.QUIT or (
                    ev.type == pygame.KEYDOWN and ev.key == pygame.K_ESCAPE):
                pygame.quit()
                sys.exit(0)
        screen.fill((60, 60, 60))
        pygame.draw.polygon(screen, (115, 115, 115), verts)
        pygame.draw.rect(screen, (240, 240, 240),
                         (*w2s(-ghw, cs), int(2 * ghw * SCALE), int((cs - gs) * SCALE)))
        pygame.draw.rect(screen, (20, 20, 20),
                         (*w2s(-chw, ni), int(2 * chw * SCALE), int((ni - cs) * SCALE)))
        pygame.draw.polygon(screen, (200, 180, 100), verts, 3)
        for sx in (-chw, chw):
            pygame.draw.line(screen, (220, 100, 50), w2s(sx, gs),
                             w2s(sx, gs + cfg.side_wall_length), 3)
        pygame.draw.circle(screen, (230, 40, 40), w2s(*env.light_pos), 9)
        pos = state.pos[0].cpu().numpy()
        yaw = state.yaw[0].cpu().numpy()
        for i in range(N):
            cx, cy = w2s(pos[i, 0], pos[i, 1])
            pygame.draw.circle(screen, (80, 140, 220), (cx, cy),
                               max(3, int(cfg.robot_radius * SCALE)))
            hx = pos[i, 0] + 1.6 * cfg.robot_radius * math.cos(yaw[i])
            hy = pos[i, 1] + 1.6 * cfg.robot_radius * math.sin(yaw[i])
            pygame.draw.line(screen, (255, 255, 120), (cx, cy), w2s(hx, hy), 2)
        hud = f"step {step_i}   ep return[env0] {ret0:+.0f}   {status()}"
        screen.blit(font.render(hud, True, (230, 230, 230)), (16, 12))
        pygame.display.flip()
        clock.tick(hz)

    return draw


def main(argv=None) -> dict:
    """Evaluate; returns the episodes' returns and lengths, the env steps
    taken and their wall seconds."""
    args = build_parser().parse_args(argv)
    meta = Checkpointer.load_metadata(args.checkpoint)
    device = resolve_device(args.device)
    variant = meta.get("variant", "dandelion")
    overrides = {}
    if args.episode_length is not None:
        overrides["episode_length_s"] = args.episode_length
    env = make_env(args.task, variant=variant, num_envs=args.num_envs,
                   device=device, **overrides)
    E, N = env.num_envs, env.num_agents

    params = Checkpointer.restore_params(args.checkpoint, device=device)
    actor = actor_from_metadata(meta)
    actor.load_state_dict(params["actor"], assign=True)
    discrete, recurrent = bool(meta["discrete"]), bool(meta["recurrent"])
    print(f"[play] restored {args.checkpoint}  variant={variant} "
          f"discrete={discrete} recurrent={recurrent}  device={device}")

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)

    def policy(obs, carry):
        """(env actions, the actor's next carry)."""
        flat = obs.reshape(E * N, meta["obs_dim"])
        if recurrent:
            logits, carry = actor.step(flat, carry)
        elif discrete:
            logits = actor(flat)
        if discrete:
            act = (torch.argmax(logits, dim=-1) if args.deterministic
                   else DiscreteActor.sample(logits, generator=gen))
            return act.reshape(E, N).to(torch.int32), carry
        mu, std = actor(flat)
        a = mu if args.deterministic else Actor.sample(mu, std, generator=gen)
        return (torch.clamp(a, -3.0, 3.0) / 3.0).reshape(E, N, -1), carry

    returns: list[float] = []
    lengths: list[float] = []
    draw = None
    if args.render:
        draw = make_viewer(env, variant, args.hz,
                           lambda: f"episodes {len(returns)}/{args.num_episodes}")

    state, obs = env.reset(gen)
    carry = actor.initial_state(E * N, device=device) if recurrent else ()
    ep_ret = np.zeros(E)
    ep_len = np.zeros(E)
    step_i = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        while len(returns) < args.num_episodes:
            actions, carry = policy(obs, carry)
            state, ts = env.step(state, actions)
            obs = ts.obs
            ep_ret += ts.reward.cpu().numpy()
            ep_len += 1
            step_i += 1
            if draw is not None:
                draw(state, step_i, ep_ret[0])
            done = ts.done.cpu().numpy()
            if done.any():
                returns.extend(ep_ret[done].tolist())
                lengths.extend(ep_len[done].tolist())
                ep_ret[done] = 0.0
                ep_len[done] = 0.0
                if recurrent:
                    keep = (~ts.done).to(torch.float32)[:, None].expand(E, N)
                    keep = keep.reshape(E * N, 1)
                    carry = (carry[0] * keep, carry[1] * keep)
                print(f"[play] {len(returns)}/{args.num_episodes} episodes", flush=True)
    seconds = time.perf_counter() - t0

    r = np.asarray(returns[: args.num_episodes])
    lens = np.asarray(lengths[: args.num_episodes])
    print("\n── Evaluation results ─────────────────────────")
    print(f"  episodes : {len(r)}")
    print(f"  mean     : {r.mean():.3f}")
    print(f"  std      : {r.std():.3f}")
    print(f"  min      : {r.min():.3f}")
    print(f"  max      : {r.max():.3f}")
    print(f"  median   : {np.median(r):.3f}")
    print(f"  mean len : {lens.mean():.1f}")
    return {"returns": r, "lengths": lens, "env_steps": step_i, "num_envs": E,
            "seconds": seconds}


if __name__ == "__main__":
    main()
