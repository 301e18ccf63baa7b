"""Arena-on-lanes env state and the fused env step over it.

Counterpart of ``swarmacb_tpu/env/lanes.py``. Companion of
``ops/fused_step.py``: the whole env state stays in the kernel's (R, Ep)
layout (robots on rows, arenas on columns, Ep = arenas padded to a
multiple of 128) across a rollout, so each env step is one call of
``ops.fused_env_step`` plus the random draws. The layout is converted twice
per rollout, at its start and at its end.

RNG: ``step_lanes`` draws the turn durations (three (N, Ep) int32 tiles, for
the discrete variants) and the spawn radius, angle and yaw ((N, Ep) each)
from the lanes state's ``generator`` every step, as the JAX package draws
them from its key (lanes.py:164-188). Both are injectable in the (E, N)
layout of ``DirectionalGateEnv.step``, for replay against the JAX package.
"""

from __future__ import annotations

import torch

from .. import ops
from ..ops.fused_step import MACHINE_TILES
from . import sensors
from .behaviors import draw_durations
from .directional_gate import _padded
from .state import BehaviorState, EnvState


def to_lanes(x, num_envs: int):
    """(E, ...) leading-env tensor → lanes tile, contiguous.

    (E,) → (1, Ep); (E, N) → (N, Ep). Pad lanes are zero-filled and
    carried along; they never affect real lanes (all kernel math is
    lane-local) and ``from_lanes`` drops them.
    """
    x = x[None, :] if x.dim() == 1 else x.t()
    pad = _padded(num_envs) - num_envs
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.contiguous()


def from_lanes(x, num_envs: int, squeeze: bool = False):
    """Inverse of ``to_lanes``: (R, Ep) → (E, R), or (E,) when squeezed."""
    x = x[:, :num_envs].t()
    return x[:, 0] if squeeze else x


def state_to_lanes(env, state: EnvState) -> dict:
    """EnvState → lanes dict (bool latches become int32 tiles). The
    generator rides along under ``"generator"``."""
    E = env.num_envs
    t = lambda v: to_lanes(v, E)  # noqa: E731
    lanes = dict(
        px=t(state.pos[..., 0]), py=t(state.pos[..., 1]),
        yaw=t(state.yaw), prev=t(state.prev_ground),
        sc=t(state.step_count), er=t(state.episode_reward),
        cg=t(state.completed_group_reward), generator=state.generator,
    )
    if env.cfg.discrete_actions:
        b = state.behavior
        fields = (b.explore_state, b.explore_steps, b.explore_dir,
                  b.photo_avoiding, b.photo_steps, b.photo_dir,
                  b.antiphoto_avoiding, b.antiphoto_steps, b.antiphoto_dir)
        for name, v in zip(MACHINE_TILES, fields):
            lanes[name] = t(v.to(torch.int32) if v.dtype == torch.bool else v)
    return lanes


def lanes_to_state(env, lanes: dict) -> EnvState:
    """Lanes dict → EnvState (the exact inverse of ``state_to_lanes``)."""
    E, N = env.num_envs, env.num_agents
    f = lambda v: from_lanes(v, E).contiguous()  # noqa: E731
    s = lambda v: from_lanes(v, E, squeeze=True).contiguous()  # noqa: E731
    if env.cfg.discrete_actions:
        es, ek, ed, pa, pk, pd, aa, ak, ad = (f(lanes[n]) for n in MACHINE_TILES)
        behavior = BehaviorState(
            explore_state=es, explore_steps=ek, explore_dir=ed,
            photo_avoiding=pa.to(torch.bool), photo_steps=pk, photo_dir=pd,
            antiphoto_avoiding=aa.to(torch.bool), antiphoto_steps=ak,
            antiphoto_dir=ad)
    else:
        behavior = BehaviorState.init(E, N, lanes["px"].device)
    return EnvState(
        pos=torch.stack([f(lanes["px"]), f(lanes["py"])], dim=-1),
        yaw=f(lanes["yaw"]), prev_ground=f(lanes["prev"]),
        step_count=s(lanes["sc"]), episode_reward=s(lanes["er"]),
        completed_group_reward=s(lanes["cg"]),
        behavior=behavior, generator=lanes["generator"],
    )


def critic_state_from_lanes(env, lanes: dict):
    """5-D polar critic state (E, N, 5) straight from a lanes state
    (sensors.critic_state_5d; directional_gate_env.py:798-809)."""
    E = env.num_envs
    pos = torch.stack([from_lanes(lanes["px"], E), from_lanes(lanes["py"], E)],
                      dim=-1)
    return sensors.critic_state_5d(
        pos, from_lanes(lanes["yaw"], E), env.arena_center,
        env.cfg.arena_circumradius, env.light_dir)


def obs_from_tiles(env, obs_tiles, prev_tile):
    """Assemble (E, N, obs_dim) observations from the kernel's obs tiles
    (ground channel = the post-reset ``prev`` tile, which equals
    ground_color(new_pos) elementwise)."""
    E = env.num_envs
    ground = from_lanes(prev_tile, E)[..., None]          # (E, N, 1)
    ground3 = ground.expand(ground.shape[:2] + (3,))
    if env.cfg.variant in ("dandelion", "daisy"):
        pv, lv, zt, rp = obs_tiles
        N = env.num_agents

        def multi(x, lead):                                # (lead·N, Ep)
            return from_lanes(x, E).reshape(E, lead, N).transpose(1, 2)

        return torch.cat([multi(pv, 8), multi(lv, 8), ground3,
                          from_lanes(zt, E)[..., None], multi(rp, 4)], dim=-1)
    (zt,) = obs_tiles
    return torch.cat([ground3, from_lanes(zt, E)[..., None]], dim=-1)


def actions_to_lanes(env, env_actions):
    """The env actions of a decision in lanes form: (E, N) module ids →
    (N, Ep) int32; (E, N, 2) normalized wheels → ((N, Ep), (N, Ep))."""
    E = env.num_envs
    if env.cfg.discrete_actions:
        return to_lanes(env_actions.reshape(E, -1).to(torch.int32), E)
    return (to_lanes(env_actions[..., 0], E), to_lanes(env_actions[..., 1], E))


def step_lanes(env, lanes: dict, actions, *, want_obs: bool = True,
               injected_durations=None, injected_spawn=None):
    """Fused-kernel equivalent of ``DirectionalGateEnv.step`` on a lanes
    state. ``actions``: (N, Ep) int32 module ids for discrete variants, a
    ((N, Ep), (N, Ep)) tuple of normalized wheels for dandelion (this
    function applies the reference's clamp·max_speed preprocessing,
    directional_gate_env.py:512-525); ``actions_to_lanes`` makes either.
    ``injected_durations`` / ``injected_spawn`` take the (E, N) layout of
    ``DirectionalGateEnv.step``. Returns
    (new_lanes, reward (E,), done (E,) bool, obs_tiles)."""
    cfg = env.cfg
    E, N = cfg.num_envs, cfg.num_agents
    Ep = _padded(E)
    gen = lanes["generator"]
    dev = lanes["px"].device

    if cfg.discrete_actions:
        if injected_durations is None:
            draws = tuple(env.draw(lambda s: draw_durations(gen, s, dev), (N, Ep), dim=1,
                                   lanes=True) for _ in range(3))
        else:
            draws = tuple(to_lanes(injected_durations[n], E)
                          for n in ("explore", "photo", "antiphoto"))
    else:
        draws = ()
        left, right = actions
        ms = cfg.max_wheel_speed
        actions = (torch.clamp(left, -1.0, 1.0) * ms,
                   torch.clamp(right, -1.0, 1.0) * ms)

    if injected_spawn is None:
        spos, syaw = env._sample_spawn(gen, (N, Ep), lanes=True)
        spawn = (spos[..., 0].contiguous(), spos[..., 1].contiguous(), syaw)
    else:
        spos, syaw = injected_spawn
        spawn = (to_lanes(spos[..., 0], E), to_lanes(spos[..., 1], E),
                 to_lanes(syaw, E))

    new_lanes, reward, done, obs_tiles = ops.fused_env_step(
        lanes, actions, draws, spawn, cfg, want_obs=want_obs)
    new_lanes["generator"] = gen
    return (new_lanes, from_lanes(reward, E, squeeze=True),
            from_lanes(done, E, squeeze=True).to(torch.bool), obs_tiles)
