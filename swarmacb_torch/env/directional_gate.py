"""Directional Gate (DGT) mission — batched PyTorch environment.

Counterpart of ``swarmacb_tpu/env/directional_gate.py``, for every variant.
One ``step`` call advances E arenas × N robots on the env's device: sensors
→ behaviour wheels (discrete variants) or wheels from actions (dandelion) →
differential-drive integration → 3 collision passes → colour-transition
team reward → time-limit done → folded auto-reset → observations.

Step-ordering contract replicated from the reference (SURVEY.md §3.2):
  * discrete variants compute sensors from PRE-integration poses, use them
    for behaviour dispatch, and REUSE them for this step's observations
    (directional_gate_env.py:495-504,657-662) — so discrete observations
    are one integration step staler than dandelion's, and post-reset
    observations keep the stale pre-reset sensor block (only the ground
    channel is fresh, directional_gate_env.py:677).
  * continuous (dandelion) computes observations fresh from post-collision
    (possibly reset) poses.
  * reward counts colour transitions of post-collision positions against
    ``prev_ground`` (directional_gate_env.py:698-738).
  * episodes truncate when the step counter reaches
    ``max_episode_length − 1`` (directional_gate_env.py:744-750, Isaac
    increments the counter before the check).
  * auto-reset (directional_gate_env.py:756-792): uniform-in-disc spawns of
    radius inradius − 2r, uniform yaw in [−π, π), colour tracking re-seeded
    from the new poses, behaviour machines zeroed, and the episode group
    reward snapshotted into ``completed_group_reward`` before zeroing.

The N² sensor pass and the robot push-out go through ``ops`` (CUDA kernels
on the card, their plain versions on the CPU). ``env/lanes.py`` drives the
same tick through one fused kernel (``ops.fused_env_step``) instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config.env_cfg import DirectionalGateEnvCfg
from ..device import resolve_device
from .. import ops
from ..numerics import sqrt_rn
from ..parallel.mesh import draw_local
from . import behaviors, geometry, physics, sensors
from .state import BehaviorState, EnvState, TimeStep


def _padded(E: int) -> int:
    """Arenas padded to whole lanes tiles (``env/lanes.py``)."""
    lanes = ops.fused_step.LANES
    return ((E + lanes - 1) // lanes) * lanes


class DirectionalGateEnv:
    """Env object: static config, geometry tables on the device, and pure
    functions of (state, actions) that return new states.

    ``device`` defaults to the card; pass ``device="cpu"`` to run on the CPU.
    ``shard=(lo, E_global)`` makes it one rank's share of a data-parallel
    run: ``cfg.num_envs`` arenas from arena ``lo`` of ``E_global``, whose
    random draws are those arenas' columns of the global draws (``draw``).
    """

    def __init__(self, cfg: DirectionalGateEnvCfg, device=None, shard=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.shard = (0, cfg.num_envs) if shard is None else tuple(shard)
        lo, total = self.shard
        if not 0 <= lo <= total - cfg.num_envs:
            raise ValueError(f"shard {self.shard} does not hold {cfg.num_envs} arenas")
        arena = geometry.wall_segments(cfg.arena_circumradius, cfg.arena_num_sides)
        gate = geometry.gate_wall_segments(
            cfg.corridor_width, cfg.gate_south_y, cfg.side_wall_length
        )
        # Combined list for sensor raycasts (directional_gate_env.py:69-77)
        segments = np.concatenate([arena, gate], axis=0)
        normals, points = geometry.wall_faces(
            cfg.arena_circumradius, cfg.arena_num_sides, fixed=cfg.fixed_wall_faces
        )
        dev = self.device
        self.wall_segments = torch.from_numpy(segments).to(dev)
        self.face_normals = torch.from_numpy(normals).to(dev)
        self.face_points = torch.from_numpy(points).to(dev)
        # Arena centre / light direction for the critic state
        # (directional_gate_env.py:98-101), as float32 host constants
        self.arena_center = np.zeros(2, dtype=np.float32)
        light = np.asarray(cfg.light_position[:2], dtype=np.float32)
        self.light_pos = light
        lv = light - self.arena_center
        self.light_dir = (lv / (np.linalg.norm(lv) + 1e-8)).astype(np.float32)

    # ── properties ────────────────────────────────────────────────
    @property
    def num_envs(self) -> int:
        return self.cfg.num_envs

    @property
    def num_agents(self) -> int:
        return self.cfg.num_agents

    @property
    def obs_dim(self) -> int:
        return self.cfg.obs_dim

    # ── random draws ──────────────────────────────────────────────
    def draw(self, draw, shape, dim: int, per: int = 1, lanes: bool = False):
        """``draw(s)`` under the draw rule of a data-parallel run
        (``parallel.draw_local``): ``shape[dim]`` holds this env's arenas,
        ``per`` entries each, and the global draw holds all ``E_global``.
        With ``lanes``, ``dim`` is the last one and holds the lanes layout's
        padded width: the draw spans the padded global width, and this
        env's arenas are kept and padded again. An env that is not a shard
        draws ``draw(shape)``."""
        lo, total = self.shard
        E = self.num_envs
        if total == E:
            return draw(tuple(shape))
        if not lanes:
            return draw_local(draw, shape, dim, lo * per, total * per)
        local = tuple(shape[:-1]) + (E,)
        x = draw_local(draw, local, len(local) - 1, lo, _padded(total))
        return torch.nn.functional.pad(x, (0, shape[-1] - E))

    # ── reset ─────────────────────────────────────────────────────
    def _sample_spawn(self, generator: torch.Generator, shape, lanes: bool = False):
        """Uniform-in-disc positions + uniform yaw, for (E, N) robots, or
        with ``lanes`` for the (N, Ep) lanes layout.

        Matches directional_gate_env.py:773-783: radius √u · (inradius − 2r),
        angle uniform in [0, 2π), yaw uniform in [−π, π).
        """
        cfg = self.cfg
        safe_r = cfg.inradius - cfg.robot_radius * 2
        u = self.draw(lambda s: torch.rand(s, generator=generator, device=self.device),
                      (3,) + tuple(shape), dim=2 if lanes else 1, lanes=lanes)
        r = sqrt_rn(u[0]) * safe_r
        theta = u[1] * 2 * math.pi
        yaw = u[2] * 2 * math.pi - math.pi
        pos = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
        return pos, yaw

    def make_state(self, pos, yaw, generator: torch.Generator, step_count=None,
                   episode_reward=None, completed_group_reward=None) -> EnvState:
        """An EnvState from given poses (and optional counters), e.g. to
        start the port and the JAX package from the same state."""
        E, N = yaw.shape
        dev = self.device
        pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        yaw = torch.as_tensor(yaw, dtype=torch.float32, device=dev)

        def vec(x, dtype):
            if x is None:
                return torch.zeros(E, dtype=dtype, device=dev)
            return torch.as_tensor(x, dtype=dtype, device=dev)

        return EnvState(
            pos=pos,
            yaw=yaw,
            prev_ground=sensors.ground_color(pos, self.cfg),
            step_count=vec(step_count, torch.int32),
            episode_reward=vec(episode_reward, torch.float32),
            completed_group_reward=vec(completed_group_reward, torch.float32),
            behavior=BehaviorState.init(E, N, dev),
            generator=generator,
        )

    def reset(self, generator: torch.Generator) -> tuple[EnvState, torch.Tensor]:
        """Fresh state for all E arenas. Returns (state, obs).

        ``generator`` must live on the env's device; the spawn draws of this
        reset and of every later auto-reset come from it.
        """
        pos, yaw = self._sample_spawn(generator, (self.num_envs, self.num_agents))
        state = self.make_state(pos, yaw, generator)
        return state, self._observations(state)

    # ── sensors / obs ─────────────────────────────────────────────
    def _compute_sensor_block(self, pos, yaw):
        """Every sensor of the given poses: the fused pairwise pass (the
        JAX package's ``use_pallas`` branch), its (value, angle) aggregate,
        and the light sensor."""
        cfg = self.cfg
        # wall raycast fused into the same pass: prox already carries
        # max(wall, robot) per sensor
        prox_vals, ztilde, rab_proj, rab_x, rab_y = ops.pairwise_sensors(
            pos, yaw, prox_range=cfg.prox_range,
            robot_radius=cfg.robot_radius, rab_range=cfg.rab_range,
            alpha_rab=cfg.alpha_parameter, wall_segments=self.wall_segments,
        )
        prox_value, prox_angle = sensors.aggregate_prox(prox_vals)
        light_vals, light_value, light_angle = sensors.compute_light(
            pos, yaw, self.light_pos, cfg.light_threshold)
        return dict(
            prox_vals=prox_vals, prox_value=prox_value, prox_angle=prox_angle,
            light_vals=light_vals, light_value=light_value, light_angle=light_angle,
            ztilde=ztilde, rab_proj=rab_proj, rab_x=rab_x, rab_y=rab_y,
        )

    def _observations(self, state: EnvState, sensor_cache=None) -> torch.Tensor:
        """Per-agent observations (E, N, obs_dim).

        Matches directional_gate_env.py:650-692: cached sensors are reused
        when provided (discrete variants); ground is always fresh.
        """
        cfg = self.cfg
        cache = sensor_cache or self._compute_sensor_block(state.pos, state.yaw)
        ground = sensors.ground_obs(state.pos, cfg)
        if cfg.variant in ("dandelion", "daisy"):
            return sensors.collect_obs_dandelion(
                cache["prox_vals"], cache["light_vals"], ground,
                cache["ztilde"], cache["rab_proj"],
            )
        return sensors.collect_obs_lily(ground, cache["ztilde"])

    def critic_state(self, state: EnvState) -> torch.Tensor:
        """5-D polar critic state (E, N, 5) — directional_gate_env.py:798-809."""
        return sensors.critic_state_5d(
            state.pos, state.yaw, self.arena_center,
            self.cfg.arena_circumradius, self.light_dir,
        )

    # ── step ──────────────────────────────────────────────────────
    def step(self, state: EnvState, actions: torch.Tensor,
             injected_durations=None, injected_spawn=None
             ) -> tuple[EnvState, TimeStep]:
        """Advance one control tick (10 Hz).

        Args:
            state: current EnvState (any, e.g. one built by ``make_state``).
            actions: (E, N, 2) normalized wheel commands for dandelion, or
                (E, N) / (E, N, 1) int module indices for discrete variants.
            injected_durations: optional {explore, photo, antiphoto} (E, N)
                int32 turn durations that replace the behaviour draws.
            injected_spawn: optional (pos (E, N, 2), yaw (E, N)) that
                replaces the auto-reset's random spawn draw.
            Both are for replay against the JAX package.

        Returns (new_state, TimeStep).
        """
        cfg = self.cfg
        bstate = state.behavior
        sensor_cache = None

        if cfg.discrete_actions:
            module_ids = actions.reshape(state.yaw.shape).to(torch.int32)
            if injected_durations is None:
                # the explore, photo and antiphoto draws, in that order
                injected_durations = {n: self.draw(
                    lambda s: behaviors.draw_durations(state.generator, s, self.device),
                    module_ids.shape, dim=0) for n in ("explore", "photo", "antiphoto")}
            sensor_cache = self._compute_sensor_block(state.pos, state.yaw)
            left, right, bstate = behaviors.dispatch(
                module_ids, bstate,
                sensor_cache["prox_value"], sensor_cache["prox_angle"],
                sensor_cache["light_value"], sensor_cache["light_angle"],
                sensor_cache["rab_x"], sensor_cache["rab_y"],
                injected_durations, cfg.max_wheel_speed, cfg.alpha_parameter,
                cfg.prox_threshold,
            )
        else:
            # Dandelion: clamp [−1,1] then scale (directional_gate_env.py:512-525)
            clamped = torch.clamp(actions, -1.0, 1.0)
            left = clamped[..., 0] * cfg.max_wheel_speed
            right = clamped[..., 1] * cfg.max_wheel_speed

        # Integrate + collisions (directional_gate_env.py:527-545)
        pos, yaw = physics.integrate_and_wrap(
            state.pos, state.yaw, left, right, cfg.wheelbase, cfg.dt
        )
        pos = physics.resolve_wall_collisions(
            pos, self.face_normals, self.face_points, cfg.robot_radius
        )
        pos = physics.resolve_gate_wall_collisions(
            pos, cfg.robot_radius, cfg.corridor_width / 2.0,
            cfg.gate_south_y, cfg.side_wall_length,
        )
        pos = ops.resolve_robot_collisions(pos, cfg.robot_radius)

        # Reward: colour transitions (directional_gate_env.py:698-738)
        curr_color = sensors.ground_color(pos, cfg)
        prev = state.prev_ground
        black_to_white = (prev < 0.25) & (curr_color > 0.75)
        white_to_black = (prev > 0.75) & (curr_color < 0.25)
        k_plus = black_to_white.to(torch.float32).sum(1)
        k_minus = white_to_black.to(torch.float32).sum(1)
        reward = k_plus - k_minus
        episode_reward = state.episode_reward + reward

        # Done: time limit only (directional_gate_env.py:744-750; Isaac
        # increments episode_length_buf before the check)
        step_count = state.step_count + 1
        done = step_count >= (cfg.max_episode_length - 1)

        # ── folded auto-reset (directional_gate_env.py:756-792) ────
        if injected_spawn is not None:
            spawn_pos, spawn_yaw = injected_spawn
        else:
            spawn_pos, spawn_yaw = self._sample_spawn(
                state.generator, (cfg.num_envs, cfg.num_agents)
            )
        dm = done[:, None]
        new_pos = torch.where(dm[..., None], spawn_pos, pos)
        new_yaw = torch.where(dm, spawn_yaw, yaw)
        new_prev_ground = torch.where(
            dm, sensors.ground_color(new_pos, cfg), curr_color
        )
        completed = torch.where(done, episode_reward, state.completed_group_reward)
        episode_reward = torch.where(done, torch.zeros_like(episode_reward),
                                     episode_reward)
        step_count = torch.where(done, torch.zeros_like(step_count), step_count)
        bstate = bstate.reset_where(done)

        new_state = EnvState(
            pos=new_pos,
            yaw=new_yaw,
            prev_ground=new_prev_ground,
            step_count=step_count,
            episode_reward=episode_reward,
            completed_group_reward=completed,
            behavior=bstate,
            generator=state.generator,
        )
        # Observations: discrete variants reuse the pre-step sensor cache
        # (stale across resets, matching the reference); ground is fresh.
        obs = self._observations(new_state, sensor_cache=sensor_cache)
        return new_state, TimeStep(obs=obs, reward=reward, done=done)
