"""Environment configuration for the Directional Gate (DGT) mission.

All constants match the reference implementation
(the reference's ``missions/directional_gate/directional_gate_env_cfg.py``):
dodecagonal arena of 4.91 m², 20 e-puck robots, 120 s episodes at 10 Hz,
reward = K⁺ − K⁻ (correct − incorrect gate crossings).

A copy of ``swarmacb_tpu.config.env_cfg`` with the same field names and
defaults, so the same YAML files and overrides load unchanged into the
PyTorch port. The config is a *frozen* (hashable) dataclass.
Variant-dependent tables mirror ``directional_gate_env_cfg.py:43-56``.
"""

from __future__ import annotations

import dataclasses
import math

# ── Arena geometry (directional_gate_env_cfg.py:27-36) ─────────────────
#  Regular dodecagon of area 4.91 m²:
#  Area = (1/2) n R² sin(2π/n)  →  R = √(2A / (n sin(2π/n)))  ≈ 1.279 m
_ARENA_N_SIDES = 12
_ARENA_AREA = 4.91
_ARENA_CIRCUMRADIUS = math.sqrt(
    2 * _ARENA_AREA / (_ARENA_N_SIDES * math.sin(2 * math.pi / _ARENA_N_SIDES))
)

_NUM_AGENTS = 20

# Variant-dependent observation / action dimensions
# (directional_gate_env_cfg.py:43-56)
OBS_DIM = {
    "dandelion": 24,  # 8 prox + 8 light + 3 ground + 1 ztilde + 4 RAB
    "daisy": 24,
    "lily": 4,        # 3 ground + 1 ztilde
    "tulip": 4,
    "cyclamen": 4,
}
ACT_DIM = {
    "dandelion": 2,   # continuous (left_vel, right_vel)
    "daisy": 1,       # discrete module index 0..5
    "lily": 1,
    "tulip": 1,
    "cyclamen": 1,
}
NUM_BEHAVIOR_MODULES = 6
VARIANTS = tuple(OBS_DIM.keys())


@dataclasses.dataclass(frozen=True)
class DirectionalGateEnvCfg:
    """Frozen (hashable) environment config for the DGT mission.

    Field names and defaults match the reference ``@configclass``
    (directional_gate_env_cfg.py:76-158) so YAML / CLI plumbing carries over.
    """

    # CASA variant: "dandelion" | "daisy" | "lily" | "tulip" | "cyclamen"
    variant: str = "dandelion"

    num_agents: int = _NUM_AGENTS
    num_envs: int = 5                 # paper: 5 parallel arenas during training

    # Whether actions are discrete module indices (all variants but dandelion)
    num_actions: int = NUM_BEHAVIOR_MODULES

    # Simulation (directional_gate_env_cfg.py:96-102)
    decimation: int = 1
    episode_length_s: float = 120.0
    dt: float = 0.1                   # 10 Hz control frequency

    # Arena (directional_gate_env_cfg.py:112-115)
    arena_num_sides: int = _ARENA_N_SIDES
    arena_area: float = _ARENA_AREA
    arena_circumradius: float = _ARENA_CIRCUMRADIUS

    # E-puck robot (directional_gate_env_cfg.py:118-122)
    robot_radius: float = 0.035
    robot_height: float = 0.05
    robot_mass: float = 0.190
    max_wheel_speed: float = 0.12
    wheelbase: float = 0.053

    # Sensors (directional_gate_env_cfg.py:125-127)
    prox_range: float = 0.10
    rab_range: float = 0.20
    light_threshold: float = 0.2

    # Ground zones (directional_gate_env_cfg.py:141-145)
    corridor_width: float = 0.50
    corridor_length: float = 1.06
    gate_width: float = 0.45
    gate_length: float = 0.33
    side_wall_length: float = 0.50

    # Light source XY (directional_gate_env_cfg.py:149)
    light_position: tuple = (0.0, -1.4, 0.0)

    # Behaviour modules (directional_gate_env_cfg.py:156)
    alpha_parameter: float = 5.0
    prox_threshold: float = 0.1       # behaviour-module obstacle threshold

    # Parity switch: the reference's wall-face table has an off-by-one in
    # the mid-angle of the last face (directional_gate_env.py:567-576):
    # faces 5 and 11 both resolve to the WEST face (mid-angle π) and the
    # EAST face gets no collision constraint (robots can bulge ~15 cm past
    # the east wall; the west wall pushes with 2× penetration). We replicate
    # that behaviour by default for bit-exact trajectory parity; set
    # ``fixed_wall_faces=True`` for the geometrically correct table.
    fixed_wall_faces: bool = False

    # Kept so configs written for the JAX package load unchanged. The port
    # ignores it: its kernels (ops/pairwise.py) are chosen by the device of
    # the tensors — CUDA kernels on the card, their plain PyTorch versions
    # on the CPU.
    use_pallas: bool = False

    # ── derived properties ─────────────────────────────────────────
    @property
    def discrete_actions(self) -> bool:
        return self.variant != "dandelion"

    @property
    def obs_dim(self) -> int:
        return OBS_DIM[self.variant]

    @property
    def act_dim(self) -> int:
        return ACT_DIM[self.variant]

    @property
    def max_episode_length(self) -> int:
        """Steps per episode: ceil(episode_length_s / (dt * decimation))."""
        return math.ceil(self.episode_length_s / (self.dt * self.decimation))

    @property
    def inradius(self) -> float:
        return self.arena_circumradius * math.cos(math.pi / self.arena_num_sides)

    @property
    def north_inradius(self) -> float:
        return self.inradius

    @property
    def corridor_south_y(self) -> float:
        return self.north_inradius - self.corridor_length

    @property
    def gate_south_y(self) -> float:
        return self.corridor_south_y - self.gate_length

    @property
    def possible_agents(self) -> tuple:
        return tuple(f"epuck_{i}" for i in range(self.num_agents))

    def replace(self, **kwargs) -> "DirectionalGateEnvCfg":
        return dataclasses.replace(self, **kwargs)

    def update_variant(self, variant: str) -> "DirectionalGateEnvCfg":
        """Return a copy with the CASA variant switched
        (directional_gate_env_cfg.py:161-170)."""
        if variant not in VARIANTS:
            raise ValueError(f"Unknown variant {variant!r}; choose from {VARIANTS}")
        return self.replace(variant=variant)
