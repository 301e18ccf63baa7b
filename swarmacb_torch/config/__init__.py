"""Configuration: env config, trainer config, ML-Agents-schema YAML loader."""

from .env_cfg import ACT_DIM, NUM_BEHAVIOR_MODULES, OBS_DIM, VARIANTS, DirectionalGateEnvCfg
from .loader import load_config
from .poca_cfg import POCAConfig

__all__ = [
    "ACT_DIM",
    "NUM_BEHAVIOR_MODULES",
    "OBS_DIM",
    "VARIANTS",
    "DirectionalGateEnvCfg",
    "POCAConfig",
    "load_config",
]
