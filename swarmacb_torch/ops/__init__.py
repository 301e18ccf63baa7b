"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, and the wrappers that pick one by the device of the input.

  pairwise_sensors, resolve_robot_collisions   (pairwise.py, csrc/pairwise.cu;
                                                past 32 robots an arena the
                                                wide route csrc/pairwise_wide.cu)
  fused_tail (forward and backward)            (baseline_tail.py,
                                                csrc/tail_forward.cu,
                                                csrc/baseline_tail.cu;
                                                the wide route csrc/tail_wide.cu)
  fused_cf_attention (forward and backward)    (cf_attention.py,
                                                csrc/cf_attention.cu; the wide
                                                route csrc/cf_attention_wide.cu)
  fused_env_step (one whole env control tick)  (fused_step.py,
                                                csrc/fused_step.cu; the wide
                                                route csrc/fused_step_wide.cu)

``launches`` counts the kernel launches of each wrapper since the last
``reset_launches()`` (the wide routes under names of their own,
``fused_tail_wide``, ``pairwise_sensors_wide`` and so on); ``build()`` compiles every kernel up front.
"""

from ._cuda import build, launches, reset_launches
from .baseline_tail import fused_tail, tail_reference
from .cf_attention import cf_reference, fused_cf_attention
from .fused_step import fused_env_step, fused_env_step_plain
from .pairwise import (
    pairwise_sensors,
    pairwise_sensors_plain,
    resolve_robot_collisions,
)

__all__ = [
    "build",
    "cf_reference",
    "fused_cf_attention",
    "fused_env_step",
    "fused_env_step_plain",
    "fused_tail",
    "launches",
    "pairwise_sensors",
    "pairwise_sensors_plain",
    "reset_launches",
    "resolve_robot_collisions",
    "tail_reference",
]
