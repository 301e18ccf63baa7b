"""Data-parallel training over ``torch.distributed`` (NCCL on the card,
gloo on the CPU)."""

from .mesh import Mesh, digest, draw_local, make_mesh

__all__ = ["Mesh", "digest", "draw_local", "make_mesh"]
