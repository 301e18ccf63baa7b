"""Data-parallel ranks over ``torch.distributed`` — counterpart of
``swarmacb_tpu/parallel/mesh.py``.

The JAX package shards the env batch (E arenas) over a 1-D ``data`` mesh
and replicates the parameters; XLA then emits the gradient all-reduce. Here
each rank is one process that holds E / world arenas (``shard_range``) and
the same parameters, and the trainer averages its gradients over the ranks
after every minibatch (``Mesh.all_reduce_mean_``, one flat buffer a call).
The backend is NCCL on the card and gloo on the CPU; a failed init raises
and never falls back to another backend.

The draw rule (``draw_local``): every rank draws each random tensor at the
global shape from a generator that all ranks hold in step, and keeps its
own slice. The rollout of the ranks is then the rollout of one process over
all E arenas, as the JAX mesh rollout equals the one-device rollout, and a
single rank draws exactly what a run without a mesh draws.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """One rank of a data-parallel run: its index, the number of ranks,
    the device it computes on and its process group. ``comm`` counts the
    collectives this rank made (calls, bytes of the buffers reduced, and,
    with ``timed``, the seconds spent in them, the device synchronized
    around each call)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup]
    backend: str
    timed: bool = False
    comm: dict = dataclasses.field(
        default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard_range(self, num_envs: int) -> tuple[int, int]:
        """This rank's arenas ``[lo, hi)`` of ``num_envs``; E % world ≠ 0
        raises (tests/test_distributed.py:94)."""
        if num_envs % self.world:
            raise ValueError(f"num_envs={num_envs} must divide over {self.world} ranks")
        per = num_envs // self.world
        return self.rank * per, (self.rank + 1) * per

    def _collective(self, fn, buf: torch.Tensor):
        if self.timed and buf.device.type == "cuda":
            torch.cuda.synchronize(buf.device)
        t0 = time.perf_counter()
        fn(buf, group=self.group)
        if self.timed and buf.device.type == "cuda":
            torch.cuda.synchronize(buf.device)
        self.comm["calls"] += 1
        self.comm["bytes"] += buf.numel() * buf.element_size()
        if self.timed:
            self.comm["seconds"] += time.perf_counter() - t0

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Replace each tensor by its mean over the ranks, in place: one
        flat float32 buffer, one all-reduce."""
        tensors = list(tensors)
        buf = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
        self._collective(dist.all_reduce, buf)
        buf.div_(self.world)
        with torch.no_grad():
            for t, part in zip(tensors, buf.split([t.numel() for t in tensors])):
                t.copy_(part.view_as(t))

    def check_replicated(self, tensors: Sequence[torch.Tensor], what: str) -> None:
        """Raise unless every rank holds the same ``tensors`` bit for bit:
        their digest, and its negation, all-reduced with MAX must agree.
        Nothing is broadcast, so ranks that drew different weights are
        found, not hidden."""
        d = int(digest(tensors)[:14], 16)
        probe = torch.tensor([d, -d], dtype=torch.int64, device=self._comm_device())
        dist.all_reduce(probe, op=dist.ReduceOp.MAX, group=self.group)
        if int(probe[0]) != -int(probe[1]):
            raise RuntimeError(f"{what} differ between the ranks (rank {self.rank} holds "
                               f"digest {d:014x})")

    def _comm_device(self) -> torch.device:
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def digest(tensors: Sequence[torch.Tensor]) -> str:
    """SHA-256 of the tensors' bytes, in order (hex)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().to("cpu").contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def make_mesh(world: Optional[int] = None, device=None, backend: Optional[str] = None,
              rank: Optional[int] = None, init_method: Optional[str] = None) -> Mesh:
    """Join (or start) the process group of a data-parallel run.

    ``rank`` and ``world`` default to ``torchrun``'s ``RANK`` and
    ``WORLD_SIZE`` (else 0 and 1); ``device`` to the card, ``cuda`` without
    an index meaning ``cuda:LOCAL_RANK``, and ``"cpu"`` runs on the CPU.
    The backend is NCCL for a CUDA device and gloo for the CPU; an explicit
    ``backend`` overrides it (gloo ranks sharing one card). On NCCL, more
    ranks on this host (``LOCAL_WORLD_SIZE``, else ``world``) than visible
    GPUs raise. ``init_method`` defaults to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``)."""
    world = world if world is not None else (_env_int("WORLD_SIZE") or 1)
    rank = rank if rank is not None else (_env_int("RANK") or 0)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    from ..device import resolve_device

    dev = resolve_device(device)
    chosen = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if dev.index is None:
            local = _env_int("LOCAL_RANK")
            dev = torch.device("cuda", torch.cuda.current_device() if local is None else local)
        # NCCL takes a GPU a rank on each host: torchrun's LOCAL_WORLD_SIZE
        # ranks share this host's cards, else all ``world`` ranks do
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
        if chosen == "nccl" and local_world > torch.cuda.device_count():
            raise ValueError(f"{local_world} NCCL ranks on this host need {local_world} "
                             f"GPUs; {torch.cuda.device_count()} are visible")
        torch.cuda.set_device(dev)
    dist.init_process_group(chosen, init_method=init_method or "env://", rank=rank,
                            world_size=world, timeout=datetime.timedelta(minutes=10))
    return Mesh(rank=rank, world=world, device=dev, group=dist.group.WORLD,
                backend=dist.get_backend())


def draw_local(draw, shape: Sequence[int], dim: int, lo: int, total: int) -> torch.Tensor:
    """The draw rule: ``draw(s)`` at the global shape ``s`` (``shape`` with
    ``total`` entries along ``dim``), of which this rank keeps the
    ``shape[dim]`` entries from ``lo``. Every rank calls it with the same
    generator state and so leaves the generator in step; a rank that holds
    everything (``lo == 0``, ``total == shape[dim]``) draws ``draw(shape)``."""
    shape = tuple(shape)
    if lo == 0 and total == shape[dim]:
        return draw(shape)
    full = list(shape)
    full[dim] = total
    return draw(tuple(full)).narrow(dim, lo, shape[dim]).contiguous()
