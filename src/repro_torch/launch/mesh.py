"""Production and host meshes (port of `repro/launch/mesh.py`).

Functions, never module-level constants: importing this module touches no
process group, as the reference's touches no device state.

  make_production_mesh(multi_pod)  (16, 16) ("data", "model"), 256 ranks, or
                                   (2, 16, 16) ("pod", "data", "model"), 512,
                                   its pod axis folded into data (32, 16):
                                   a `DeviceMesh` over the initialised
                                   process group (the dry run's `fake`
                                   backend of that world size)
  make_host_mesh(data, model)      a (data, model) mesh over the initialised
                                   group's ranks, on the card unless asked
                                   for the CPU (tests: `gloo`)
  AbstractMesh(shape, names)       the axis sizes alone, for the policies
                                   (the reference's `jax.sharding.AbstractMesh`)
  axis_sizes(mesh)                 {axis name: size} of either
  fake_world(n)                    a `fake`-backend group of n ranks in this
                                   one process (the dry run)
  join_group(device_type)          join the group the REPRO_DIST_* knobs
                                   name, one process per card

The knobs (one process per card, the same command on every rank):

  REPRO_DIST_COORD      the group's rendezvous address (host:port, rank 0's
                        TCP store); unset = one process, no group.
  REPRO_DIST_NPROCS     number of processes in the group (with _COORD).
  REPRO_DIST_RANK       this process's rank in 0..NPROCS-1 (with _COORD).
"""
from __future__ import annotations

import datetime
import math
import os
from typing import NamedTuple

import torch

ENV_COORD = "REPRO_DIST_COORD"
ENV_NPROCS = "REPRO_DIST_NPROCS"
ENV_RANK = "REPRO_DIST_RANK"
DIST_KNOBS = f"{ENV_COORD}, {ENV_NPROCS} and {ENV_RANK}"
DIST_TIMEOUT_S = 600             # the group's timeout for a collective


class AbstractMesh(NamedTuple):
    """A mesh's axis sizes and names, no ranks: what the policies read."""
    shape: tuple
    mesh_dim_names: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` or an `AbstractMesh` (the
    reference's `mesh.shape`)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def production_shape(multi_pod: bool = False) -> AbstractMesh:
    """Single pod: 16 x 16 = 256 cards (data x model).  Multi-pod: 2 x 16 x
    16 = 512 (pod x data x model); the 'pod' axis joins data parallelism."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _device_mesh(device_type: str, shape: AbstractMesh):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make mesh: no process group is initialised "
                           "(torch.distributed.init_process_group first)")
    n = math.prod(shape.shape)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"make mesh: {shape.shape} needs {n} ranks, the "
                           f"group has {world}")
    if world > n:               # the first n ranks (this one among them)
        from torch.distributed.device_mesh import DeviceMesh
        if dist.get_rank() >= n:
            raise RuntimeError(f"make mesh: rank {dist.get_rank()} is not "
                               f"among the mesh's {n}")
        return DeviceMesh(device_type, torch.arange(n).reshape(shape.shape),
                          mesh_dim_names=tuple(shape.mesh_dim_names))
    return init_device_mesh(device_type, tuple(shape.shape),
                            mesh_dim_names=tuple(shape.mesh_dim_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The production mesh over an initialised group of 256 (512) ranks
    (the dry run's: `fake_world`, its DTensors' local shards on `meta`).
    The two-pod mesh is built as (32, 16) ("data", "model"), its pod axis
    folded into data major to minor: the policies put 'pod' and 'data' on
    a tensor dim only together, as ('pod', 'data') (`Policy.dp`), so every
    placement covers the same ranks in the same order as on (2, 16, 16),
    and DTensor's sharding propagation searches two mesh dims, not three
    (the dry run's trace of jamba takes minutes on three).  The policies'
    specs on the three-axis mesh are `production_shape(True)`'s."""
    shape = production_shape(multi_pod)
    if multi_pod:
        shape = AbstractMesh((shape.shape[0] * shape.shape[1],
                              shape.shape[2]), ("data", "model"))
    return _device_mesh(device_type, shape)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda"):
    """A (data, model) mesh over the initialised group's ranks (tests,
    examples, one card)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: 'cuda' asked for but "
                           "torch.cuda.is_available() is False; pass "
                           "device_type='cpu'")
    return _device_mesh(device_type, AbstractMesh((data, model),
                                                  ("data", "model")))


def fake_world(n: int) -> None:
    """A process group of `n` ranks in this one process, this process rank
    0, on the `fake` backend (collectives return at once, move nothing):
    the dry run's stand-in for a pod; a mesh of fewer ranks takes the
    first ones.  A fake group of n ranks is kept; another is replaced (the
    dry run keeps one group of 512 for both production meshes: a group
    replaced under live meshes leaves DTensor's caches naming its
    subgroups)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def card_index(rank: int) -> int:
    """The card of a rank's process: LOCAL_RANK where it is set, else rank
    mod the visible cards (ranks share a card where there are fewer)."""
    local = os.environ.get("LOCAL_RANK", "").strip()
    return int(local) if local else rank % torch.cuda.device_count()


def join_group(device_type: str = "cuda") -> bool:
    """Join the process group named by REPRO_DIST_COORD / REPRO_DIST_NPROCS
    / REPRO_DIST_RANK over TCP.  For the card (`device_type` "cuda") the
    default group is `gloo` for CPU tensors and `nccl` for CUDA tensors,
    this process on its card (`card_index`); for the CPU it is `gloo`.
    Where the process already holds a default group, its world size and
    rank must be the knobs'.  False (nothing joined) when REPRO_DIST_COORD
    is unset."""
    coord = os.environ.get(ENV_COORD, "").strip()
    if not coord:
        return False
    try:
        nprocs = int(os.environ[ENV_NPROCS])
        rank = int(os.environ[ENV_RANK])
    except KeyError as e:
        raise ValueError(
            f"{ENV_COORD}={coord!r} is set but {e.args[0]} is not; "
            f"multi-host runs need {ENV_NPROCS} and {ENV_RANK}") from None
    except ValueError:
        raise ValueError(
            f"{ENV_NPROCS}/{ENV_RANK} must be integers (got "
            f"{os.environ.get(ENV_NPROCS)!r}/{os.environ.get(ENV_RANK)!r})"
        ) from None
    if not 0 <= rank < nprocs:
        raise ValueError(f"{ENV_RANK}={rank} outside 0..{nprocs - 1} "
                         f"({ENV_NPROCS}={nprocs})")
    import torch.distributed as dist
    if not dist.is_initialized():
        if device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("join_group: 'cuda' asked for but "
                                   "torch.cuda.is_available() is False")
            torch.cuda.set_device(card_index(rank))
            backend = "cpu:gloo,cuda:nccl"
        else:
            backend = "gloo"
        url = coord if "://" in coord else f"tcp://{coord}"
        dist.init_process_group(
            backend, init_method=url, world_size=nprocs, rank=rank,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    elif (dist.get_world_size(), dist.get_rank()) != (nprocs, rank):
        raise ValueError(
            f"{ENV_NPROCS}={nprocs}/{ENV_RANK}={rank} disagree with this "
            f"process's group (world {dist.get_world_size()}, rank "
            f"{dist.get_rank()})")
    return True

