"""Partition layer of the sweep pipeline (port of `repro.nmp.partition`):
a (lane, seed) mesh over the ranks of a process group, one card each.

The reference builds a 2-D `jax.sharding.Mesh` ("lanes" x "seeds") over the
visible devices and lets XLA run one SPMD program over it.  The port's sweep
loop is eager and host-bound (about a thousand launches an epoch), so one
process driving several cards would issue every shard's launches from one
host thread.  The port therefore puts the mesh over *processes*: every rank
of a `torch.distributed` group runs the same entry point with the same
arguments (SPMD, as the reference's multi-host run), on its own card, over
its own block of the group batch, and the results come back to every rank
through a `gloo` group on the host:

  * rank r of a (dl, ds) mesh holds lane block r // ds and seed block
    r % ds (the reference's lane-major device order); the padded lane count
    and the episode seed schedule's seed width are padded to the mesh's
    divisors, as the reference pads them;
  * per-(lane, seed) work never crosses a rank (the epoch loop has no
    cross-lane collective: its agent and TOM gates are masked per cell), so
    each rank's block is an independent run, and `host_fetch` all-gathers
    the blocks and reassembles exactly what one device returns;
  * ranks past the mesh (REPRO_SWEEP_DEVICES below the world size, or a
    server shrunk to fewer ranks) hold no cells but join every gather.

Each rank runs on `cuda:{LOCAL_RANK}` where LOCAL_RANK is set, else on card
rank mod `torch.cuda.device_count()`; ranks share a card where there are
fewer cards than ranks.  `gloo` gathers work there too (NCCL refuses two
ranks on one card), and the results land on the host anyway.

One process without a group runs on one card, however many it sees, as the
reference does on one device (`build_mesh` returns None): asking it for more
(REPRO_SWEEP_DEVICES above 1, or a REPRO_SWEEP_MESH of more than 1x1) raises
a ValueError that names the REPRO_DIST_* knobs.

Env knobs (validated as in the reference):

  REPRO_SWEEP_DEVICES   how many ranks the sweep mesh spans: an integer, or
                        "all" (default: every rank of the group).  Values
                        outside 1..world raise.
  REPRO_SWEEP_MESH      mesh shape as "LANESxSEEDS" (e.g. "2x2", "4x1"), or
                        "auto" (default).  The shape must factor the
                        selected rank count exactly.
  REPRO_DIST_COORD      the group's rendezvous address (host:port, rank 0's
                        TCP store); unset = one process, no group.
  REPRO_DIST_NPROCS     number of processes in the group (with _COORD).
  REPRO_DIST_RANK       this process's rank in 0..NPROCS-1 (with _COORD).

A gather waits DIST_TIMEOUT_S seconds for the other ranks, so a rank that
hangs fails every rank instead of hanging them.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.launch.mesh import (DIST_KNOBS, DIST_TIMEOUT_S, card_index,
                                     join_group)

LANE_AXIS = "lanes"
SEED_AXIS = "seeds"
_ENV_DEVICES = "REPRO_SWEEP_DEVICES"
_ENV_MESH = "REPRO_SWEEP_MESH"


@dataclasses.dataclass(frozen=True)
class _Group:
    world: int
    rank: int
    gloo: Any                        # gloo group over every rank
    n_hosts: int


_group: _Group | None = None


# ---------------------------------------------------------------------------
# The process group
# ---------------------------------------------------------------------------

def maybe_init_distributed() -> bool:
    """Join the process group named by REPRO_DIST_COORD / REPRO_DIST_NPROCS
    / REPRO_DIST_RANK (`launch.mesh.join_group`: a `gloo` group over TCP,
    or, where the process already holds a default group of that size and
    rank, a `gloo` group beside it).  A no-op (returns False) when
    REPRO_DIST_COORD is unset, and idempotent once joined."""
    global _group
    if _group is not None:
        return True
    if not join_group("cpu"):
        return False
    import torch.distributed as dist
    nprocs, rank = dist.get_world_size(), dist.get_rank()
    gloo = (dist.group.WORLD if dist.get_backend() == "gloo"
            else dist.new_group(backend="gloo", timeout=datetime.timedelta(
                seconds=DIST_TIMEOUT_S)))
    hosts = [None] * nprocs
    dist.all_gather_object(hosts, socket.gethostname(), group=gloo)
    _group = _Group(world=nprocs, rank=rank, gloo=gloo,
                    n_hosts=len(set(hosts)))
    return True


def world() -> tuple[int, int]:
    """(ranks in the process group, this process's rank); (1, 0) alone."""
    maybe_init_distributed()
    return (1, 0) if _group is None else (_group.world, _group.rank)


def is_writer() -> bool:
    """True on the rank that writes shared files (rank 0, or a lone
    process)."""
    return world()[1] == 0


def barrier() -> None:
    """Wait for every rank of the group (a no-op alone)."""
    if world()[0] > 1:
        import torch.distributed as dist
        dist.barrier(group=_group.gloo)


def agree(obj):
    """Rank 0's `obj` on every rank (a decision every rank must share:
    a wall-clock reading, a checkpoint step); `obj` itself alone."""
    if world()[0] == 1:
        return obj
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_group.gloo)
    return box[0]


def agree_max(x: float) -> float:
    """The largest `x` over every rank (a tick's wall: the slowest
    rank's); `x` itself alone."""
    return x if world()[0] == 1 else max(_all_gather(x))


def _all_gather(obj) -> list:
    import torch.distributed as dist
    out = [None] * _group.world
    dist.all_gather_object(out, obj, group=_group.gloo)
    return out


def _platform(device: torch.device) -> str:
    return "gpu" if device.type == "cuda" else device.type


def visible_devices(device: str | torch.device = "cuda") -> list:
    """The devices of the run's type that this process sees."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device.  In a group, a bare "cuda" becomes
    `cuda:{LOCAL_RANK}` where that is set, else card rank mod the visible
    cards (made this thread's current card); a device with an index, the
    CPU, and a lone process's device are kept."""
    dev = resolve_device(device)
    n_world, rank = world()
    if dev.type != "cuda" or dev.index is not None or n_world == 1:
        return dev
    idx = card_index(rank)
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def _one_process_hint(n_world: int) -> str:
    if n_world > 1:
        return ""
    return (f"; this process is alone (no process group): the port runs "
            f"one process per card, so start one process for each rank "
            f"with {DIST_KNOBS}")


# ---------------------------------------------------------------------------
# Rank selection + mesh construction
# ---------------------------------------------------------------------------

def sweep_devices(device: str | torch.device = "cuda") -> list[int]:
    """Ranks the sweep mesh spans, honoring REPRO_SWEEP_DEVICES: every rank
    of the group ("all", the default) or the first n."""
    n_world, _ = world()
    raw = os.environ.get(_ENV_DEVICES, "all").strip().lower()
    if raw in ("", "all"):
        return list(range(n_world))
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"{_ENV_DEVICES}={raw!r}: expected an integer or 'all'") from None
    if not 1 <= n <= n_world:
        vis = visible_devices(device)
        raise ValueError(
            f"{_ENV_DEVICES}={n} outside 1..{n_world} ({n_world} rank(s) "
            f"in the process group; {len(vis)} {_platform(vis[0])} "
            f"device(s) visible to this process)"
            f"{_one_process_hint(n_world)}")
    return list(range(n))


def sweep_mesh_shape(n_devices: int) -> tuple[int, int] | None:
    """The (lane, seed) mesh shape forced by REPRO_SWEEP_MESH, or None when
    unset/"auto".  The shape must factor `n_devices` exactly; anything else
    raises a ValueError naming the knob, the value and the ranks."""
    raw = os.environ.get(_ENV_MESH, "").strip().lower()
    if raw in ("", "auto"):
        return None
    parts = raw.split("x")
    try:
        if len(parts) != 2:
            raise ValueError
        dl, ds = int(parts[0]), int(parts[1])
        if dl < 1 or ds < 1:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"{_ENV_MESH}={raw!r}: expected 'LANESxSEEDS' with two positive "
            "integers (e.g. '4x1', '2x2') or 'auto'") from None
    if dl * ds != n_devices:
        raise ValueError(
            f"{_ENV_MESH}={raw!r}: a {dl}x{ds} (lane x seed) mesh needs "
            f"{dl * ds} devices but {n_devices} device(s) are selected "
            f"({_ENV_DEVICES}) — the shape must factor the device count "
            f"exactly; a device is a rank of the process group"
            f"{_one_process_hint(world()[0])}")
    return dl, ds


def auto_mesh_shape(n_devices: int,
                    groups: list[tuple[int, int, int]]) -> tuple[int, int]:
    """Factor `n_devices` into the (lane, seed) dims that minimize total
    padded-cell work Σ weight · pad(L, dl) · pad(S, ds) over a plan's groups
    (n_lanes, n_seeds, weight); ties break toward the smaller seed dim."""
    if n_devices <= 1:
        return (max(n_devices, 1), 1)

    def pad(n, d):
        return ((max(n, 1) + d - 1) // d) * d

    best = None
    for ds in range(1, n_devices + 1):
        if n_devices % ds:
            continue
        dl = n_devices // ds
        cost = sum(w * pad(L, dl) * pad(S, ds) for L, S, w in groups)
        key = (cost, ds)
        if best is None or key < best[0]:
            best = (key, (dl, ds))
    return best[1]


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A (lane, seed) mesh over the first dl·ds ranks of the process group,
    lane-major: rank r holds lane block r // ds and seed block r % ds.
    Every rank of the group, in the mesh or not, joins its gathers."""
    shape: tuple[int, int]           # (lane dim, seed dim)
    rank: int                        # this process's rank
    world: int                       # ranks in the group
    device: torch.device             # this rank's device
    n_hosts: int

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coord(self) -> tuple[int, int] | None:
        """This rank's (lane block, seed block), None past the mesh."""
        if self.rank >= self.size:
            return None
        return divmod(self.rank, self.shape[1])


def placement(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device, after validating both knobs (a request a lone
    process cannot serve raises ValueError)."""
    sweep_mesh_shape(len(sweep_devices(device)))
    return rank_device(device)


def build_mesh(devices=None, shape: tuple[int, int] | None = None,
               device: str | torch.device = "cuda") -> RankMesh | None:
    """A (lane, seed) mesh over the ranks `devices` (default:
    `sweep_devices()`), which must be the group's first ranks.

    `shape` is (lane_dim, seed_dim); by default the REPRO_SWEEP_MESH
    override or, unset, the 1-D lane layout `(n, 1)` — callers with a plan
    in hand (sweep.run_grid) pass `auto_mesh_shape(...)` instead.  Returns
    None in a lone process — the one-device path, no padding or gathers —
    and a mesh of one rank in a group, whose other ranks join its
    gathers."""
    devices = sweep_devices(device) if devices is None else list(devices)
    n = len(devices)
    n_world, rank = world()
    if n_world == 1:
        if n > 1:
            raise ValueError(f"a mesh of {n} ranks in a lone process"
                             f"{_one_process_hint(1)}")
        return None
    if devices != list(range(n)):
        raise ValueError(f"a sweep mesh spans the group's first ranks, "
                         f"not {devices}")
    if shape is None:
        shape = sweep_mesh_shape(n) or (n, 1)
    dl, ds = int(shape[0]), int(shape[1])
    if dl * ds != n:
        raise ValueError(
            f"mesh shape {dl}x{ds} does not factor the {n} selected "
            f"rank(s) ({n_world} in the group; see {_ENV_MESH})")
    return RankMesh(shape=(dl, ds), rank=rank, world=n_world,
                    device=rank_device(device), n_hosts=_group.n_hosts)


def mesh_desc(mesh: RankMesh | None) -> dict:
    """JSON-friendly mesh description (benchmark records, memo keys)."""
    if mesh is None:
        return {"n_devices": 1, "shape": [1, 1],
                "axis_names": [LANE_AXIS, SEED_AXIS], "n_hosts": 1}
    return {"n_devices": mesh.size, "shape": list(mesh.shape),
            "axis_names": [LANE_AXIS, SEED_AXIS], "n_hosts": mesh.n_hosts}


def mesh_lane_dim(mesh: RankMesh | None) -> int:
    return 1 if mesh is None else mesh.shape[0]


def mesh_seed_dim(mesh: RankMesh | None) -> int:
    return 1 if mesh is None else mesh.shape[1]


def mesh_signature(device: str | torch.device = "cuda") -> str:
    """Stable signature of the mesh the next sweep would run on (device
    platform, rank count, forced shape, host count), as the reference's:
    grid memo keys must never cross a mesh change."""
    n = len(sweep_devices(device))
    shape = os.environ.get(_ENV_MESH, "auto").strip().lower() or "auto"
    hosts = 1 if _group is None else _group.n_hosts
    return f"{_platform(torch.device(device))}:{n}:{shape}:{hosts}"


# ---------------------------------------------------------------------------
# Padding + placement
# ---------------------------------------------------------------------------

def padded_lane_count(n_lanes: int, mesh: RankMesh | None) -> int:
    """Smallest lane count >= n_lanes divisible by the mesh's lane dim."""
    dl = mesh_lane_dim(mesh)
    return ((n_lanes + dl - 1) // dl) * dl


def padded_seed_count(n_seeds: int, mesh: RankMesh | None) -> int:
    """Smallest seed width >= n_seeds divisible by the mesh's seed dim."""
    ds = mesh_seed_dim(mesh)
    return ((n_seeds + ds - 1) // ds) * ds


def pad_group_batch(batch: dict[str, np.ndarray],
                    n_to: int) -> dict[str, np.ndarray]:
    """Pad every lane-axis array to `n_to` lanes by repeating lane 0
    (padding lanes are real, legal simulations whose outputs are dropped)."""
    if not batch:
        raise ValueError(
            "pad_group_batch: empty group batch (no arrays) — a group must "
            "hold at least one lane before it can be padded")
    n = next(iter(batch.values())).shape[0]
    if n_to == n:
        return batch
    assert n_to > n
    return {k: np.concatenate([v, np.repeat(v[:1], n_to - n, axis=0)])
            for k, v in batch.items()}


def pad_seed_axis(batch: dict[str, np.ndarray],
                  s_to: int) -> dict[str, np.ndarray]:
    """Pad the episode seed schedule's (L, S, E) seed axis to `s_to` slots
    by repeating slot 0.  Only `ep_seed` carries a seed axis."""
    eps = batch["ep_seed"]
    if eps.shape[1] == s_to:
        return batch
    assert s_to > eps.shape[1]
    out = dict(batch)
    out["ep_seed"] = np.concatenate(
        [eps, np.repeat(eps[:, :1], s_to - eps.shape[1], axis=1)], axis=1)
    return out


def _block(mesh: RankMesh, n_lanes: int, n_seeds: int):
    """This rank's (lane slice, seed slice) of an (n_lanes, n_seeds) grid
    padded to the mesh's divisors, or None past the mesh."""
    if mesh.coord is None:
        return None
    pl, ps = mesh.coord
    dl, ds = mesh.shape
    l, s = n_lanes // dl, n_seeds // ds
    return slice(pl * l, (pl + 1) * l), slice(ps * s, (ps + 1) * s)


def shard_group_batch(batch: dict[str, np.ndarray], mesh: RankMesh | None,
                      device: torch.device) -> dict[str, torch.Tensor] | None:
    """Place a (padded) group batch on this rank's device: its lane block
    of every array, and of the episode seed schedule its (lane, seed)
    block.  Without a mesh the whole batch; past the mesh None (no
    cells)."""
    if mesh is not None:
        blk = _block(mesh, batch["ep_seed"].shape[0],
                     batch["ep_seed"].shape[1])
        if blk is None:
            return None
        lanes, seeds = blk
        batch = {k: (v[lanes, seeds] if k == "ep_seed" else v[lanes])
                 for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def local_cells(mesh: RankMesh | None, n_lanes: int,
                n_seeds: int) -> list[int]:
    """The flat lane-major cell indices (lane * n_seeds + seed) this rank
    holds of an (n_lanes, n_seeds) grid, in its own lane-major order."""
    if mesh is None:
        return list(range(n_lanes * n_seeds))
    blk = _block(mesh, n_lanes, n_seeds)
    if blk is None:
        return []
    lanes, seeds = blk
    return [li * n_seeds + si for li in range(lanes.start, lanes.stop)
            for si in range(seeds.start, seeds.stop)]


def shard_agent_batch(cells: list, mesh: RankMesh | None, n_lanes: int,
                      n_seeds: int) -> list | None:
    """This rank's cells of a flat lane-major (n_lanes * n_seeds,) agent
    batch, given as its list of per-cell snapshots (stacked after the
    cut, so a rank copies only its own cells).  Past the mesh None."""
    if mesh is None:
        return cells
    return [cells[i] for i in local_cells(mesh, n_lanes, n_seeds)] or None


def replicate(x, mesh: RankMesh | None):
    """A lane-independent input (e.g. TOM candidate tables): every rank
    builds and keeps its own copy, so this is `x` itself."""
    return x


# ---------------------------------------------------------------------------
# Results back to the host
# ---------------------------------------------------------------------------

def _tree_map(fn, *trees):
    """`fn` over the leaves (tensors, arrays) of matching trees of dicts
    (their own type kept), lists, tuples and dataclasses."""
    t = trees[0]
    if t is None or isinstance(t, (torch.Tensor, np.ndarray, np.generic)):
        return fn(*trees)
    if isinstance(t, dict):
        return type(t)({k: _tree_map(fn, *(x[k] for x in trees))
                        for k in t})
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    if dataclasses.is_dataclass(t):
        return type(t)(**{f.name: _tree_map(fn, *(getattr(x, f.name)
                                                  for x in trees))
                          for f in dataclasses.fields(t)})
    return fn(*trees)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def host_fetch(tree, mesh: RankMesh | None = None,
               seeds: int | None = None):
    """Bring a tree of tensors back to host numpy.

    On a mesh every rank gets the whole result: each rank's block is
    all-gathered over the group and put at its (lane, seed) place, so the
    result is exactly what one device returns.  Leaves are (l, s, ...)
    blocks, or with `seeds` flat lane-major (l * seeds, ...) cells of
    `seeds` seed slots a lane.  A rank past the mesh passes None and gets
    the whole all the same."""
    local = None if tree is None else _tree_map(_to_numpy, tree)
    if mesh is None:
        return local
    parts = [(c, t) for c, t in _all_gather((mesh.coord, local))
             if c is not None]
    dl, ds = mesh.shape

    def place(*blocks):
        b0 = blocks[0]
        grid = b0.shape[:2] if seeds is None else (b0.shape[0] // seeds,
                                                   seeds)
        l, s = grid
        full = np.empty((dl * l, ds * s) + b0.shape[1 if seeds else 2:],
                        b0.dtype)
        for (pl, ps), b in zip((c for c, _ in parts), blocks):
            full[pl * l:(pl + 1) * l, ps * s:(ps + 1) * s] = (
                b.reshape((l, s) + b.shape[1:]) if seeds else b)
        return full.reshape((-1,) + full.shape[2:]) if seeds else full

    return _tree_map(place, *(t for _, t in parts))
