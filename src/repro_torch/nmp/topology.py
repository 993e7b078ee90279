"""Pluggable memory-cube topology layer: precomputed routing tensors
(port of `repro.nmp.topology`).

A `Topology` is built host-side once per (topology name, geometry) with
numpy, exactly as the reference builds it, and `topology_tensors` moves its
tables to the run's device once per (config, device):

  hops        (C, C)    i32   path length (link traversals) of route s->d
  route_links (C, C, L) f32   0/1 incidence: link l lies on route s->d
  routes_flat (C*C, L)  f32   the same, pair-flattened (kernel layout)
  hops_flat   (C*C,)    f32   hops, pair-flattened (exact small ints)
  nearest_mc  (C,)      i32   cube -> nearest memory controller index
  nbr/nbr_valid (C, D)        neighbour table for the "near" remap actions
  far         (C,)      i32   "far" remap target per cube

Builders: `mesh2d` (the paper's XY-routed mesh), `torus2d`, `ring` and
`dragonfly` (deterministic BFS minimal routes).  Every builder satisfies
`hops[s, d] == route_links[s, d].sum()` (asserted at build time).
"""
from __future__ import annotations

import dataclasses
import functools
from collections import deque

import numpy as np

import torch

from repro_torch.nmp.config import NMPConfig


@dataclasses.dataclass(frozen=True)
class Topology:
    """Host-side routing tensors for one cube interconnect (see module doc).
    All arrays are numpy; `topology_tensors` moves them to a device."""
    name: str
    n_cubes: int
    n_links: int
    mc_cubes: tuple[int, ...]
    hops: np.ndarray           # (C, C) int32
    route_links: np.ndarray    # (C, C, L) float32, 0/1
    nearest_mc: np.ndarray     # (C,) int32
    nbr: np.ndarray            # (C, D) int32 neighbor table (self-padded)
    nbr_valid: np.ndarray      # (C, D) bool
    far: np.ndarray            # (C,) int32 "far" remap target
    # Kernel-friendly layouts of the same tensors (see kernels/epoch_fused):
    # pair-indexed flattenings so the fused epoch kernel can express the
    # route gather + einsum as one-hot matmuls over a (C*C, ...) table.
    routes_flat: np.ndarray    # (C*C, L) float32 == route_links.reshape
    hops_flat: np.ndarray      # (C*C,) float32 == hops.reshape (exact ints)


# ---------------------------------------------------------------------------
# Generic graph machinery (shared by the non-mesh builders)
# ---------------------------------------------------------------------------

def hop_count(topo: Topology, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """Route length (link traversals) between cube ids: a gather from the
    hop matrix, on `a`'s device."""
    hops = torch.from_numpy(np.ascontiguousarray(topo.hops)).to(a.device)
    return hops[a.long(), b.long()]


def link_loads(topo: Topology, src: torch.Tensor, dst: torch.Tensor,
               weight: torch.Tensor) -> torch.Tensor:
    """Flow `weight` (flits) accumulated over every link on each route.

    src, dst: (F,) cube ids; weight: (F,) flits.  Returns (n_links,) float32
    loads: one gather of the route-link incidence rows and one product
    (exact for flit-count weights in any summation order)."""
    routes = torch.from_numpy(np.ascontiguousarray(topo.route_links)).to(
        src.device)[src.long(), dst.long()]                    # (F, L)
    return torch.einsum("f,fl->l", weight.to(torch.float32), routes)


def _routes_from_edges(n_cubes: int, edges: list[tuple[int, int]]
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(hops, route_links) for minimal routing over an undirected edge list.

    Deterministic BFS from every source (neighbors visited in ascending cube
    order, first-discovered parent wins), so route choice is stable across
    builds.  `edges[l]` defines link id l."""
    L = len(edges)
    adj: list[list[tuple[int, int]]] = [[] for _ in range(n_cubes)]
    for l, (a, b) in enumerate(edges):
        adj[a].append((b, l))
        adj[b].append((a, l))
    for lst in adj:
        lst.sort()
    hops = np.full((n_cubes, n_cubes), -1, np.int32)
    routes = np.zeros((n_cubes, n_cubes, L), np.float32)
    for s in range(n_cubes):
        parent = np.full(n_cubes, -1, np.int64)
        plink = np.full(n_cubes, -1, np.int64)
        hops[s, s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for v, l in adj[u]:
                if hops[s, v] < 0:
                    hops[s, v] = hops[s, u] + 1
                    parent[v], plink[v] = u, l
                    q.append(v)
        if (hops[s] < 0).any():
            missing = np.flatnonzero(hops[s] < 0)
            raise ValueError(f"disconnected topology: cube {s} cannot reach "
                             f"cubes {missing.tolist()}")
        for d in range(n_cubes):
            u = d
            while u != s:
                routes[s, d, plink[u]] = 1.0
                u = parent[u]
    return hops, routes


def _nbr_from_edges(n_cubes: int, edges: list[tuple[int, int]]
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Self-padded (C, D) neighbor table from an edge list (ascending order)."""
    neigh: list[list[int]] = [[] for _ in range(n_cubes)]
    for a, b in edges:
        neigh[a].append(b)
        neigh[b].append(a)
    D = max(len(n) for n in neigh)
    nbr = np.tile(np.arange(n_cubes, dtype=np.int32)[:, None], (1, D))
    valid = np.zeros((n_cubes, D), bool)
    for c, lst in enumerate(neigh):
        lst = sorted(lst)
        nbr[c, :len(lst)] = lst
        valid[c, :len(lst)] = True
    return nbr, valid


def _far_by_hops(hops: np.ndarray) -> np.ndarray:
    """Farthest cube per cube (ties -> lowest cube id)."""
    return np.argmax(hops, axis=1).astype(np.int32)


def _nearest_mc(hops: np.ndarray, mc_cubes: tuple[int, ...]) -> np.ndarray:
    """Cube -> nearest-MC index (ties broken by MC order)."""
    return np.argmin(hops[:, list(mc_cubes)], axis=1).astype(np.int32)


def _spread_mc_cubes(n_cubes: int, n_mcs: int) -> tuple[int, ...]:
    """Evenly spaced MC attachment points for topologies without corners
    (distinct whenever n_cubes >= n_mcs; `_finish` rejects the rest)."""
    return tuple(int(round(i * n_cubes / n_mcs)) % n_cubes
                 for i in range(n_mcs))


def _finish(name: str, cfg: NMPConfig, edges: list[tuple[int, int]],
            mc_cubes: tuple[int, ...], *,
            hops: np.ndarray | None = None,
            routes: np.ndarray | None = None,
            nbr: np.ndarray | None = None,
            nbr_valid: np.ndarray | None = None,
            far: np.ndarray | None = None) -> Topology:
    """Assemble + validate a Topology (conservation asserted at build time)."""
    C = cfg.n_cubes
    if hops is None or routes is None:
        hops, routes = _routes_from_edges(C, edges)
    if nbr is None or nbr_valid is None:
        nbr, nbr_valid = _nbr_from_edges(C, edges)
    if far is None:
        far = _far_by_hops(hops)
    np.testing.assert_array_equal(routes.sum(axis=-1), hops,
                                  err_msg=f"{name}: route length != hops")
    assert (hops == hops.T).all(), f"{name}: asymmetric hop matrix"
    if len(set(mc_cubes)) != len(mc_cubes):
        # Silently piling several controllers onto one cube would leave the
        # cost model injecting at n_mcs rates while routing to fewer live
        # MCs — refuse the degenerate geometry instead.
        raise ValueError(f"{name}: duplicate MC attachment cubes {mc_cubes} "
                         f"(geometry too small for {len(mc_cubes)} MCs)")
    if len(mc_cubes) != cfg.n_mcs:
        # The engine sizes its MC-queue state to cfg.n_mcs; an attachment
        # list of any other length would silently drop scattered traffic
        # (out-of-bounds scatter) or leave dead queue slots.  mesh2d/torus2d
        # pin one MC per CMP corner, so they only support n_mcs == 4.
        raise ValueError(f"{name}: {len(mc_cubes)} MC attachment cubes for "
                         f"n_mcs={cfg.n_mcs}")
    return Topology(name=name, n_cubes=C, n_links=len(edges),
                    mc_cubes=tuple(int(m) for m in mc_cubes),
                    hops=hops.astype(np.int32), route_links=routes,
                    nearest_mc=_nearest_mc(hops, mc_cubes),
                    nbr=nbr, nbr_valid=nbr_valid, far=far.astype(np.int32),
                    routes_flat=np.ascontiguousarray(
                        routes.reshape(C * C, len(edges))),
                    hops_flat=hops.reshape(C * C).astype(np.float32))


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def mesh2d(cfg: NMPConfig) -> Topology:
    """The paper's 2D mesh with static XY routing — bit-identical to the
    historical `nmp.network` model.

    Link indexing (undirected, contention aggregates both directions):
      horizontal link (y, x <-> x+1):  id = y * (X-1) + x      for x in [0, X-1)
      vertical   link (x, y <-> y+1):  id = H + x * (Y-1) + y  for y in [0, Y-1)
    XY routes traverse X at the source row, then Y at the destination column.
    The neighbor table keeps the historical candidate slot order
    [x-1, x+1, y-1, y+1] (invalid slots = self) and `far` is the historical
    mirror through the array center — NOT the hop-farthest cube."""
    X, Y = cfg.mesh_x, cfg.mesh_y
    C = X * Y
    H = Y * (X - 1)
    L = H + X * (Y - 1)
    edges = ([(y * X + x, y * X + x + 1) for y in range(Y)
              for x in range(X - 1)]
             + [(y * X + x, (y + 1) * X + x) for x in range(X)
                for y in range(Y - 1)])
    assert len(edges) == L

    cx, cy = np.arange(C) % X, np.arange(C) // X
    hops = (np.abs(cx[:, None] - cx[None, :])
            + np.abs(cy[:, None] - cy[None, :])).astype(np.int32)
    routes = np.zeros((C, C, L), np.float32)
    for s in range(C):
        for d in range(C):
            sx, sy, dx, dy = cx[s], cy[s], cx[d], cy[d]
            for x in range(min(sx, dx), max(sx, dx)):     # X at the source row
                routes[s, d, sy * (X - 1) + x] = 1.0
            for y in range(min(sy, dy), max(sy, dy)):     # Y at the dest column
                routes[s, d, H + dx * (Y - 1) + y] = 1.0

    # historical candidate slot order: [x-1, x+1, y-1, y+1]
    cand_x = np.stack([cx - 1, cx + 1, cx, cx], axis=1)
    cand_y = np.stack([cy, cy, cy - 1, cy + 1], axis=1)
    valid = ((cand_x >= 0) & (cand_x < X) & (cand_y >= 0) & (cand_y < Y))
    nbr = np.where(valid, cand_y * X + cand_x, np.arange(C)[:, None])
    far = ((Y - 1 - cy) * X + (X - 1 - cx)).astype(np.int32)
    return _finish("mesh2d", cfg, edges, cfg.mc_cubes, hops=hops,
                   routes=routes, nbr=nbr.astype(np.int32),
                   nbr_valid=valid, far=far)


def torus2d(cfg: NMPConfig) -> Topology:
    """2D torus: the mesh plus X/Y wraparound links (every row and column is
    a ring).  Minimal routes via deterministic BFS; the corner MCs of the
    mesh keep their attachment points (the torus has no corners, but the
    package pins the controllers)."""
    X, Y = cfg.mesh_x, cfg.mesh_y
    edges = [(y * X + x, y * X + (x + 1) % X) for y in range(Y)
             for x in range(X if X > 2 else X - 1)]
    edges += [(y * X + x, ((y + 1) % Y) * X + x) for x in range(X)
              for y in range(Y if Y > 2 else Y - 1)]
    return _finish("torus2d", cfg, edges, cfg.mc_cubes)


def ring(cfg: NMPConfig) -> Topology:
    """Single bidirectional ring over all C cubes (cube i <-> i+1 mod C) —
    the cheapest interconnect, the worst bisection.  MCs attach at evenly
    spaced cubes."""
    C = cfg.n_cubes
    edges = [(i, (i + 1) % C) for i in range(C if C > 2 else C - 1)]
    return _finish("ring", cfg, edges, _spread_mc_cubes(C, cfg.n_mcs))


def dragonfly(cfg: NMPConfig) -> Topology:
    """Dragonfly: `mesh_y` groups of `mesh_x` cubes, all-to-all links inside
    each group, one global link per group pair (attached round-robin over
    each group's cubes).  Minimal group-direct routes (<= 3 hops) via BFS.
    MCs attach at evenly spaced cubes (the first cube of each group on the
    default square geometry)."""
    a, g = cfg.mesh_x, cfg.mesh_y
    C = a * g
    edges = [(gi * a + i, gi * a + j) for gi in range(g)
             for i in range(a) for j in range(i + 1, a)]
    for g1 in range(g):
        for g2 in range(g1 + 1, g):
            edges.append((g1 * a + g2 % a, g2 * a + g1 % a))
    return _finish("dragonfly", cfg, edges, _spread_mc_cubes(C, cfg.n_mcs))


TOPOLOGIES: dict[str, callable] = {
    "mesh2d": mesh2d,
    "torus2d": torus2d,
    "ring": ring,
    "dragonfly": dragonfly,
}


def validate_topology(name: str) -> str:
    """Return `name` if it names a registered builder, else raise — the one
    validation every layer (config resolution, scenario builders, plan)
    shares."""
    if name not in TOPOLOGIES:
        raise ValueError(f"unknown topology {name!r}; expected one of "
                         f"{sorted(TOPOLOGIES)}")
    return name


def build_topology(cfg: NMPConfig) -> Topology:
    """Build the routing tensors `cfg.topology` declares (uncached)."""
    return TOPOLOGIES[validate_topology(cfg.topology)](cfg)


@functools.lru_cache(maxsize=None)
def _build_cached(topology: str, mesh_x: int, mesh_y: int,
                  n_mcs: int) -> Topology:
    return build_topology(NMPConfig(topology=topology, mesh_x=mesh_x,
                                    mesh_y=mesh_y, n_mcs=n_mcs))


def get_topology(cfg: NMPConfig) -> Topology:
    """Cached host-side routing tensors for a config.  The cache keys on the
    fields the builders actually read (topology name + geometry), so configs
    differing only in timing/cache knobs share one tensor set."""
    return _build_cached(cfg.topology, cfg.mesh_x, cfg.mesh_y, cfg.n_mcs)


@dataclasses.dataclass(frozen=True)
class TopoTensors:
    """A Topology's tables on one device (see module doc)."""
    n_cubes: int
    n_links: int
    hops: torch.Tensor          # (C, C) int32
    route_links: torch.Tensor   # (C, C, L) float32
    routes_flat: torch.Tensor   # (C*C, L) float32
    hops_flat: torch.Tensor     # (C*C,) float32
    nearest_mc: torch.Tensor    # (C,) int32
    nbr: torch.Tensor           # (C, D) int32
    nbr_valid: torch.Tensor     # (C, D) bool
    far: torch.Tensor           # (C,) int32


_TENSOR_CACHE: dict = {}


def topology_tensors(cfg: NMPConfig, device: torch.device) -> TopoTensors:
    """`get_topology(cfg)`'s tables on `device`, moved there once per
    (geometry, device) and reused by every epoch afterwards."""
    key = (cfg.topology, cfg.mesh_x, cfg.mesh_y, cfg.n_mcs, str(device))
    if key not in _TENSOR_CACHE:
        t = get_topology(cfg)
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        _TENSOR_CACHE[key] = TopoTensors(
            n_cubes=t.n_cubes, n_links=t.n_links, hops=on(t.hops),
            route_links=on(t.route_links), routes_flat=on(t.routes_flat),
            hops_flat=on(t.hops_flat), nearest_mc=on(t.nearest_mc),
            nbr=on(t.nbr), nbr_valid=on(t.nbr_valid), far=on(t.far))
    return _TENSOR_CACHE[key]
