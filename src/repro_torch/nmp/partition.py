"""Partition layer of the sweep pipeline (port of `repro.nmp.partition`).

The reference builds a 2-D `jax.sharding.Mesh` ("lanes" x "seeds") over the
visible devices and shards each group batch over it.  This slice of the port
places a sweep on the caller's ONE device with no mesh, which is what the
reference does on one device (`build_mesh` returns None there): a machine
with several GPUs also runs on that one device unless the knobs below ask
for more, and a request for more than one device raises
NotImplementedError naming ROADMAP.md's multi-GPU item.  `jax.distributed`
(the reference's multi-host scaffolding) waits for the same item.

The pure functions give the reference's answers: the knobs' validation,
the auto-factored mesh shape, padded lane and seed counts, batch padding
and the mesh description and signature.

Env knobs (validated as in the reference):

  REPRO_SWEEP_DEVICES   how many devices the sweep uses: an integer, or
                        "all".  Values outside 1..len(devices) raise; an
                        explicit request for more than one device raises
                        NotImplementedError (not ported yet).
  REPRO_SWEEP_MESH      mesh shape "LANESxSEEDS" or "auto" (default).  The
                        shape must factor the selected device count; a
                        shape of more than one device raises
                        NotImplementedError (not ported yet).
"""
from __future__ import annotations

import os

import numpy as np
import torch

LANE_AXIS = "lanes"
SEED_AXIS = "seeds"
_ENV_DEVICES = "REPRO_SWEEP_DEVICES"
_ENV_MESH = "REPRO_SWEEP_MESH"
MULTI_GPU_ITEM = ("ROADMAP.md, queue 1, multi-GPU placement of run_grid "
                  "(the lane x seed mesh over several GPUs and "
                  "torch.distributed)")


def _platform(device: torch.device) -> str:
    return "gpu" if device.type == "cuda" else device.type


def visible_devices(device: str | torch.device = "cuda") -> list:
    """The devices of the run's type that this process sees."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def sweep_devices(device: str | torch.device = "cuda") -> list:
    """Devices the sweep would span, honoring REPRO_SWEEP_DEVICES."""
    devices = visible_devices(device)
    raw = os.environ.get(_ENV_DEVICES, "all").strip().lower()
    if raw in ("", "all"):
        return devices
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"{_ENV_DEVICES}={raw!r}: expected an integer or 'all'") from None
    if not 1 <= n <= len(devices):
        raise ValueError(f"{_ENV_DEVICES}={n} outside 1..{len(devices)} "
                         f"({len(devices)} {_platform(devices[0])} devices "
                         "visible)")
    return devices[:n]


def sweep_mesh_shape(n_devices: int) -> tuple[int, int] | None:
    """The (lane, seed) mesh shape forced by REPRO_SWEEP_MESH, or None when
    unset/"auto".  The shape must factor `n_devices` exactly; anything else
    raises a ValueError naming the knob, the value and the devices."""
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
            "exactly")
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


def placement(device: str | torch.device = "cuda") -> torch.device:
    """The one device a sweep runs on, after validating both knobs.  An
    explicit request for more than one device raises NotImplementedError:
    placement over several GPUs is not ported yet."""
    devices = sweep_devices(device)
    explicit = os.environ.get(_ENV_DEVICES, "").strip() != ""
    shape = sweep_mesh_shape(len(devices))
    if (explicit and len(devices) > 1) or (shape is not None
                                           and shape[0] * shape[1] > 1):
        raise NotImplementedError(
            f"{_ENV_DEVICES}={os.environ.get(_ENV_DEVICES, '')!r} / "
            f"{_ENV_MESH}={os.environ.get(_ENV_MESH, '')!r} ask for "
            f"{len(devices)} devices; the port runs a sweep on one device "
            f"until {MULTI_GPU_ITEM}")
    return torch.device(device)


def build_mesh(devices=None, shape: tuple[int, int] | None = None):
    """None on one device (no placement, as the reference on one device);
    several devices raise NotImplementedError (not ported yet)."""
    devices = sweep_devices() if devices is None else list(devices)
    if len(devices) <= 1:
        return None
    raise NotImplementedError(f"a sweep mesh over {len(devices)} devices: "
                              f"{MULTI_GPU_ITEM}")


def mesh_desc(mesh) -> dict:
    """JSON-friendly mesh description (one device: no mesh)."""
    assert mesh is None
    return {"n_devices": 1, "shape": [1, 1],
            "axis_names": [LANE_AXIS, SEED_AXIS], "n_hosts": 1}


def mesh_lane_dim(mesh) -> int:
    assert mesh is None
    return 1


def mesh_seed_dim(mesh) -> int:
    assert mesh is None
    return 1


def mesh_signature(device: str | torch.device = "cuda") -> str:
    """Stable signature of the mesh the next sweep would run on (device
    platform, device count, forced shape, host count), as the reference's:
    grid memo keys must never cross a mesh change."""
    devices = sweep_devices(device)
    shape = os.environ.get(_ENV_MESH, "auto").strip().lower() or "auto"
    return f"{_platform(devices[0])}:{len(devices)}:{shape}:1"


def padded_lane_count(n_lanes: int, mesh) -> int:
    """Smallest lane count >= n_lanes divisible by the mesh's lane dim."""
    dl = mesh_lane_dim(mesh)
    return ((n_lanes + dl - 1) // dl) * dl


def padded_seed_count(n_seeds: int, mesh) -> int:
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


def shard_group_batch(batch: dict[str, np.ndarray], mesh,
                      device: torch.device) -> dict[str, torch.Tensor]:
    """Place a group batch on the sweep's device (one host->device copy
    per array)."""
    assert mesh is None
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def host_fetch(tree):
    """Tensors of a (nested) dict, list or dataclass-free tree -> numpy."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: host_fetch(v) for k, v in tree.items()}
    return tree
