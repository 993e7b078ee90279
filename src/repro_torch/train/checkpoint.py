"""Checkpoints with atomic commits, retention, async writes and corruption-
detecting restore (port of `repro.train.checkpoint`): the fault-tolerance
substrate of the continual-learning `PolicyStore`.

The on-disk format is the reference's, so either package reads what the
other wrote:

  <dir>/step_<k:09d>.tmp/...   while writing
  <dir>/step_<k:09d>/          after the atomic rename (commit point)
      meta.json                step, extras, and per leaf its shape, dtype
                               and crc32
      shard_<host>.npz         the leaf arrays, one entry per leaf key

Every file is flushed and fsync'd before the tmp directory is renamed over
the final name (and the parent directory fsync'd after), so a process
killed at any byte leaves either no `step_<k>` or a complete one.  bf16
leaves are stored as a uint16 view tagged "bfloat16" and decoded with a
torch view.  `restore` checks every leaf against its crc32 and, when no
step is named, falls back to the newest intact step.

Leaf keys are the reference's `jax.tree_util` path strings, emitted by
`core.tree.leaf_paths` and mapped back by `core.tree.unflatten`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.tree import Tree, leaf_paths, unflatten


class CheckpointCorruptError(RuntimeError):
    """A checkpoint step failed integrity verification (unreadable meta or
    shard, missing leaf, or per-leaf checksum mismatch)."""


def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array that goes to disk: bf16 tensors as their
    uint16 bit pattern (see `_write`)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    return np.asarray(leaf)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                      # pragma: no cover - exotic fs
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def decode_leaf(a: np.ndarray, dtype_str: str):
    """Undo the on-disk encoding of one leaf: a "bfloat16" leaf (stored as
    a uint16 view, numpy has no bf16) comes back as a bf16 CPU tensor
    viewing the same bytes; any other leaf is returned as it is."""
    if dtype_str == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    return a


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # -- write ----------------------------------------------------------
    def save(self, step: int, tree: Tree, extras: dict | None = None,
             host_id: int = 0):
        arrays, bf16 = {}, set()
        for k, v in leaf_paths(tree):
            arrays[k] = _host(v)
            if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
                bf16.add(k)
        meta = {
            "step": step,
            "extras": extras or {},
            "leaves": {k: {"shape": list(a.shape),
                           "dtype": "bfloat16" if k in bf16 else str(a.dtype)}
                       for k, a in arrays.items()},
        }
        self.wait()
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, arrays, meta, host_id))
            self._thread.start()
        else:
            self._write(step, arrays, meta, host_id)

    def _write_guarded(self, *args):
        try:
            self._write(*args)
        except BaseException as e:       # re-raised by wait()
            self._exc = e

    def _write(self, step, arrays, meta, host_id):
        tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
        final = os.path.join(self.dir, f"step_{step:09d}")
        if os.path.exists(tmp):          # stale tmp from a killed writer
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        # bf16 leaves already arrive as their uint16 view (`_host`)
        for k, a in arrays.items():
            meta["leaves"][k]["crc32"] = zlib.crc32(a.tobytes())
        shard = os.path.join(tmp, f"shard_{host_id}.npz")
        np.savez(shard, **arrays)
        _fsync_file(shard)
        meta_path = os.path.join(tmp, "meta.json")
        with open(meta_path, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):
            # overwrite (resume-from-older-step rewrites stale later steps);
            # a kill between these two calls loses only the stale step —
            # restore falls back to the next newest intact one.
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic commit
        _fsync_dir(self.dir)
        self._gc()

    def wait(self):
        """Block until the in-flight async write finishes.  Re-raises the
        writer's exception if it failed, so a failed save cannot masquerade
        as success."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- read -----------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if (d.startswith("step_") and not d.endswith(".tmp")
                    and d.split("_", 1)[1].isdigit()):
                out.append(int(d.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_meta(self, step: int | None = None) -> dict:
        """Checkpoint metadata (step, extras, per-leaf shapes/dtypes/crcs)
        without loading any arrays.  Raises `CheckpointCorruptError` on
        unreadable or malformed metadata."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints in {self.dir!r}: the directory holds no "
                "committed step_<k> entries (nothing was ever saved here, "
                "or every save was torn before its atomic commit)")
        path = os.path.join(self.dir, f"step_{step:09d}", "meta.json")
        try:
            with open(path) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CheckpointCorruptError(
                f"unreadable checkpoint metadata {path}: {e}") from e
        if not isinstance(meta, dict) or "leaves" not in meta:
            raise CheckpointCorruptError(
                f"malformed checkpoint metadata {path}")
        return meta

    def load_arrays(self, step: int, host_id: int = 0
                    ) -> tuple[dict, dict, set[str]]:
        """One step's raw (still encoded) arrays with integrity checks:
        `(arrays, meta, bad_keys)`, where `bad_keys` holds every leaf that is
        missing, unreadable or fails its recorded crc32.  Raises
        `CheckpointCorruptError` only when the step is unreadable as a whole
        (garbage meta, missing or unopenable shard file)."""
        meta = self.read_meta(step)
        path = os.path.join(self.dir, f"step_{step:09d}",
                            f"shard_{host_id}.npz")
        try:
            data = np.load(path)
        except Exception as e:
            raise CheckpointCorruptError(
                f"unreadable checkpoint shard {path}: {e}") from e
        arrays: dict[str, np.ndarray] = {}
        bad: set[str] = set()
        try:
            for key, rec in meta["leaves"].items():
                try:
                    a = data[key]
                except Exception:
                    bad.add(key)
                    continue
                crc = rec.get("crc32")
                if crc is not None and zlib.crc32(a.tobytes()) != crc:
                    bad.add(key)
                    continue
                arrays[key] = a
        finally:
            data.close()
        return arrays, meta, bad

    def verify(self, step: int, host_id: int = 0) -> bool:
        """True iff every leaf of `step` loads and matches its checksum."""
        try:
            _, _, bad = self.load_arrays(step, host_id)
        except (CheckpointCorruptError, FileNotFoundError):
            return False
        return not bad

    def newest_intact_step(self, host_id: int = 0) -> int | None:
        for s in reversed(self.all_steps()):
            if self.verify(s, host_id):
                return s
        return None

    def restore(self, template: Tree, step: int | None = None,
                device: str | torch.device = "cuda", host_id: int = 0,
                shardings: Tree | None = None, mesh=None
                ) -> tuple[Tree, dict]:
        """Restore onto `template`'s structure, every leaf a tensor on
        `device`; or, given `shardings` (a tree of `policies.Sharding`
        over `template`) and the `mesh` they place on, every leaf a DTensor
        of its placements there, this rank keeping its own slice of the
        whole array that every rank reads (`policies.local_slice`, moved
        to the mesh's device; no collective): the reference's resharding
        restore, onto any mesh whatever mesh wrote the checkpoint.

        An explicitly requested corrupt `step` raises
        `CheckpointCorruptError`.  With `step=None`, corrupt steps are
        skipped newest-first until an intact one restores (the count is
        `fallback_steps_skipped` in the returned info dict)."""
        if shardings is not None:
            if mesh is None:
                raise ValueError("restore: shardings need the mesh they "
                                 "place on")
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if mesh.device_type == "cuda"
                   else torch.device(mesh.device_type))
        else:
            dev = resolve_device(device)
        explicit = step is not None
        steps = [step] if explicit else list(reversed(self.all_steps()))
        if not steps:
            raise FileNotFoundError(
                f"no checkpoints in {self.dir!r}: the directory holds no "
                "committed step_<k> entries")
        skipped = 0
        last_err: Exception | None = None
        for s in steps:
            try:
                # with shardings: whole on the host, each rank's slice moved
                tree, info = self._restore_step(
                    template, s, dev if shardings is None
                    else torch.device("cpu"), host_id)
                if shardings is not None:
                    tree = _placed(tree, shardings, mesh, dev)
                info["fallback_steps_skipped"] = skipped
                return tree, info
            except CheckpointCorruptError as e:
                if explicit:
                    raise
                skipped += 1
                last_err = e
        raise CheckpointCorruptError(
            f"no intact checkpoint step in {self.dir!r} "
            f"({skipped} corrupt step(s) skipped): {last_err}")

    def _restore_step(self, template: Tree, step: int, device: torch.device,
                      host_id: int) -> tuple[Tree, dict]:
        arrays, meta, bad = self.load_arrays(step, host_id)
        leaves = {}
        for key, _leaf in leaf_paths(template):
            if key in bad or key not in arrays:
                raise CheckpointCorruptError(
                    f"checkpoint step {step} leaf {key!r} is missing or "
                    "fails its checksum")
            a = decode_leaf(arrays[key], meta["leaves"][key]["dtype"])
            leaves[key] = torch.as_tensor(a).to(device)
        tree = unflatten(template, leaves)
        return tree, {"step": meta["step"], **meta["extras"]}


def _placed(tree: Tree, shardings: Tree, mesh, device) -> Tree:
    """A restored tree's whole host tensors as DTensors of their
    shardings' placements, each rank's slice on `device`."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.policies import _walk, local_slice

    def one(_, full, sh):
        local = local_slice(full, mesh, sh.placements).to(
            device, copy=True, memory_format=torch.contiguous_format)
        return DTensor.from_local(local, mesh, sh.placements,
                                  run_check=False, shape=full.shape,
                                  stride=full.stride())
    return _walk(one, tree, shardings)
