"""Roofline of a step on one card or a mesh of cards (port of
`repro/launch/roofline.py`'s `Roofline`), and the counter of a step's own
costs that stands in for the reference's HLO parser.

Three terms per (arch x shape x cards), over a `Chip` record of the card's
published peaks:

  compute_s    = FLOPs / (chips * chip.peak_flops)          bf16 dense peak
  memory_s     = HBM bytes / (chips * chip.hbm_bw)          device memory
  collective_s = collective bytes / (chips * chip.link_bw)  NVLink, each way

The collective term holds only inside one NVLink host (`chip.host_cards`
cards, all to all); `collective_net_s` charges a mesh larger than a host
at the network's rate per card (`chip.net_bw`), which every collective of
the (16, 16) production meshes crosses: their model axis spans two hosts
and their data axis one card of each of 16.

`count_step_costs(fn, *args)` runs the port's real step (DTensor params on
a mesh, or plain tensors) under `FlopCounterMode` and `CommDebugMode` and
returns an `HLOStats`-shaped record: FLOPs per card, collective bytes per
card by kind, the trip counts it was scaled by.  It stands in for the
reference's `parse_hlo_costs` / `parse_hlo_collectives` (HLO text of a
compiled step, whose FLOPs are the per-device program's).  The flash and
SSD kernels are counted by their formulas (`kernels/costs.py`), whatever
runs them.  FLOPs are each rank's own work, repeated work included: an op
on plain tensors (a local shard) at its size, an op on DTensors at its
whole size over the ranks that split it (the mesh dims its output is
sharded or partial over), so work that every rank of a mesh dim repeats
(a replicated output) counts in full on each.  `period_scaled` stands in for
`scan_corrected`: a step at full depth and microbatch count is
extrapolated from two counts at one and two super-block periods, each with
two microbatches split at their boundary (exact where each period and
each microbatch costs the same).  The reference's `_shape_bytes` (HLO shape text) has no
counterpart, nor its fusion-boundary byte count: `hbm_bytes` is 0 here,
and the dry run's byte term is `memory_model.memory_bytes`, as the
reference's.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import torch


@dataclasses.dataclass(frozen=True)
class Chip:
    """Published peaks of one card."""
    name: str
    peak_flops: float       # bf16 dense, FLOP/s
    hbm_bw: float           # device memory, bytes/s
    hbm_bytes: float        # device memory, bytes
    link_bw: float          # card-to-card, bytes/s each way
    net_bw: float = 0.0     # card to another host, bytes/s each way
    host_cards: int = 0     # cards of one host (0: no network record)


# NVIDIA H100 SXM data sheet: dense bf16, HBM3, NVLink 4 (900 GB/s a card
# to the rest of its host, 450 GB/s each way).  The rates assume the full
# 700 W power limit.  Between hosts, a DGX H100 gives each of its 8 cards
# one 400 Gb/s InfiniBand port (ConnectX-7): 50 GB/s each way.
H100 = Chip(name="NVIDIA H100 SXM", peak_flops=989e12, hbm_bw=3.35e12,
            hbm_bytes=80e9, link_bw=450e9, net_bw=400e9 / 8, host_cards=8)


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_hbm: float
    bytes_collective: float
    chips: int
    model_flops: float
    chip: Chip = H100

    @property
    def compute_s(self):
        return self.flops / (self.chips * self.chip.peak_flops)

    @property
    def memory_s(self):
        return self.bytes_hbm / (self.chips * self.chip.hbm_bw)

    @property
    def collective_s(self):
        return self.bytes_collective / (self.chips * self.chip.link_bw)

    @property
    def collective_net_s(self):
        """The collective term at the network's rate where the mesh is
        larger than one host (else `collective_s`)."""
        if not self.chip.host_cards or self.chips <= self.chip.host_cards:
            return self.collective_s
        return self.bytes_collective / (self.chips * self.chip.net_bw)

    @property
    def dominant(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self):
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self):
        return self.model_flops / max(self.flops, 1.0)

    @property
    def roofline_fraction(self):
        """Fraction of the chips' peak the step achieves, assuming perfect
        overlap (model-FLOPs time / bounding-term time)."""
        return self.fraction_at(self.step_s)

    def fraction_at(self, step_s: float) -> float:
        """The model-FLOPs share of the chips' peak of a step that takes
        `step_s` (a measured step: its model_flops / (step x peak))."""
        ideal = self.model_flops / (self.chips * self.chip.peak_flops)
        return ideal / max(step_s, 1e-12)

    def as_dict(self):
        return {
            "flops": self.flops, "bytes_hbm": self.bytes_hbm,
            "bytes_collective": self.bytes_collective, "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }



# ---------------------------------------------------------------------------
# The step's own costs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HLOStats:
    """The reference's record of a compiled step's costs, per card."""
    collective_bytes: float
    collective_ops: dict
    trip_counts: dict
    flops: float = 0.0          # per card
    hbm_bytes: float = 0.0      # no counterpart (see module doc)
    marks: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0         # this rank's allocation peak, where asked


def _comm_mode():
    from torch.distributed.tensor.debug import CommDebugMode

    class CommBytes(CommDebugMode):
        """CommDebugMode that also sums each collective's bytes on this
        rank (the larger of its local input and output) by kind."""

        def __init__(self):
            super().__init__()
            self.bytes_by_kind = defaultdict(int)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            packet = func._overloadpacket
            if packet in self.comm_registry:
                kind = packet.__name__.split(".")[-1]
                ins = [a for a in args if isinstance(a, torch.Tensor)]
                outs = out if isinstance(out, (list, tuple)) else [out]
                nb = lambda ts: sum(t.numel() * t.element_size() for t in ts
                                    if isinstance(t, torch.Tensor))
                self.bytes_by_kind[kind] += max(nb(ins), nb(outs))
            return out

    return CommBytes()


def _peak_mode(args):
    """A dispatch mode that tracks the bytes of this rank's storages the
    step allocates (a DTensor's local shard, a plain tensor's storage),
    each counted once from its first op output until it is freed, and
    keeps the peak.  The arguments' storages are known beforehand and
    never counted (an in-place update returns them).  It stands in for
    `MemTracker`, which does not see the local shards under a DTensor."""
    import weakref
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class PeakBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = self.peak = 0
            self.sizes = {}

        def _storage(self, t):
            if isinstance(t, DTensor):
                t = t._local_tensor
            return t.untyped_storage() if isinstance(t, torch.Tensor) \
                else None

        def _free(self, key):
            self.live -= self.sizes.pop(key, 0)

        def track(self, t, count: bool = True):
            st = self._storage(t)
            if st is None or id(st) in self.sizes:
                return
            n = st.nbytes() if count else 0
            self.sizes[id(st)] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, id(st))

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                self.track(t)
            return out

    mode = PeakBytes()
    for t in tree_leaves(args):
        mode.track(t, count=False)
    return mode


def _flop_mode():
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode
    from torch.utils._pytree import tree_leaves

    class RankFlops(FlopCounterMode):
        """FlopCounterMode that also sums this rank's own FLOPs (`local`):
        an op on DTensors (seen at its whole shape) over the ranks its
        first output is sharded or partial over."""

        def __init__(self):
            super().__init__(display=False)
            self.local = 0.0

        def _count_flops(self, func_packet, out, args, kwargs):
            f = self.flop_registry.get(func_packet)
            if f is not None:
                n = f(*args, **kwargs, out_val=out)
                t = next((o for o in tree_leaves(out)
                          if isinstance(o, DTensor)), None)
                if t is not None:
                    mesh = t.device_mesh
                    n /= math.prod(mesh.size(i) for i, p in
                                   enumerate(t.placements)
                                   if p.is_shard() or p.is_partial())
                self.local += n
            return out

    return RankFlops()


def count_step_costs(fn, *args, memory: bool = False, **kwargs) -> HLOStats:
    """fn(*args, **kwargs) run once under a `CommDebugMode` and
    `FlopCounterMode`, the kernels counted by their formulas: FLOPs per
    card (this rank's own work, `_flop_mode`) and collective bytes per
    card, by kind; `marks` the running totals (flops, {kind: bytes})
    at each `kernels.costs.mark()` (the train step's microbatch ends);
    with `memory`, `peak_bytes`, the peak of what the step allocates on
    this rank beyond its arguments (`_peak_mode`)."""
    import contextlib
    from repro_torch.kernels import costs
    comm = _comm_mode()
    fc = _flop_mode()
    marks = []

    def snapshot():
        marks.append((fc.local,
                      {k: float(v) for k, v in comm.bytes_by_kind.items()}))

    mem = None
    if memory:
        import gc
        gc.collect()            # an earlier trace's cycles freed first
        mem = _peak_mode((args, kwargs))
    # the comm mode outside FlopCounterMode (and the byte tracker): so
    # FlopCounterMode sees every DTensor op at its whole shape (the other
    # way round it misses most of them)
    with comm, fc, (mem or contextlib.nullcontext()), costs.counting(), \
            costs.marking(snapshot):
        fn(*args, **kwargs)
    by_kind = {k: float(v) for k, v in sorted(comm.bytes_by_kind.items())}
    peak = 0 if mem is None else mem.peak
    return HLOStats(collective_bytes=float(sum(by_kind.values())),
                    collective_ops=by_kind, trip_counts={},
                    flops=fc.local, marks=marks,
                    peak_bytes=peak)


def _parts(s: HLOStats):
    """(fixed, per microbatch) of a step traced with two microbatches, its
    marks at their ends: each microbatch costs the same, so the second's
    is the difference of the marks, and the rest is what the two leave."""
    kinds = set(s.collective_ops)
    (f1, c1), (f2, c2) = s.marks[-2], s.marks[-1]
    per = {"flops": f2 - f1}
    per.update({k: c2.get(k, 0.0) - c1.get(k, 0.0) for k in kinds})
    total = {"flops": s.flops, **s.collective_ops}
    fixed = {k: total.get(k, 0.0) - 2 * per.get(k, 0.0) for k in total}
    return fixed, per


def period_scaled(count, n_super: int, microbatches: int) -> HLOStats:
    """The costs at `n_super` super-block periods and `microbatches`
    microbatches, from `count(periods)` at 1 and 2 periods: a step's costs
    are f(n, m) = a + b n + m (c + e n) (a: the rest, b: each period's
    own, c: each microbatch's own, e: each period of each microbatch; the
    scan correction of the reference).  A training step is traced with
    two microbatches and its `marks` split the microbatch's part from the
    rest; a step without marks (prefill, decode) is a + b n.

    The allocation peak of a training step grows with its saved
    activations, a + b n from 1 and 2 periods.  A step without marks
    keeps no activations from one period to the next: its peak is one
    period's live tensors above what the earlier periods leave, and the
    first period sees fewer of those (the embedding's output in place of
    a block's residual), so its peak is read at 2 and 3 periods, p2 +
    (n - 2)(p3 - p2), where 1 and 2 periods would scale the first
    period's offset by n (qwen3-32b's prefill at S 32768: 6.38 and 6.71
    GB, 6.71 at 3 periods, extrapolated to 27.5 GB from 1 and 2)."""
    s1, s2 = count(1), count(2)
    if s1.marks:
        (fx1, pm1), (fx2, pm2) = _parts(s1), _parts(s2)
    else:
        fx1 = {"flops": s1.flops, **s1.collective_ops}
        fx2 = {"flops": s2.flops, **s2.collective_ops}
        pm1 = pm2 = {}
        microbatches = 0
    keys = set(fx1) | set(fx2)

    def lin(v1, v2):
        return v1 + (n_super - 1) * (v2 - v1)

    out = {k: lin(fx1.get(k, 0.0), fx2.get(k, 0.0))
           + microbatches * lin(pm1.get(k, 0.0), pm2.get(k, 0.0))
           for k in keys}
    ops = {k: out[k] for k in sorted(keys) if k != "flops"}
    peak = lin(s1.peak_bytes, s2.peak_bytes)
    if not s1.marks and s1.peak_bytes and n_super > 1:
        p3 = count(3).peak_bytes if n_super > 2 else s2.peak_bytes
        peak = s2.peak_bytes + (n_super - 2) * (p3 - s2.peak_bytes)
    return HLOStats(collective_bytes=float(sum(ops.values())),
                    collective_ops=ops,
                    trip_counts={"super_blocks": n_super,
                                 "microbatches": max(microbatches, 1)},
                    flops=out["flops"],
                    peak_bytes=int(peak))
