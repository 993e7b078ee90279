"""Synthetic NMP-op trace generators for the paper's nine kernels (§6.4-6.5)
(numpy port of `repro.nmp.traces`; every trace is array-equal to it).

The paper replays `<&dest += &src1 OP &src2>` traces captured from annotated
NMP regions of Rodinia/CRONO/CortexSuite kernels. Offline we synthesize traces
whose *measured* characteristics reproduce the paper's workload analysis:

  Fig. 5a  page-access-volume classes (low / moderate / heavy),
  Fig. 5b  active pages per epoch (working set),
  Fig. 5c  page affinity (radix x co-access weight quadrants).

The paper targets "long running applications ... which repeatedly use their
kernels": each generator builds one kernel-iteration access pattern and tiles
it `iters` times (with per-iteration jitter where the real kernel would not be
exactly periodic), so runtime remapping decisions can pay off on later
iterations — the effect AIMM exploits.

"""
from __future__ import annotations

import dataclasses

import numpy as np

APPS = ("BP", "LUD", "KM", "MAC", "PR", "RBM", "RD", "SC", "SPMV")


@dataclasses.dataclass
class Trace:
    name: str
    dest: np.ndarray       # (n_ops,) int32 page ids
    src1: np.ndarray
    src2: np.ndarray
    n_pages: int
    read_write: np.ndarray  # (n_pages,) bool: True => RW page (blocking migration)
    program_id: np.ndarray  # (n_ops,) int32 (0 for single-program)
    iter_ops: int = 0       # ops per kernel iteration (0 = non-periodic)

    @property
    def n_ops(self) -> int:
        return int(self.dest.shape[0])

    def as_dict(self):
        return {
            "dest": self.dest, "src1": self.src1, "src2": self.src2,
            "program_id": self.program_id,
        }


def _mk(name, dest, src1, src2, n_pages, rw_pages=None, iter_ops=0):
    dest = np.asarray(dest, np.int32)
    src1 = np.asarray(src1, np.int32)
    src2 = np.asarray(src2, np.int32)
    rw = np.zeros(n_pages, bool)
    rw[np.unique(dest)] = True           # destination pages are read-write
    if rw_pages is not None:
        rw[rw_pages] = True
    return Trace(name, dest, src1, src2, n_pages,
                 rw, np.zeros_like(dest), iter_ops)


def _tile(pattern: tuple[np.ndarray, np.ndarray, np.ndarray], n_ops: int):
    """Repeat one kernel-iteration pattern up to n_ops ops."""
    d, a, b = (np.asarray(x, np.int32) for x in pattern)
    reps = int(np.ceil(n_ops / d.size))
    return (np.tile(d, reps)[:n_ops], np.tile(a, reps)[:n_ops],
            np.tile(b, reps)[:n_ops])


def _zipf(rng, n, size, alpha):
    p = 1.0 / np.arange(1, n + 1) ** alpha
    p /= p.sum()
    return rng.choice(n, size=size, p=p)


def backprop(n_ops=8192, seed=0, iters=4) -> Trace:
    """BP: huge memory residency, small working set, low affinity/page reuse.

    One training epoch sweeps a large weight region once (weight-gradient
    accumulation) against a small hot activation set; epochs repeat.
    """
    rng = np.random.default_rng(seed)
    n_pages = 4096
    n_act = 64                                   # hot activation pages
    per = n_ops // iters
    weights = rng.permutation(n_pages - n_act)[:per] + n_act
    dest = weights                               # sweep weights (low reuse)
    src1 = rng.integers(0, n_act, per)           # activations (hot)
    src2 = np.clip(dest - 1, 0, n_pages - 1)
    return _mk("BP", *_tile((dest, src1, src2), n_ops), n_pages, iter_ops=per)


def lud(n_ops=8192, seed=1, iters=1) -> Trace:
    """LUD: blocked factorization — high active pages, high affinity.

    The k-loop itself revisits row/column panels, so no extra tiling needed.
    """
    rng = np.random.default_rng(seed)
    nb = 32                                      # blocks per matrix dim
    n_pages = nb * nb
    dest, src1, src2 = [], [], []
    k = 0
    while len(dest) < n_ops:
        k = (k + 1) % (nb - 1)
        # trailing submatrix update: A[i,j] -= A[i,k] * A[k,j]
        ii = rng.integers(k + 1, nb, size=min(256, n_ops - len(dest)))
        jj = rng.integers(k + 1, nb, size=ii.size)
        dest.extend(ii * nb + jj)
        src1.extend(ii * nb + k)
        src2.extend(k * nb + jj)
    return _mk("LUD", dest[:n_ops], src1[:n_ops], src2[:n_ops], n_pages)


def kmeans(n_ops=8192, seed=2, iters=4) -> Trace:
    """KM: centroid pages extremely hot; points re-streamed every iteration."""
    rng = np.random.default_rng(seed)
    n_pages = 512
    k = 16
    per = n_ops // iters
    pts = rng.integers(k, n_pages, per)
    cent = rng.integers(0, k, per)
    return _mk("KM", *_tile((cent, pts, cent), n_ops), n_pages, iter_ops=per)


def mac(n_ops=8192, seed=3, iters=2) -> Trace:
    """MAC: multiply-accumulate over two sequential vectors; streaming, low reuse."""
    n_pages = 1024
    v = n_pages // 2 - 8
    per = n_ops // iters
    i = np.arange(per)
    src1 = 8 + (i * 7919) % v            # strided walk over vector A region
    src2 = 8 + v + (i * 7919) % v        # matching walk over vector B
    dest = (i // 64) % 8                 # few accumulator pages (hot dests)
    return _mk("MAC", *_tile((dest, src1, src2), n_ops), n_pages, iter_ops=per)


def pagerank(n_ops=16384, seed=4, iters=4) -> Trace:
    """PR: power-law graph; rank iterations repeat the edge list (large WS,
    high radix, many lightly-accessed pages)."""
    rng = np.random.default_rng(seed)
    n_pages = 2048
    per = n_ops // iters
    dst_nodes = _zipf(rng, n_pages, per, alpha=1.1)   # rank[dst] += rank[src]/deg
    src_nodes = _zipf(rng, n_pages, per, alpha=0.7)
    deg = rng.integers(0, n_pages, per)               # degree table access
    return _mk("PR", *_tile((dst_nodes, src_nodes, deg), n_ops), n_pages, iter_ops=per)


def rbm(n_ops=8192, seed=5, iters=8) -> Trace:
    """RBM: bipartite visible/hidden — tiny page set, nearly all active, high
    affinity, heavy reuse across contrastive-divergence epochs."""
    rng = np.random.default_rng(seed)
    n_pages = 96
    nv = 48
    per = n_ops // iters
    hid = rng.integers(nv, n_pages, per)
    vis = rng.integers(0, nv, per)
    w = rng.integers(0, n_pages, per)
    return _mk("RBM", *_tile((hid, vis, w), n_ops), n_pages, iter_ops=per)


def reduce_(n_ops=8192, seed=6, iters=2) -> Trace:
    """RD: sum reduction over a sequential vector; very low reuse."""
    n_pages = 1024
    per = n_ops // iters
    i = np.arange(per)
    src1 = 4 + i % (n_pages - 4)
    src2 = 4 + (i + 1) % (n_pages - 4)
    dest = i % 4                               # accumulator tree root pages
    return _mk("RD", *_tile((dest, src1, src2), n_ops), n_pages, iter_ops=per)


def streamcluster(n_ops=8192, seed=7, iters=4) -> Trace:
    """SC: stream points vs medium-sized center set (user-determined WS)."""
    rng = np.random.default_rng(seed)
    n_pages = 768
    n_centers = 96
    per = n_ops // iters
    centers = rng.integers(0, n_centers, per)
    pts = (np.arange(per) * 13) % (n_pages - n_centers) + n_centers
    return _mk("SC", *_tile((centers, pts, centers), n_ops), n_pages, iter_ops=per)


def spmv(n_ops=8192, seed=8, iters=4) -> Trace:
    """SPMV: iterative solver — irregular column gathers, ~10 active pages per
    window, same matrix re-multiplied every iteration."""
    rng = np.random.default_rng(seed)
    n_pages = 1024
    n_rows = 64                                # output vector pages
    per = n_ops // iters
    row_of_op = np.repeat(np.arange(per // 32 + 1) % n_rows, 32)[:per]
    cols = _zipf(rng, n_pages - n_rows, per, alpha=0.9) + n_rows
    x = _zipf(rng, n_pages - n_rows, per, alpha=1.2) + n_rows
    return _mk("SPMV", *_tile((row_of_op, cols, x), n_ops), n_pages, iter_ops=per)


_GENERATORS = {
    "BP": backprop, "LUD": lud, "KM": kmeans, "MAC": mac, "PR": pagerank,
    "RBM": rbm, "RD": reduce_, "SC": streamcluster, "SPMV": spmv,
}


def make_trace(app: str, n_ops: int = 8192, seed: int | None = None,
               **kw) -> Trace:
    gen = _GENERATORS[app.upper()]
    kw["n_ops"] = n_ops
    if seed is not None:
        kw["seed"] = seed
    return gen(**kw)


def merge_traces(traces: list[Trace], interleave: int = 32) -> Trace:
    """Multi-program workload: interleave traces round-robin in `interleave`-op
    bursts with disjoint (offset) page spaces, as in the paper's shared-resource
    baseline (§7.5.2)."""
    offsets = np.cumsum([0] + [t.n_pages for t in traces[:-1]])
    n_pages = sum(t.n_pages for t in traces)
    streams = []
    for pid, (t, off) in enumerate(zip(traces, offsets)):
        streams.append({
            "dest": t.dest + off, "src1": t.src1 + off, "src2": t.src2 + off,
            "program_id": np.full(t.n_ops, pid, np.int32),
        })
    n_total = sum(t.n_ops for t in traces)
    cols = {k: np.zeros(n_total, np.int32) for k in ("dest", "src1", "src2", "program_id")}
    ptrs = [0] * len(traces)
    pos = 0
    while pos < n_total:
        for pid, t in enumerate(traces):
            take = min(interleave, t.n_ops - ptrs[pid], n_total - pos)
            if take <= 0:
                continue
            for k in cols:
                cols[k][pos:pos + take] = streams[pid][k][ptrs[pid]:ptrs[pid] + take]
            ptrs[pid] += take
            pos += take
    rw = np.zeros(n_pages, bool)
    for t, off in zip(traces, offsets):
        rw[off:off + t.n_pages] = t.read_write
    name = "+".join(t.name for t in traces)
    iter_ops = sum(t.iter_ops or t.n_ops for t in traces)
    return Trace(name, cols["dest"], cols["src1"], cols["src2"], n_pages, rw,
                 cols["program_id"], iter_ops)


def program_of_page(trace: Trace) -> np.ndarray:
    """Recover page->program ownership (for the HOARD allocator)."""
    owner = np.zeros(trace.n_pages, np.int32)
    for arr in (trace.dest, trace.src1, trace.src2):
        owner[arr] = trace.program_id
    return owner


# ---------------------------------------------------------------------------
# Workload analysis (reproduces Fig. 5)
# ---------------------------------------------------------------------------

def analyze(trace: Trace, epoch: int = 250) -> dict:
    """Page-access classes, active pages per epoch, affinity quadrants."""
    pages = np.concatenate([trace.dest, trace.src1, trace.src2])
    counts = np.bincount(pages, minlength=trace.n_pages)
    used = counts[counts > 0]
    q1, q2 = np.quantile(used, [0.5, 0.9]) if used.size else (0, 0)
    classes = {
        "low": float((used <= max(q1, 2)).mean()) if used.size else 0.0,
        "moderate": float(((used > max(q1, 2)) & (used <= q2)).mean()) if used.size else 0.0,
        "heavy": float((used > q2).mean()) if used.size else 0.0,
    }
    n_epochs = max(trace.n_ops // epoch, 1)
    active = []
    for e in range(n_epochs):
        w = slice(e * epoch, (e + 1) * epoch)
        active.append(len(np.unique(np.concatenate(
            [trace.dest[w], trace.src1[w], trace.src2[w]]))))
    # affinity: radix = distinct partner pages; weight = co-access count
    pairs = np.stack([
        np.concatenate([trace.dest, trace.dest, trace.src1]),
        np.concatenate([trace.src1, trace.src2, trace.src2]),
    ], 1)
    key = pairs[:, 0].astype(np.int64) * trace.n_pages + pairs[:, 1]
    uniq, wcnt = np.unique(key, return_counts=True)
    a = uniq // trace.n_pages
    radix = np.bincount(a.astype(np.int64), minlength=trace.n_pages)
    return {
        "classes": classes,
        "active_pages_mean": float(np.mean(active)),
        "radix_mean": float(radix[radix > 0].mean()) if (radix > 0).any() else 0.0,
        "edge_weight_mean": float(wcnt.mean()) if wcnt.size else 0.0,
        "n_pages_used": int((counts > 0).sum()),
    }
