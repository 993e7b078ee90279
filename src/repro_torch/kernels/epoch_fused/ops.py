"""Wrappers of the fused epoch-core kernels.

`fused_epoch_call` runs the shared stage, the route stage or both for a
batch of B lanes, in the reference's three call shapes (`shared_parts`: the
seed-invariant half once per lane; `route_parts`: the route half once per
seed cell; `fused_parts`: both in one launch, the serial runner's path).
`tom_scores` scores the TOM candidates alone; given `tom_cands`, the shared
stage scores them in its own launch (SharedParts.tom_scores, as the
reference's SharedEpoch carries them).  Each takes the plain version
(ref.py) for CPU tensors and launches its CUDA kernel (csrc/epoch_fused.cu)
for CUDA tensors; anything else raises, and there is no fallback from
kernel to plain.  `launches` counts kernel launches and nothing else:
`fused_epoch` every launch of the fused kernel, `tom_scores_folded` those
of them that scored the TOM candidates, `tom_scores` the standalone
scorer's; `launches_by_shape` splits them by call shape and batch B.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.epoch_fused import ref
from repro_torch.kernels.epoch_fused.ref import RouteParts, SharedParts
from repro_torch.nmp.baselines import tom_score_constants
from repro_torch.nmp.topology import TopoTensors

launches = {"fused_epoch": 0, "tom_scores": 0, "tom_scores_folded": 0}
# the same launches by call shape and batch, e.g. "shared+tom B=15"
launches_by_shape: dict[str, int] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    launches_by_shape.clear()


def _count_shape(key: str) -> None:
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1


_FUSED_ARGTYPES = ([ctypes.c_void_p] * 30 + [ctypes.c_int] * 11
                   + [ctypes.c_float])
_ARGTYPES = {
    "fused_epoch_launch": _FUSED_ARGTYPES + [ctypes.c_void_p],
    "fused_epoch_tom_launch": _FUSED_ARGTYPES + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "tom_scores_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
}


def _launcher(name: str):
    """(library, its C launcher `name` with argument types set)."""
    lib = build.load("epoch_fused")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _checked_cands(cands, P, dev):
    """The (K, P) i32 candidate tables, checked; K in the kernels' 1..32."""
    K = cands.shape[0] if cands.dim() == 2 else 0
    if not 0 < K <= 32:
        raise ValueError(f"tom_scores: K={K} candidates, kernel takes 1..32")
    return _checked("tom_cands", cands, torch.int32, (K, P), dev)


def _dispatch(*tensors: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel), from the tensors' device."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"epoch_fused: unsupported device {dev}")
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"epoch_fused: tensors on {dev} and {t.device}")
    return dev.type


def _checked(name, t, dtype, shape, dev):
    if t is None:
        raise ValueError(f"epoch_fused: {name} is required for this call")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"epoch_fused: {name} must be {dtype} {tuple(shape)}"
                         f" on {dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def fused_epoch_call(dest, src1, src2, valid, *, epochs=None, rb_stamp=None,
                     page_ema=None, n_pages=None, pei_idx=None,
                     rb_winner=None, pei_hot1=None, pei_hot2=None,
                     eff_table=None, compute_remap=None, technique=None,
                     is_aimm=None, pending_mig_loads=None, topo=None,
                     pei_k: int = 0, aimm: bool = False,
                     run_shared: bool = True, run_route: bool = True,
                     n_mcs: int = 0, packet_flits: float = 0.0,
                     tom_cands=None, n_cubes: int = 0
                     ) -> tuple[SharedParts | None, RouteParts | None]:
    """The epoch core for B lanes; returns (SharedParts | None,
    RouteParts | None) after the static stage flags, as the reference's
    `kernel.fused_epoch_call` does.  With `tom_cands` (K, P), the shared
    stage also scores the K TOM candidates over `n_cubes` cubes (default:
    the topology's) into SharedParts.tom_scores, in the same launch."""
    assert run_shared or run_route
    pei = pei_k > 0
    if tom_cands is not None:
        if not run_shared:
            raise ValueError("epoch_fused: tom_cands rides with the shared "
                             "stage (run_shared)")
        n_cubes = n_cubes or (topo.n_cubes if topo is not None else 0)
        if n_cubes <= 0:
            raise ValueError("epoch_fused: tom_cands needs n_cubes")
    if _dispatch(dest, src1, src2, valid, tom_cands) == "cpu":
        sp = rp = None
        if run_shared:
            sp = ref.shared_stage(dest, src1, src2, valid, epochs, rb_stamp,
                                  page_ema if pei else None, n_pages,
                                  pei_idx, pei_k=pei_k, aimm=aimm)
            if tom_cands is not None:
                sp = sp._replace(tom_scores=ref.tom_stage(
                    dest, src1, src2, valid, tom_cands, n_cubes))
            rb_winner, pei_hot1, pei_hot2 = (sp.rb_winner, sp.pei_hot1,
                                             sp.pei_hot2)
        if run_route:
            rp = ref.route_stage(
                dest, src1, src2, valid, rb_winner, pei_hot1, pei_hot2,
                eff_table, compute_remap, technique, is_aimm,
                pending_mig_loads, topo.routes_flat, topo.hops_flat,
                topo.nearest_mc, pei=pei, aimm=aimm, n_mcs=n_mcs,
                packet_flits=packet_flits)
        return sp, rp
    return _launch_fused(dest, src1, src2, valid, epochs, rb_stamp, page_ema,
                         n_pages, pei_idx, rb_winner, pei_hot1, pei_hot2,
                         eff_table, compute_remap, technique, is_aimm,
                         pending_mig_loads, topo, pei_k, aimm, run_shared,
                         run_route, n_mcs, packet_flits, tom_cands, n_cubes)


def _launch_fused(dest, src1, src2, valid, epochs, rb_stamp, page_ema,
                  n_pages, pei_idx, rb_winner, pei_hot1, pei_hot2, eff_table,
                  compute_remap, technique, is_aimm, pending_mig_loads, topo,
                  pei_k, aimm, run_shared, run_route, n_mcs, packet_flits,
                  tom_cands, n_cubes):
    dev = dest.device
    B, W = dest.shape
    i32, f32, u8 = torch.int32, torch.float32, torch.bool
    dest, src1, src2 = (_checked(n, t, i32, (B, W), dev) for n, t in
                        (("dest", dest), ("src1", src1), ("src2", src2)))
    valid = _checked("valid", valid, f32, (B, W), dev)
    pei = pei_k > 0
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    # P from whichever P-sized table this call shape has
    P = (rb_stamp.shape[1] - 1) if run_shared else eff_table.shape[1]
    C = L = M = 0
    out_stamp = out_ema = out_touch = None
    if run_shared:
        epochs = _checked("epochs", epochs, f32, (B,), dev)
        rb_stamp = _checked("rb_stamp", rb_stamp, i32, (B, P + 1), dev)
        out_stamp = empty((B, P + 1), i32)
        rb_winner = empty((B, 3 * W), u8)
        if pei:
            if not 0 < pei_k <= P:
                raise ValueError(f"epoch_fused: pei_k={pei_k} not in 1..{P}")
            page_ema = _checked("page_ema", page_ema, f32, (B, P), dev)
            n_pages = _checked("n_pages", n_pages, i32, (B,), dev)
            pei_idx = _checked("pei_idx", pei_idx, i32, (B,), dev)
            out_ema = empty((B, P), f32)
            pei_hot1, pei_hot2 = empty((B, W), u8), empty((B, W), u8)
        if aimm:
            out_touch = empty((B, P), f32)
    else:
        rb_winner = _checked("rb_winner", rb_winner, u8, (B, 3 * W), dev)
        if pei:
            pei_hot1 = _checked("pei_hot1", pei_hot1, u8, (B, W), dev)
            pei_hot2 = _checked("pei_hot2", pei_hot2, u8, (B, W), dev)
    route_out = [None] * 7
    routes_flat = hops_flat = nearest_mc = None
    if run_route:
        C, L, M = topo.n_cubes, topo.n_links, n_mcs
        routes_flat = _checked("routes_flat", topo.routes_flat, f32,
                               (C * C, L), dev)
        hops_flat = _checked("hops_flat", topo.hops_flat, f32, (C * C,), dev)
        nearest_mc = _checked("nearest_mc", topo.nearest_mc, i32, (C,), dev)
        eff_table = _checked("eff_table", eff_table, i32, (B, P), dev)
        technique = _checked("technique", technique, i32, (B,), dev)
        pending_mig_loads = _checked("pending_mig_loads", pending_mig_loads,
                                     f32, (B, L), dev)
        if aimm:
            compute_remap = _checked("compute_remap", compute_remap, i32,
                                     (B, P), dev)
            is_aimm = _checked("is_aimm", is_aimm, u8, (B,), dev)
        route_out = [empty((B, W), i32), empty((B, L), f32),
                     empty((B, W), f32), empty((B, C), f32),
                     empty((B, C), f32), empty((B, C), f32),
                     empty((B, M), f32)]
    args = [ptr(dest), ptr(src1), ptr(src2), ptr(valid), ptr(epochs),
            ptr(rb_stamp), ptr(out_stamp), ptr(rb_winner), ptr(page_ema),
            ptr(out_ema), ptr(n_pages), ptr(pei_idx), ptr(pei_hot1),
            ptr(pei_hot2), ptr(out_touch), ptr(eff_table),
            ptr(compute_remap), ptr(technique), ptr(is_aimm),
            ptr(pending_mig_loads), ptr(routes_flat), ptr(hops_flat),
            ptr(nearest_mc), *[ptr(t) for t in route_out], B, W, P, C, L, M,
            pei_k, int(run_shared), int(run_route), int(pei), int(aimm),
            float(packet_flits)]
    tom_out = None
    if tom_cands is not None:
        tom_cands = _checked_cands(tom_cands, P, dev)
        K = tom_cands.shape[0]
        tom_out = empty((B, K), f32)
        lib, fn = _launcher("fused_epoch_tom_launch")
        args += [ptr(tom_cands), ptr(tom_out), K, n_cubes,
                 *tom_score_constants(n_cubes)]
    else:
        lib, fn = _launcher("fused_epoch_launch")
    code = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "fused_epoch")
    launches["fused_epoch"] += 1
    if tom_out is not None:
        launches["tom_scores_folded"] += 1
    stage = ("fused" if run_shared and run_route
             else "shared" if run_shared else "route")
    _count_shape(f"{stage}{'+tom' if tom_out is not None else ''} B={B}")
    sp = rp = None
    if run_shared:
        sp = SharedParts(rb_stamp=out_stamp, rb_winner=rb_winner,
                         page_ema=out_ema, pei_hot1=pei_hot1 if pei else None,
                         pei_hot2=pei_hot2 if pei else None,
                         touch_cnt=out_touch, tom_scores=tom_out)
    if run_route:
        rp = RouteParts(*route_out)
    return sp, rp


def shared_parts(dest, src1, src2, valid, epochs, rb_stamp, page_ema,
                 n_pages, pei_idx, *, pei_k: int, aimm: bool,
                 tom_cands=None, n_cubes: int = 0) -> SharedParts:
    """Seed-invariant stage alone (one launch per lane batch); with
    `tom_cands` (K, P) also the TOM scores over `n_cubes` cubes."""
    sp, _ = fused_epoch_call(dest, src1, src2, valid, epochs=epochs,
                             rb_stamp=rb_stamp, page_ema=page_ema,
                             n_pages=n_pages, pei_idx=pei_idx, pei_k=pei_k,
                             aimm=aimm, run_shared=True, run_route=False,
                             tom_cands=tom_cands, n_cubes=n_cubes)
    return sp


def route_parts(dest, src1, src2, valid, rb_winner, pei_hot1, pei_hot2,
                eff_table, compute_remap, technique, is_aimm,
                pending_mig_loads, topo: TopoTensors, *, pei_k: int,
                aimm: bool, n_mcs: int, packet_flits: float) -> RouteParts:
    """Schedule/route/count stage alone, from precomputed winners/hot flags."""
    _, rp = fused_epoch_call(
        dest, src1, src2, valid, rb_winner=rb_winner, pei_hot1=pei_hot1,
        pei_hot2=pei_hot2, eff_table=eff_table, compute_remap=compute_remap,
        technique=technique, is_aimm=is_aimm,
        pending_mig_loads=pending_mig_loads, topo=topo, pei_k=pei_k,
        aimm=aimm, run_shared=False, run_route=True, n_mcs=n_mcs,
        packet_flits=packet_flits)
    return rp


def fused_parts(dest, src1, src2, valid, epochs, rb_stamp, page_ema,
                n_pages, pei_idx, eff_table, compute_remap, technique,
                is_aimm, pending_mig_loads, topo: TopoTensors, *, pei_k: int,
                aimm: bool, n_mcs: int, packet_flits: float, tom_cands=None
                ) -> tuple[SharedParts, RouteParts]:
    """Both stages in ONE launch: the serial runner's path; with
    `tom_cands` (K, P) the TOM scores too, over the topology's cubes."""
    return fused_epoch_call(
        dest, src1, src2, valid, epochs=epochs, rb_stamp=rb_stamp,
        page_ema=page_ema, n_pages=n_pages, pei_idx=pei_idx,
        eff_table=eff_table, compute_remap=compute_remap,
        technique=technique, is_aimm=is_aimm,
        pending_mig_loads=pending_mig_loads, topo=topo, pei_k=pei_k,
        aimm=aimm, run_shared=True, run_route=True, n_mcs=n_mcs,
        packet_flits=packet_flits, tom_cands=tom_cands)


def tom_scores(dest, src1, src2, valid, cands, n_cubes: int) -> torch.Tensor:
    """(B, K) TOM candidate scores of each lane's window; cands (K, P)."""
    if _dispatch(dest, src1, src2, valid, cands) == "cpu":
        return ref.tom_stage(dest, src1, src2, valid, cands, n_cubes)
    dev = dest.device
    B, W = dest.shape
    K, P = cands.shape
    args = [_checked(n, t, torch.int32, (B, W), dev) for n, t in
            (("dest", dest), ("src1", src1), ("src2", src2))]
    args.append(_checked("valid", valid, torch.float32, (B, W), dev))
    args.append(_checked_cands(cands, P, dev))
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    inv_c, recip = tom_score_constants(n_cubes)
    lib, fn = _launcher("tom_scores_launch")
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(*[t.data_ptr() for t in args], out.data_ptr(), B, W, P, K,
              n_cubes, inv_c, recip, stream)
    build.check(lib, code, "tom_scores")
    launches["tom_scores"] += 1
    _count_shape(f"tom_scores B={B}")
    return out
