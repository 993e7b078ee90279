"""Plain-torch versions of the fused epoch core: the CPU path and the
yardstick the CUDA kernels (csrc/epoch_fused.cu) are held to.

  shared_stage : row-buffer stamp-and-count, PEI top_k threshold + hot
                 flags, access-EMA decay/update, page touch counts (the
                 seed-invariant half of the cost model).
  route_stage  : effective-table gathers, technique scheduling (PEI hot
                 sources, AIMM compute remap), per-link flit loads, hop
                 counts, per-cube compute / access / distinct counts, MC
                 queue depths.
  tom_stage    : TOM candidate co-location scores for one op window.

Every tensor carries a leading lane axis B.  Exactness contract (as in the
reference's ref.py): every value entering a reduction is an exact small
integer in f32, or +1.0 added onto a decayed EMA one access at a time, so
scatter-adds, einsums and atomics give the same bits in any order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.nmp.baselines import (TECHNIQUES, schedule_by_id,
                                       tom_colocation_score)

LDB_ID = TECHNIQUES.index("ldb")


class SharedParts(NamedTuple):
    """Outputs of the seed-invariant stage."""
    rb_stamp: torch.Tensor            # (B, P+1) i32 updated row-buffer stamps
    rb_winner: torch.Tensor           # (B, 3W) bool first-touch indicators
    page_ema: torch.Tensor | None     # (B, P) f32 updated access EMA (PEI)
    pei_hot1: torch.Tensor | None     # (B, W) bool src1 above PEI threshold
    pei_hot2: torch.Tensor | None     # (B, W) bool
    touch_cnt: torch.Tensor | None    # (B, P) f32 window touch counts (AIMM)
    tom_scores: torch.Tensor | None = None  # (B, K) f32 TOM candidate scores


class RouteParts(NamedTuple):
    """Outputs of the schedule/route/count stage."""
    ccube: torch.Tensor       # (B, W) i32 scheduled compute cube per op
    loads: torch.Tensor       # (B, L) f32 per-link flit loads (+ pending mig)
    hops_op: torch.Tensor     # (B, W) f32 total hops per op
    ops_c: torch.Tensor       # (B, C) f32 compute ops per cube
    acc_c: torch.Tensor       # (B, C) f32 accesses per cube
    distinct_c: torch.Tensor  # (B, C) f32 distinct pages touched per cube
    mcq: torch.Tensor         # (B, M) f32 MC queue depths


def shared_stage(dest, src1, src2, valid, epochs, rb_stamp, page_ema,
                 n_pages, pei_idx, *, pei_k: int, aimm: bool) -> SharedParts:
    B, W = dest.shape
    P = rb_stamp.shape[1] - 1
    dev = dest.device

    # Row-buffer stamp race over the 3W accesses: invalid accesses stamp the
    # sink row P with 0; an access wins iff its page's max stamp is its own.
    acc_page = torch.cat([dest, src1, src2], dim=1).long()
    acc_valid = torch.cat([valid, valid, valid], dim=1)
    ok = acc_valid > 0
    tag_base = (epochs.to(torch.int32) + 1) * (3 * W)
    stamp_val = torch.where(
        ok, tag_base[:, None] + torch.arange(3 * W, dtype=torch.int32,
                                             device=dev),
        torch.zeros((), dtype=torch.int32, device=dev))
    stamp_idx = torch.where(ok, acc_page, torch.full_like(acc_page, P))
    new_stamp = rb_stamp.scatter_reduce(1, stamp_idx, stamp_val,
                                        reduce="amax", include_self=True)
    rb_winner = (new_stamp.gather(1, stamp_idx) == stamp_val) & ok

    if pei_k > 0:
        # threshold = the m-th largest access EMA (top_k order statistic),
        # read from the PRE-update EMA; the decayed EMA is stored.
        top = torch.topk(page_ema, pei_k, dim=1).values
        m = n_pages - pei_idx
        r = torch.clamp(m - 1, 0, pei_k - 1).long()
        thresh = top.gather(1, r[:, None])[:, 0]
        t = torch.clamp(thresh, min=1e-6)[:, None]
        pei_hot1 = page_ema.gather(1, src1.long()) >= t
        pei_hot2 = page_ema.gather(1, src2.long()) >= t
        new_ema = page_ema * 0.9
        for pages in (dest, src1, src2):    # +1.0 per access, never pre-summed
            new_ema = new_ema.scatter_add(1, pages.long(), valid)
    else:
        pei_hot1 = pei_hot2 = new_ema = None

    touch_cnt = (torch.zeros((B, P), dtype=torch.float32, device=dev)
                 .scatter_add_(1, acc_page, acc_valid) if aimm else None)
    return SharedParts(rb_stamp=new_stamp, rb_winner=rb_winner,
                       page_ema=new_ema, pei_hot1=pei_hot1,
                       pei_hot2=pei_hot2, touch_cnt=touch_cnt)


def _compute_cubes(dest, src1, src2, eff_table, compute_remap, technique,
                   is_aimm, pei_hot1, pei_hot2, n_cubes, *, pei: bool,
                   aimm: bool):
    """Schedule the compute cube per op: technique baseline + AIMM remap."""
    dcube = eff_table.gather(1, dest.long())
    s1cube = eff_table.gather(1, src1.long())
    s2cube = eff_table.gather(1, src2.long())
    if pei:
        ccube = schedule_by_id(technique, dcube, s1cube, s2cube,
                               pei_hot1, pei_hot2)
    else:
        ccube = torch.where(technique[:, None] == LDB_ID, s1cube, dcube)
    if aimm:
        # compute-remap table: -1 none, 0..C-1 fixed cube, C = "source mode"
        cr = compute_remap.gather(1, dest.long())
        cr = torch.where(cr >= 0, cr, compute_remap.gather(1, src1.long()))
        cr = torch.where(cr >= 0, cr, compute_remap.gather(1, src2.long()))
        aimm_cc = torch.where(cr == n_cubes, s1cube,
                              torch.where(cr >= 0, cr, ccube))
        ccube = torch.where(is_aimm[:, None], aimm_cc, ccube)
    return dcube, s1cube, s2cube, ccube


def route_stage(dest, src1, src2, valid, rb_winner, pei_hot1, pei_hot2,
                eff_table, compute_remap, technique, is_aimm,
                pending_mig_loads, routes_flat, hops_flat, nearest_mc, *,
                pei: bool, aimm: bool, n_mcs: int,
                packet_flits: float) -> RouteParts:
    B = dest.shape[0]
    C = nearest_mc.shape[0]
    dev = dest.device
    dcube, s1cube, s2cube, ccube = _compute_cubes(
        dest, src1, src2, eff_table, compute_remap, technique, is_aimm,
        pei_hot1, pei_hot2, C, pei=pei, aimm=aimm)

    # flows s1->c, s2->c, c->d over the pair-flattened route table
    fsrc = torch.cat([s1cube, s2cube, ccube], dim=1)
    fdst = torch.cat([ccube, ccube, dcube], dim=1)
    fw = torch.cat([valid, valid, valid], dim=1) * packet_flits
    routes = routes_flat[(fsrc * C + fdst).long()]              # (B, 3W, L)
    loads = torch.einsum("bf,bfl->bl", fw, routes) + pending_mig_loads

    hops_op = (hops_flat[(s1cube * C + ccube).long()]
               + hops_flat[(s2cube * C + ccube).long()]
               + hops_flat[(ccube * C + dcube).long()])

    zeros = lambda n: torch.zeros((B, n), dtype=torch.float32, device=dev)
    ops_c = zeros(C).scatter_add_(1, ccube.long(), valid)
    acc_cube = torch.cat([dcube, s1cube, s2cube], dim=1).long()
    acc_valid = torch.cat([valid, valid, valid], dim=1)
    distinct_c = zeros(C).scatter_add_(1, acc_cube, rb_winner.float())
    acc_c = zeros(C).scatter_add_(1, acc_cube, acc_valid)
    mcq = zeros(n_mcs).scatter_add_(1, nearest_mc[dcube.long()].long(), valid)
    return RouteParts(ccube=ccube.to(torch.int32), loads=loads,
                      hops_op=hops_op, ops_c=ops_c, acc_c=acc_c,
                      distinct_c=distinct_c, mcq=mcq)


def tom_stage(dest, src1, src2, valid, cands, n_cubes: int) -> torch.Tensor:
    """(B, K) TOM candidate co-location scores of each lane's window."""
    return torch.stack([tom_colocation_score(cands[k], dest, src1, src2,
                                             valid, n_cubes)
                        for k in range(cands.shape[0])], dim=1)
