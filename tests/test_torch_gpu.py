"""The port's CUDA kernels against their plain-torch versions, on the card.

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test here needs the card: the `cuda` fixture skips it, with a reason,
where there is none (decided when the test runs, never at import, so every
pytest-xdist worker collects the same tests).  Bars: the epoch kernels are
equal to their plain versions (`torch.equal`, the exact contract of the
epoch core); the dueling-qnet kernel is within rtol/atol 1e-4; the TD
step's `td_grad` within rtol 1e-5 (atol 1e-5 x the leaf's max) of its
plain versions and `adamw_lanes` `torch.equal` to the card path's update.
"""
import numpy as np
import pytest
import torch

from chip_smoke import AIMM_PATH_KERNELS, epoch_inputs

pytestmark = pytest.mark.gpu

QKEYS = ("w0", "b0", "w1", "b1", "w_v", "b_v", "w_a", "b_a")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there (no "
                    "interpret mode for CUDA C++)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _equal(got, want):
    for a, b in zip(got, want):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("pei,aimm", [(False, False), (True, False),
                                      (False, True), (True, True)])
@pytest.mark.parametrize("app,epoch", [("BP", 37), ("KM", 5)])
def test_fused_epoch_three_call_shapes_equal_plain(cuda, app, epoch, pei,
                                                   aimm):
    from repro_torch.kernels.epoch_fused import ops, ref
    from repro_torch.nmp.config import NMPConfig
    cfg = NMPConfig()
    x, topo, pei_k, _ = epoch_inputs(cuda, app, 16384 if app == "BP" else
                                     2048, seed=epoch, epoch=epoch)
    win = [x[k] for k in ("dest", "src1", "src2", "valid")]
    k = pei_k if pei else 0
    tech = torch.tensor([2 if pei else 0], dtype=torch.int32, device=cuda)
    rt = dict(n_mcs=cfg.n_mcs, packet_flits=cfg.packet_flits)
    sp = ref.shared_stage(*win, x["epochs"], x["rb_stamp"],
                          x["page_ema"] if pei else None, x["n_pages"],
                          x["pei_idx"], pei_k=k, aimm=aimm)
    rp = ref.route_stage(*win, sp.rb_winner, sp.pei_hot1, sp.pei_hot2,
                         x["eff_table"], x["compute_remap"], tech,
                         x["is_aimm"], x["pending"], topo.routes_flat,
                         topo.hops_flat, topo.nearest_mc, pei=pei, aimm=aimm,
                         **rt)
    before = ops.launches["fused_epoch"]
    _equal(ops.shared_parts(*win, x["epochs"], x["rb_stamp"], x["page_ema"],
                            x["n_pages"], x["pei_idx"], pei_k=k, aimm=aimm),
           sp)
    _equal(ops.route_parts(*win, sp.rb_winner, sp.pei_hot1, sp.pei_hot2,
                           x["eff_table"], x["compute_remap"], tech,
                           x["is_aimm"], x["pending"], topo, pei_k=k,
                           aimm=aimm, **rt), rp)
    fsp, frp = ops.fused_parts(*win, x["epochs"], x["rb_stamp"],
                               x["page_ema"], x["n_pages"], x["pei_idx"],
                               x["eff_table"], x["compute_remap"], tech,
                               x["is_aimm"], x["pending"], topo, pei_k=k,
                               aimm=aimm, **rt)
    torch.cuda.synchronize()
    _equal(fsp, sp)
    _equal(frp, rp)
    assert ops.launches["fused_epoch"] == before + 3


def _synthetic_epoch(dev, B, P, seed, *, W=128, pages=None, valid=None,
                     ema=None):
    """B lanes of fused-kernel inputs over P pages and a W-op window, made
    with numpy from a seed: a different window, stamps, tables and EMA per
    lane.  `pages`, `valid` and `ema` (numpy, (B, W) / (B, P)) override the
    random ones."""
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import pei_hot_index, pei_top_k
    from repro_torch.nmp.topology import topology_tensors
    cfg = NMPConfig()
    rng = np.random.default_rng(seed)
    C = cfg.n_cubes
    topo = topology_tensors(cfg, dev)
    win = {k: (pages if pages is not None else
               rng.integers(0, P, (B, W))).astype(np.int32)
           for k in ("dest", "src1", "src2")}
    if ema is None:
        ema = (rng.choice(np.array([0.0, 0.9, 1.0, 1.81], np.float32), (B, P))
               + (rng.random((B, P)) < 0.2) * rng.random((B, P)))
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    x = dict(
        **{k: on(v) for k, v in win.items()},
        valid=on((np.ones((B, W)) if valid is None else valid
                  ).astype(np.float32)),
        epochs=on(rng.integers(0, 100, B).astype(np.float32)),
        rb_stamp=on(rng.integers(0, 3 * W * 100, (B, P + 1)).astype(np.int32)),
        page_ema=on(np.asarray(ema, np.float32)),
        n_pages=on(np.full(B, P, np.int32)),
        pei_idx=on(np.full(B, pei_hot_index(P, cfg), np.int32)),
        eff_table=on(rng.integers(0, C, (B, P)).astype(np.int32)),
        compute_remap=on(np.where(rng.random((B, P)) < 0.7, -1,
                                  rng.integers(0, C + 1, (B, P))
                                  ).astype(np.int32)),
        is_aimm=on(rng.random(B) < 0.75),
        pending=on(np.where(rng.random((B, topo.n_links)) < 0.3, 256.0, 0.0
                            ).astype(np.float32)))
    return x, topo, pei_top_k(P, cfg)


def _check_three_shapes(dev, x, topo, pei_k, pei, aimm):
    """shared_parts, route_parts and fused_parts equal to the plain version
    (torch.equal), lanes alternating between the bnmp and the pei technique
    where pei is on."""
    from repro_torch.kernels.epoch_fused import ops, ref
    from repro_torch.nmp.config import NMPConfig
    cfg = NMPConfig()
    B = x["dest"].shape[0]
    win = [x[k] for k in ("dest", "src1", "src2", "valid")]
    k = pei_k if pei else 0
    tech = torch.tensor([2 * (i % 2) if pei else 0 for i in range(B)],
                        dtype=torch.int32, device=dev)
    rt = dict(n_mcs=cfg.n_mcs, packet_flits=cfg.packet_flits)
    sp = ref.shared_stage(*win, x["epochs"], x["rb_stamp"],
                          x["page_ema"] if pei else None, x["n_pages"],
                          x["pei_idx"], pei_k=k, aimm=aimm)
    rp = ref.route_stage(*win, sp.rb_winner, sp.pei_hot1, sp.pei_hot2,
                         x["eff_table"], x["compute_remap"], tech,
                         x["is_aimm"], x["pending"], topo.routes_flat,
                         topo.hops_flat, topo.nearest_mc, pei=pei, aimm=aimm,
                         **rt)
    _equal(ops.shared_parts(*win, x["epochs"], x["rb_stamp"], x["page_ema"],
                            x["n_pages"], x["pei_idx"], pei_k=k, aimm=aimm),
           sp)
    _equal(ops.route_parts(*win, sp.rb_winner, sp.pei_hot1, sp.pei_hot2,
                           x["eff_table"], x["compute_remap"], tech,
                           x["is_aimm"], x["pending"], topo, pei_k=k,
                           aimm=aimm, **rt), rp)
    fsp, frp = ops.fused_parts(*win, x["epochs"], x["rb_stamp"],
                               x["page_ema"], x["n_pages"], x["pei_idx"],
                               x["eff_table"], x["compute_remap"], tech,
                               x["is_aimm"], x["pending"], topo, pei_k=k,
                               aimm=aimm, **rt)
    torch.cuda.synchronize()
    _equal(fsp, sp)
    _equal(frp, rp)


FLAG_SETS = pytest.mark.parametrize("pei,aimm", [(False, True), (True, False),
                                                 (True, True)],
                                    ids=["bnmp+aimm", "pei", "pei+aimm"])


@FLAG_SETS
@pytest.mark.parametrize("P,W", [(4096, 128), (4093, 128), (1030, 300),
                                 (30000, 128)])
def test_fused_epoch_distinct_lanes(cuda, P, W, pei, aimm):
    """B = 4 lanes with different windows and tables in one launch; P not a
    multiple of 4 puts every lane's P-sized rows on another 16-byte offset,
    a window wider than the block's 256 threads takes the loops' later
    rounds, and P = 30000 rows do not fit in shared memory (the kernel
    works on them in device memory)."""
    x, topo, pei_k = _synthetic_epoch(cuda, 4, P, seed=P, W=W)
    _check_three_shapes(cuda, x, topo, pei_k, pei, aimm)


@FLAG_SETS
def test_fused_epoch_one_page_window(cuda, pei, aimm):
    """Every access of the window on one page, dest = src1 = src2: 384 +1.0s
    onto one EMA entry, one stamp race winner, every count on one key."""
    x, topo, pei_k = _synthetic_epoch(cuda, 2, 4096, seed=7,
                                      pages=np.full((2, 128), 123))
    _check_three_shapes(cuda, x, topo, pei_k, pei, aimm)


@FLAG_SETS
def test_fused_epoch_all_invalid_window(cuda, pei, aimm):
    x, topo, pei_k = _synthetic_epoch(cuda, 2, 4096, seed=8,
                                      valid=np.zeros((2, 128)))
    _check_three_shapes(cuda, x, topo, pei_k, pei, aimm)


@pytest.mark.parametrize("P", [4096, 4095])
def test_fused_epoch_pei_ties_at_threshold(cuda, P):
    """The r-th largest EMA inside a run of equal values (10 pages above it,
    r + 10 pages at it), and the window's sources on pages at, above and
    below it."""
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import pei_hot_index
    m = P - pei_hot_index(P, NMPConfig())
    rng = np.random.default_rng(P)
    ema = np.zeros((2, P), np.float32)
    ema[:, :] = rng.random((2, P)).astype(np.float32) * 0.99
    perm = rng.permutation(P)
    ema[:, perm[:10]] = 5.0
    ema[:, perm[10:m + 20]] = 1.0
    pages = rng.choice(perm[:m + 60], (2, 128))
    x, topo, pei_k = _synthetic_epoch(cuda, 2, P, seed=P, pages=pages,
                                      ema=ema)
    _check_three_shapes(cuda, x, topo, pei_k, True, False)


@pytest.mark.parametrize("n_valid", [128, 41, 1])
def test_tom_scores_equal_plain(cuda, n_valid):
    from repro_torch.kernels.epoch_fused import ops, ref
    from repro_torch.nmp.baselines import tom_candidates
    from repro_torch.nmp.config import NMPConfig
    x, _, _, tr = epoch_inputs(cuda, "SPMV", 2048, seed=n_valid, epoch=3)
    valid = (torch.arange(128, device=cuda) < n_valid).float()[None]
    cands = tom_candidates(tr.n_pages, NMPConfig(), cuda)
    win = [x["dest"], x["src1"], x["src2"], valid]
    got = ops.tom_scores(*win, cands, 16)
    assert torch.equal(got, ref.tom_stage(*win, cands, 16))


def _tom_window(dev, B, W, P, seed, fractional):
    """B lanes of a W-op window over P pages; valid flags 0/1, or (the
    kernels' float path) multiples of 1/4, whose sums are exact in any
    order."""
    rng = np.random.default_rng(seed)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    pages = [on(rng.integers(0, P, (B, W)).astype(np.int32))
             for _ in range(3)]
    levels = np.array([0.0, 0.25, 0.5, 0.75, 1.0] if fractional
                      else [0.0, 1.0, 1.0, 1.0], np.float32)
    return pages + [on(rng.choice(levels, (B, W)))]


@pytest.mark.parametrize("K,W,fractional,C", [
    (1, 128, False, 16), (32, 128, False, 16), (6, 128, True, 16),
    (6, 130, True, 16), (32, 300, False, 16), (6, 128, False, 40)],
    ids=["k1", "k32", "fractional", "odd-width", "k32-wide", "40-cubes"])
def test_tom_scores_float_path_and_k_range(cuda, K, W, fractional, C):
    """The standalone scorer at the ends of its K range, on a window whose
    valid flags are not all 0/1 (float sums), widths that are not a
    multiple of 32 or take several rounds of 128 ops, and more cubes than a
    warp has lanes (per-cube counts in shared memory); random candidate
    tables, 3 lanes."""
    from repro_torch.kernels.epoch_fused import ops, ref
    P = 3000
    win = _tom_window(cuda, 3, W, P, seed=K + W, fractional=fractional)
    gen = torch.Generator(device=cuda).manual_seed(K)
    cands = torch.randint(0, C, (K, P), generator=gen, device=cuda,
                          dtype=torch.int32)
    before = ops.launches["tom_scores"]
    got = ops.tom_scores(*win, cands, C)
    assert ops.launches["tom_scores"] == before + 1
    assert torch.equal(got, ref.tom_stage(*win, cands, C))


@pytest.mark.parametrize("P,W", [(4096, 128), (30000, 128), (1030, 300)])
@pytest.mark.parametrize("pei,aimm,fractional", [
    (True, False, False), (False, True, False), (False, True, True)],
    ids=["pei", "bnmp+aimm", "bnmp+aimm-fractional"])
def test_tom_fold_equal_plain(cuda, pei, aimm, fractional, P, W):
    """The TOM scores folded into the shared stage (shared_parts and
    fused_parts given tom_cands): equal to the plain version and to the
    standalone kernel, with the launch's other outputs equal to those of
    the same launch without TOM.  P = 30000 takes the instantiation whose
    rows stay in device memory; W = 300 takes the fold's later rounds.
    Valid flags in quarters take the float sums (not with PEI: float
    atomics onto an EMA are not exact in every order)."""
    from repro_torch.kernels.epoch_fused import ops, ref
    from repro_torch.nmp.baselines import tom_candidates
    from repro_torch.nmp.config import NMPConfig
    cfg = NMPConfig()
    valid = None
    if fractional:
        valid = np.random.default_rng(P).choice(
            np.array([0.0, 0.25, 0.5, 1.0], np.float32), (4, W))
    x, topo, pei_k = _synthetic_epoch(cuda, 4, P, seed=P + W, W=W,
                                      valid=valid)
    cands = tom_candidates(P, cfg, cuda)
    win = [x[k] for k in ("dest", "src1", "src2", "valid")]
    k = pei_k if pei else 0
    tech = torch.tensor([2 * (i % 2) if pei else 0 for i in range(4)],
                        dtype=torch.int32, device=cuda)
    rt = dict(n_mcs=cfg.n_mcs, packet_flits=cfg.packet_flits)
    want = ref.tom_stage(*win, cands, cfg.n_cubes)
    alone = ops.tom_scores(*win, cands, cfg.n_cubes)
    shared = lambda **tom: ops.shared_parts(
        *win, x["epochs"], x["rb_stamp"], x["page_ema"], x["n_pages"],
        x["pei_idx"], pei_k=k, aimm=aimm, **tom)
    fused = lambda **tom: ops.fused_parts(
        *win, x["epochs"], x["rb_stamp"], x["page_ema"], x["n_pages"],
        x["pei_idx"], x["eff_table"], x["compute_remap"], tech,
        x["is_aimm"], x["pending"], topo, pei_k=k, aimm=aimm, **rt, **tom)
    before = dict(ops.launches)
    sp = shared(tom_cands=cands, n_cubes=cfg.n_cubes)
    fsp, frp = fused(tom_cands=cands)
    assert ops.launches["tom_scores_folded"] == \
        before["tom_scores_folded"] + 2
    assert ops.launches["fused_epoch"] == before["fused_epoch"] + 2
    assert ops.launches["tom_scores"] == before["tom_scores"]
    base_sp, (base_fsp, base_frp) = shared(), fused()
    torch.cuda.synchronize()
    for got in (sp.tom_scores, fsp.tom_scores):
        assert torch.equal(got, want)
        assert torch.equal(got, alone)
    _equal(sp._replace(tom_scores=None), base_sp)
    _equal(fsp._replace(tom_scores=None), base_fsp)
    _equal(frp, base_frp)


def test_pei_tom_episode_scores_in_the_fused_launch(cuda):
    """A PEI + TOM episode scores its TOM candidates inside the fused epoch
    kernel: one launch per epoch, no standalone scorer launch."""
    from repro_torch.kernels.epoch_fused import ops as eops
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import run_episode
    from repro_torch.nmp.traces import make_trace
    eops.reset_launches()
    run_episode(make_trace("KM", n_ops=1024), NMPConfig(), "pei", "tom",
                seed=1, device=cuda)
    assert eops.launches == {"fused_epoch": 8, "tom_scores": 0,
                             "tom_scores_folded": 8}


@pytest.mark.parametrize("agents", [1, 3])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
def test_dueling_qnet_within_tolerance(cuda, n, agents):
    from repro_torch.core import dqn
    from repro_torch.kernels.dueling_qnet import ops
    from repro_torch.kernels.dueling_qnet.ref import dueling_qnet_ref
    from repro_torch.core import prng
    gen = torch.Generator(device=cuda).manual_seed(n)
    params = dqn.init_params(prng.PRNGKey(n, cuda),
                             dqn.DQNConfig(state_dim=106), agents, cuda)
    xs = torch.rand((agents, n, 106), generator=gen, device=cuda) * 2
    got = ops.qnet_forward(params, xs)
    want = dueling_qnet_ref(xs, *[params[k] for k in QKEYS])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,hidden,A", [(37, (96, 64), 5), (37, (90, 62), 5),
                                        (106, (300, 128), 8)],
                         ids=["bulk", "unaligned", "wide"])
def test_dueling_qnet_other_widths(cuda, S, hidden, A):
    """Widths other than the production one: odd state and action counts
    (bulk copies still apply), hidden widths that are not a multiple of 4
    floats (the threads copy the weights), and a layer wider than one
    256-unit group."""
    from repro_torch.core import dqn
    from repro_torch.kernels.dueling_qnet import ops
    from repro_torch.kernels.dueling_qnet.ref import dueling_qnet_ref
    from repro_torch.core import prng
    gen = torch.Generator(device=cuda).manual_seed(S + A)
    params = dqn.init_params(prng.PRNGKey(S + A, cuda),
                             dqn.DQNConfig(state_dim=S, n_actions=A,
                                           hidden=hidden), 2, cuda)
    for k in params:
        if k.startswith("b"):
            params[k] = 0.1 * torch.randn(params[k].shape, generator=gen,
                                          device=cuda)
    xs = torch.rand((2, 40, S), generator=gen, device=cuda) * 2
    before = ops.launches["dueling_qnet"]
    got = ops.qnet_forward(params, xs)
    assert ops.launches["dueling_qnet"] == before + 1
    want = dueling_qnet_ref(xs, *[params[k] for k in QKEYS])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_deterministic_cell_on_card_matches_cpu(cuda):
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import run_episode
    from repro_torch.nmp.traces import make_trace
    tr = make_trace("SPMV", n_ops=2048)
    a = run_episode(tr, NMPConfig(), "pei", "tom", seed=2, device=cuda)
    b = run_episode(tr, NMPConfig(), "pei", "tom", seed=2, device="cpu")
    for k in ("action", "invoke", "valid", "util", "mean_hops"):
        assert torch.equal(a.metrics[k].cpu(), b.metrics[k]), k
    np.testing.assert_allclose(a.metrics["cycles"].cpu().numpy(),
                               b.metrics["cycles"].numpy(), rtol=1e-5)


def test_learned_aimm_episode_launches_every_kernel(cuda):
    from repro_torch.kernels.adamw_lanes import ops as aops
    from repro_torch.kernels.batched_linear import ops as lops
    from repro_torch.kernels.dueling_qnet import ops as qops
    from repro_torch.kernels.epoch_fused import ops as eops
    from repro_torch.kernels.td_grad import ops as gops
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import run_episode
    from repro_torch.nmp.traces import make_trace
    for ops in (eops, qops, gops, aops, lops):
        ops.reset_launches()
    res = run_episode(make_trace("KM", n_ops=1024), NMPConfig(), "bnmp",
                      "aimm", seed=1, device=cuda)
    assert float(res.env.ops_done) == 1024
    assert eops.launches["fused_epoch"] == 8
    assert qops.launches["dueling_qnet"] == 3 * 8
    assert gops.launches["td_grad"] == aops.launches["adamw_lanes"] == 8
    assert lops.launches["batched_linear"] == 0


# ---------------------------------------------------------------------------
# model-zoo kernels: flash attention (the bars of flash_attention/ref.py
# BARS: elementwise, relative L2 overall and per row) and the SSD scan
# (1e-4 f32 against the chunked plain version; 5e-2 for bf16 inputs, whose
# output is rounded to bf16)
# ---------------------------------------------------------------------------

FLASH_CASES = [(S, hd, causal) for S in (100, 128, 384, 1000)
               for hd in (16, 64, 128) for causal in (True, False)
               if causal or S in (100, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,hd,causal", FLASH_CASES)
def test_flash_attention_within_tolerance(cuda, S, hd, causal, dtype):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import BARS, attention_ref
    from repro_torch.kernels.flash_attention.ref import compare
    gen = torch.Generator(device=cuda).manual_seed(S * hd)
    B, H, K = 2, 8, 2
    q, k, v = (0.5 * torch.randn((B, S, n, hd), generator=gen, device=cuda)
               for n in (H, K, K))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = ops.launches["flash_attention"]
    got = ops.gqa_flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before + 1
    kk, vv = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
    want = attention_ref(q.transpose(1, 2), kk.transpose(1, 2),
                         vv.transpose(1, 2), causal=causal).transpose(1, 2)
    assert got.dtype == dtype
    cmp = compare(got, want)
    assert cmp["ok"], (cmp, BARS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("L,chunk,P,N", [(64, 32, 16, 8), (128, 128, 16, 16),
                                         (256, 64, 64, 128),
                                         (512, 256, 64, 128),
                                         (192, 96, 48, 100)])
def test_ssd_scan_within_tolerance(cuda, L, chunk, P, N, dtype):
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_ref
    gen = torch.Generator(device=cuda).manual_seed(L + P + N)
    B, H = 2, 4
    rnd = lambda *s: 0.5 * torch.randn(s, generator=gen, device=cuda)
    x, b, c = rnd(B, L, H, P), rnd(B, L, N), rnd(B, L, N)
    dt = rnd(B, L, H).abs() * 0.2
    a = -rnd(H).abs() - 0.1
    x, b, c = x.to(dtype), b.to(dtype), c.to(dtype)
    before = ops.launches["ssd_scan"]
    got = ops.ssd(x, b, c, dt, a, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launches["ssd_scan"] == before + 1
    want = ssd_chunked(x, b, c, dt, a, chunk=chunk).to(dtype)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.float32 and L <= 256:
        torch.testing.assert_close(got, ssd_ref(x, b, c, dt, a), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 16, "mma_sync_bf16"), (torch.bfloat16, 32,
                                            "mma_sync_bf16"),
    (torch.bfloat16, 64, "wgmma_bf16"), (torch.bfloat16, 128, "wgmma_bf16"),
    (torch.float32, 64, "cuda_core_f32"), (torch.float32, 128,
                                           "cuda_core_f32")])
def test_flash_attention_kernel_follows_shape(cuda, dtype, hd, kernel):
    """The wrapper picks the kernel from dtype and head dim alone, and the
    one it picked is within BARS of the plain version."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import BARS, attention_ref
    from repro_torch.kernels.flash_attention.ref import compare
    assert ops.kernel_for(dtype, hd) == kernel
    gen = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn((1, 300, n, hd), generator=gen,
                           device=cuda).to(dtype) for n in (4, 1, 1))
    before = dict(ops.kernel_launches)
    got = ops.gqa_flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in ops.kernel_launches.items()} == {
        n: int(n == kernel) for n in ops.KERNELS}
    want = attention_ref(q.transpose(1, 2), *(t.repeat_interleave(
        4, dim=2).transpose(1, 2) for t in (k, v))).transpose(1, 2)
    cmp = compare(got, want)
    assert cmp["ok"], (cmp, BARS[dtype])


@pytest.mark.parametrize("scale", [0.3, 0.0, -0.2])
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 32),
                                      (torch.bfloat16, 128),
                                      (torch.float32, 128)],
                         ids=["mma_sync", "wgmma", "f32"])
def test_flash_attention_any_scale(cuda, dtype, hd, scale):
    """Every kernel takes the caller's scale, zero and negative too, as the
    plain version does."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import BARS, attention_ref
    from repro_torch.kernels.flash_attention.ref import compare
    gen = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn((1, 300, n, hd), generator=gen,
                           device=cuda).to(dtype) for n in (4, 1, 1))
    got = ops.gqa_flash_attention(q, k, v, causal=True, scale=scale)
    want = attention_ref(q.transpose(1, 2), *(t.repeat_interleave(
        4, dim=2).transpose(1, 2) for t in (k, v)),
        scale=scale).transpose(1, 2)
    cmp = compare(got, want)
    assert cmp["ok"], (cmp, BARS[dtype])


def test_flash_attention_many_query_tiles_ragged_tail(cuda):
    """hd 128, GQA ratio 4, unit-variance inputs: S 2176 (17 query tiles of
    128 on the wgmma kernel) and S 2139 (a ragged last query and K/V tile,
    which TMA fills with zeros and the kernel masks)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import BARS, attention_ref
    from repro_torch.kernels.flash_attention.ref import compare
    gen = torch.Generator(device=cuda).manual_seed(2176)
    for S in (2176, 2176 - 37):
        q, k, v = (torch.randn((2, S, n, 128), generator=gen,
                               device=cuda).bfloat16() for n in (8, 2, 2))
        before = ops.kernel_launches["wgmma_bf16"]
        got = ops.gqa_flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert ops.kernel_launches["wgmma_bf16"] == before + 1
        want = attention_ref(q.transpose(1, 2), *(t.repeat_interleave(
            4, dim=2).transpose(1, 2) for t in (k, v))).transpose(1, 2)
        cmp = compare(got, want)
        assert cmp["ok"], (S, cmp, BARS[torch.bfloat16])


def _flash_plain(q, k, v, window=0, causal=True):
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rep = q.shape[2] // k.shape[2]
    kk, vv = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    return attention_ref(q.transpose(1, 2), kk.transpose(1, 2),
                         vv.transpose(1, 2), causal=causal,
                         window=window).transpose(1, 2)


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 16, "mma_sync_bf16"), (torch.bfloat16, 32,
                                            "mma_sync_bf16"),
    (torch.bfloat16, 64, "wgmma_bf16"), (torch.bfloat16, 128, "wgmma_bf16"),
    (torch.bfloat16, 256, "wgmma_bf16"), (torch.float32, 32, "cuda_core_f32"),
    (torch.float32, 256, "cuda_core_f32")])
@pytest.mark.parametrize("S,window", [(300, 1), (300, 64), (700, 100),
                                      (1000, 256), (1000, 2000), (520, 128)])
def test_flash_attention_window_each_kernel(cuda, dtype, hd, kernel, S,
                                            window):
    """Every kernel with a causal window, against the plain version's mask
    (key j visible to query i iff i - window < j <= i): windows narrower
    than a key tile, not a multiple of one, wider than S; ragged S."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import BARS, compare
    assert ops.kernel_for(dtype, hd) == kernel
    gen = torch.Generator(device=cuda).manual_seed(S + window + hd)
    q, k, v = (torch.randn((2, S, n, hd), generator=gen,
                           device=cuda).to(dtype) for n in (4, 2, 2))
    before = dict(ops.kernel_launches)
    got = ops.gqa_flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in ops.kernel_launches.items()} == {
        n: int(n == kernel) for n in ops.KERNELS}
    cmp = compare(got, _flash_plain(q, k, v, window))
    assert cmp["ok"], (cmp, BARS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,causal", [(128, True), (384, True), (1000, True),
                                      (2176, True), (256, False),
                                      (512, False)])
def test_flash_attention_hd256(cuda, S, causal, dtype):
    """hd 256 (gemma3's width): the wgmma kernel with 64-key tiles (bf16)
    and the CUDA-core kernel (f32), GQA ratio 2, unit-variance inputs."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import BARS, compare
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn((1, S, n, 256), generator=gen,
                           device=cuda).to(dtype) for n in (4, 2, 2))
    got = ops.gqa_flash_attention(q, k, v, causal=causal)
    cmp = compare(got, _flash_plain(q, k, v, causal=causal))
    assert cmp["ok"], (cmp, BARS[dtype])


@pytest.mark.parametrize("hd", [128, 256])
def test_flash_attention_gqa_ratio_one_windowed(cuda, hd):
    """H = K (deepseek-moe-16b's 16/16 heads), with and without a window."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import BARS, compare
    gen = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn((2, 640, 4, hd), generator=gen,
                           device=cuda).bfloat16() for _ in range(3))
    for window in (0, 200):
        got = ops.gqa_flash_attention(q, k, v, causal=True, window=window)
        cmp = compare(got, _flash_plain(q, k, v, window))
        assert cmp["ok"], (window, cmp, BARS[torch.bfloat16])


@pytest.mark.parametrize("carry", [False, True])
def test_ssd_scan_main_shape(cuda, carry):
    """mamba2-370m's SSD shape (L 4096, H 32, P 64, N 128, chunk 256), once
    with the state carried across chunks (decay 0.17-0.99 per chunk)."""
    from chip_smoke import ssd_inputs
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    x, b, c, dt, a = ssd_inputs(cuda, carry)
    got = ops.ssd(x, b, c, dt, a, chunk=256)
    want = ssd_chunked(x, b, c, dt, a, chunk=256)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# threefry2x32 and the batched engine's widths (B = L lanes and L·S cells)
# ---------------------------------------------------------------------------

def test_threefry_kernel_equal_plain(cuda):
    """Every draw mode of the threefry kernel against ref.py, torch.equal,
    one launch each."""
    from repro_torch.core import prng
    from repro_torch.kernels.threefry import ops, ref
    keys = prng.split(prng.PRNGKey(7, cuda), 1 << 16)
    kc = keys.cpu()
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    hi = (torch.arange(1 << 16, device=cuda) % 5000 + 1).to(torch.int32)
    p = torch.rand((1 << 16, 4), device=cuda)
    p[:, 2] = 0
    before = ops.launches["threefry"]
    pairs = [
        (ops.split(keys, 3), ref.split(kc, 3)),
        (ops.bits(keys, (5,)), ref.bits(kc, (5,))),
        (ops.uniform(keys, (3,)), ref.uniform(kc, (3,))),
        (ops.uniform(keys, (2,), lo, 1.0), ref.uniform(kc, (2,), lo, 1.0)),
        (ops.randint(keys, (4,), 0, hi), ref.randint(kc, (4,), 0, hi.cpu())),
        (ops.choice(keys, p), ref.choice(kc, p.cpu()))]
    pairs += [(ops.randint(keys, (2,), lo_, lo_ + span),
               ref.randint(kc, (2,), lo_, lo_ + span))
              for lo_, span in ((0, 1), (0, 8), (3, 13), (0, 65537),
                                (-5, 2**31 - 1))]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got.cpu(), want)
    assert ops.launches["threefry"] == before + len(pairs)


@FLAG_SETS
@pytest.mark.parametrize("B", [45, 135])
def test_fused_epoch_sweep_widths_with_tom(cuda, B, pei, aimm):
    """The batched engine's widths: the shared stage with the TOM fold at
    B lanes, the route stage and the fused launch at B cells."""
    from repro_torch.kernels.epoch_fused import ops, ref
    from repro_torch.nmp.baselines import tom_candidates
    from repro_torch.nmp.config import NMPConfig
    cfg = NMPConfig()
    x, topo, pei_k = _synthetic_epoch(cuda, B, 4096, seed=B + pei)
    _check_three_shapes(cuda, x, topo, pei_k, pei, aimm)
    win = [x[k] for k in ("dest", "src1", "src2", "valid")]
    cands = tom_candidates(4096, cfg, cuda)
    k = pei_k if pei else 0
    sp = ops.shared_parts(*win, x["epochs"], x["rb_stamp"], x["page_ema"],
                          x["n_pages"], x["pei_idx"], pei_k=k, aimm=aimm,
                          tom_cands=cands, n_cubes=cfg.n_cubes)
    want = ref.tom_stage(*win, cands, cfg.n_cubes)
    torch.cuda.synchronize()
    assert torch.equal(sp.tom_scores, want)


@pytest.mark.parametrize("n", [1, 64])
def test_dueling_qnet_at_sweep_width(cuda, n):
    """G = 45 agents (the figure grid's learned cells), act and TD rows."""
    from repro_torch.core import dqn, prng
    from repro_torch.kernels.dueling_qnet import ops
    from repro_torch.kernels.dueling_qnet.ref import dueling_qnet_ref
    keys = prng.split(prng.PRNGKey(n, cuda), 45)
    params = dqn.init_params(keys, dqn.DQNConfig(state_dim=106), 45, cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    xs = torch.rand((45, n, 106), generator=gen, device=cuda) * 2
    got = ops.qnet_forward(params, xs)
    want = dueling_qnet_ref(xs, *[params[k] for k in QKEYS])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_small_run_grid_on_card_matches_cpu(cuda):
    """A folded grid (deterministic, scripted NEAR and learned lanes) on the
    card against the port's CPU path: per-epoch integer timelines equal,
    cycles within rtol 1e-5."""
    from repro_torch.kernels.threefry import ops
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.scenarios import Scenario, seed_variants
    from repro_torch.nmp.sweep import run_grid
    from repro_torch.nmp.traces import make_trace
    grid = []
    for app, n in (("KM", 384), ("SPMV", 768)):
        tr = make_trace(app, n_ops=n)
        for mapper, forced in (("none", -1), ("tom", -1), ("aimm", 1),
                               ("aimm", -1)):
            grid += seed_variants(Scenario(
                name=f"{app}/{mapper}/{forced}", trace=tr, technique="pei",
                mapper=mapper, forced_action=forced,
                episodes=2 if forced < 0 and mapper == "aimm" else 1),
                seeds=(0, 1, 2))
    ops.reset_launches()
    card = run_grid(grid, NMPConfig(), device=cuda)
    assert ops.launches["threefry"] > 0
    cpu = run_grid(grid, NMPConfig(), device="cpu")
    for k in ("ops", "valid_t", "invoke_t", "migrations"):
        assert np.array_equal(card.metrics[k], cpu.metrics[k]), k
    np.testing.assert_allclose(card.metrics["cycles"], cpu.metrics["cycles"],
                               rtol=1e-5)


@pytest.mark.parametrize("G", [1, 3, 45])
def test_batched_linear_kernels_equal_plain_and_batch_invariant(cuda, G):
    """The TD step's products and sums within 1e-5 of torch's, and agent
    0's result the same bits at every agent count (torch's are not)."""
    from repro_torch.kernels.batched_linear import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(G)
    x = torch.randn((G, 64, 106), generator=gen, device=cuda)
    w = torch.randn((G, 106, 128), generator=gen, device=cuda) * 0.1
    dy = torch.randn((G, 64, 128), generator=gen, device=cuda)
    bias = torch.randn((G, 128), generator=gen, device=cuda)
    calls = [lambda a, b, c: ops.bgemm(a, b),
             lambda a, b, c: ops.bgemm(a, b, bias[:a.shape[0]]),
             lambda a, b, c: ops.bgemm(c, b.transpose(1, 2)),
             lambda a, b, c: ops.bgemm_colsum(a.transpose(1, 2), c),
             lambda a, b, c: ops.sq_norm([b, a, c])]
    plain = [lambda a, b, c: a @ b,
             lambda a, b, c: a @ b + bias[:, None, :],
             lambda a, b, c: c @ b.transpose(1, 2),
             lambda a, b, c: (a.transpose(1, 2) @ c, c.sum(1)),
             lambda a, b, c: ref.sq_norm([b, a, c])]
    before = ops.launches["batched_linear"]
    for k, p in zip(calls, plain):
        got = k(x, w, dy)
        torch.testing.assert_close(got, p(x, w, dy), rtol=1e-5, atol=1e-5)
        alone = k(x[:1], w[:1], dy[:1])
        for a_, g_ in zip(alone if isinstance(alone, tuple) else (alone,),
                          got if isinstance(got, tuple) else (got,)):
            assert torch.equal(a_[0], g_[0])
    assert ops.launches["batched_linear"] == before + 2 * len(calls)
    # the layer: forward one launch, backward two, within rtol 1e-5 of
    # torch's autograd
    xs = x.clone().requires_grad_(True)
    ws, bs = w.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    before = ops.launches["batched_linear"]
    y = ops.linear(xs, ws, bs)
    grads = torch.autograd.grad((y * dy).sum(), [xs, ws, bs])
    assert ops.launches["batched_linear"] == before + 3
    xp = x.clone().requires_grad_(True)
    wp, bp = w.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    yp = ref.linear(xp, wp, bp)
    want = torch.autograd.grad((yp * dy).sum(), [xp, wp, bp])
    torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
    for g_, w_ in zip(grads, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("G", [1, 3, 45])
@pytest.mark.parametrize("S", [106, 24, 298])
def test_td_grad_within_bar_and_batch_invariant(cuda, S, G):
    """The TD step's forward, loss and backward in one launch within rtol
    1e-5 (atol 1e-5 x the leaf's max) of the card path before it
    (td_grad/ref.py over batched_linear) and of plain torch, two runs
    torch.equal, agents not ready exactly 0, agent 0 alone torch.equal to
    agent 0 of G (chip_smoke.hold_td_grad)."""
    from chip_smoke import hold_td_grad
    from repro_torch.kernels.td_grad import ops
    before = ops.launches["td_grad"]
    hold_td_grad(cuda, G, S)
    assert ops.launches["td_grad"] == before + (3 if G > 1 else 2)


def test_td_grad_every_agent_not_ready_is_zero(cuda):
    from chip_smoke import hold_td_grad
    hold_td_grad(cuda, 3, 106, torch.zeros(3, device=cuda))


@pytest.mark.parametrize("G", [1, 3, 45])
def test_adamw_lanes_equals_card_path(cuda, G):
    """The clipped AdamW step in one launch: new params, m and v
    torch.equal to the card path's (batched_linear's norm and the torch
    ops) for the same gradients, every third agent not ready."""
    from chip_smoke import hold_adamw_lanes
    from repro_torch.kernels.adamw_lanes import ops
    before = ops.launches["adamw_lanes"]
    hold_adamw_lanes(cuda, G)
    assert ops.launches["adamw_lanes"] == before + 1


@pytest.mark.parametrize("G", [1, 45])
def test_td_step_launches_each_kernel_once(cuda, G):
    """`agent.train` at the paper's network: one td_grad and one
    adamw_lanes launch, no batched_linear product, two dueling_qnet
    launches (the targets)."""
    from chip_smoke import aimm_kernel_ops, td_agents
    from repro_torch.core import agent as agent_mod
    ag, cfg = td_agents(cuda, G)
    ops = aimm_kernel_ops()
    before = [dict(o.launches) for o in ops]
    out = agent_mod.train(ag, cfg)
    got = {k: v - b[k] for o, b in zip(ops, before)
           for k, v in o.launches.items() if v - b[k]}
    assert got == {"td_grad": 1, "adamw_lanes": 1, "dueling_qnet": 2,
                   "threefry": got["threefry"]}
    assert torch.isfinite(out.loss_ema).all()


def test_td_step_uncovered_shape_takes_the_card_path(cuda):
    """A network td_grad does not cover (hidden 96 / 64) trains through
    autograd over batched_linear's products, and its update through
    adamw_lanes; its loss and new parameters match the CPU's within rtol
    1e-5 (atol 1e-5 x the leaf's max)."""
    from chip_smoke import aimm_kernel_ops, td_agents
    from repro_torch.core import agent as agent_mod
    ag, cfg = td_agents(cuda, 3, hidden=(96, 64))
    ops = aimm_kernel_ops()
    before = [dict(o.launches) for o in ops]
    out = agent_mod.train(ag, cfg)
    got = {k: v - b[k] for o, b in zip(ops, before)
           for k, v in o.launches.items() if v - b[k]}
    assert "td_grad" not in got and got["batched_linear"] > 0
    assert got["adamw_lanes"] == 1
    ag_cpu = ag.replace(**{f: _to_cpu(getattr(ag, f)) for f in (
        "params", "target_params", "opt_state", "replay", "step",
        "train_steps", "loss_ema", "global_step", "rng")})
    want = agent_mod.train(ag_cpu, cfg)
    torch.testing.assert_close(out.loss_ema.cpu(), want.loss_ema, rtol=1e-5,
                               atol=1e-6)
    for k, p in want.params.items():
        torch.testing.assert_close(out.params[k].cpu(), p, rtol=1e-5,
                                   atol=1e-5 * p.abs().max().item())


def _to_cpu(x):
    import dataclasses
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return dataclasses.replace(x, **{f.name: _to_cpu(getattr(x, f.name))
                                     for f in dataclasses.fields(x)})


def test_learned_grid_equals_serial_on_card(cuda):
    """Learned lanes that train (3 episodes of SPMV/4096 and a greedy eval,
    3 seeds folded) in one run_grid equal their serial runs on the card:
    the batch-invariant TD step keeps every agent's bits whatever G."""
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import run_episode, run_program
    from repro_torch.nmp.scenarios import Scenario, seed_variants
    from repro_torch.nmp.sweep import run_grid
    from repro_torch.nmp.traces import make_trace
    tr = make_trace("SPMV", n_ops=4096)
    grid = seed_variants(Scenario(name="s", trace=tr, mapper="aimm",
                                  episodes=3, eval_episode=True),
                         seeds=(0, 1, 2))
    res = run_grid(grid, NMPConfig(), device=cuda)
    for i, sc in enumerate(grid):
        runs = run_program(tr, NMPConfig(), "bnmp", "aimm", episodes=3,
                           seed=sc.seed, device=cuda)
        runs.append(run_episode(tr, NMPConfig(), "bnmp", "aimm",
                                agent=runs[-1].agent, seed=sc.seed,
                                explore=False, device=cuda))
        assert int(runs[-1].agent.train_steps[0]) > 0
        for e, r in enumerate(runs):
            assert np.array_equal(res.metrics["opc_t"][i, e],
                                  r.metrics["opc"].cpu().numpy()), (i, e)


def _lineage_phases(tags):
    """Two phases of learned lineage lanes, one lane per tag: KM then SC at
    2048 ops (past min_replay, so the agents take TD steps)."""
    from repro_torch.nmp.scenarios import Scenario
    from repro_torch.nmp.traces import make_trace
    traces = {a: make_trace(a, n_ops=2048) for a in ("KM", "SC")}
    seeds = {"a": 0, "b": 5}
    return [[Scenario(name=f"p{pi}:{t}", trace=traces[app], mapper="aimm",
                      episodes=2, seed=seeds[t], lineage=t) for t in tags]
            for pi, app in enumerate(("KM", "SC"))]


def test_lineage_grid_equals_chained_single_lineage_runs_on_card(cuda):
    """Two lineages in one run_grid per phase, on the card, equal each
    lineage run alone through the same phases: every metric and per-epoch
    array, and every stored leaf (the batch-invariant TD step)."""
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.continual import PolicyStore
    from repro_torch.nmp.sweep import run_grid
    from repro_torch.train.checkpoint import leaf_paths
    both = PolicyStore()
    grid = [run_grid(ph, NMPConfig(), store=both, device=cuda)
            for ph in _lineage_phases(("a", "b"))]
    for lane, tag in enumerate(("a", "b")):
        alone = PolicyStore()
        for pi, ph in enumerate(_lineage_phases((tag,))):
            res = run_grid(ph, NMPConfig(), store=alone, device=cuda)
            for k, v in res.metrics.items():
                assert np.array_equal(grid[pi].metrics[k][lane], v[0]), (
                    tag, pi, k)
            assert np.array_equal(grid[pi].actions[lane], res.actions[0])
        assert int(alone.get(tag)["train_steps"]) > 0
        for (k, a), (_, b) in zip(leaf_paths(both.get(tag)),
                                  leaf_paths(alone.get(tag))):
            assert a.dtype == b.dtype and np.array_equal(a, b), (tag, k)


def test_agent_staging_batch_on_card_equals_per_cell_stack(cuda):
    """The warm agent batch built through AgentStaging's host buffers (one
    copy per leaf) equals the per-cell stack on the card (a `checkout` or
    `cold_start` per cell, concatenated), leaf for leaf: warm cells from
    the store, fresh tags cold-started on the card, seed padding and lane
    padding."""
    from repro_torch.core import agent as agent_mod
    from repro_torch.nmp import plan as plan_mod
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.continual import PolicyStore
    from repro_torch.nmp.engine import default_agent_cfg
    from repro_torch.nmp.scenarios import seed_variants
    from repro_torch.nmp.sweep import AgentStaging, _warm_agent_batch
    from repro_torch.train.checkpoint import leaf_paths
    cfg = NMPConfig()
    acfg = default_agent_cfg(cfg)
    store = PolicyStore()
    store.put("a", agent_mod.cold_start(11, acfg, device=cuda))
    (p0,) = _lineage_phases(("a", "b"))[:1]
    grid = seed_variants(p0[0], seeds=(0, 1)) + [p0[1]]
    group = next(g for g in plan_mod.plan_grid(grid, cfg).groups
                 if g.lineage)
    cells = []                                    # the per-cell stack
    for lane in group.lanes:
        tag = lane.scenario.lineage
        warm = store.checkout(tag, cuda) if tag in store else None
        for seed in lane.seeds + (lane.seeds[0],) * (3 - group.n_seeds):
            cells.append(warm if warm is not None
                         else agent_mod.cold_start(int(seed), acfg,
                                                   device=cuda))
    cells += cells[:3] * (3 - group.n_lanes)
    want = agent_mod.cat_agents(cells)
    got = _warm_agent_batch(group, 3, store, acfg, cuda, n_seeds=3,
                            staging=AgentStaging())
    assert got.params["w0"].device.type == "cuda"
    assert got.step.shape == (9,)
    for (k, x), (_, y) in zip(leaf_paths(agent_mod.export_agents(got)),
                              leaf_paths(agent_mod.export_agents(want))):
        assert x.dtype == y.dtype and np.array_equal(x, y), k


# ---------------------------------------------------------------------------
# the later model families: one full-width layer of each, card against CPU
# (the zoo's bf16 bar: rtol 2e-2, atol 2e-2 x max |CPU|; MoE layers on the
# CPU run's routes, repro_torch.testing.RouteReplay, the card's own top-k
# agreeing on MIN_ROUTE_AGREEMENT of the tokens), and the MoE layer's
# repeat run
# ---------------------------------------------------------------------------

FAMILY_LAYERS = [("gemma3-12b", ("L", "D")), ("gemma3-12b", ("G", "D")),
                 ("deepseek-moe-16b", ("A", "E")), ("qwen3-32b", ("A", "D")),
                 ("phi3-medium-14b", ("A", "D")),
                 ("mixtral-8x22b", ("W", "E")),
                 ("jamba-1.5-large-398b", ("A", "E"))]


@pytest.mark.parametrize("arch,block", FAMILY_LAYERS,
                         ids=[f"{a}-{''.join(b)}" for a, b in FAMILY_LAYERS])
def test_full_width_layer_card_matches_cpu(cuda, arch, block):
    import dataclasses
    from repro_torch.testing import RouteReplay, hold_bf16, tree_to
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch), n_layers=1, pattern=(block,),
                              first_k_dense=0)
    card, cpu = build_model(cfg, cuda), build_model(cfg, "cpu")
    params, _ = card.init(4)
    toks = torch.randint(1, cfg.vocab, (1, 128),
                         generator=torch.Generator().manual_seed(4))
    routes = RouteReplay()
    with torch.inference_mode():
        with routes.record():
            want = cpu.apply(tree_to(params, "cpu"), {"tokens": toks})[0]
        before = ops.kernel_launches["wgmma_bf16"]
        with routes.replay():
            got = card.apply(params, {"tokens": toks.to(cuda)})[0]
        torch.cuda.synchronize()
    assert ops.kernel_launches["wgmma_bf16"] == before + 1
    hold_bf16(got, want, f"{arch} {block}")
    routes.check(f"{arch} {block}")
    assert routes.seen == (128 if cfg.moe is not None else 0)


def test_moe_layer_repeat_runs_equal_on_card(cuda):
    """deepseek-moe-16b's MoE layer at full width (E 64, top 6, 2 shared),
    T 4096 and T 4 (a decode step at batch 4): two runs torch.equal, the
    combine gathering each token's slots in a fixed order."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.testing import RouteReplay
    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device=cuda).manual_seed(5)
    params, _ = moe.init_moe(gen, cfg.d_model, cfg.moe)
    for T in (4096, 4):
        x = torch.randn((1, T, cfg.d_model), generator=gen,
                        device=cuda).bfloat16()
        (y0, a0), (y1, a1) = (moe.moe_ffn(params, x, cfg.moe)
                              for _ in range(2))
        assert torch.equal(y0, y1) and torch.isfinite(y0.float()).all()
        assert all(torch.equal(a0[k], a1[k]) for k in a0)
        routes = RouteReplay()
        with routes.record():
            moe.route({k: v.cpu() for k, v in params.items()},
                      x.reshape(T, -1).cpu(), cfg.moe)
        with routes.replay():
            moe.route(params, x.reshape(T, -1), cfg.moe)
        routes.check(f"deepseek-moe-16b MoE layer T {T}, card vs CPU")
        assert routes.seen == T


def test_moe_layer_backward_repeat_runs_equal_on_card(cuda):
    """deepseek-moe-16b's MoE layer at full width, T 4096: the gradients
    of the input and of every weight (through the gathers, the batched
    expert products, the gathered combine and the lb_loss term) twice
    torch.equal, finite."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device=cuda).manual_seed(6)
    params, _ = moe.init_moe(gen, cfg.d_model, cfg.moe)
    x = torch.randn((1, 4096, cfg.d_model), generator=gen,
                    device=cuda).bfloat16()
    dy = torch.randn(x.shape, generator=gen, device=cuda).bfloat16()
    keys = sorted(params)

    def grads():
        leaves = [params[k].detach().requires_grad_() for k in keys]
        xg = x.detach().requires_grad_()
        y, aux = moe.moe_ffn(dict(zip(keys, leaves)), xg, cfg.moe)
        loss = (y.float() * dy.float()).sum() + 1e-2 * aux["lb_loss"]
        return torch.autograd.grad(loss, leaves + [xg])

    first, second = grads(), grads()
    for k, a, b in zip(keys + ["x"], first, second):
        assert torch.equal(a, b), k
        assert bool(torch.isfinite(a.float()).all()), k


# ---------------------------------------------------------------------------
# non-causal flash with S_kv != S (the encoder's 'B' layers and cross
# attention), each CUDA kernel; whole 'B' and 'C' blocks at full width
# ---------------------------------------------------------------------------

KV_KERNELS = [(torch.bfloat16, 16, "mma_sync_bf16"),
              (torch.bfloat16, 32, "mma_sync_bf16"),
              (torch.bfloat16, 64, "wgmma_bf16"),
              (torch.bfloat16, 128, "wgmma_bf16"),
              (torch.bfloat16, 256, "wgmma_bf16"),
              (torch.float32, 32, "cuda_core_f32"),
              (torch.float32, 128, "cuda_core_f32")]


@pytest.mark.parametrize("dtype,hd,kernel", KV_KERNELS,
                         ids=[f"{k}-hd{h}" for _, h, k in KV_KERNELS])
@pytest.mark.parametrize("S,S_kv", [(100, 1500), (448, 1500), (1500, 1500),
                                    (300, 77), (1000, 17), (130, 129),
                                    (1, 200)])
def test_flash_attention_separate_kv_length_each_kernel(cuda, dtype, hd,
                                                        kernel, S, S_kv):
    """Non-causal, q (B, S) against k/v (B, S_kv): S_kv above and below S,
    ragged on both sides (the last query and key tiles part-full), against
    the plain version within BARS."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import BARS, compare
    assert ops.kernel_for(dtype, hd) == kernel
    gen = torch.Generator(device=cuda).manual_seed(S + S_kv + hd)
    q = torch.randn((2, S, 4, hd), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((2, S_kv, 2, hd), generator=gen,
                        device=cuda).to(dtype) for _ in range(2))
    before = dict(ops.kernel_launches)
    got = ops.gqa_flash_attention_kv(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in ops.kernel_launches.items()} == {
        n: int(n == kernel) for n in ops.KERNELS}
    assert got.shape == q.shape and got.dtype == dtype
    cmp = compare(got, _flash_plain(q, k, v, causal=False))
    assert cmp["ok"], (cmp, BARS[dtype])


def test_flash_attention_causal_separate_kv_length_raises(cuda):
    """Causal with S_kv != S: the wrapper raises before any launch, and the
    C launcher refuses it too (cudaErrorInvalidValue), as does a window
    without causal."""
    from repro_torch.kernels.flash_attention import ops
    q = torch.zeros((1, 64, 2, 64), device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros((1, 96, 2, 64), device=cuda, dtype=torch.bfloat16)
    out = torch.empty_like(q)
    before = ops.launches["flash_attention"]
    with pytest.raises(ValueError, match="S_kv == S"):
        ops.gqa_flash_attention_kv(q, kv, kv, causal=True)
    assert ops.launches["flash_attention"] == before
    lib = ops._lib()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for causal, window, s_kv in ((1, 0, 96), (0, 8, 96), (0, 0, 0)):
        code = lib.flash_attention_launch(
            q.data_ptr(), kv.data_ptr(), kv.data_ptr(), out.data_ptr(), 1, 64,
            s_kv, 2, 2, 64, 0.125, causal, window, ops.KERNELS["wgmma_bf16"],
            stream)
        assert code != 0, (causal, window, s_kv)


ENCDEC_BLOCKS = [("whisper-large-v3", 448, 1500),
                 ("llama-3.2-vision-11b", 256, 1601)]


@pytest.mark.parametrize("arch,S,S_mem", ENCDEC_BLOCKS)
def test_full_width_encdec_block_card_matches_cpu(cuda, arch, S, S_mem):
    """One full-width 'C' block on the card (kernels) against the CPU path,
    final hidden state, the zoo's bf16 bar: whisper's with one encoder 'B'
    block before it (enc_frames S 1500, tokens 448: the 'B' self-attention,
    the causal self-attention and the 448 x 1500 cross attention, three
    launches), llama-vision's against 1601 image tokens (two launches)."""
    import dataclasses
    from repro_torch.configs import EncoderCfg, get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import build_model
    from repro_torch.testing import hold_bf16, tree_to
    cfg = dataclasses.replace(get_config(arch), n_layers=1,
                              pattern=(("C", "D"),))
    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=EncoderCfg(n_layers=1,
                                                          dec_seq=S))
    card, cpu = build_model(cfg, cuda), build_model(cfg, "cpu")
    params, _ = card.init(6)
    g = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(1, cfg.vocab, (1, S), generator=g)}
    key = "enc_frames" if cfg.encoder is not None else "img_embed"
    batch[key] = torch.randn((1, S_mem, cfg.d_model), generator=g).bfloat16()
    with torch.inference_mode():
        want = cpu.apply(tree_to(params, "cpu"), batch)[0]
        before = ops.kernel_launches["wgmma_bf16"]
        got = card.apply(params, {k: v.to(cuda) for k, v in batch.items()})[0]
        torch.cuda.synchronize()
    n = 3 if cfg.encoder is not None else 2
    assert ops.kernel_launches["wgmma_bf16"] == before + n
    hold_bf16(got, want, f"{arch} 'C' block")


# ---------------------------------------------------------------------------
# training: the backward kernels (flash_attention_bwd.cu, ssd_scan_bwd.cu)
# against autograd through their plain versions (flash: GRAD_BARS of
# flash_attention/ref.py; SSD: 1e-4 relative L2 per gradient), two runs
# torch.equal, and the variants that are not ported raising
# ---------------------------------------------------------------------------

def _flash_train_inputs(dev, B, S, H, K, hd, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, S, n, hd), generator=gen, device=dev).to(dtype)
            for n in (H, K, K, H)]


def _flash_grads(q, k, v, do, **kw):
    from repro_torch.kernels.flash_attention import ops
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = ops.gqa_flash_attention_kv(q, k, v, **kw)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), do))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,K,hd", [(2, 100, 4, 2, 64),
                                        (1, 384, 8, 2, 128),
                                        (2, 1000, 4, 4, 64),
                                        (1, 4096, 32, 8, 128),
                                        (1, 64, 4, 4, 128),
                                        (1, 64, 8, 1, 64),
                                        (2, 129, 4, 2, 64),
                                        (1, 129, 8, 1, 128),
                                        (1, 4097, 8, 8, 128),
                                        (2, 4097, 8, 1, 64)])
def test_flash_backward_within_bars(cuda, B, S, H, K, hd, dtype):
    """Within GRAD_BARS of the plain autograd and two runs torch.equal, at
    the kernels' tile edges too: S of one 64-row tile, one past a 128-row
    tile and one past 4096, GQA ratios 1 and 8, B 2 at hd 64."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        GRAD_BARS, attention_grads_ref, compare_grad)
    q, k, v, do = _flash_train_inputs(cuda, B, S, H, K, hd, dtype, S + hd)
    before = dict(ops.launches)
    out, *got = _flash_grads(q, k, v, do, causal=True)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before["flash_attention"] + 1
    assert (ops.launches["flash_attention_bwd"]
            == before["flash_attention_bwd"] + 1)
    _equal((out, *got), _flash_grads(q, k, v, do, causal=True))
    ref_out, *want = attention_grads_ref(q, k, v, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        cmp = compare_grad(g, w)
        assert cmp["ok"], (name, cmp, GRAD_BARS[dtype])
    # the forward with the LSE store gives the prefill forward's bits
    with torch.no_grad():
        plain_fwd = ops.gqa_flash_attention_kv(q, k, v, causal=True)
    assert torch.equal(out, plain_fwd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_lse_is_the_rows_logsumexp(cuda, dtype):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import visible
    B, S, H, K, hd = 1, 300, 4, 2, 128
    q, k, v, _ = _flash_train_inputs(cuda, B, S, H, K, hd, dtype, 5)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
    ops._forward(q, k, v, hd ** -0.5, True, 0, lse)
    kk = k.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * hd ** -0.5
    s = s.masked_fill(~visible(S, S, 0, cuda), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_backward_two_runs_equal(cuda, dtype):
    q, k, v, do = _flash_train_inputs(cuda, 1, 1000, 8, 2, 128, dtype, 9)
    first = _flash_grads(q, k, v, do, causal=True)
    second = _flash_grads(q, k, v, do, causal=True)
    _equal(first, second)


# (B, S, S_kv, H, K, hd, causal, window): S and S_kv off every tile
# multiple, S_kv < S and S_kv > S, a window below one 64-row tile and one
# >= S, GQA ratios 1, 2, 4 and 6, B 2
BWD_VARIANTS = [
    ("window-sub-tile", 1, 200, 200, 4, 2, 128, True, 48),
    ("window-hd64-b2", 2, 1500, 1500, 4, 1, 64, True, 100),
    ("window-ge-s", 1, 448, 448, 6, 1, 128, True, 1000),
    ("window-hd256", 2, 448, 448, 6, 1, 256, True, 100),
    ("window-hd256-long", 1, 1500, 1500, 4, 2, 256, True, 300),
    ("encoder", 1, 1500, 1500, 4, 4, 64, False, 0),
    ("cross-skv-gt-s-b2", 2, 448, 1500, 4, 2, 64, False, 0),
    ("cross-skv-lt-s", 1, 1500, 200, 8, 2, 128, False, 0),
    ("cross-ratio6", 1, 200, 1601, 6, 1, 128, False, 0),
    ("cross-hd256", 1, 200, 1601, 4, 4, 256, False, 0),
    ("cross-hd256-skv-lt-s", 1, 1601, 448, 4, 2, 256, False, 0),
    ("causal-hd256", 1, 1500, 1500, 4, 2, 256, True, 0),
    ("causal-hd256-b2", 2, 129, 129, 8, 2, 256, True, 0),
    # hd 16 and 32 (the smoke configs' widths; bf16 on mma.sync): the smoke
    # training shape (B 4, S 128) causal and with its window 32, a window
    # below one tile, a ragged S, and non-causal with S_kv == S, > S, < S
    ("smoke-causal-hd16", 4, 128, 128, 4, 2, 16, True, 0),
    ("smoke-window32-hd16", 4, 128, 128, 4, 2, 16, True, 32),
    ("window-sub-tile-hd16", 1, 200, 200, 4, 2, 16, True, 8),
    ("causal-hd32-ragged-b2", 2, 1000, 1000, 4, 2, 32, True, 0),
    ("window-hd32", 1, 1024, 1024, 6, 1, 32, True, 100),
    ("encoder-hd16", 1, 1500, 1500, 4, 4, 16, False, 0),
    ("cross-skv-gt-s-hd32-b2", 2, 448, 1500, 4, 2, 32, False, 0),
    ("cross-skv-lt-s-hd16", 1, 1500, 200, 8, 2, 16, False, 0),
]


def _flash_variant_inputs(dev, B, S, S_kv, H, K, hd, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, n_s, n, hd), generator=gen, device=dev).to(dtype)
            for n_s, n in ((S, H), (S_kv, K), (S_kv, K), (S, H))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_VARIANTS, ids=[c[0] for c in BWD_VARIANTS])
def test_flash_backward_variants_within_bars(cuda, case, dtype):
    """Each mask and key length the forward takes, at hd 16, 32, 64, 128
    and 256: within GRAD_BARS of the plain autograd, one forward and one
    backward launch, two runs torch.equal, and the forward with the LSE
    store gives the prefill forward's bits."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        GRAD_BARS, attention_grads_ref, compare_grad)
    _, B, S, S_kv, H, K, hd, causal, window = case
    q, k, v, do = _flash_variant_inputs(cuda, B, S, S_kv, H, K, hd, dtype,
                                        S + S_kv + hd + window)
    kw = dict(causal=causal, window=window)
    before = dict(ops.launches)
    out, *got = _flash_grads(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before["flash_attention"] + 1
    assert (ops.launches["flash_attention_bwd"]
            == before["flash_attention_bwd"] + 1)
    _equal((out, *got), _flash_grads(q, k, v, do, **kw))
    _, *want = attention_grads_ref(q, k, v, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all()), name
        cmp = compare_grad(g, w)
        assert cmp["ok"], (name, cmp, GRAD_BARS[dtype])
    with torch.no_grad():
        plain_fwd = ops.gqa_flash_attention_kv(q, k, v, **kw)
    assert torch.equal(out, plain_fwd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,S_kv,hd,causal,window", [
    (300, 300, 256, True, 0), (300, 300, 128, True, 50),
    (300, 700, 64, False, 0), (700, 300, 256, False, 0),
    (300, 300, 16, True, 0), (300, 300, 16, True, 32),
    (300, 700, 32, False, 0), (700, 300, 16, False, 0),
    (300, 300, 32, True, 50)])
def test_flash_lse_variants_are_the_rows_logsumexp(cuda, dtype, S, S_kv, hd,
                                                   causal, window):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import visible
    B, H, K = 1, 4, 2
    q, k, v, _ = _flash_variant_inputs(cuda, B, S, S_kv, H, K, hd, dtype, 6)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
    ops._forward(q, k, v, hd ** -0.5, causal, window, lse)
    kk = k.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * hd ** -0.5
    if causal:
        s = s.masked_fill(~visible(S, S, window, cuda), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [16, 32])
def test_flash_backward_smoke_widths_main_shape(cuda, hd, dtype):
    """minitron-8b's attention shape cut to hd 16 and 32 (B 1, S 4096, H 32,
    K 8, causal): within GRAD_BARS of the plain autograd, one backward
    launch, two runs torch.equal."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        GRAD_BARS, attention_grads_ref, compare_grad)
    q, k, v, do = _flash_train_inputs(cuda, 1, 4096, 32, 8, hd, dtype, hd)
    before = dict(ops.launches)
    out, *got = _flash_grads(q, k, v, do, causal=True)
    torch.cuda.synchronize()
    assert (ops.launches["flash_attention_bwd"]
            == before["flash_attention_bwd"] + 1)
    _equal((out, *got), _flash_grads(q, k, v, do, causal=True))
    _, *want = attention_grads_ref(q, k, v, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        cmp = compare_grad(g, w)
        assert cmp["ok"], (name, cmp, GRAD_BARS[dtype])


@pytest.mark.parametrize("B,L,H,P,N,chunk", [(2, 64, 4, 16, 8, 32),
                                             (1, 256, 4, 64, 128, 64),
                                             (2, 512, 3, 48, 100, 128),
                                             (1, 1024, 8, 64, 128, 256),
                                             (1, 256, 2, 16, 16, 256),
                                             (1, 384, 4, 48, 100, 96),
                                             (2, 192, 3, 16, 100, 96)])
def test_ssd_backward_within_bar(cuda, B, L, H, P, N, chunk):
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_grads_ref
    gen = torch.Generator(device=cuda).manual_seed(L + P + N)
    rnd = lambda *s: 0.5 * torch.randn(s, generator=gen, device=cuda)
    x, b, c, dy = rnd(B, L, H, P), rnd(B, L, N), rnd(B, L, N), rnd(B, L, H, P)
    dt = rnd(B, L, H).abs() * 0.2
    a = -rnd(H).abs() - 0.1
    xs = [t.requires_grad_() for t in (x, b, c, dt, a)]
    before = dict(ops.launches)
    y = ops.ssd(*xs, chunk=chunk)
    got = torch.autograd.grad(y, xs, dy)
    torch.cuda.synchronize()
    assert ops.launches["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    want = ssd_grads_ref(*xs, dy, chunk=chunk)
    for name, g, w in zip(("dx", "db", "dc", "ddt", "da"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        rel = float((g - w).norm() / w.norm())
        assert rel <= 1e-4, (name, rel)


@pytest.mark.parametrize("carry", [False, True])
def test_ssd_backward_main_shape_and_repeat(cuda, carry):
    """mamba2-370m's SSD shape, gradients within 1e-4 relative L2, and two
    runs torch.equal."""
    from chip_smoke import ssd_inputs
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_grads_ref
    xs = [t.requires_grad_() for t in ssd_inputs(cuda, carry)]
    dy = torch.randn(xs[0].shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(3))
    runs = [torch.autograd.grad(ops.ssd(*xs, chunk=256), xs, dy)
            for _ in range(2)]
    _equal(runs[0], runs[1])
    want = ssd_grads_ref(*xs, dy, chunk=256)
    for name, g, w in zip(("dx", "db", "dc", "ddt", "da"), runs[0], want):
        rel = float((g - w).norm() / w.norm())
        assert rel <= 1e-4, (name, rel)


def test_ssd_backward_chunk_not_ported_raises(cuda):
    from repro_torch.kernels.ssd_scan import ops
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1, 96, 2, 16), generator=gen, device=cuda)
    b, c = (torch.randn((1, 96, 8), generator=gen, device=cuda)
            for _ in range(2))
    dt = torch.rand((1, 96, 2), generator=gen, device=cuda) * 0.1
    a = -torch.ones(2, device=cuda)
    xs = [t.requires_grad_() for t in (x, b, c, dt, a)]
    y = ops.ssd(*xs, chunk=48)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        y.sum().backward()


def test_smoke_train_loop_on_card(cuda, tmp_path):
    """mamba2-370m's smoke config trains 4 steps on the card through
    `train_loop` with a restart at step 2: finite losses, the same losses as
    an uninterrupted run, and one SSD forward and backward launch per layer
    and microbatch a step."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.launch.train import train
    ops.reset_launches()
    res = train("mamba2-370m", smoke=True, steps=4, seq=64, global_batch=2,
                microbatches=2, ckpt_dir=str(tmp_path / "a"), device="cuda",
                fail_at=(2,), checkpoint_every=2, log=lambda m: None)
    per_step = 2 * 2            # n_layers x microbatches
    # the failure strikes before step 2 runs; the loop resumes at step 2
    assert ops.launches["ssd_scan_bwd"] == per_step * 4
    ref = train("mamba2-370m", smoke=True, steps=4, seq=64, global_batch=2,
                microbatches=2, ckpt_dir=str(tmp_path / "b"), device="cuda",
                log=lambda m: None)
    assert res["restarts"] == 1
    assert all(np.isfinite(res["losses"]))
    assert res["losses"] == ref["losses"]


def test_smoke_minitron_trains_on_card(cuda, tmp_path):
    """The reference's documented `launch.train --arch minitron-8b --smoke`
    on the card at its defaults (S 128, global batch 4) for 5 steps: finite
    losses, no restart, the flash backward at hd 16 once per attention
    layer a step."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.train import train
    ops.reset_launches()
    res = train("minitron-8b", smoke=True, steps=5, ckpt_dir=str(tmp_path),
                device="cuda", log=lambda m: None)
    assert res["restarts"] == 0
    assert len(res["losses"]) == 5 and all(np.isfinite(res["losses"]))
    assert res["cfg"].attn.head_dim == 16
    assert ops.launches["flash_attention_bwd"] == 2 * 5   # 2 layers x 5


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "qwen3-32b"])
def test_sharding_search_on_card_equals_cpu(cuda, arch):
    """The mapper's 60-step search on the card against the CPU's: every
    action, knob setting and step time `==`, or parting once at a greedy
    near-tie below 1e-4 relative (chip_smoke.hold_search); the search's
    Q network, TD step and draws launch their kernels."""
    from chip_smoke import hold_search, recording_acts
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.sharding_mapper import search
    from repro_torch.kernels.adamw_lanes import ops as aops
    from repro_torch.kernels.dueling_qnet import ops as qops
    from repro_torch.kernels.td_grad import ops as gops
    from repro_torch.kernels.threefry import ops as tops
    for ops in (gops, aops, qops, tops):
        ops.reset_launches()
    cfg = get_config(arch)
    card = search(cfg, SHAPES["train_4k"], steps=60, seed=0, device="cuda")
    assert qops.launches["dueling_qnet"] > 0
    assert gops.launches["td_grad"] == aops.launches["adamw_lanes"] > 0
    assert tops.launches["threefry"] > 0
    runs = {}
    for d in ("cuda", "cpu"):
        with recording_acts() as rec:
            runs[d] = (search(cfg, SHAPES["train_4k"], steps=60, seed=0,
                              device=d), rec)
    assert runs["cuda"][0] == card
    hold_search(arch, *runs["cuda"], *runs["cpu"])


def test_cost_models_unchanged_by_the_card(cuda):
    """memory_bytes, the Roofline and the cost model are host arithmetic:
    the same numbers with the card initialised and a kernel run."""
    from repro_torch.configs import ARCHS, SHAPES, get_config
    from repro_torch.core.sharding_mapper import CostModel, Knobs
    from repro_torch.launch.memory_model import memory_bytes
    from repro_torch.launch.roofline import Roofline
    from repro_torch.models.model import model_flops

    def numbers():
        out = []
        for arch in ARCHS:
            cfg = get_config(arch)
            for shape in SHAPES.values():
                mf, mb = model_flops(cfg, shape), memory_bytes(cfg, shape)
                out.append(Roofline(mf, mb, 0.0, 1, mf).as_dict())
            cm = CostModel(cfg, SHAPES["train_4k"])
            out.append([cm.hbm_per_chip(Knobs()), cm.objective(Knobs())])
        return out

    before = numbers()
    torch.ones(4, device="cuda").sum().item()
    assert numbers() == before


# ---------------------------------------------------------------------------
# The sharding layer on a one-card mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world1():
    """A world-1 nccl group and a (1, 1) mesh over the card."""
    import socket
    import torch.distributed as dist
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there (no "
                    "interpret mode for CUDA C++)")
    from repro_torch.launch.mesh import make_host_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    yield make_host_mesh(1, 1)
    dist.destroy_process_group()


@pytest.mark.parametrize("arch,layers,quant", [("minitron-8b", 1, True),
                                               ("mamba2-370m", 2, False),
                                               ("deepseek-moe-16b", 2, False)])
def test_world1_sharded_train_step_equals_unsharded(cuda, world1, arch,
                                                    layers, quant):
    """One training step (2 microbatches, S 512, full width, `layers`
    deep) through DTensor params, state and batch placed by the policies
    on the (1, 1) mesh: loss and updated params torch.equal to the
    unsharded step's, the same flash and SSD launches."""
    import dataclasses
    from chip_smoke import local_tree, placed, reset_zoo_launches, \
        zoo_launches
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models.model import abstract_init, build_model
    from repro_torch.sharding import policies as P
    from repro_torch.train.optimizer import adamw, quantized_adamw
    from repro_torch.train.train_step import make_train_step
    mesh = world1
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = build_model(cfg, cuda)
    S, B = 512, 2
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    shapes, roles = abstract_init(model)
    pspecs = P.param_specs(roles, shapes, cfg, mesh)
    ospecs = P.opt_state_specs(pspecs, shapes, mesh, cfg, quantized=quant)
    one = ShapeCfg("mb", S, B // 2, "train")
    mbspecs = P.batch_specs(cfg, one, mesh, model.input_specs(one))
    bspecs = P.batch_specs(cfg, ShapeCfg("b", S, B, "train"), mesh,
                           model.input_specs(ShapeCfg("b", S, B, "train")))
    opt = (quantized_adamw if quant else adamw)(1e-3, weight_decay=0.01,
                                                 grad_clip=1.0)
    step = torch.tensor(0, device=cuda)
    p0, _ = model.init(0)
    reset_zoo_launches()
    p0, _, m0 = make_train_step(model, opt, microbatches=2)(
        p0, opt.init(p0), batch, step)
    torch.cuda.synchronize()
    c0 = zoo_launches()
    p1, _ = model.init(0)
    reset_zoo_launches()
    p1, _, m1 = make_train_step(
        model, opt, microbatches=2,
        grad_shardings=P.zero_shard_specs(pspecs, shapes, mesh, cfg),
        batch_shardings={k: mbspecs[k] for k in batch})(
        placed(p1, pspecs, mesh), placed(opt.init(p1), ospecs, mesh),
        placed(batch, {k: bspecs[k] for k in batch}, mesh), step)
    torch.cuda.synchronize()
    assert zoo_launches() == c0 and any(c0.values())
    assert torch.equal(m1["loss"], m0["loss"])
    from repro_torch.core.tree import tree_leaves
    for a, b in zip(tree_leaves(local_tree(p1)), tree_leaves(p0)):
        assert torch.equal(a, b)


def test_world1_sharded_prefill_and_decode_equal(cuda, world1):
    """minitron-8b at 2 layers: the prefill (B 1, S 1024) and 8 greedy
    decode steps on placed caches torch.equal to the unsharded path, the
    prefill's flash launches the same."""
    import dataclasses
    from chip_smoke import local_tree, placed, reset_zoo_launches, \
        zoo_launches
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models.model import abstract_init, build_model
    from repro_torch.sharding import policies as P
    mesh = world1
    cfg = dataclasses.replace(get_config("minitron-8b"), n_layers=2)
    model = build_model(cfg, cuda)
    params, roles = model.init(0)
    shapes, _ = abstract_init(model)
    dparams = placed(params, P.param_specs(roles, shapes, cfg, mesh), mesh)
    S = 1024
    toks = torch.randint(0, cfg.vocab, (1, S), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
    with torch.no_grad():
        reset_zoo_launches()
        h0 = model.apply(params, {"tokens": toks})[0]
        c0 = zoo_launches()
        reset_zoo_launches()
        h1 = model.apply(dparams, {"tokens": placed(
            {"t": toks}, {"t": P.sharding((None, None), mesh)}, mesh)["t"]})[0]
        assert zoo_launches() == c0 and c0["flash_attention"] == 2
        assert torch.equal(local_tree({"h": h1})["h"], h0)
        dshape = ShapeCfg("d", S, 1, "decode")
        cs = P.batch_specs(cfg, dshape, mesh, model.input_specs(dshape))
        c_plain = model.init_caches(1, S)
        c_shard = placed(model.init_caches(1, S), cs["caches"], mesh)
        tok = toks[:, :1]
        for t in range(8):
            l0, c_plain = model.decode_step(params, tok, c_plain, t)
            l1, c_shard = model.decode_step(
                dparams, placed({"t": tok}, {"t": cs["token"]}, mesh)["t"],
                c_shard, t)
            assert torch.equal(local_tree({"l": l1})["l"], l0)
            tok = l0[:, -1].float().argmax(-1)[:, None]


# -- the partition layer: two ranks sharing the card ------------------------

def _mesh_grid_small():
    from repro_torch.nmp.scenarios import Scenario, seed_variants
    from repro_torch.nmp.traces import make_trace
    grid = []
    for app in ("KM", "PR"):
        tr = make_trace(app, n_ops=512)
        grid += seed_variants(Scenario(name=f"{app}/aimm", trace=tr,
                                       mapper="aimm", episodes=2),
                              seeds=(0, 1, 2))
        grid += [Scenario(name=f"{app}/none", trace=tr, mapper="none")]
    return grid


def _two_tenants():
    from repro_torch.nmp.scenarios import tenant_fleet
    return tenant_fleet(n_tenants=2, apps=("KM", "SC"), n_phases=2,
                        n_ops_per_app=512)


def _mesh_runs(dev):
    """The small grid under 2x1 and 1x2 (one rank's shape "1x1" alone) and
    a 2-tenant server on 2 slots: metrics, actions and the kernels'
    launches."""
    import os
    from chip_smoke import aimm_launches, reset_aimm_launches, served_record
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.serving import MappingServer
    from repro_torch.nmp.sweep import run_grid
    cfg = NMPConfig()
    out = {}
    for shape in ("2x1", "1x2"):
        if os.environ.get("REPRO_DIST_COORD"):
            os.environ["REPRO_SWEEP_MESH"] = shape
        reset_aimm_launches()
        res = run_grid(_mesh_grid_small(), cfg, device=dev)
        out[shape] = (res.metrics, res.actions, res.mesh_shape,
                      aimm_launches())
    srv = MappingServer(cfg, n_slots=2, device=dev)
    for tid, stream in _two_tenants().items():
        srv.submit(tid, stream)
    srv.run()
    out["server"] = served_record(srv)
    return out


def _gpu_mesh_worker(rank, port, out_dir):
    import os
    import pickle
    for k in ("REPRO_SWEEP_MESH", "REPRO_SWEEP_DEVICES", "LOCAL_RANK"):
        os.environ.pop(k, None)
    os.environ.update(REPRO_DIST_COORD=f"127.0.0.1:{port}",
                      REPRO_DIST_NPROCS="2", REPRO_DIST_RANK=str(rank))
    from repro_torch.nmp import partition
    torch.backends.cuda.matmul.allow_tf32 = False
    out = _mesh_runs(partition.rank_device("cuda"))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def test_two_ranks_on_the_card_equal_one(cuda, tmp_path):
    """Two rank processes sharing the card (a gloo group on localhost): the
    small grid under 2x1 and 1x2 and a 2-tenant server, every metric and
    per-epoch action `==` to one rank on the card, each rank launching the
    AIMM kernels."""
    import pickle
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    one = _mesh_runs(cuda)
    mp.spawn(_gpu_mesh_worker, args=(port, str(tmp_path)), nprocs=2,
             join=True)
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            got = pickle.load(f)
        for shape in ("2x1", "1x2"):
            m, a, mesh_shape, launches = got[shape]
            assert tuple(mesh_shape) == (int(shape[0]), int(shape[2]))
            assert set(m) == set(one[shape][0])
            for k, v in one[shape][0].items():
                assert np.array_equal(m[k], v), (rank, shape, k)
            assert np.array_equal(a, one[shape][1]), (rank, shape)
            for k in AIMM_PATH_KERNELS:
                assert launches[k] > 0, (rank, shape, k)
        srv, want = got["server"], one["server"]
        assert srv["stats"]["n_devices"] == 2
        for tid, phases in want["tenants"].items():
            for (gm, ga), (wm, wa) in zip(srv["tenants"][tid], phases):
                for k, v in wm.items():
                    assert np.array_equal(gm[k], v), (rank, tid, k)
                assert np.array_equal(ga, wa), (rank, tid)
