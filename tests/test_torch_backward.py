"""Gradients of the port's attention and SSD scan on the CPU against
`jax.grad` of the live JAX reference, in float32.

On the CPU the port's kernel wrappers (`gqa_flash_attention_kv`, `ssd`)
take their plain versions, and autograd runs through them; on the card the
same calls run the backward kernels (csrc/flash_attention_bwd.cu,
csrc/ssd_scan_bwd.cu; tests/test_torch_gpu.py holds those against this
plain autograd).  Inputs come from numpy seeds.  Bars, float32:
  * attention: each of dq, dk, dv within rtol 1e-4 and atol 1e-5 x max
    |reference| of `jax.grad` through the reference's own `attend` (dense,
    the mask of each kind) or `attend_chunked` (S 1024): both compute the
    same softmax in float32 in another order, a few ulp apart.
  * SSD: each of dx, db, dc, ddt, da within 1e-4 relative L2 of `jax.grad`
    through the reference's sequential `ssd_ref`, and the whole Mamba2
    block's gradients (input and every parameter) within 1e-4 relative L2
    of `jax.grad` through the reference's `mamba_block` (its `chunk_step`,
    the clipped exponents included: the block's decays clip there).
The bf16 bar of the flash backward kernel (`GRAD_BARS`) is checked here
against an emulation of the kernel's arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models import attention as jattn
from repro.models import mamba as jmamba
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (GRAD_BARS,
                                                     attention_grads_ref,
                                                     compare_grad)
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.models import mamba

# (id, B, S, S_kv, H, K, hd, kind, window)
ATTN_CASES = [("causal-gqa", 2, 64, 64, 4, 2, 16, "causal", 0),
              ("causal-hd64", 1, 96, 96, 4, 1, 64, "causal", 0),
              ("causal-hd128", 1, 40, 40, 2, 2, 128, "causal", 0),
              ("window", 1, 80, 80, 4, 2, 16, "window", 8),
              ("bidir", 2, 48, 48, 2, 2, 32, "bidir", 0),
              ("cross-skv", 1, 40, 72, 4, 2, 16, "bidir", 0)]


def _attn_inputs(seed, B, S, S_kv, H, K, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S_kv, K, hd), (B, S_kv, K, hd),
                      (B, S, H, hd))]


def _port_attn_grads(q, k, v, do, kind, window, scale):
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = fops.gqa_flash_attention_kv(q, k, v, causal=kind != "bidir",
                                      scale=scale, window=window)
    return [g.numpy() for g in torch.autograd.grad(out, (q, k, v),
                                                   torch.from_numpy(do))]


def _close(got, want, what):
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=what)


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_attention_grads_match_jax_grad(case):
    name, B, S, S_kv, H, K, hd, kind, window = case
    q, k, v, do = _attn_inputs(S + hd, B, S, S_kv, H, K, hd)
    scale = hd ** -0.5

    def f(q, k, v):
        o = jattn.attend(q, jattn._expand_kv(k, H), jattn._expand_kv(v, H),
                         kind, window, scale)
        return jnp.sum(o * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    got = _port_attn_grads(q, k, v, do, kind, window, scale)
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, np.asarray(w), f"{name} {n}")


@pytest.mark.parametrize("kind,window", [("causal", 0), ("window", 300)])
def test_attention_grads_match_jax_grad_of_attend_chunked(kind, window):
    B, S, H, K, hd = 1, 1024, 2, 1, 16
    q, k, v, do = _attn_inputs(7, B, S, S, H, K, hd)
    scale = hd ** -0.5

    def f(q, k, v):
        o = jattn.attend_chunked(q, jattn._expand_kv(k, H),
                                 jattn._expand_kv(v, H), kind, window, scale)
        return jnp.sum(o * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    got = _port_attn_grads(q, k, v, do, kind, window, scale)
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, np.asarray(w), f"chunked {kind} {n}")


def _emulated_kernel_grads(q, k, v, do, scale):
    """The backward kernels' arithmetic in float32 torch ops: P from the
    row log-sum-exp, D = rowsum(dO o) from the forward's output in q's
    dtype, every product in float32, gradients rounded to q's dtype."""
    H, K = q.shape[2], k.shape[2]
    rep = H // K
    out, *_ = attention_grads_ref(q, k, v, do, scale=scale)
    qf, kf, vf, df = (t.float() for t in (q, k, v, do))
    kk, vv = (t.repeat_interleave(rep, dim=2) for t in (kf, vf))
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kk) * scale
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    D = (df * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", df, vv) - D)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kk) * scale
    fold = lambda t: t.reshape(*t.shape[:2], K, rep, t.shape[-1]).sum(3)
    dk = fold(torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale)
    dv = fold(torch.einsum("bhqk,bqhd->bkhd", p, df))
    return [t.to(q.dtype) for t in (dq, dk, dv)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_grad_bars_hold_for_the_kernels_arithmetic(dtype):
    """GRAD_BARS against the plain autograd at S 1024, hd 128: the
    emulated kernel passes each bar (bf16 reads ~2.7e-3 relative L2)."""
    q, k, v, do = (torch.from_numpy(t).to(dtype) for t in
                   _attn_inputs(0, 1, 1024, 1024, 4, 2, 128))
    _, *want = attention_grads_ref(q, k, v, do)
    got = _emulated_kernel_grads(q, k, v, do, 128 ** -0.5)
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        cmp = compare_grad(g, w)
        assert cmp["ok"], (n, cmp, GRAD_BARS[dtype])
        if dtype == torch.bfloat16:
            assert cmp["rel_l2"] > 1e-4      # the bar is not idle


def _ssd_inputs(seed, B, L, H, P, N):
    rng = np.random.default_rng(seed)
    rnd = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    x, b, c, dy = rnd(B, L, H, P), rnd(B, L, N), rnd(B, L, N), rnd(B, L, H, P)
    dt = np.abs(rnd(B, L, H)) * 0.1
    a = -np.abs(rnd(H)) - 0.1
    return (x, b, c, dt, a), dy


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("L,chunk", [(128, 32), (96, 96)])
def test_ssd_grads_match_jax_grad_of_ssd_ref(L, chunk):
    xs, dy = _ssd_inputs(L, 2, L, 3, 16, 8)

    def f(*xs):
        return jnp.sum(jax_ssd_ref(*xs) * dy)

    want = jax.grad(f, argnums=tuple(range(5)))(*xs)
    tx = [torch.from_numpy(t).requires_grad_() for t in xs]
    sops.reset_launches()
    y = sops.ssd(*tx, chunk=chunk)
    got = torch.autograd.grad(y, tx, torch.from_numpy(dy))
    assert sops.launches == {"ssd_scan": 0, "ssd_scan_bwd": 0}   # CPU: plain
    for n, g, w in zip(("dx", "db", "dc", "ddt", "da"), got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= 1e-4, n


@pytest.fixture(scope="module")
def mamba_pair():
    """f32 weights of the mamba2 smoke block (dt_bias drawn around 0.5, so
    the chunked form's exponents clip), its input and output cotangent, and
    `jax.grad` of the reference's `mamba_block` over all of them."""
    cfg = get_config("mamba2-370m", smoke=True)
    jcfg = jax_get_config("mamba2-370m", smoke=True)
    D = cfg.d_model
    key = jax.random.PRNGKey(3)
    jp = {k: np.array(v, np.float32) for k, v in
          jmamba.init_mamba(key, D, jcfg.ssm)[0].items()}
    rng = np.random.default_rng(3)
    jp["dt_bias"] = rng.standard_normal(jp["dt_bias"].shape).astype(
        np.float32) * 0.5 + 0.5
    h = rng.standard_normal((2, 64, D)).astype(np.float32)
    dout = rng.standard_normal((2, 64, D)).astype(np.float32)

    def f(params, h):
        return jnp.sum(jmamba.mamba_block(params, h, jcfg.ssm, D) * dout)

    gp, gh = jax.grad(f, argnums=(0, 1))(jp, h)
    return cfg, jp, h, dout, gp, gh


def test_mamba_block_grads_match_jax_grad(mamba_pair):
    cfg, jp, h, dout, gp, gh = mamba_pair
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in jp.items()}
    th = torch.from_numpy(h).requires_grad_()
    out = mamba.mamba_block(params, th, cfg.ssm, cfg.d_model)
    keys = sorted(params)
    grads = torch.autograd.grad(out, [params[k] for k in keys] + [th],
                                torch.from_numpy(dout))
    for k, g in zip(keys, grads):
        assert _rel(g.numpy(), gp[k]) <= 1e-4, k
    assert _rel(grads[-1].numpy(), gh) <= 1e-4


def test_mamba_block_decays_clip(mamba_pair):
    """The fixture's decays reach the clip: some in-chunk exponent is below
    -60, so the clipped gradient path is exercised above."""
    cfg, jp, h, *_ = mamba_pair
    dt = np.log1p(np.exp(jp["dt_bias"]))        # the typical dt, x ~ 0
    a = -np.exp(jp["a_log"])
    assert float((dt * a).min()) * cfg.ssm.chunk < -60
