"""The port's flash attention (`repro_torch.kernels.flash_attention`) on the
CPU against the live JAX reference.

The same inputs, drawn with numpy from a fixed seed, go to the reference's
`gqa_flash_attention` (the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it) and to the port's wrapper, which takes its
plain version for CPU tensors.  Tolerances are the reference's own: 2e-5
for float32, 2e-2 for bfloat16 (its output is rounded to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import gqa_flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.attention import _expand_kv as jax_expand_kv
from repro.models.attention import attend as jax_attend
from repro.models.attention import attend_chunked as jax_attend_chunked
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (MASK_VALUE,
                                                     attention_ref, compare)
from repro_torch.models.attention import _expand_kv, attend, attend_chunked

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, shapes, dtype):
    _, jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal(s) * 0.5).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


CASES = [(S, hd, causal) for S in (128, 256, 384) for hd in (64, 128)
         for causal in (True, False) if causal or S in (128, 256)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,hd,causal", CASES)
def test_gqa_flash_attention_matches_reference(S, hd, causal, dtype):
    B, H, K = 2, 4, 2
    (jq, jk, jv), (q, k, v) = _inputs(S + hd, [(B, S, H, hd), (B, S, K, hd),
                                               (B, S, K, hd)], dtype)
    tol = DTYPES[dtype][3]
    ops.reset_launches()
    got = ops.gqa_flash_attention(q, k, v, causal=causal)
    assert ops.launches["flash_attention"] == 0     # CPU: the plain version
    assert got.dtype == q.dtype and got.shape == q.shape
    want = jax_flash(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,causal", [(128, True), (384, True),
                                      (256, False)])
def test_attention_ref_matches_reference(S, causal, dtype):
    B, H, hd = 2, 4, 64
    (jq, jk, jv), (q, k, v) = _inputs(S, [(B, H, S, hd)] * 3, dtype)
    tol = DTYPES[dtype][3]
    np.testing.assert_allclose(
        _np(attention_ref(q, k, v, causal=causal)),
        _np(jax_attention_ref(jq, jk, jv, causal=causal)), rtol=tol, atol=tol)


def test_non_causal_ragged_length_raises():
    q = torch.zeros((1, 384, 2, 64))
    with pytest.raises(ValueError, match="block-aligned"):
        ops.gqa_flash_attention(q, q, q, causal=False)


def test_model_attention_matches_kernel():
    """The port's chunked online-softmax attention and its flash path agree
    (the reference's test_model_attention_matches_kernel, 2e-4)."""
    B, S, H, hd = 1, 1024, 2, 64
    _, (q, k, v) = _inputs(40, [(B, S, H, hd)] * 3, "f32")
    a = attend_chunked(q, k, v, "causal", 0, hd ** -0.5)
    b = ops.gqa_flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", ["causal", "bidir"])
def test_attend_chunked_matches_reference(kind):
    B, S, H, hd = 1, 1024, 2, 32
    (jq, jk, jv), (q, k, v) = _inputs(41, [(B, S, H, hd)] * 3, "f32")
    np.testing.assert_allclose(
        attend_chunked(q, k, v, kind, 0, hd ** -0.5).numpy(),
        np.asarray(jax_attend_chunked(jq, jk, jv, kind, 0, hd ** -0.5)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dense_attend_matches_reference_and_flash(dtype):
    """The port's dense `attend` (on `_expand_kv`'d K/V) against the
    reference's, and against the port's flash path on the un-expanded K/V."""
    B, S, H, K, hd = 2, 96, 4, 2, 32
    (jq, jk, jv), (q, k, v) = _inputs(42, [(B, S, H, hd), (B, S, K, hd),
                                           (B, S, K, hd)], dtype)
    tol = DTYPES[dtype][3]
    got = attend(q, _expand_kv(k, H), _expand_kv(v, H), "causal", 0,
                 hd ** -0.5)
    want = jax_attend(jq, jax_expand_kv(jk, H), jax_expand_kv(jv, H),
                      "causal", 0, hd ** -0.5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np(got), _np(ops.gqa_flash_attention(q, k, v, causal=True)),
        rtol=tol, atol=tol)


def _bf16_kernel_emulation(q, k, v, drop=None):
    """What the bf16 kernel computes, in float32 on the CPU: 64-key tiles
    with a running max, P rounded to bf16 for the P.V product, the row sum
    over the unrounded P, output rounded to bf16.  `drop` = (first row,
    tile) leaves that tile out for the rows from there on: a faulty kernel."""
    S, hd = q.shape[-2], q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd ** -0.5
    keep = torch.ones((S, S), dtype=torch.bool).tril()
    if drop is not None:
        keep[drop[0]:, 64 * drop[1]:64 * drop[1] + 64] = False
    s = s.masked_fill(~keep, MASK_VALUE)
    acc = torch.zeros(q.shape)
    m = torch.full((*q.shape[:-1], 1), MASK_VALUE)
    l = torch.zeros((*q.shape[:-1], 1))
    for t in range(0, S, 64):
        st = s[..., t:t + 64]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(st - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.bfloat16().float() @ v.float()[..., t:t + 64, :]
        m = m_new
    return (acc / l).to(q.dtype)


@pytest.mark.parametrize("hd", [16, 128])
def test_bf16_bars_pass_the_kernels_rounding(hd):
    """A sound bf16 kernel passes BARS: the rounding of P (which the f32
    reference does not do) stays inside them at unit-variance q/k/v, where
    rows with few keys carry it un-averaged."""
    _, (q, k, v) = _inputs(43, [(1, 2, 1024, hd)] * 3, "bf16")
    q, k, v = (t * 2 for t in (q, k, v))     # unit variance
    cmp = compare(_bf16_kernel_emulation(q, k, v),
                  attention_ref(q, k, v, causal=True))
    assert cmp["ok"], cmp


@pytest.mark.parametrize("drop", [(300, 2), (1018, 15)])
def test_bf16_bars_fail_a_dropped_kv_tile(drop):
    """A kernel that skips one 64-key tile for some late rows fails BARS,
    down to the last 6 rows."""
    _, (q, k, v) = _inputs(43, [(1, 2, 1024, 128)] * 3, "bf16")
    q, k, v = (t * 2 for t in (q, k, v))
    cmp = compare(_bf16_kernel_emulation(q, k, v, drop),
                  attention_ref(q, k, v, causal=True))
    assert not cmp["ok"], cmp


# ---------------------------------------------------------------------------
# the causal window (the 'W'/'L' mixers) and head dim 256 (gemma3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 64, 256])
@pytest.mark.parametrize("S,window", [(64, 1), (64, 24), (64, 200),
                                      (2560, 32), (2560, 1024)])
def test_attention_ref_window_matches_reference(S, window, hd):
    """attention_ref with a window against the reference's `attend` (S 64)
    and `attend_chunked` (S 2560: its per-query-chunk KV-span branch), f32
    within 2e-5; and the wrapper's CPU path on un-expanded GQA K/V."""
    B, H, K = 1, 2, 1
    (jq, jk, jv), (q, k, v) = _inputs(S + window + hd, [(B, S, H, hd),
                                                        (B, S, K, hd),
                                                        (B, S, K, hd)], "f32")
    jk, jv = jax_expand_kv(jk, H), jax_expand_kv(jv, H)
    scale = hd ** -0.5
    ref = jax_attend if S <= 2048 else jax_attend_chunked
    want = np.asarray(ref(jq, jk, jv, "window", window, scale))
    kk, vv = _expand_kv(k, H), _expand_kv(v, H)
    got = attention_ref(q.transpose(1, 2), kk.transpose(1, 2),
                        vv.transpose(1, 2), window=window).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    ops.reset_launches()
    flash = ops.gqa_flash_attention(q, k, v, causal=True, window=window)
    assert ops.launches["flash_attention"] == 0
    np.testing.assert_allclose(flash.numpy(), want, rtol=2e-5, atol=2e-5)
    if S > 2048:    # the port's own chunked loop takes the same branch
        np.testing.assert_allclose(
            attend_chunked(q, kk, vv, "window", window, scale).numpy(), want,
            rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S", [128, 384])
def test_gqa_flash_attention_hd256_matches_pallas_kernel(S, dtype):
    """Head dim 256, causal: the reference's Pallas kernel in interpret mode
    (as tests/test_kernels.py runs it) against the port's wrapper."""
    B, H, K, hd = 1, 4, 2, 256
    (jq, jk, jv), (q, k, v) = _inputs(S + hd, [(B, S, H, hd), (B, S, K, hd),
                                               (B, S, K, hd)], dtype)
    tol = DTYPES[dtype][3]
    got = ops.gqa_flash_attention(q, k, v, causal=True)
    want = jax_flash(jq, jk, jv, causal=True, interpret=True)
    assert got.shape == q.shape and got.dtype == q.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_window_argument_is_checked():
    q = torch.zeros((1, 64, 2, 16))
    for kw in (dict(window=-1), dict(window=8, causal=False)):
        with pytest.raises(ValueError, match="window"):
            ops.gqa_flash_attention(q, q, q, **kw)
    assert ops.HEAD_DIMS == (16, 32, 64, 128, 256)
    assert ops.kernel_for(torch.bfloat16, 256) == "wgmma_bf16"
    assert ops.kernel_for(torch.float32, 256) == "cuda_core_f32"


# ---------------------------------------------------------------------------
# non-causal with S_kv != S (the encoder's 'B' layers and cross attention)
# ---------------------------------------------------------------------------

KV_CASES = [(1, 48, 16), (40, 17, 16), (100, 1500, 64), (448, 1500, 64),
            (300, 77, 128), (513, 2100, 32)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,S_kv,hd", KV_CASES)
def test_attention_ref_separate_kv_length_matches_reference(S, S_kv, hd,
                                                            dtype):
    """attention_ref, non-causal, q (B, H, S, hd) against k/v (B, H, S_kv,
    hd): the reference's own `attention_ref` and its model's dense
    `attend` of kind 'bidir' on the same inputs; and the wrapper's CPU path
    on un-expanded GQA K/V (no launch)."""
    B, H, K = 2, 4, 2
    (jq, jk, jv), (q, k, v) = _inputs(S + S_kv + hd, [(B, S, H, hd),
                                                      (B, S_kv, K, hd),
                                                      (B, S_kv, K, hd)],
                                      dtype)
    tol = DTYPES[dtype][3]
    kk, vv = _expand_kv(k, H), _expand_kv(v, H)
    got = attention_ref(q.transpose(1, 2), kk.transpose(1, 2),
                        vv.transpose(1, 2), causal=False).transpose(1, 2)
    jkk, jvv = jax_expand_kv(jk, H), jax_expand_kv(jv, H)
    want = jax_attention_ref(jq.transpose(0, 2, 1, 3), jkk.transpose(0, 2, 1, 3),
                             jvv.transpose(0, 2, 1, 3), causal=False)
    np.testing.assert_allclose(_np(got), _np(want.transpose(0, 2, 1, 3)),
                               rtol=tol, atol=tol)
    want = jax_attend(jq, jkk, jvv, "bidir", 0, hd ** -0.5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    ops.reset_launches()
    flash = ops.gqa_flash_attention_kv(q, k, v, causal=False)
    assert ops.launches["flash_attention"] == 0
    assert flash.shape == q.shape and flash.dtype == q.dtype
    np.testing.assert_allclose(_np(flash), _np(got), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,S_kv,kv_valid", [(1024, 1500, 1500),
                                             (512, 2100, 2100),
                                             (1024, 3072, 2600)])
def test_attend_chunked_kv_valid_matches_reference(S, S_kv, kv_valid):
    """attend_chunked of kind 'bidir' with K/V padded to a CHUNK_KV multiple
    and the keys at or past `kv_valid` masked, against the reference's."""
    B, H, hd = 1, 2, 32
    (jq, jk, jv), (q, k, v) = _inputs(S_kv + kv_valid, [(B, S, H, hd),
                                                        (B, S_kv, H, hd),
                                                        (B, S_kv, H, hd)],
                                      "f32")
    want = jax_attend_chunked(jq, jk, jv, "bidir", 0, hd ** -0.5,
                              kv_valid=kv_valid)
    got = attend_chunked(q, k, v, "bidir", 0, hd ** -0.5, kv_valid=kv_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_separate_kv_length_is_checked():
    """Causal needs S_kv == S (the reference asserts it, attention.py:105);
    S_kv 0 is refused; `gqa_flash_attention` keeps the reference wrapper's
    contract (S_kv == S)."""
    q = torch.zeros((1, 64, 2, 16))
    kv = torch.zeros((1, 80, 2, 16))
    with pytest.raises(ValueError, match="S_kv == S"):
        ops.gqa_flash_attention_kv(q, kv, kv, causal=True)
    with pytest.raises(ValueError, match="S_kv"):
        ops.gqa_flash_attention_kv(q, kv[:, :0], kv[:, :0], causal=False)
    with pytest.raises(ValueError, match="window"):
        ops.gqa_flash_attention_kv(q, kv, kv, causal=False, window=8)
    with pytest.raises(ValueError, match=r"\(B, S, K, hd\)"):
        ops.gqa_flash_attention(q, kv, kv, causal=False)
    with pytest.raises(ValueError, match="S_kv == S"):
        attention_ref(q.transpose(1, 2), kv.transpose(1, 2),
                      kv.transpose(1, 2), causal=True)
    assert ops.gqa_flash_attention_kv(q, kv, kv, causal=False).shape == q.shape
