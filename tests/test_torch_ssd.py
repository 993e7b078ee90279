"""The port's SSD scan (`repro_torch.kernels.ssd_scan`) on the CPU against
the live JAX reference.

The same inputs, drawn with numpy from a fixed seed, go to the reference's
`ssd` (the Pallas kernel in interpret mode) and `ssd_ref`, and to the
port's `ops.ssd` (its plain chunked version on the CPU) and `ssd_ref`.
Tolerances are the reference's own (tests/test_kernels.py): 1e-4 for
float32, 5e-2 for bfloat16 inputs (the output is rounded to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_ref


def _inputs(seed, B, L, H, P, N, dtype):
    rng = np.random.default_rng(seed)
    rnd = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    x, b, c = rnd(B, L, H, P), rnd(B, L, N), rnd(B, L, N)
    dt = np.abs(rnd(B, L, H)) * 0.1
    a = -np.abs(rnd(H)) - 0.1
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    jx = [jnp.asarray(t).astype(jdt) for t in (x, b, c)]
    tx = [torch.from_numpy(t).to(tdt) for t in (x, b, c)]
    return (jx + [jnp.asarray(dt), jnp.asarray(a)],
            tx + [torch.from_numpy(dt), torch.from_numpy(a)])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("L,chunk", [(64, 32), (128, 128), (256, 64)])
def test_ssd_matches_reference(L, chunk, dtype):
    jx, tx = _inputs(L + chunk, 2, L, 4, 16, 8, dtype)
    tol = 5e-2 if dtype == "bf16" else 1e-4
    ops.reset_launches()
    got = ops.ssd(*tx, chunk=chunk)
    assert ops.launches["ssd_scan"] == 0        # CPU: the plain version
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    np.testing.assert_allclose(_np(got), _np(jax_ssd(*jx, chunk=chunk)),
                               rtol=tol, atol=tol)
    # the chunked plain version against the sequential oracle
    np.testing.assert_allclose(_np(got), _np(ssd_ref(*tx)), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_ref_matches_reference(dtype):
    jx, tx = _inputs(7, 2, 96, 3, 8, 4, dtype)
    np.testing.assert_allclose(_np(ssd_ref(*tx)), _np(jax_ssd_ref(*jx)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,nheads", [(1, 1), (3, 4), (2, 8)])
def test_ssd_batch_and_heads_match_reference(B, nheads):
    jx, tx = _inputs(20 + B, B, 64, nheads, 8, 4, "f32")
    np.testing.assert_allclose(_np(ops.ssd(*tx, chunk=32)),
                               _np(jax_ssd(*jx, chunk=32)), rtol=1e-4,
                               atol=1e-4)


def test_ssd_rejects_ragged_length():
    _, tx = _inputs(0, 1, 48, 2, 8, 4, "f32")
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd(*tx, chunk=32)


# ---------------------------------------------------------------------------
# The CUDA kernel's arithmetic, emulated: every product on the tensor cores
# as a 3xTF32 split (a = hi + lo, each rounded to TF32; hi.hi + hi.lo +
# lo.hi accumulated in float32), the rest in float32.  This models the
# operands' rounding only: the sums run in float32 in einsum's order, not
# in the tensor cores' truncating accumulation, so the kernel's order of
# accumulation (partials per 64-deep k-tile) is held by the card tests.
# ---------------------------------------------------------------------------

def tf32(t):
    """float32 rounded to TF32 (10-bit mantissa), to nearest, ties to even,
    as the kernel's `tf32_rne` does it on the bits."""
    u = t.float().contiguous().view(torch.int32)
    u = (u + 0xFFF + ((u >> 13) & 1)) & -0x2000
    return u.view(torch.float32)


def _split_mm(terms):
    def mm(spec, a, b):
        if terms == 0:                                     # float64 oracle
            return torch.einsum(spec, a, b)
        ah, bh = tf32(a), tf32(b)
        if terms == 1:
            return torch.einsum(spec, ah, bh)
        al, bl = tf32(a - ah), tf32(b - bh)
        return (torch.einsum(spec, al, bh) + torch.einsum(spec, ah, bl)
                + torch.einsum(spec, ah, bh))
    return mm


def _chunked_as_kernel(x, b, c, dt, a, chunk, terms):
    """ssd_chunked with the kernel's products: C.B^T once per chunk, the
    weighted intra product W.X, the inter product (e_i C_i).R and the
    chunk state (w B)^T.X, each through `_split_mm(terms)` (0: float64)."""
    dtype = torch.float64 if terms == 0 else torch.float32
    mm = _split_mm(terms)
    Bsz, L, H, P = x.shape
    N, Q = b.shape[-1], chunk
    nc = L // Q
    xc, bc, cc = (t.to(dtype).reshape(Bsz, nc, Q, *t.shape[2:])
                  for t in (x, b, c))
    dtc, a = dt.to(dtype).reshape(Bsz, nc, Q, H), a.to(dtype)
    clip_exp = lambda z: torch.exp(torch.clamp(z, -60.0, 0.0))
    mask = torch.ones((Q, Q), dtype=torch.bool).tril()
    R = torch.zeros((Bsz, H, N, P), dtype=dtype)
    ys = []
    for ci in range(nc):
        x_i, B_i, C_i, dt_i = xc[:, ci], bc[:, ci], cc[:, ci], dtc[:, ci]
        seg = torch.cumsum(dt_i * a, dim=1)                      # (B, Q, H)
        cb = mm("bin,bjn->bij", C_i, B_i)
        w = (cb[..., None] * clip_exp(seg[:, :, None] - seg[:, None])
             * mask[None, ..., None] * dt_i[:, None])            # (B,Q,Q,H)
        y = mm("bijh,bjhp->bihp", w, x_i)
        eC = clip_exp(seg)[..., None] * C_i[:, :, None]          # (B,Q,H,N)
        y = y + mm("bihn,bhnp->bihp", eC, R)
        wB = (clip_exp(seg[:, -1:] - seg) * dt_i)[..., None] * B_i[:, :, None]
        R = R * clip_exp(seg[:, -1])[..., None, None] + mm(
            "bjhn,bjhp->bhnp", wB, x_i)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(Bsz, L, H, P)


def _carry_inputs(seed, L, H, P, N):
    """chip_smoke.py's ssd_inputs(carry=True), drawn with numpy: x and B/C
    SiLU'd normals, dt = 0.01 softplus(randn), a = -uniform(0.05, 1), so a
    chunk of 256 decays by 0.17-0.99 and every chunk leans on the state
    carried in."""
    rng = np.random.default_rng(seed)
    silu = lambda z: z / (1 + np.exp(-z))
    x = silu(rng.standard_normal((1, L, H, P)))
    b, c = (silu(rng.standard_normal((1, L, N))) for _ in range(2))
    dt = 0.01 * np.log1p(np.exp(rng.standard_normal((1, L, H))))
    a = -(0.05 + 0.95 * rng.random(H))
    return [torch.from_numpy(t.astype(np.float32)) for t in (x, b, c, dt, a)]


def test_tf32_rounds_to_nearest_even():
    one = 1.0
    ulp = 2.0 ** -10                                  # TF32 ulp at 1.0
    t = torch.tensor([one, one + ulp / 2, one + 1.5 * ulp, one + ulp / 4,
                      -(one + ulp / 2 + 2 ** -20), 3.0e-3])
    got = tf32(t)
    assert got[0] == one and got[1] == one            # tie -> even (down)
    assert got[2] == one + 2 * ulp                    # tie -> even (up)
    assert got[3] == one
    assert got[4] == -(one + ulp)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2 ** -11


@pytest.mark.parametrize("terms,passes", [(3, True), (1, False)],
                         ids=["3xTF32", "1xTF32"])
def test_tf32_split_meets_the_kernels_bar(terms, passes):
    """At mamba2-370m's P 64, N 128, chunk 256 (L cut to 1024, state carried
    across chunks), the 3xTF32 split stays within the kernel's 1e-4 bar of
    a float64 run; plain TF32 does not."""
    x, b, c, dt, a = _carry_inputs(5, 1024, 32, 64, 128)
    want = _chunked_as_kernel(x, b, c, dt, a, 256, 0)
    got = _chunked_as_kernel(x, b, c, dt, a, 256, terms).double()
    # in float64 the emulation is the plain chunked scan (float32)
    np.testing.assert_allclose(
        want.numpy(), ssd_chunked(x, b, c, dt, a, chunk=256).numpy(),
        rtol=1e-5, atol=1e-5)
    ok = torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    err = float((got - want).abs().max())
    assert ok == passes, (terms, err, float(want.abs().max()))

