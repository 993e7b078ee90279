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
from repro_torch.kernels.ssd_scan.ref import ssd_ref


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
