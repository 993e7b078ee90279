"""Training the smoke configs that no other CPU gradient test holds against
the live JAX reference: qwen3-32b (grouped-query attention with q/k norms),
phi3-medium-14b, mixtral-8x22b (sliding window 32, MoE) and
jamba-1.5-large-398b (Mamba, attention and MoE layers in one stack).
tests/test_torch_train.py holds minitron-8b and mamba2-370m,
tests/test_torch_train_families.py gemma3, whisper, llama-vision and
deepseek-moe; with these four every arch whose reference
`launch.train --smoke` command runs is held.

One step's loss and every gradient leaf of the port's `make_loss_fn`
against `jax.value_and_grad` of the reference's on the same seeded numpy
batch (B 2, S 128, the reference's `--seq` default) and the reference's
weights carried across bit-equal, MoE layers on the reference's own expert
choice (`RouteReplay`), as in tests/test_torch_train_families.py, whose
helpers this file uses.  As shipped (bf16) the loss and every leaf within
the zoo's bar (rtol 2e-2, atol 2e-2 x max |reference|), with the
exceptions those files make for models and leaves that sum over every
position, held instead by relative L2 about twice what they read, as
mamba2-370m's 5e-2 sits above its 0.15-2.7%: jamba's leaves within 1e-1
(its Mamba leaves read 1.3-4.9%, where bf16 rounds at other places in the
two packages' scans and convolutions, dt_bias the most, and the norm
scales before its Mamba mixers cross the elementwise bar by up to 1.4x),
and qwen3's q/k norm scales, like gemma3's leaves, within 5e-2 (2.0-2.9%:
one scale of 16 a head, summed over every position and head, crosses the
elementwise bar by 1.5x).  In float32 every leaf of all four within 1e-4
relative L2 (they read <= 2e-5) and the loss within 1e-5 relative: the
arithmetic is the reference's.
"""
import pytest
import torch

from repro.train import checkpoint as j_ckpt
from repro_torch.core.tree import leaf_paths
from repro_torch.models.convert import to_reference_layout
from tests.test_torch_train_families import (_batch, _bf16_bar, _patch_f32,
                                             _port_value_and_grad,
                                             _reference,
                                             _reference_value_and_grad,
                                             _rel_l2)

ARCHS = ("qwen3-32b", "phi3-medium-14b", "mixtral-8x22b",
         "jamba-1.5-large-398b")

# bf16 leaves held by relative L2 (see above): every leaf of an arch here,
# and these leaves of any arch; every other leaf to the elementwise bar
REL_L2_ARCHS = {"jamba-1.5-large-398b": 1e-1}
SUMMED_LEAVES = ("mixer/q_norm", "mixer/k_norm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs small eager ops: one intra-op thread takes
    about the same wall time here and leaves the other cores to the other
    test workers (as tests/test_torch_sharding_mapper.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _value_and_grads(arch, f32, monkeypatch):
    """(loss, reference loss, {path: (port leaf, reference leaf)})."""
    if f32:
        _patch_f32(monkeypatch)
    jm, jp, m, p = _reference(arch, f32=f32)
    jb, tb = _batch(m.cfg)
    jloss, jgrads, routes = _reference_value_and_grad(jm, jp, jb,
                                                      monkeypatch)
    loss, grads = _port_value_and_grad(m, p, tb, routes)
    want = dict(j_ckpt._leaf_paths(jgrads))
    got = dict(leaf_paths(to_reference_layout(m.cfg, grads)))
    assert list(got) == list(want)
    return loss, jloss, {k: (g, want[k]) for k, g in got.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_within_bf16_bar(arch, monkeypatch):
    loss, jloss, leaves = _value_and_grads(arch, False, monkeypatch)
    _bf16_bar(loss, jloss, f"{arch} loss")
    for k, (g, w) in leaves.items():
        assert g.dtype == torch.bfloat16 or str(w.dtype) == "float32", k
        if arch in REL_L2_ARCHS:
            assert _rel_l2(g, w) <= REL_L2_ARCHS[arch], k
        elif k.endswith(SUMMED_LEAVES):
            assert _rel_l2(g, w) <= 5e-2, k
        else:
            _bf16_bar(g, w, f"{arch} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_in_float32(arch, monkeypatch):
    loss, jloss, leaves = _value_and_grads(arch, True, monkeypatch)
    rel = abs(float(loss.detach()) - float(jloss)) / abs(float(jloss))
    assert rel <= 1e-5, f"{arch} loss: relative error {rel:.3g} > 1e-5"
    for k, (g, w) in leaves.items():
        assert g.dtype == torch.float32
        err = _rel_l2(g, w)
        assert err <= 1e-4, f"{arch} {k}: relative L2 {err:.3g} > 1e-4"
