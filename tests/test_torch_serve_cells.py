"""The reference's two serving cells, `prefill_32k` and `decode_32k`, as the
dry run defines them (`launch/dryrun.py` `serve_fn`: prefill is `apply`,
then the last token's `logits`; decode is `make_serve_step` at position
S - 1 of caches of S entries), run on real tensors from `serve_inputs`
on the CPU and held against the live JAX reference at the SMOKE widths,
S cut from 32768 to 4096: past the reference's DENSE_MAX_S (its chunked
attention) and 16 SSD chunks of 256.

Weights come from the port's `Model.init`, carried into the reference's
layout bit-equal by `to_reference_layout`; the port's inputs (tokens, frames, image
embeddings, and the decode caches filled from the seed) go to the
reference as the same bytes.  Bar: the bf16 bar of
tests/test_torch_model_families.py and tests/test_torch_encdec.py, rtol
2e-2 and atol 2e-2 x max |reference| (`repro_torch.testing.BF16_RTOL`),
MoE layers on the reference's own routes (`reference_routes`, as there);
the greedy token `==` wherever the reference's top-2 logit margin
exceeds the bar.  `apply_rope` at positions 0-32767 against the
reference's within 1e-5 (float32; the cell's longest positions).
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.layers import apply_rope as jax_apply_rope
from repro.models.model import build_model as jax_build_model
from repro.train.serve_step import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import dryrun
from repro_torch.models.convert import to_reference_layout
from repro_torch.models.layers import apply_rope
from repro_torch.models.model import build_model
from repro_torch.testing import BF16_RTOL

from test_torch_model_families import reference_routes

S = 4096
# one arch of each family: dense, MoE (with a sliding window), Mamba,
# encoder-decoder, vision (gemma3-12b's local/global prefill is held at S
# 2560 in test_torch_model_families.py; its decode cell is here)
PREFILL_ARCHS = ("minitron-8b", "mixtral-8x22b", "mamba2-370m",
                 "whisper-large-v3", "llama-3.2-vision-11b")
# local/global and sliding-window rings past 128 windows of 32, the Mamba
# state, the zero cross caches of an encoder-decoder
DECODE_ARCHS = ("gemma3-12b", "mixtral-8x22b", "mamba2-370m",
                "whisper-large-v3")
DECODE_BATCH = 2


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference model, its params, the port's model, the same params):
    the port's `init(0)` carried into the reference's layout by
    `to_reference_layout`, bit-equal (the reference's own init takes
    ~3 s an arch here); one a module, shared by the prefill and decode
    cells (neither writes the params)."""
    m = build_model(get_config(arch, smoke=True), device="cpu")
    p, _ = m.init(0)
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    return jm, _tree(to_reference_layout(m.cfg, p)), m, p


def _jnp(t: torch.Tensor):
    """A tensor as a jax array of the same bytes (bf16 through int16)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v) for v in tree]
    return _jnp(tree)


def _stacked(caches: dict) -> dict:
    """The port's cache tree (one dict a super-block) in the reference's
    layout: each pattern position's leaves stacked over the super-blocks."""
    supers = caches["supers"]
    return {"first": caches["first"],
            "supers": {key: {name: torch.stack([s[key][name] for s in supers])
                             for name in supers[0][key]}
                       for key in supers[0]}}


def _f32(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _hold(got, want, what: str) -> float:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    atol = BF16_RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=atol,
                               err_msg=what)
    return atol


def _sure_tokens_equal(got_tok, want_tok, logits, atol, what) -> int:
    """got_tok `==` want_tok wherever the top-2 margin of the reference's
    logits exceeds the bar; returns how many rows that held for."""
    want = _f32(logits)[:, -1]
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > atol + BF16_RTOL * np.abs(top2[:, 1])
    got_tok = np.asarray(got_tok).reshape(-1)
    want_tok = np.asarray(want_tok).reshape(-1)
    assert np.array_equal(got_tok[sure], want_tok[sure]), what
    return int(sure.sum())


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_cell_last_token_logits_match_reference(arch, monkeypatch):
    jm, jp, m, p = _pair(arch)
    routes = reference_routes(monkeypatch)
    shape = ShapeCfg("prefill_cell", S, 1, "prefill")
    batch = dryrun.serve_inputs(m, shape, seed=11)
    if m.cfg.encoder is not None:
        assert batch["enc_frames"].shape == (1, S, m.cfg.d_model)
    else:
        assert batch["tokens"].shape == (1, S)

    def jax_prefill(params, b):
        hidden, _ = jm.apply(params, b)
        return jm.logits(params, hidden[:, -1:])
    want = jax.jit(jax_prefill)(jp, _tree(batch))
    jax.effects_barrier()
    with torch.inference_mode(), routes.replay():
        got = dryrun.serve_fn(m, shape)(p, batch)
    routes.check(f"{arch} prefill S {S}")
    assert (routes.seen > 0) == (m.cfg.moe is not None)
    assert got.shape == (1, 1, m.cfg.padded_vocab)
    _hold(got, want, f"{arch} prefill S {S} last-token logits")


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_cell_at_the_last_position_matches_reference(arch,
                                                            monkeypatch):
    """The port's serve step on caches of S entries filled from the seed,
    at position S - 1, against the reference's `make_serve_step` on the
    same bytes: the logits within the bar (the reference's `decode_step`,
    which its serve step wraps), the greedy tokens `==` where sure, and
    the caches as the reference leaves them."""
    jm, jp, m, p = _pair(arch)
    cfg = m.cfg
    shape = ShapeCfg("decode_cell", S, DECODE_BATCH, "decode")
    batch = dryrun.serve_inputs(m, shape, seed=12)
    caches = batch["caches"]
    for i, (mx, _) in enumerate(cfg.pattern):
        c = caches["supers"][0][str(i)]
        if mx in "WL":
            assert c["k"].shape[1] == cfg.attn.window < S
        elif mx != "M":
            assert c["k"].shape[1] == S and float(c["k"].abs().max()) > 0
        if "xk" in c:
            assert not c["xk"].any()
    jcaches = _tree(_stacked(caches))
    token = _jnp(batch["token"])
    pos = jnp.asarray(S - 1, jnp.int32)
    jtok, _ = jax.jit(jax_make_serve_step(jm))(jp, token, jcaches, pos)
    # the routes of the reference's decode_step alone
    routes = reference_routes(monkeypatch)
    jlogits, jnew = jax.jit(jm.decode_step)(jp, token, jcaches, pos)
    jax.effects_barrier()
    seen = []

    def spy(*a):
        out = m.decode_step(*a)
        seen.append(out[0])
        return out
    with torch.inference_mode(), routes.replay():
        tok, new = dryrun.serve_fn(m._replace(decode_step=spy), shape)(
            p, batch)
    routes.check(f"{arch} decode at {S - 1}")
    assert (routes.seen > 0) == (cfg.moe is not None)
    assert tok.shape == (DECODE_BATCH, 1) and tok.dtype == torch.int32
    (logits,) = seen
    assert torch.equal(tok[:, 0], logits[:, -1].float().argmax(-1).int())
    atol = _hold(logits, jlogits, f"{arch} decode logits at {S - 1}")
    _sure_tokens_equal(tok.numpy(), jtok, jlogits, atol,
                       f"{arch} decode tokens against the reference's")
    new_ref = _stacked(new)
    for key, c in new_ref["supers"].items():
        for name, t in c.items():
            _hold(t, jnew["supers"][key][name],
                  f"{arch} cache {key}/{name} after the step")


def test_apply_rope_at_the_cell_positions_matches_reference():
    """Positions 0-32767, float32, head dim 16 at the default theta 1e4 and
    128 at gemma3-12b's 1e6: the angles reach 32767 rad."""
    rng = np.random.default_rng(7)
    pos = np.arange(32768, dtype=np.int32)
    for hd, theta in ((16, 1e4), (128, 1e6)):
        x = rng.standard_normal((1, 32768, 2, hd)).astype(np.float32)
        got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"hd {hd} {theta}")


@pytest.mark.parametrize("causal,window,S_kv", [(True, 0, 1000),
                                                (True, 37, 1000),
                                                (False, 0, 700)])
def test_attention_ref_by_query_blocks_matches_dense(causal, window, S_kv,
                                                     monkeypatch):
    """The plain version a query block at a time (what it runs above
    DENSE_MAX_SCORES scores a head) against its dense form, float32: at
    two block sizes, and through `attention_ref` with the threshold set
    below this shape's scores."""
    g = torch.Generator().manual_seed(S_kv + window)
    q = torch.randn((2, 3, 1000, 16), generator=g)
    k, v = (torch.randn((2, 3, S_kv, 16), generator=g) for _ in range(2))
    want = attention_ref(q, k, v, causal=causal, window=window)
    for block in (64, 333):
        got = fref._blocks(q, k, v, 16 ** -0.5, causal, window, block)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(fref, "DENSE_MAX_SCORES", 1000 * S_kv - 1)
    monkeypatch.setattr(fref, "BLOCK_ROWS", 256)
    got = attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
