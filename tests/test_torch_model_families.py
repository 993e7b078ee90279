"""The port's model families beyond minitron-8b and mamba2-370m on the CPU
against the live JAX reference, at their SMOKE sizes: gemma3-12b (local
'L' and global 'G' attention, head dim 16, window 32), deepseek-moe-16b
(MoE with shared experts, softmax-then-top-k router, a leading dense
block, H = K), qwen3-32b (qk-norm), phi3-medium-14b, mixtral-8x22b
(sliding-window 'W' attention and top-k-then-softmax MoE) and
jamba-1.5-large-398b (Mamba2, attention and MoE in one super-block).

Weights come from the reference's `Model.init` and are carried across by
`params_from_numpy`, bit-equal.  Bar: the bf16 bar of
tests/test_torch_models.py, rtol 2e-2 and atol 2e-2 x max |reference|.

MoE archs: a route is a discontinuity.  The two frameworks round bf16 at
other places, so a token whose top-k router scores are nearly tied in some
MoE layer can pick another expert on one side, and its hidden state then
differs by a whole expert's output.  So in these tests the port's router
takes the reference's own choice of experts (recorded from the reference's
run with `jax.debug.callback`, in call order, and replayed by
`repro_torch.testing.RouteReplay`) and everything else of the layer is the
port's: gates from its own logits, capacity, dispatch, the experts, the
combine.  The bar then holds at every token; the port's own top-k must
agree with the reference's choice on MIN_ROUTE_AGREEMENT (95%) of the
routed tokens or more.  Fed the same inputs, the MoE layer's own routing is held `==` in
tests/test_torch_moe.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models.model import count_params as jax_count_params
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model, count_params
from repro_torch.testing import BF16_RTOL, RouteReplay

ARCHS = ("gemma3-12b", "deepseek-moe-16b", "qwen3-32b", "phi3-medium-14b",
         "mixtral-8x22b", "jamba-1.5-large-398b")
RTOL = BF16_RTOL


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference model, reference params, port model, port params)."""
    arch = request.param
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    m = build_model(get_config(arch, smoke=True), device="cpu")
    p = params_from_numpy(m.cfg, jax.tree.map(np.asarray, jp), "cpu")
    return arch, jm, jp, m, p


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def reference_routes(monkeypatch) -> RouteReplay:
    """A RouteReplay fed the reference's top-k expert choice at each call
    of its `_moe_dispatch`, in call order (module docstring)."""
    routes = RouteReplay()
    dispatch = jax_moe._moe_dispatch

    def recording(params, x, cfg, swiglu=True):
        logits = (x.reshape(-1, x.shape[-1]).astype(jnp.float32)
                  @ params["router"])
        score = (jax.nn.softmax(logits, axis=-1)
                 if cfg.router_pre_softmax else logits)
        _, idx = jax.lax.top_k(score, cfg.top_k)
        jax.debug.callback(lambda e: routes.push(np.array(e)), idx,
                           ordered=True)
        return dispatch(params, x, cfg, swiglu)
    monkeypatch.setattr(jax_moe, "_moe_dispatch", recording)
    return routes


def _close_bf16(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)
    return atol


def test_params_carried_across_bit_equal(pair):
    """Every leaf, the MoE blocks' float32 router and (E, ...) expert stacks
    and deepseek's leading dense block included."""
    arch, jm, jp, m, p = pair
    cfg = m.cfg
    ref = jax.tree.map(np.asarray, jp)
    for key in ("embed", "ln_f") + (("head",) if "head" in ref else ()):
        for leaf, arr in ref[key].items():
            assert np.array_equal(_bits(p[key][leaf]), arr.view(np.int16))
    assert len(p["decoder"]["first"]) == cfg.first_k_dense
    for i, block in enumerate(ref["decoder"]["first"]):
        for path, a in jax.tree_util.tree_flatten_with_path(block)[0]:
            t = p["decoder"]["first"][i]
            for k in path:
                t = t[k.key]
            want = a.view(np.int16) if a.dtype.name == "bfloat16" else a
            assert np.array_equal(_bits(t), want), ("first", i, path)
    assert len(p["decoder"]["supers"]) == cfg.n_super
    n_moe = 0
    for i in range(cfg.n_super):
        for pos, block in ref["decoder"]["supers"].items():
            for path, arr in jax.tree_util.tree_flatten_with_path(block)[0]:
                t = p["decoder"]["supers"][i][pos]
                for k in path:
                    t = t[k.key]
                a = arr[i]
                want = a.view(np.int16) if a.dtype.name == "bfloat16" else a
                assert t.dtype == (torch.float32 if a.dtype == np.float32
                                   else t.dtype)
                assert np.array_equal(_bits(t), want), (i, pos, path)
                n_moe += path[-1].key == "router"
    assert (n_moe > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_reference_full_and_active(arch):
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke), jax_get_config(arch, smoke)
        for active in (False, True):
            assert count_params(cfg, active) == jax_count_params(jcfg,
                                                                 active)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("S", [128, 2560])
def test_apply_and_logits_bf16_match_reference(pair, S, monkeypatch):
    """S 2560 is above DENSE_MAX_S: the reference runs attend_chunked there
    (for the windowed mixers its KV-span branch), the port its flash path
    with the window."""
    arch, jm, jp, m, p = pair
    routes = reference_routes(monkeypatch)
    toks = np.random.default_rng(S).integers(0, m.cfg.vocab, (2, S))
    jh, jaux = jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    jax.effects_barrier()
    with torch.inference_mode(), routes.replay():
        h, aux = m.apply(p, {"tokens": torch.from_numpy(toks)})
        lg = m.logits(p, h)
    assert h.dtype == torch.bfloat16
    routes.check(f"{arch} S={S}")
    if m.cfg.moe is not None:
        assert routes.seen > 0
        np.testing.assert_allclose(float(aux["lb_loss"]),
                                   float(jaux["lb_loss"]), rtol=RTOL)
    else:
        assert routes.seen == 0 and float(aux["lb_loss"]) == 0.0
    _close_bf16(h, jh, f"{arch} hidden S={S}")
    _close_bf16(lg, jm.logits(jp, jh), f"{arch} logits S={S}")


def test_decode_teacher_forced_past_the_window(pair, monkeypatch):
    """48 steps with a 64-entry cache (past the smoke window of 32, so the
    windowed mixers' ring buffer wraps): 8 prompt tokens, then the
    reference's own greedy tokens, fed to both; logits compared per step,
    and the port's greedy token equal wherever the reference's top-2
    margin exceeds the bar."""
    arch, jm, jp, m, p = pair
    B, seq, n_prompt, steps = 2, 64, 8, 48
    routes = reference_routes(monkeypatch)
    prompt = np.random.default_rng(5).integers(1, m.cfg.vocab, (B, n_prompt))
    jstep = jax.jit(jm.decode_step)
    jcaches = jm.init_caches(B, seq)
    caches = m.init_caches(B, seq)
    for i, (mx, _) in enumerate(m.cfg.pattern):
        want = min(seq, m.cfg.attn.window) if mx in "WL" else seq
        if mx != "M":
            assert caches["supers"][0][str(i)]["k"].shape[1] == want
    token = prompt[:, 0]
    checked = 0
    for t in range(steps):
        jl, jcaches = jstep(jp, jnp.asarray(token[:, None], jnp.int32),
                            jcaches, jnp.asarray(t, jnp.int32))
        jax.effects_barrier()
        with torch.inference_mode(), routes.replay():
            lg, caches = m.decode_step(p, torch.from_numpy(token[:, None]),
                                       caches, t)
        atol = _close_bf16(lg, jl, f"{arch} decode step {t}")
        want = _np(jl)[:, -1]
        ref_tok = want.argmax(-1)
        top2 = np.sort(want, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > atol + RTOL * np.abs(top2[:, 1])
        got_tok = _np(lg)[:, -1].argmax(-1)
        assert np.array_equal(got_tok[sure], ref_tok[sure]), (arch, t)
        checked += int(sure.sum())
        token = prompt[:, t + 1] if t + 1 < n_prompt else ref_tok
    assert checked > 0
    routes.check(f"{arch} decode")
    assert (routes.seen > 0) == (m.cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_smoke_cpu_completes_every_request(arch, capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", arch, "--smoke", "--device", "cpu"]) == 0
    assert "[serve] 4/4 completed" in capsys.readouterr().out


def test_windowed_cache_is_a_ring_of_the_window():
    """init_caches: windowed mixers hold min(seq, window) entries, the
    others seq; deepseek's leading dense block a full cache."""
    cfg = get_config("gemma3-12b", smoke=True)
    m = build_model(cfg, device="cpu")
    for seq in (16, 64):
        c = m.init_caches(2, seq)["supers"][0]
        for i, (mx, _) in enumerate(cfg.pattern):
            want = min(seq, cfg.attn.window) if mx == "L" else seq
            assert c[str(i)]["k"].shape == (2, want, 2, 16)
    ds = build_model(get_config("deepseek-moe-16b", smoke=True), "cpu")
    assert ds.init_caches(1, 40)["first"][0]["k"].shape == (1, 40, 4, 16)


def test_moe_aux_sums_over_the_super_blocks():
    """apply's lb_loss is the sum of the MoE layers' losses (jamba: 4 'E'
    positions in its super-block), not counting leading dense blocks."""
    cfg = get_config("jamba-1.5-large-398b", smoke=True)
    m = build_model(cfg, device="cpu")
    p, _ = m.init(0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab,
                                                              (1, 32)))
    seen = []
    ffn = moe.moe_ffn

    def recording(*a, **k):
        y, aux = ffn(*a, **k)
        seen.append(float(aux["lb_loss"]))
        return y, aux
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "moe_ffn", recording)
        with torch.inference_mode():
            _, aux = m.apply(p, {"tokens": toks})
    assert len(seen) == sum(ff == "E" for _, ff in cfg.pattern) * cfg.n_super
    assert float(aux["lb_loss"]) == pytest.approx(sum(seen), rel=1e-6)
    assert dataclasses.replace(cfg, n_layers=8).n_super == 1


@pytest.mark.parametrize("window", [0, 5, 40])
def test_decode_attend_window_matches_reference(window):
    """decode_attend's window (valid cache entries position - window ..
    position - 1, beside the new token) against the reference's, f32,
    1e-5."""
    from repro.models.attention import decode_attend as jax_decode_attend
    from repro_torch.models.attention import decode_attend
    cfg = get_config("gemma3-12b", smoke=True).attn
    rng = np.random.default_rng(window)
    D, S, B, position = 64, 48, 2, 30
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    params = {n: (rng.standard_normal(s) * 0.2).astype(np.float32)
              for n, s in (("wq", (D, H * hd)), ("wk", (D, K * hd)),
                           ("wv", (D, K * hd)), ("wo", (H * hd, D)))}
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, S, K, hd)).astype(np.float32)
              for _ in range(2))
    want = jax_decode_attend({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                             position, cfg, window=window)
    got = decode_attend({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x), torch.from_numpy(ck),
                        torch.from_numpy(cv), position, cfg, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
