"""The port's model zoo (`repro_torch.models`, `repro_torch.train.serve_step`,
`repro_torch.launch.serve`) on the CPU against the live JAX reference, at
the SMOKE sizes of minitron-8b and mamba2-370m.

Weights come from the reference's `Model.init` and are carried across by
`params_from_numpy`, bit-equal.  Bars:
  * f32 blocks (`mamba_block`, `self_attention`, weights and inputs cast to
    float32): 1e-4.
  * bf16 model (`apply` + `logits`, `decode_step`): rtol 2e-2 and atol
    2e-2 x the largest |value| of the reference tensor.  The two frameworks
    round bf16 at different places (XLA keeps fused elementwise
    intermediates in f32; torch rounds after each op), so the hidden state
    differs by a few bf16 ulps (2^-8 relative each); in a logit those
    differences are summed over d_model products, so they scale with the
    logits' overall size rather than with each logit's own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import mamba as jax_mamba
from repro.models.model import build_model as jax_build_model
from repro.models.model import count_params as jax_count_params
from repro_torch.configs import get_config
from repro_torch.models import attention, mamba
from repro_torch.models.convert import params_from_numpy, to_tensor
from repro_torch.models.model import build_model, count_params

ARCHS = ("minitron-8b", "mamba2-370m")
RTOL = 2e-2


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


def _close_bf16(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)
    return atol


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_params_carried_across_bit_equal(pair):
    arch, jm, jp, m, p = pair
    cfg = m.cfg
    ref = jax.tree.map(np.asarray, jp)
    for key in ("embed", "ln_f") + (("head",) if "head" in ref else ()):
        for leaf, arr in ref[key].items():
            t = p[key][leaf]
            assert t.dtype == torch.bfloat16
            assert np.array_equal(_bits(t), arr.view(np.int16)), (key, leaf)
    assert len(p["decoder"]["supers"]) == cfg.n_super
    for i in range(cfg.n_super):
        for pos, block in ref["decoder"]["supers"].items():
            flat = jax.tree_util.tree_flatten_with_path(block)[0]
            for path, arr in flat:
                t = p["decoder"]["supers"][i][pos]
                for k in path:
                    t = t[k.key]
                a = arr[i]
                want = a.view(np.int16) if a.dtype.name == "bfloat16" else a
                assert np.array_equal(_bits(t), want), (i, pos, path)


def test_to_tensor_keeps_bf16_bits():
    a = np.asarray(jnp.asarray([1.0, -2.5, 3.1415927, 1e-8, 65504.0],
                               jnp.bfloat16))
    t = to_tensor(a, "cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


def test_count_params_matches_reference():
    for arch in ARCHS:
        assert count_params(get_config(arch)) == jax_count_params(
            jax_get_config(arch))
        assert get_config(arch).param_count() == jax_get_config(
            arch).param_count()


def _block_f32(tree, mixer_key="mixer"):
    blk = jax.tree.map(lambda a: np.asarray(a, np.float32)[0],
                       tree["decoder"]["supers"]["0"][mixer_key])
    return (jax.tree.map(jnp.asarray, blk),
            {k: torch.from_numpy(np.array(v)) for k, v in blk.items()})


def test_mamba_block_f32_matches_reference():
    jm = jax_build_model(jax_get_config("mamba2-370m", smoke=True))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1))[0])
    jblk, blk = _block_f32(tree)
    cfg = get_config("mamba2-370m", smoke=True)
    x = np.random.default_rng(3).standard_normal((2, 96, cfg.d_model)
                                                 ).astype(np.float32)
    want = jax_mamba.mamba_block(jblk, jnp.asarray(x), cfg.ssm, cfg.d_model)
    got = mamba.mamba_block(blk, torch.from_numpy(x), cfg.ssm, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("S", [64, 2560])
def test_self_attention_f32_matches_reference(S):
    """S 2560 is above DENSE_MAX_S: the reference runs attend_chunked there,
    the port its flash path."""
    jm = jax_build_model(jax_get_config("minitron-8b", smoke=True))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2))[0])
    jblk, blk = _block_f32(tree)
    cfg = get_config("minitron-8b", smoke=True)
    x = np.random.default_rng(S).standard_normal((1, S, cfg.d_model)
                                                 ).astype(np.float32)
    want = jax_attention.self_attention(jblk, jnp.asarray(x), cfg.attn,
                                        "causal")
    got = attention.self_attention(blk, torch.from_numpy(x), cfg.attn,
                                   "causal")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("S", [128, 2560])
def test_apply_and_logits_bf16_match_reference(pair, S):
    """S 2560 runs the reference's chunked attention (S > DENSE_MAX_S)."""
    arch, jm, jp, m, p = pair
    toks = np.random.default_rng(S).integers(0, m.cfg.vocab, (2, S))
    jh, _ = jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.inference_mode():
        h, aux = m.apply(p, {"tokens": torch.from_numpy(toks)})
        lg = m.logits(p, h)
    assert h.dtype == torch.bfloat16 and float(aux["lb_loss"]) == 0.0
    _close_bf16(h, jh, f"{arch} hidden S={S}")
    _close_bf16(lg, jm.logits(jp, jh), f"{arch} logits S={S}")


def test_decode_teacher_forced_matches_reference(pair):
    """24 steps: 8 prompt tokens, then the reference's own greedy tokens,
    fed to both; logits compared per step, and the port's greedy token
    equal wherever the reference's top-2 margin exceeds the bar."""
    arch, jm, jp, m, p = pair
    B, seq, n_prompt, steps = 2, 32, 8, 24
    prompt = np.random.default_rng(5).integers(1, m.cfg.vocab, (B, n_prompt))
    jstep = jax.jit(jm.decode_step)
    jcaches = jm.init_caches(B, seq)
    caches = m.init_caches(B, seq)
    token = prompt[:, 0]
    checked = 0
    for t in range(steps):
        jl, jcaches = jstep(jp, jnp.asarray(token[:, None], jnp.int32),
                            jcaches, jnp.asarray(t, jnp.int32))
        with torch.inference_mode():
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_smoke_cpu_completes_every_request(arch, capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", arch, "--smoke", "--device", "cpu"]) == 0
    assert "[serve] 4/4 completed" in capsys.readouterr().out


def test_device_policy_and_unported_parts_raise():
    """The device policy: `build_model` defaults to the card and raises
    without one (no drop to the CPU), on the CPU when asked; every arch of
    the reference builds there (whisper's encoder, cross attention and GELU
    MLP included since they were ported), and what is no part of the zoo
    raises: an unknown arch, block kind or attention kind."""
    import dataclasses

    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs import ARCHS as PORT_ARCHS
    cfg = get_config("minitron-8b", smoke=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(get_config("whisper-large-v3", smoke=True))
    assert PORT_ARCHS == JAX_ARCHS
    for arch in PORT_ARCHS:
        m = build_model(get_config(arch, smoke=True), device="cpu")
        assert m.device == torch.device("cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-tiny")
    with pytest.raises(ValueError, match="mixers"):
        build_model(dataclasses.replace(cfg, pattern=(("X", "D"),)), "cpu")
    x = torch.zeros((1, 8, cfg.d_model), dtype=torch.bfloat16)
    blk = build_model(cfg, device="cpu").init(0)["decoder"]["supers"][0]
    with pytest.raises(ValueError, match="kind"):
        attention.self_attention(blk["0"]["mixer"], x, cfg.attn, "cross")
