"""The port's encoder-decoder and vision families on the CPU against the live
JAX reference: whisper-large-v3 (a bidirectional 'B' encoder, 'C' decoder
blocks with cross attention to its output, GELU MLPs) and
llama-3.2-vision-11b (a 'C' block every fifth layer, cross attention to the
image embeddings), at their SMOKE sizes.

Weights come from the reference's `Model.init` and are carried across by
`params_from_numpy`, bit-equal.  Bars:
  * f32 layers (`cross_attention`, `self_attention` of kind 'bidir', the
    GELU MLP and `moe_ffn(swiglu=False)`, weights and inputs in float32):
    2e-5, the reference kernel's own float32 tolerance.
  * bf16 models (`apply` + `logits`, `decode_step`): the zoo's bar of
    tests/test_torch_models.py, rtol 2e-2 and atol 2e-2 x max |reference|.
Inputs are the reference's batch layout: tokens, plus `enc_frames` (B,
S_enc, D) or `img_embed` (B, n_img, D), drawn with numpy.

The reference's serving path never fills the cross caches `xk`/`xv` (its
`init_caches` builds them as zeros, and `BatchServer` runs no encoder), so
in decode every 'C' block's cross attention attends to zero keys and
values and adds exactly 0; the port does the same, and the decode test
holds it to that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro.models.model import count_params as jax_count_params
from repro_torch.configs import MoECfg, get_config
from repro_torch.models import attention, layers, moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model, count_params
from repro_torch.testing import BF16_RTOL

ARCHS = ("whisper-large-v3", "llama-3.2-vision-11b")
F32_TOL = 2e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _close_bf16(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = BF16_RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=atol,
                               err_msg=what)
    return atol


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference model, reference params, port model, port params)."""
    arch = request.param
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    m = build_model(get_config(arch, smoke=True), device="cpu")
    p = params_from_numpy(m.cfg, jax.tree.map(np.asarray, jp), "cpu")
    return arch, jm, jp, m, p


@pytest.fixture(scope="module")
def f32_blocks():
    """Each smoke arch's reference init as numpy arrays, {arch: tree};
    `_leaf_f32` takes block 0 of one of its stacks in float32."""
    out = {}
    for arch in ARCHS:
        jm = jax_build_model(jax_get_config(arch, smoke=True))
        tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1))[0])
        out[arch] = tree
    return out


def _leaf_f32(tree, *path):
    for k in path:
        tree = tree[k]
    blk = {k: np.asarray(v, np.float32)[0] for k, v in tree.items()}
    return ({k: jnp.asarray(v) for k, v in blk.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in blk.items()})


# ---------------------------------------------------------------------------
# layers in float32
# ---------------------------------------------------------------------------

# (arch, Sq, Skv): the reference's dense branch (Sq <= 16, and
# max(Sq, Skv) <= DENSE_MAX_S), its chunked one (Q padded to CHUNK_Q, K/V
# padded to a CHUNK_KV multiple and masked past Skv), GQA (llama, K 2 of 4)
CROSS_CASES = [("whisper-large-v3", 1, 48), ("whisper-large-v3", 16, 1500),
               ("whisper-large-v3", 40, 1500),
               ("whisper-large-v3", 600, 2560),
               ("llama-3.2-vision-11b", 40, 17),
               ("llama-3.2-vision-11b", 2560, 17),
               ("llama-3.2-vision-11b", 700, 2100)]


@pytest.mark.parametrize("arch,Sq,Skv", CROSS_CASES)
def test_cross_attention_f32_matches_reference(f32_blocks, arch, Sq, Skv):
    """Memory (B, Skv, D) and its precomputed (k, v): the port (dense
    `attend` at Sq <= 16, else the flash path, non-causal, Skv != Sq)
    against the reference's `cross_attention` in each of its branches."""
    cfg = get_config(arch, smoke=True)
    jblk, blk = _leaf_f32(f32_blocks[arch], "decoder", "supers", "0", "xattn")
    rng = np.random.default_rng(Sq * 7 + Skv)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, Skv, cfg.d_model)).astype(np.float32)
    want = jax_attention.cross_attention(jblk, jnp.asarray(x),
                                         jnp.asarray(mem), cfg.attn)
    got = attention.cross_attention(blk, torch.from_numpy(x),
                                    torch.from_numpy(mem), cfg.attn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    K, hd = cfg.attn.n_kv, cfg.attn.head_dim
    kv = [rng.standard_normal((2, Skv, K, hd)).astype(np.float32)
          for _ in range(2)]
    want = jax_attention.cross_attention(
        jblk, jnp.asarray(x), tuple(jnp.asarray(a) for a in kv), cfg.attn)
    got = attention.cross_attention(
        blk, torch.from_numpy(x), tuple(torch.from_numpy(a) for a in kv),
        cfg.attn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("S", [40, 1500, 2560])
def test_bidir_self_attention_f32_matches_reference(f32_blocks, S):
    """The encoder's 'B' self-attention: the reference's dense `attend` up
    to 2048 (whisper's 1500 frames), `attend_chunked` above it; the port's
    flash path, non-causal, at any S."""
    cfg = get_config("whisper-large-v3", smoke=True)
    jblk, blk = _leaf_f32(f32_blocks["whisper-large-v3"], "encoder",
                          "supers", "0", "mixer")
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)
                                                 ).astype(np.float32)
    want = jax_attention.self_attention(jblk, jnp.asarray(x), cfg.attn,
                                        "bidir")
    got = attention.self_attention(blk, torch.from_numpy(x), cfg.attn,
                                   "bidir")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_gelu_mlp_f32_matches_reference(f32_blocks):
    """whisper's GELU MLP: `jax.nn.gelu`'s tanh form (torch's default erf
    form is off by ~1e-3 here and fails the bar)."""
    cfg = get_config("whisper-large-v3", smoke=True)
    jblk, blk = _leaf_f32(f32_blocks["whisper-large-v3"], "decoder",
                          "supers", "0", "ffn")
    assert set(blk) == {"w_up", "w_down"}
    x = np.random.default_rng(9).standard_normal((2, 33, cfg.d_model)
                                                 ).astype(np.float32) * 3
    want = np.asarray(jax_layers.mlp(jblk, jnp.asarray(x), swiglu=False))
    got = layers.mlp(blk, torch.from_numpy(x), swiglu=False).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    erf = (torch.nn.functional.gelu(torch.from_numpy(x) @ blk["w_up"])
           @ blk["w_down"]).numpy()
    assert np.abs(erf - want).max() > 10 * F32_TOL


@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("router_pre_softmax", [False, True])
def test_moe_ffn_gelu_f32_matches_reference(n_shared, router_pre_softmax):
    """moe_ffn(swiglu=False): GELU experts and shared experts (no config
    uses it; the reference has it), float32, both routers."""
    cfg = MoECfg(n_routed=8, top_k=2, d_expert=32, n_shared=n_shared,
                 router_pre_softmax=router_pre_softmax)
    D = 64
    tree = jax_moe.init_moe(jax.random.PRNGKey(n_shared), D, cfg,
                            swiglu=False)[0]
    tree = {k: np.array(v, np.float32) for k, v in tree.items()}
    x = np.random.default_rng(n_shared).standard_normal((2, 48, D)
                                                        ).astype(np.float32)
    want, jaux = jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in tree.items()},
                                 jnp.asarray(x), cfg, swiglu=False)
    got, aux = moe.moe_ffn({k: torch.from_numpy(v) for k, v in tree.items()},
                           torch.from_numpy(x), cfg, swiglu=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    for k in ("lb_loss", "drop_frac"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)
    gen = torch.Generator().manual_seed(0)
    assert set(moe.init_moe(gen, D, cfg, swiglu=False)[0]) == set(tree)


# ---------------------------------------------------------------------------
# whole models, bf16
# ---------------------------------------------------------------------------

def _batch(cfg, B, S, S_mem, seed):
    """The reference's batch layout, drawn with numpy: numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    key = "enc_frames" if cfg.encoder is not None else "img_embed"
    batch[key] = rng.standard_normal((B, S_mem, cfg.d_model)
                                     ).astype(np.float32)
    return batch


def test_params_carried_across_bit_equal(pair):
    """Every leaf: the decoder's stack (the 'C' blocks' xattn and ln_x
    too), and whisper's encoder stack, unstacked over encoder.n_layers,
    and ln_enc."""
    arch, jm, jp, m, p = pair
    cfg = m.cfg
    ref = jax.tree.map(np.asarray, jp)
    for key in ("embed", "ln_f", "head", "ln_enc"):
        for leaf, arr in ref.get(key, {}).items():
            assert np.array_equal(_bits(p[key][leaf]), arr.view(np.int16))
    stacks = [("decoder", cfg.n_super)]
    if cfg.encoder is not None:
        stacks.append(("encoder", cfg.encoder.n_layers))
        assert "ln_enc" in p
    else:
        assert "encoder" not in p and "ln_enc" not in p
    n_cross = 0
    for name, n in stacks:
        assert p[name]["first"] == [] and len(p[name]["supers"]) == n
        for i in range(n):
            for pos, block in ref[name]["supers"].items():
                for path, arr in jax.tree_util.tree_flatten_with_path(
                        block)[0]:
                    t = p[name]["supers"][i][pos]
                    for k in path:
                        t = t[k.key]
                    a = arr[i]
                    assert np.array_equal(_bits(t), a.view(np.int16)), (
                        name, i, pos, path)
                    n_cross += path[0].key == "xattn"
    assert n_cross == 4 * cfg.n_super * sum(mx == "C" for mx, _ in
                                            cfg.pattern)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_reference(arch):
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke), jax_get_config(arch, smoke)
        assert count_params(cfg) == jax_count_params(jcfg)
        assert cfg.param_count() == jcfg.param_count()


# (tokens S, memory S): whisper's decoder against 48 and its published 1500
# frames (the reference's dense attention) and 2560 (its chunked encoder and
# cross attention, Q padded); llama-vision at S 40 and 2560 (chunked).
APPLY_CASES = [("whisper-large-v3", 16, 48), ("whisper-large-v3", 40, 1500),
               ("whisper-large-v3", 600, 2560),
               ("llama-3.2-vision-11b", 40, 17),
               ("llama-3.2-vision-11b", 2560, 17)]


@pytest.mark.parametrize("pair,S,S_mem", APPLY_CASES, indirect=["pair"])
def test_apply_and_logits_bf16_match_reference(pair, S, S_mem):
    arch, jm, jp, m, p = pair
    nb = _batch(m.cfg, 2, S, S_mem, seed=S + S_mem)
    jbatch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.bfloat16)
              for k, v in nb.items()}
    jh, _ = jax.jit(jm.apply)(jp, jbatch)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    batch = {k: v if k == "tokens" else v.bfloat16() for k, v in batch.items()}
    with torch.inference_mode():
        h, aux = m.apply(p, batch)
        lg = m.logits(p, h)
    assert h.dtype == torch.bfloat16 and float(aux["lb_loss"]) == 0.0
    _close_bf16(h, jh, f"{arch} hidden S={S} memory {S_mem}")
    _close_bf16(lg, jm.logits(jp, jh), f"{arch} logits S={S}")


def test_decode_teacher_forced_matches_reference(pair):
    """16 steps with the zero cross caches of the reference's
    `init_caches` (whisper: seq entries; llama-vision: n_img_tokens): 8
    prompt tokens, then the reference's own greedy tokens, fed to both;
    logits compared per step.  The cross attention adds exactly 0."""
    arch, jm, jp, m, p = pair
    B, seq, n_prompt, steps = 2, 32, 8, 16
    prompt = np.random.default_rng(5).integers(1, m.cfg.vocab, (B, n_prompt))
    jstep = jax.jit(jm.decode_step)
    jcaches = jm.init_caches(B, seq)
    caches = m.init_caches(B, seq)
    mem_len = m.cfg.n_img_tokens or seq
    for i, (mx, _) in enumerate(m.cfg.pattern):
        c = caches["supers"][0][str(i)]
        assert ("xk" in c) == (mx == "C")
        if mx == "C":
            assert c["xk"].shape == (B, mem_len, m.cfg.attn.n_kv,
                                     m.cfg.attn.head_dim)
            assert not c["xk"].any() and not c["xv"].any()
            h = torch.randn((B, 1, m.cfg.d_model)).bfloat16()
            blk = p["decoder"]["supers"][0][str(i)]["xattn"]
            out = attention.cross_attention(blk, h, (c["xk"], c["xv"]),
                                            m.cfg.attn)
            assert not out.any()
    token = prompt[:, 0]
    for t in range(steps):
        jl, jcaches = jstep(jp, jnp.asarray(token[:, None], jnp.int32),
                            jcaches, jnp.asarray(t, jnp.int32))
        with torch.inference_mode():
            lg, caches = m.decode_step(p, torch.from_numpy(token[:, None]),
                                       caches, t)
        _close_bf16(lg, jl, f"{arch} decode step {t}")
        token = prompt[:, t + 1] if t + 1 < n_prompt else _np(jl)[:, -1
                                                                  ].argmax(-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_smoke_cpu_completes_every_request(arch, capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", arch, "--smoke", "--device", "cpu"]) == 0
    assert "[serve] 4/4 completed" in capsys.readouterr().out
