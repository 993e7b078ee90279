"""The port's mixture-of-experts FFN (`repro_torch.models.moe`) on the CPU
against the live JAX reference (`repro.models.moe`).

The same inputs, drawn with numpy from a fixed seed, and the reference's
own `init_moe` weights (cast to float32 on both sides, so the point is the
algorithm, not where bf16 rounds) go through both `moe_ffn`s.  Bars:
  * routing `==`: each slot's token and validity (E, C) per dispatch group,
    and `drop_frac`.  The reference returns no slots, so
    `_reference_routing` replays its dispatch (src/repro/models/moe.py:88-114)
    in jnp on the same inputs, through its own `_capacity`;
  * the output and `lb_loss` within 1e-5 (float32 products and sums in
    another order).
Both router styles (top-k then softmax: mixtral/jamba; softmax then top-k,
renormalised: deepseek), with ample capacity (nothing dropped) and tight
capacity (dropping), one and two dispatch groups, with and without shared
experts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoECfg as JaxMoECfg
from repro.models.moe import _capacity as jax_capacity
from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro_torch.configs.base import MoECfg
from repro_torch.models import moe

D = 32


def _case(pre: bool, capacity_factor: float, groups: int, shared: int,
          seed: int = 0):
    kw = dict(n_routed=8, top_k=2, d_expert=48, n_shared=shared,
              capacity_factor=capacity_factor, router_pre_softmax=pre,
              dispatch_groups=groups)
    jparams, _ = jax_init_moe(jax.random.PRNGKey(seed), D, JaxMoECfg(**kw))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    x = np.random.default_rng(seed).standard_normal((4, 24, D)).astype(
        np.float32)
    return JaxMoECfg(**kw), MoECfg(**kw), jparams, params, x


def _reference_routing(jparams, x, cfg):
    """The reference dispatch's routing, line for line (moe.py:88-114)."""
    B, S, Dm = x.shape
    T = B * S
    E, K = cfg.n_routed, cfg.top_k
    C = jax_capacity(T, cfg)
    xf = jnp.asarray(x).reshape(T, Dm)
    logits = xf.astype(jnp.float32) @ jparams["router"]
    if cfg.router_pre_softmax:
        probs = jax.nn.softmax(logits, axis=-1)
        gate_vals, expert_idx = jax.lax.top_k(probs, K)
    else:
        _, expert_idx = jax.lax.top_k(logits, K)
    flat_e = expert_idx.reshape(T * K)
    flat_tok = jnp.repeat(jnp.arange(T), K)
    order = jnp.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_tok[order]
    counts = jnp.bincount(flat_e, length=E)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(T * K) - starts[se]
    keep = pos < C
    slot = jnp.where(keep, se * C + pos, E * C)
    tok_of_slot = jnp.zeros((E * C + 1,), jnp.int32).at[slot].set(
        st.astype(jnp.int32))[:-1].reshape(E, C)
    valid_slot = jnp.zeros((E * C + 1,)).at[slot].set(
        keep.astype(jnp.float32))[:-1].reshape(E, C)
    return np.asarray(tok_of_slot), np.asarray(valid_slot)


CASES = [(pre, cf, groups, shared)
         for pre in (False, True) for cf in (4.0, 0.5)
         for groups in (1, 2) for shared in (0, 2)]


@pytest.mark.parametrize(
    "pre,cf,groups,shared", CASES,
    ids=[f"{'deepseek' if p else 'mixtral'}-cf{c}-G{g}-shared{s}"
         for p, c, g, s in CASES])
def test_moe_ffn_matches_reference(pre, cf, groups, shared):
    jcfg, cfg, jparams, params, x = _case(pre, cf, groups, shared)
    want, jaux = jax_moe_ffn(jparams, jnp.asarray(x), jcfg)
    got, aux = moe.moe_ffn(params, torch.from_numpy(x), cfg)
    # the routing of every dispatch group (a group is T / G tokens, as the
    # reference's vmap over x.reshape(G, T // G, 1, D))
    T = x.shape[0] * x.shape[1]
    xg = x.reshape(groups, T // groups, 1, D)
    for g in range(groups):
        ref_tok, ref_valid = _reference_routing(jparams, xg[g], jcfg)
        r = moe.route(params, torch.from_numpy(xg[g]).reshape(-1, D), cfg)
        assert np.array_equal(r["tok_of_slot"].numpy(), ref_tok), g
        assert np.array_equal(r["valid_slot"].numpy(), ref_valid), g
    assert float(aux["drop_frac"]) == float(jaux["drop_frac"])
    if cf >= 4.0:
        assert float(aux["drop_frac"]) == 0.0
    else:
        assert float(aux["drop_frac"]) > 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux["lb_loss"]), float(jaux["lb_loss"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pre", [False, True])
def test_each_token_sums_its_kept_slots_in_scatter_order(pre):
    """`tok_slots` lists each token's kept slots (ascending slot id, i.e.
    ascending expert, then rank) and nothing else: every valid slot appears
    once, under its own token, and the dropped assignments point at the
    discarded row E*C."""
    _, cfg, _, params, x = _case(pre, 0.5, 1, 0, seed=3)
    r = moe.route(params, torch.from_numpy(x).reshape(-1, D), cfg)
    E, C = r["tok_of_slot"].shape
    slots = r["tok_slots"]
    assert torch.equal(slots, torch.sort(slots, dim=1).values)
    kept = slots[slots < E * C]
    assert torch.equal(torch.sort(kept).values,
                       torch.nonzero(r["valid_slot"].reshape(-1))[:, 0])
    owner = torch.arange(slots.shape[0])[:, None].expand_as(slots)
    assert torch.equal(r["tok_of_slot"].reshape(-1)[kept].long(),
                       owner[slots < E * C])
    assert int((slots == E * C).sum()) == slots.numel() - int(
        r["valid_slot"].sum())


def test_bf16_moe_layer_matches_reference():
    """The bf16 layer as the models run it (the reference's bf16 weights,
    carried across bit-equal), within the models' bf16 bar: rtol 2e-2 and
    atol 2e-2 x max |reference| (tests/test_torch_models.py)."""
    kw = dict(n_routed=8, top_k=2, d_expert=48, n_shared=2,
              router_pre_softmax=True)
    jparams, _ = jax_init_moe(jax.random.PRNGKey(1), D, JaxMoECfg(**kw))
    from repro_torch.models.convert import to_tensor
    params = {k: to_tensor(np.asarray(v), "cpu") for k, v in jparams.items()}
    assert params["router"].dtype == torch.float32
    assert params["w_gate"].dtype == torch.bfloat16
    x = np.random.default_rng(1).standard_normal((2, 16, D)).astype(np.float32)
    want, _ = jax_moe_ffn(jparams, jnp.asarray(x, jnp.bfloat16),
                          JaxMoECfg(**kw))
    got, _ = moe.moe_ffn(params, torch.from_numpy(x).bfloat16(), MoECfg(**kw))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2 * float(np.abs(want).max()))


def test_init_moe_shapes_and_capacity():
    cfg = MoECfg(n_routed=8, top_k=2, d_expert=48, n_shared=2)
    gen = torch.Generator().manual_seed(0)
    p, _ = moe.init_moe(gen, D, cfg)
    assert p["router"].dtype == torch.float32 and p["router"].shape == (D, 8)
    assert p["w_gate"].shape == (8, D, 48) and p["w_down"].shape == (8, 48, D)
    assert p["ws_gate"].shape == (D, 96) and p["ws_down"].shape == (96, D)
    for n in (1, 7, 64, 1000, 4096):
        jcfg = JaxMoECfg(**dataclasses.asdict(cfg))
        assert moe._capacity(n, cfg) == jax_capacity(n, jcfg)
