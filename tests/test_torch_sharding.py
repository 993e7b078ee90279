"""The port's sharding layer (`repro_torch.sharding`) against the live
reference (`repro.sharding`), on the production meshes as axis sizes alone
(jax's `AbstractMesh(axis_sizes, axis_names)`, the port's
`launch.mesh.AbstractMesh`): roles, policies and every spec `==` for the
ten archs, the reference test file's own assertions on the port, and
`constrain` outside a context.

The port keeps one tensor per super-block where the reference stacks them
(n_super, ...); `policies.stack` folds the port's trees into the stacked
layout, and the port's spec of a super-block tensor is the stacked spec
less its leading dim (held here too)."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import shape_applicable as j_shape_applicable
from repro.models import build_model as j_build_model
from repro.models.model import abstract_init as j_abstract_init
from repro.sharding import policies as jpol
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.launch.mesh import AbstractMesh, production_shape
from repro_torch.models.model import abstract_init, build_model
from repro_torch.sharding import policies
from repro_torch.sharding.context import constrain

MESHES = {False: production_shape(False), True: production_shape(True)}


def _jmesh(multi):
    m = MESHES[multi]
    return JAbstractMesh(m.shape, m.mesh_dim_names)


_REF = {}


def _ref(arch):
    """The reference's (model, shapes, roles) of `arch`, built once."""
    if arch not in _REF:
        m = j_build_model(j_get_config(arch))
        _REF[arch] = (m,) + tuple(j_abstract_init(m))
    return _REF[arch]


_PORT = {}


def _port(arch):
    if arch not in _PORT:
        m = build_model(get_config(arch), "cpu")
        _PORT[arch] = (m,) + tuple(abstract_init(m))
    return _PORT[arch]


def _ref_specs(tree):
    """Reference NamedShardings -> {path: spec tuple}."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in flat}


def _port_specs(tree):
    """The port's `Sharding` tree, stacked -> {path: spec tuple} keyed as
    jax keys the reference's tree."""
    stacked = policies.stack(tree)
    out = {}

    def walk(t, key):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{key}[{k!r}]")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{key}[{i}]")
        else:
            out[key] = tuple(t)
    walk(stacked, "")
    return out


def _check_unstacked(tree, mesh):
    """Every super-block leaf's spec is its stacked spec less the leading
    dim; its placements are those the spec implies."""
    def walk(t, in_supers):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, in_supers or k == "supers")
        elif isinstance(t, list):
            for v in t:
                walk(v, in_supers)
        else:
            assert isinstance(t, policies.Sharding)
            assert t.placements == policies.placements_for(t.spec, mesh)
            if not in_supers:
                assert t.layer_axis is None
    walk(tree, False)


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("arch", ARCHS)
def test_roles_tree_matches_reference(arch):
    _, _, jroles = _ref(arch)
    _, shapes, roles = _port(arch)
    assert policies.stack(roles) == jroles
    # shapes fold into the reference's stacked shapes
    jshapes = _ref(arch)[1]
    flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    port = {}
    stacked = policies.stack(shapes)

    def walk(t, key):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{key}[{k!r}]")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{key}[{i}]")
        else:
            port[key] = tuple(t.shape)
    walk(stacked, "")
    assert port == {jax.tree_util.keystr(p): tuple(s.shape)
                    for p, s in flat}


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, multi):
    mesh, jmesh = MESHES[multi], _jmesh(multi)
    jm, jshapes, jroles = _ref(arch)
    m, shapes, roles = _port(arch)
    cfg, jcfg = get_config(arch), j_get_config(arch)

    assert policies.resolve_policy(cfg, mesh) == policies.Policy(
        **vars(jpol.resolve_policy(jcfg, jmesh)))

    jp = jpol.param_specs(jroles, jshapes, jcfg, jmesh)
    pp = policies.param_specs(roles, shapes, cfg, mesh)
    assert _port_specs(pp) == _ref_specs(jp)
    _check_unstacked(pp, mesh)

    jz = jpol.zero_shard_specs(jp, jshapes, jmesh, jcfg)
    pz = policies.zero_shard_specs(pp, shapes, mesh, cfg)
    assert _port_specs(pz) == _ref_specs(jz)
    _check_unstacked(pz, mesh)

    for quant in (False, True):
        jo = jpol.opt_state_specs(jp, jshapes, jmesh, jcfg, quantized=quant)
        po = policies.opt_state_specs(pp, shapes, mesh, cfg, quantized=quant)
        assert _port_specs(po) == _ref_specs(jo), quant
        _check_unstacked(po, mesh)

    n = 0
    for sname, shape in SHAPES.items():
        ok, why = shape_applicable(cfg, shape)
        assert (ok, why) == j_shape_applicable(jcfg, J_SHAPES[sname])
        if not ok:
            continue
        jb = jpol.batch_specs(jcfg, J_SHAPES[sname], jmesh,
                              jm.input_specs(J_SHAPES[sname]))
        pb = policies.batch_specs(cfg, shape, mesh, m.input_specs(shape))
        got, want = _port_specs(pb), _ref_specs(jb)
        # the reference writes P() for a 0-d position, the port ()
        assert got == want, sname
        _check_unstacked(pb, mesh)
        n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "mixtral-8x22b"])
def test_fsdp_policy_engages_for_big_models(arch):
    pol = policies.resolve_policy(get_config(arch), MESHES[False])
    assert pol.fsdp_params


def test_small_models_stay_tp_only():
    pol = policies.resolve_policy(get_config("minitron-8b"), MESHES[False])
    assert not pol.fsdp_params


def test_decode_cache_seq_sharded():
    mesh = MESHES[False]
    cfg = get_config("qwen3-32b")
    model = build_model(cfg, "cpu")
    shape = SHAPES["decode_32k"]
    bspecs = policies.batch_specs(cfg, shape, mesh, model.input_specs(shape))
    leaf = policies.stack(bspecs["caches"])["supers"]["0"]["k"]
    # (n_super, B, S, K, hd): batch over data, seq over model
    assert leaf[1] is not None and leaf[2] == "model"
    # the port's per-super-block cache (B, S, K, hd) likewise
    one = bspecs["caches"]["supers"][0]["0"]["k"]
    assert one.spec[0] is not None and one.spec[1] == "model"


def test_quantized_opt_specs_preserve_leading_sharding():
    mesh = MESHES[False]
    cfg = get_config("jamba-1.5-large-398b")
    m, shapes, roles = _port("jamba-1.5-large-398b")
    pspecs = policies.param_specs(roles, shapes, cfg, mesh)
    ospecs = policies.opt_state_specs(pspecs, shapes, mesh, cfg,
                                      quantized=True)
    leaves = []

    def walk(p, o):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], o[k])
        elif isinstance(p, list):
            for a, b in zip(p, o):
                walk(a, b)
        else:
            leaves.append((p, o))
    walk(pspecs, ospecs)
    quant = [(p, o) for p, o in leaves if "mq" in o]
    assert quant
    for p, o in quant:
        spec = _pad(p.spec, len(o["mq"].spec) - 1)
        assert o["mq"].spec[:-2] == spec[:-1]
        assert o["ms"].spec[:-1] == spec[:-1]
        assert o["vq"] == o["mq"] and o["v_lo"] == o["ms"] == o["v_sc"]


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES[True]
    assert policies.placements_for((None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    assert policies.placements_for((("pod", "data"), None), mesh) == (
        Shard(0), Shard(0), Replicate())
    assert policies.placements_for(
        (None, ("pod", "data", "model")), mesh) == (Shard(1),) * 3
    with pytest.raises(ValueError):
        policies.placements_for((("data", "pod"),), mesh)
    small = AbstractMesh((2, 4), ("data", "model"))
    assert policies.local_shape((8, 12), (("data",), "model"), small) == (
        4, 3)


def test_constrain_is_identity_outside_a_context():
    x = torch.randn(4, 8, 16)
    assert constrain(x, ("data", "model", None)) is x
    # a plain tensor inside a context is left as it is, too
    from repro_torch.sharding.context import sharding_ctx
    with sharding_ctx(MESHES[False], policies.Policy()):
        assert constrain(x, ("data", "model", None)) is x
