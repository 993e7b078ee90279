"""The port's cost models (`repro_torch.configs` `shape_applicable` /
`all_configs`, `launch/memory_model.py`, `launch/roofline.py`) on the CPU
against the live JAX reference.

The reference's peaks are passed in as the port's `Chip` record, built here
from `repro.launch.roofline` and `repro.core.sharding_mapper`, so the port
itself carries only the H100's.  Bars: every result `==` as a Python float
or bool (each expression is the reference's, in its order).
"""
import itertools
import re
from pathlib import Path

import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import SMOKE_SHAPE as J_SMOKE_SHAPE
from repro.configs import all_configs as j_all_configs
from repro.configs import get_config as j_get_config
from repro.configs import shape_applicable as j_shape_applicable
from repro.core import sharding_mapper as j_sm
from repro.launch import memory_model as j_mm
from repro.launch import roofline as j_rf
from repro_torch.configs import (ARCHS, SHAPES, SMOKE_SHAPE, all_configs,
                                 get_config, shape_applicable)
from repro_torch.launch import memory_model as mm
from repro_torch.launch.roofline import H100, Chip, Roofline

REF = Chip(name="reference", peak_flops=j_rf.PEAK_FLOPS, hbm_bw=j_rf.HBM_BW,
           hbm_bytes=j_sm.HBM_PER_CHIP, link_bw=j_rf.ICI_BW)
PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
PLANNING = [PORT / p for p in ("launch/memory_model.py", "launch/roofline.py",
                               "core/sharding_mapper.py")]


def test_registry_helpers_match_the_reference():
    assert ARCHS == J_ARCHS and set(SHAPES) == set(J_SHAPES)
    assert SMOKE_SHAPE.__dict__ == J_SMOKE_SHAPE.__dict__
    for smoke in (False, True):
        got, want = all_configs(smoke), j_all_configs(smoke)
        assert list(got) == list(want)
        assert [c.name for c in got.values()] == [c.name for c in
                                                  want.values()]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", J_ARCHS)
def test_shape_applicable_matches(arch, smoke):
    for name in J_SHAPES:
        got = shape_applicable(get_config(arch, smoke), SHAPES[name])
        want = j_shape_applicable(j_get_config(arch, smoke), J_SHAPES[name])
        assert got == want, (arch, name)


@pytest.mark.parametrize("arch", J_ARCHS)
def test_memory_bytes_equal(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, mb, q in itertools.product(J_SHAPES, (1, 8, 16),
                                         (False, True)):
        got = mm.memory_bytes(cfg, SHAPES[name], mb=mb, quantized_opt=q)
        want = j_mm.memory_bytes(jcfg, J_SHAPES[name], mb=mb,
                                 quantized_opt=q)
        assert got == want, (arch, name, mb, q)
    assert mm.memory_bytes(cfg, SMOKE_SHAPE) == j_mm.memory_bytes(
        jcfg, J_SMOKE_SHAPE)
    assert mm._attn_layers(cfg) == j_mm._attn_layers(jcfg)
    assert (mm.KAPPA_TRAIN, mm.KAPPA_FWD, mm.CHUNK_Q) == (
        j_mm.KAPPA_TRAIN, j_mm.KAPPA_FWD, j_mm.CHUNK_Q)


ROOF_CASES = [
    dict(flops=197e12 * 256, bytes_hbm=0.1, bytes_collective=0.1, chips=256,
         model_flops=197e12 * 256),
    dict(flops=1, bytes_hbm=819e9 * 512, bytes_collective=1, chips=256,
         model_flops=1),
    dict(flops=3e15, bytes_hbm=2e12, bytes_collective=5e11, chips=8,
         model_flops=2.5e15),
    dict(flops=0.0, bytes_hbm=0.0, bytes_collective=7e12, chips=4,
         model_flops=1e12),
]
PROPS = ("compute_s", "memory_s", "collective_s", "dominant", "step_s",
         "useful_ratio", "roofline_fraction")


@pytest.mark.parametrize("case", ROOF_CASES)
def test_roofline_matches_the_reference(case):
    got, want = Roofline(**case, chip=REF), j_rf.Roofline(**case)
    for p in PROPS:
        assert getattr(got, p) == getattr(want, p), p
    assert got.as_dict() == want.as_dict()
    assert got.fraction_at(got.step_s) == got.roofline_fraction


def test_roofline_on_the_card_record():
    """The reference's dominance test with the H100's peaks."""
    assert Roofline(1, 1, 1, 1, 1).chip == H100
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes,
            H100.link_bw) == (989e12, 3.35e12, 80e9, 450e9)
    r = Roofline(flops=989e12 * 8, bytes_hbm=0.1, bytes_collective=0.1,
                 chips=8, model_flops=989e12 * 8)
    assert r.compute_s == 1.0 and r.dominant == "compute"
    assert r.roofline_fraction == 1.0
    r2 = Roofline(flops=1, bytes_hbm=3.35e12 * 16, bytes_collective=1,
                  chips=8, model_flops=1)
    assert r2.dominant == "memory" and r2.memory_s == 2.0
    r3 = Roofline(flops=1, bytes_hbm=1, bytes_collective=450e9 * 24, chips=8,
                  model_flops=1)
    assert r3.dominant == "collective" and r3.collective_s == 3.0
    # a measured step's share: model_flops / (step x peak)
    assert r.fraction_at(4.0) == 0.25


def test_memory_model_sanity():
    """The reference's own sanity test, on the port."""
    cfg = get_config("minitron-8b")
    train = mm.memory_bytes(cfg, SHAPES["train_4k"], mb=8)
    decode = mm.memory_bytes(cfg, SHAPES["decode_32k"])
    prefill = mm.memory_bytes(cfg, SHAPES["prefill_32k"])
    assert train > prefill > 0
    assert decode > 2 * 2 * cfg.param_count()
    assert mm.memory_bytes(cfg, SHAPES["train_4k"], mb=16) > train


@pytest.mark.parametrize("path", PLANNING, ids=lambda p: p.name)
def test_planning_modules_carry_no_tpu_number(path):
    text = path.read_text()
    for word in (r"197e12", r"819e9", r"50e9", r"16e9", r"v5e", r"TPU",
                 r"ICI"):
        assert not re.search(rf"(?<![\w.]){word}\b", text), (path.name,
                                                               word)
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", text, re.M)
