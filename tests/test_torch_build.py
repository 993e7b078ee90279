"""The port's kernel build settings (`repro_torch.kernels.build`), on the CPU.

Nothing here runs nvcc: the tests read the flags each source is compiled
with and the library path they hash into.
"""
import pytest

from repro_torch.kernels import build

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")


def test_every_source_has_its_flags():
    assert set(build.SOURCE_FLAGS) == set(build.SOURCES)
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists(), name


@pytest.mark.parametrize("name", ["epoch_fused", "threefry", "batched_linear"])
def test_exact_kernels_keep_fmad_false(name):
    assert "-fmad=false" in build.nvcc_flags(name)


@pytest.mark.parametrize("name", ["dueling_qnet", "flash_attention",
                                  "ssd_scan", "flash_attention_bwd",
                                  "ssd_scan_bwd"])
def test_zoo_kernels_may_contract(name):
    assert not any(f.startswith("-fmad") for f in build.nvcc_flags(name))


@pytest.mark.parametrize("name", build.SOURCES)
def test_every_source_compiles_for_sm_90a(name):
    flags = build.nvcc_flags(name)
    i = flags.index("-gencode")
    assert flags[i:i + 2] == ARCH
    assert not any("sm_90," in f or f.endswith("sm_90") for f in flags)


@pytest.mark.parametrize("name", build.SOURCES)
def test_library_path_follows_the_sources_own_flags(name, monkeypatch):
    before = {n: build.library_path(n) for n in build.SOURCES}
    assert before[name].parent == build.BUILD_DIR
    assert before[name].name.startswith(f"{name}-")
    monkeypatch.setitem(build.SOURCE_FLAGS, name,
                        build.SOURCE_FLAGS[name] + ("-lineinfo",))
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert after[name] != before[name]
    assert all(after[n] == before[n] for n in build.SOURCES if n != name)
