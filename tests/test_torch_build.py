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


@pytest.mark.parametrize("name", ["epoch_fused", "threefry", "batched_linear",
                                  "td_grad", "adamw_lanes"])
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


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd"])
def test_attention_sources_include_the_shared_header(name):
    assert build.CSRC / "hopper_wgmma.cuh" in build.sources_of(name)


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd"])
def test_attention_sources_include_the_mma_sync_header(name):
    """The hd 16 / 32 kernels, forward and backward, share mma.sync,
    ldmatrix and cp.async from one header."""
    assert build.CSRC / "mma_sync.cuh" in build.sources_of(name)


@pytest.mark.parametrize("name", ["dueling_qnet", "td_grad", "adamw_lanes"])
def test_bulk_copy_sources_include_the_shared_header(name):
    assert build.CSRC / "hopper_async.cuh" in build.sources_of(name)


def test_library_path_follows_every_included_header(tmp_path, monkeypatch):
    """A changed header, included directly or through another header,
    rebuilds every source that includes it and no other."""
    (tmp_path / "a.cu").write_text('#include "top.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text('#include <cuda_runtime.h>\nint b;\n')
    (tmp_path / "top.cuh").write_text('#pragma once\n#include "leaf.cuh"\n')
    (tmp_path / "leaf.cuh").write_text("#pragma once\nint leaf = 1;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    for n in ("a", "b"):
        monkeypatch.setitem(build.SOURCE_FLAGS, n, ())
    assert build.sources_of("a") == [tmp_path / "a.cu", tmp_path / "top.cuh",
                                     tmp_path / "leaf.cuh"]
    before = {n: build.library_path(n) for n in ("a", "b")}
    (tmp_path / "leaf.cuh").write_text("#pragma once\nint leaf = 2;\n")
    after = {n: build.library_path(n) for n in ("a", "b")}
    assert after["a"] != before["a"]
    assert after["b"] == before["b"]
