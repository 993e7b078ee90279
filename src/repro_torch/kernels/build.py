"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` alone into a shared library with
a plain C interface and loaded with ctypes (no PyTorch headers, so a build
takes seconds).  Libraries land in `build/repro_torch/` at the root of the
checkout, named by a hash of the source and its own flags, so a changed source
rebuilds and an unchanged one is reused.  Nothing here runs at import: the
first CUDA launch of a wrapper builds what it needs, and `build()` builds
several sources at once (one `nvcc` process each, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("epoch_fused", "dueling_qnet", "flash_attention", "ssd_scan",
           "threefry", "batched_linear", "flash_attention_bwd",
           "ssd_scan_bwd")

# sm_90a (Hopper) for every source.  -fmad=false (no a*b+c contraction)
# only where a contract is exact: the epoch core's EMA decay then +1.0 adds
# and TOM scores, threefry's uniform scaling and choice sums, and the
# TD step's batched products and sums (batch-invariant order).  The dueling Q-network's and the zoo kernels' bars (their backward kernels' too) are
# tolerances, so their products, softmax and decay arithmetic may contract
# into FMAs.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
EXACT_FLAGS = ("-fmad=false",)
SOURCE_FLAGS = {"epoch_fused": EXACT_FLAGS, "dueling_qnet": (),
                "flash_attention": (), "ssd_scan": (),
                "threefry": EXACT_FLAGS, "batched_linear": EXACT_FLAGS,
                "flash_attention_bwd": (), "ssd_scan_bwd": ()}


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The nvcc flags of `csrc/<name>.cu`."""
    return BASE_FLAGS + SOURCE_FLAGS[name]


_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("repro_torch: nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source whose library is missing, all at once.
    Returns seconds per source built; raises with nvcc's output on failure.
    The compiler's register/shared-memory report is kept beside each
    library as `<lib>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    secs = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"repro_torch: nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        out.with_suffix(".so.log").write_text(log)
        os.replace(tmp, out)
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    if name not in _LIBS:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (cudaGetLastError())."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"repro_torch: {what} launch failed: CUDA error "
                           f"{code} ({msg})")
