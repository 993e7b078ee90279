"""Hand-written Hopper kernels with plain-torch versions beside them.

Each kernel package holds `ref.py` (the plain version: the CPU path and the
yardstick the kernel is held to) and `ops.py` (the wrapper: plain version for
CPU tensors, the CUDA kernel for CUDA tensors, a launch counter).  The CUDA
sources live in `repro_torch/csrc/` and are built by `repro_torch.kernels.build`.
"""
