"""Blocked GQA flash attention (port of `repro.kernels.flash_attention`)."""
