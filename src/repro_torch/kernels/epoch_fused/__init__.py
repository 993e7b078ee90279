"""Fused epoch-core kernels (port of `repro.kernels.epoch_fused`)."""
