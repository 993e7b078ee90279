"""Mamba2 SSD chunked scan (port of `repro.kernels.ssd_scan`)."""
