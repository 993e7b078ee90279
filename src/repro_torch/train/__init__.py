"""Optimizer substrate (port of the part of `repro.train` the agent uses)."""
