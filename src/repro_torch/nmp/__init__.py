"""Simulated NMP system (port of `repro.nmp`): the environment AIMM optimizes."""
from repro_torch.nmp.config import NMPConfig  # noqa: F401
from repro_torch.nmp.engine import (EpisodeResult, run_episode,  # noqa: F401
                                    run_program)
from repro_torch.nmp.traces import APPS, Trace, make_trace  # noqa: F401
