import functools
import inspect
import os
import random
import sys
import types

import pytest

# Tests run on the single real CPU device; the 512-device override is ONLY for
# the dry-run (repro.launch.dryrun sets it before importing jax).
os.environ.setdefault("JAX_PLATFORMS", "cpu")


# ---------------------------------------------------------------------------
# Optional-hypothesis shim
# ---------------------------------------------------------------------------
# The property tests use a small hypothesis subset (given / settings /
# strategies.{integers,sampled_from,lists,tuples}). When the real package is
# available (requirements-dev.txt) it is used unchanged; otherwise a minimal
# deterministic fallback is installed so the tier-1 suite still collects and
# exercises every property test on a fixed sample of draws.

_FALLBACK_EXAMPLES = int(os.environ.get("HYP_FALLBACK_EXAMPLES", "4"))


def _install_hypothesis_fallback():
    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def integers(min_value, max_value):
        return _Strategy(lambda r: r.randint(min_value, max_value))

    def sampled_from(elements):
        seq = list(elements)
        return _Strategy(lambda r: seq[r.randrange(len(seq))])

    def lists(elements, min_size=0, max_size=10):
        return _Strategy(lambda r: [elements.draw(r) for _ in
                                    range(r.randint(min_size, max_size))])

    def tuples(*elements):
        return _Strategy(lambda r: tuple(e.draw(r) for e in elements))

    def settings(**kw):
        def deco(fn):
            fn._hyp_settings = dict(kw)
            return fn
        return deco

    def given(*strats):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_hyp_settings", {}).get(
                    "max_examples", _FALLBACK_EXAMPLES)
                n = max(1, min(n, _FALLBACK_EXAMPLES))
                rng = random.Random(0)
                seen = set()
                for _ in range(n):
                    drawn = tuple(s.draw(rng) for s in strats)
                    key = repr(drawn)
                    if key in seen:        # dedupe repeated draws
                        continue
                    seen.add(key)
                    fn(*args, *drawn, **kwargs)
            # pytest must not treat the generated arguments as fixtures
            del wrapper.__wrapped__
            wrapper.__signature__ = inspect.Signature()
            return wrapper
        return deco

    mod = types.ModuleType("hypothesis")
    st = types.ModuleType("hypothesis.strategies")
    st.integers, st.sampled_from = integers, sampled_from
    st.lists, st.tuples = lists, tuples
    mod.given, mod.settings, mod.strategies = given, settings, st
    mod.__is_fallback__ = True
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st


try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    _install_hypothesis_fallback()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-episode AIMM / large-trace tests (deselect with "
        "-m 'not slow')")
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skipped with a reason where there is none)")


# ---------------------------------------------------------------------------
# Shared fixtures: small traces, built once per session
# ---------------------------------------------------------------------------

@pytest.fixture(scope="session")
def nmp_cfg():
    from repro.nmp import NMPConfig
    return NMPConfig()


@pytest.fixture(scope="session")
def spmv_trace():
    """Default small trace for engine tests (shared so jit caches are reused)."""
    from repro.nmp.traces import make_trace
    return make_trace("SPMV", n_ops=1024)


@pytest.fixture(scope="session")
def km_trace():
    from repro.nmp.traces import make_trace
    return make_trace("KM", n_ops=512)
