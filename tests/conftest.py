"""Shared fixtures. NOTE: no XLA_FLAGS here — the default tier-1 pass
runs against the single real CPU device; only launch/dryrun.py forces
512 host devices (and does so before any jax import). scripts/ci.sh
adds a *second* pass that opts the whole suite into 8 forced host
devices (the in-process mesh tests in test_sharded_lookup.py are
skipif-gated on device_count ≥ 8 and only execute there); the suite is
green under both device counts.

Offline environments lack ``hypothesis``; rather than skipping the five
property-based modules wholesale, we install a minimal seeded-random
stand-in into sys.modules *before collection* (conftest imports first).
It covers exactly the API surface the suite uses — ``given`` with
keyword strategies, ``settings(max_examples=…, deadline=…)``,
``strategies.integers/sampled_from/booleans`` — drawing deterministic
examples from a per-test seeded RNG. Real hypothesis, when installed,
always wins.
"""
import functools
import inspect
import random
import sys
import types
import zlib

import numpy as np
import pytest


def _install_hypothesis_stub() -> None:
    try:
        import hypothesis  # noqa: F401  (real one available — use it)
        return
    except ImportError:
        pass

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def integers(min_value, max_value):
        return _Strategy(lambda r: r.randint(min_value, max_value))

    def sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda r: r.choice(elements))

    def booleans():
        return _Strategy(lambda r: bool(r.getrandbits(1)))

    def floats(min_value=0.0, max_value=1.0, **_kw):
        return _Strategy(lambda r: r.uniform(min_value, max_value))

    class settings:
        """Decorator recording max_examples on the wrapped test."""
        def __init__(self, max_examples=20, **_kw):
            self.max_examples = max_examples

        def __call__(self, fn):
            fn._stub_max_examples = self.max_examples
            return fn

    class _UnsatisfiedAssumption(Exception):
        pass

    def given(**strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_stub_max_examples", 20)
                rng = random.Random(zlib.crc32(fn.__qualname__.encode()))
                ran = 0
                for _ in range(n * 20):          # rejection budget
                    if ran == n:
                        break
                    drawn = {k: s.draw(rng) for k, s in strategies.items()}
                    try:
                        fn(*args, **kwargs, **drawn)
                    except _UnsatisfiedAssumption:
                        continue                 # reject example, redraw
                    except Exception as e:
                        # real hypothesis prints the falsifying example;
                        # surface the drawn kwargs the same way
                        e.args = (f"{e.args[0] if e.args else e!r}"
                                  f"\n[hypothesis-stub falsifying "
                                  f"example: {drawn}]",) + e.args[1:]
                        raise
                    ran += 1
                if ran == 0:
                    pytest.skip("stub: no example satisfied assume()")
            wrapper.hypothesis_stub = True
            # hide the drawn params from pytest's fixture resolution
            # (wraps copies __wrapped__, whose signature pytest follows)
            del wrapper.__wrapped__
            wrapper.__signature__ = inspect.Signature()
            return wrapper
        return deco

    def assume(condition):
        """Reject the current drawn example (redrawn by given's loop),
        mirroring real hypothesis rather than skipping the whole test."""
        if not condition:
            raise _UnsatisfiedAssumption()

    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    mod.assume = assume
    mod.HealthCheck = types.SimpleNamespace(too_slow=None,
                                            filter_too_much=None,
                                            data_too_large=None)
    st = types.ModuleType("hypothesis.strategies")
    st.integers = integers
    st.sampled_from = sampled_from
    st.booleans = booleans
    st.floats = floats
    mod.strategies = st
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st


_install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: nightly/full-pass only (scripts/ci.sh deselects with "
        '-m "not slow"; CI_FULL=1 runs them)')
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the repro_torch kernels); skips without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# --------------------------------------------------------------------------
# Shared helpers of the lookup differential suites (test_fused_lookup,
# test_sharded_lookup, test_lsh_pruning): one definition of "a random
# multi-level network" and of "two LookupResults agree".
def make_net(seed, sizes, hs, h_repo, metric="l2", gamma=1.0, d=6,
             empty=(), **kw):
    """Random multi-level SimCacheNetwork (levels in ``empty`` get the
    sentinel key of an empty level) plus the rng for query draws."""
    import jax.numpy as jnp

    from repro.core.simcache import (SENTINEL_COORD, CacheLevel,
                                     SimCacheNetwork)
    rng_ = np.random.default_rng(seed)
    levels = []
    for j, (k, h) in enumerate(zip(sizes, hs)):
        if j in empty:
            keys = np.full((1, d), SENTINEL_COORD, np.float32)
            vals = np.full((1,), -1, np.int32)
        else:
            keys = (rng_.standard_normal((k, d)) * 2).astype(np.float32)
            vals = rng_.integers(0, 10_000, k).astype(np.int32)
        levels.append(CacheLevel(keys=jnp.asarray(keys),
                                 values=jnp.asarray(vals), h=float(h)))
    return SimCacheNetwork(levels=levels, h_repo=float(h_repo),
                           metric=metric, gamma=gamma, **kw), rng_


def assert_results_equal(a, b, exact_cost=True):
    """Two LookupResults serve identical traffic: equal winners always,
    costs bitwise for γ = 1 (``exact_cost``) else to 1e-6 (FMA
    contraction may differ across kernels)."""
    for name in ("level", "slot", "payload", "hit"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
            err_msg=name)
    for name in ("cost", "approx_cost"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        if exact_cost:
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
