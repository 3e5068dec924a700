"""The port's streaming layer on the CPU: batch bucketing against its
signature counter, the multi-stream driver, and a differential against
the JAX reference's driver.

Mirrors the non-NETDUEL parts of tests/test_streaming.py (the NETDUEL
engine and driver are held in tests/test_torch_duel_engine.py; every
port engine here has it off). The
reference counts *traces* of its jitted lookup; the port counts the
first call of ``fused_lookup`` with each new signature (shapes, dtypes,
static arguments), in ``repro_torch.tracecount``.

Tolerances: accounting inside the port is exact (bucketed ≡ unbucketed,
seeded reruns). Against the reference, discrete outputs (batch sizes,
object and ingress ids, hits, model calls) are exact and the total cost
agrees to 0.1 per hit plus 1e-5 relative, as in
tests/test_torch_engine.py (the matmul-form distance of a hit on a
stored object carries ~0.08 of f32 cancellation noise at this
catalog's radii, in either framework).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jget_smoke
from repro.core import catalog as jcatalog
from repro.core import demand as jdemand
from repro.models import model as jmodel
from repro.serve import EngineConfig as JConfig
from repro.serve import SimCacheEngine as JEngine
from repro.serve import StreamDriver as JDriver
from repro.serve import StreamSpec as JSpec
from repro_torch import tracecount
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.models import model as model_api
from repro_torch.serve import (EngineConfig, SimCacheEngine, StreamDriver,
                               StreamSpec, bucket_size)
from repro_torch.serve.engine import LATENCY_WINDOW, ServeStats
from repro_torch.serve.stream import DriverStats
from torch_threads import one_thread  # noqa: F401

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=256)
ECFG = dict(k_device=8, k_pod=12, k_global=16, h_ici=1.0, h_dcn=10.0,
            h_model=100.0, metric="l2", algo="greedy")


def make_engine(n_objects=300, bucket=True, **ecfg_kw):
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    params = model_api.init_params(cfg, 0, device="cpu")
    cat = catalog_api.embedding_catalog(n=n_objects, dim=16, seed=1)
    eng = SimCacheEngine(cfg, params,
                         EngineConfig(bucket=bucket, **ECFG, **ecfg_kw),
                         cat.coords, device="cpu")
    return eng, cfg, cat


def mixed_batches(cat, cfg, sizes, seed=0):
    """One fixed request trace with the given per-batch sizes."""
    rng = np.random.default_rng(seed)
    dem = demand_api.zipf(cat, alpha=1.1, seed=3)
    out = []
    for k in sizes:
        ids, _ = dem.sample(k, rng)
        out.append((ids, torch.as_tensor(
            rng.integers(0, cfg.vocab, (k, 8)).astype(np.int32))))
    return out


def accounting(eng):
    return {"n_hits": eng.stats.n_hits,
            "n_requests": eng.stats.n_requests,
            "model_calls": eng.stats.model_calls,
            "total_cost": eng.stats.total_cost,
            "total_approx_cost": eng.stats.total_approx_cost}


def _streams(cat, api=demand_api, spec=StreamSpec, n=3):
    rates = [5.0, 9.0, 2.0]
    return [spec(demand=api.zipf(cat, alpha=1.1, seed=s + 1),
                 rate=rates[s % len(rates)], seed=s + 1, name=f"user{s}")
            for s in range(n)]


# ===================================================================
# bucketing
# ===================================================================
def test_bucketed_matches_unbucketed_exactly():
    sizes = [1, 7, 16, 9, 33, 5, 16, 2, 31]
    accts = {}
    for bucket in (True, False):
        eng, cfg, cat = make_engine(bucket=bucket)
        batches = mixed_batches(cat, cfg, [16] * 4 + sizes)
        for ids, prompts in batches[:4]:          # cold
            eng.serve(ids, prompts)
        eng.refresh_placement()
        for ids, prompts in batches[4:]:
            eng.serve(ids, prompts)
        accts[bucket] = accounting(eng)
        accts[bucket]["counts"] = eng.counts.copy().tobytes()
    assert accts[True] == accts[False]


def test_retrace_regression_one_signature_per_bucket():
    """Batch sizes {1, 7, 64, 700} bucket to {8, 64, 1024}: the fused
    lookup sees at most one new signature per bucket (3), not one per
    batch size (4), and a second pass over the same sizes adds none."""
    eng, cfg, cat = make_engine()
    sizes = [1, 7, 64, 700]
    assert {bucket_size(s) for s in sizes} == {8, 64, 1024}
    for ids, prompts in mixed_batches(cat, cfg, [16] * 4, seed=9):
        eng.serve(ids, prompts)
    eng.refresh_placement()
    batches = mixed_batches(cat, cfg, sizes + sizes, seed=1)
    with tracecount.snapshot() as s:
        for ids, prompts in batches[:4]:
            eng.serve(ids, prompts)
        assert s.delta("fused_lookup") <= 3, \
            "fused lookup specialized beyond one signature per bucket"
        first = s.delta("fused_lookup")
        for ids, prompts in batches[4:]:
            eng.serve(ids, prompts)
        assert s.delta("fused_lookup") == first


def test_unbucketed_specializes_per_batch_size():
    """The inverse pin: without bucketing every distinct batch size is a
    new signature. The signature set is process-wide, like the
    reference's jit cache, so these sizes appear in no other test of
    this module."""
    eng, cfg, cat = make_engine(bucket=False)
    for ids, prompts in mixed_batches(cat, cfg, [16] * 2, seed=9):
        eng.serve(ids, prompts)
    eng.refresh_placement()
    sizes = [10, 11, 13, 14]
    with tracecount.snapshot() as s:
        for ids, prompts in mixed_batches(cat, cfg, sizes, seed=1):
            eng.serve(ids, prompts)
        assert s.delta("fused_lookup") == len(sizes)


def test_tracecount_api():
    tracecount.bump("probe")
    with tracecount.snapshot() as s:
        tracecount.bump("probe")
        tracecount.bump("probe")
        assert s.delta("probe") == 2 and s.delta("never") == 0
    assert tracecount.get("probe") >= 3
    sig = tracecount.Signatures("probe_sig")
    n0 = tracecount.get("probe_sig")
    for key in ("a", "b", "a", "b", "c"):
        sig.seen(key)
    assert tracecount.get("probe_sig") == n0 + 3


# ===================================================================
# multi-stream driver
# ===================================================================
def test_stream_driver_conserves_requests_and_versions():
    eng, cfg, cat = make_engine()
    drv = StreamDriver(eng, _streams(cat), max_batch=64, batch_window=3.0)
    st_cold = drv.run(100)
    assert st_cold.n_requests == 100
    eng.refresh_placement()
    st = drv.run(400)
    drv.drain_refresh()
    assert st.n_requests == 400
    assert sum(st.batch_sizes) == 400
    assert len(st.batch_latencies_ms) == st.n_batches
    assert st.distinct_batch_sizes > 1       # arrival-driven mixed sizes
    assert all(b >= a for a, b in zip(st.versions, st.versions[1:]))
    assert eng.stats.n_requests == 500


def test_stream_driver_is_deterministic_in_accounting():
    accts = []
    for _ in range(2):
        eng, cfg, cat = make_engine()
        drv = StreamDriver(eng, _streams(cat), max_batch=32,
                           batch_window=2.0)
        drv.run(80)
        eng.refresh_placement()
        st = drv.run(200)
        accts.append((accounting(eng), tuple(st.batch_sizes)))
    assert accts[0] == accts[1]


def test_stream_driver_refresh_cadence():
    eng, cfg, cat = make_engine()
    drv = StreamDriver(eng, _streams(cat), max_batch=32,
                       batch_window=2.0, refresh_every=4)
    drv.run(64)
    eng.refresh_placement()
    st = drv.run(256)
    drv.drain_refresh()
    assert st.refreshes_started > 0
    assert eng.swap_count > 0
    assert eng.refresh_count >= eng.swap_count
    assert not eng.refresh_in_flight
    assert st.requests_per_s > 0 and st.p99_ms >= st.p50_ms >= 0


def test_stream_driver_stall_window_is_per_run():
    """DriverStats.max_swap_stall_s is the max over the swaps of *that*
    run, not the engine's all-time max. Run 1 swaps in a background
    solve that finished before it began (its first poll installs it:
    deterministic, where a cadence-started solve may finish only at the
    drain on a fast engine); run 2 swaps nothing."""
    eng, cfg, cat = make_engine()
    drv = StreamDriver(eng, _streams(cat), max_batch=32, batch_window=2.0)
    drv.run(64)
    eng.refresh_placement()
    assert eng.request_refresh() and eng.wait_refresh(timeout=120)
    st1 = drv.run(128)
    assert st1.swaps == 1 and eng.swap_count == 1
    assert st1.max_swap_stall_s > 0.0        # this run did swap
    assert st1.max_swap_stall_s <= eng.max_swap_stall_s
    st2 = drv.run(64)
    assert st2.swaps == 0
    assert st2.max_swap_stall_s == 0.0, \
        "a swap-free run must not report the engine's all-time stall"
    assert eng.max_swap_stall_s > 0.0


class _Recorder:
    """A stand-in engine that records what the driver hands it, so that
    the driver's ingress ids are checked apart from any engine."""

    def __init__(self, vocab):
        self.cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                                       vocab=vocab)
        self.device = torch.device("cpu")
        self.stats = ServeStats()
        self.calls = []
        self.swap_count = 0
        self.swap_stall_s = self.last_swap_stall_s = 0.0
        self.placement_events = 0
        self.placement = type("P", (), {"version": 0})()

    def serve(self, ids, prompts, ingress_ids=None):
        self.calls.append((np.asarray(ids), prompts, ingress_ids))
        self.stats.batch_latencies_ms.append(0.0)

    def request_refresh(self):
        return False

    def poll_refresh(self):
        return False


def test_stream_driver_threads_ingress_ids():
    """Each request reaches the engine with the ingress it entered at,
    and the batches the port forms are the reference's, byte for byte:
    the same per-stream generators, the same virtual clock."""
    cat = catalog_api.embedding_catalog(n=200, dim=16, seed=1)
    jcat = jcatalog.embedding_catalog(n=200, dim=16, seed=1)

    def specs(api, spec):
        return [spec(demand=api.zipf(c, alpha=1.0, n_ingress=3, seed=s + 1),
                     rate=4.0, seed=s + 1) for s in range(2)
                for c in [cat if api is demand_api else jcat]]

    rec = _Recorder(vocab=256)
    drv = StreamDriver(rec, specs(demand_api, StreamSpec), max_batch=32,
                       batch_window=2.0, prompt_seed=5)
    st = drv.run(300)
    assert st.n_requests == 300
    ings = np.concatenate([c[2] for c in rec.calls])
    per_ingress = np.bincount(ings, minlength=3)
    assert per_ingress.sum() == 300 and np.count_nonzero(per_ingress) == 3
    # the reference's batch former on the same specs
    jdrv = JDriver(types.SimpleNamespace(cfg=rec.cfg), specs(jdemand, JSpec),
                   max_batch=32,
                   batch_window=2.0, prompt_seed=5)
    left = 300
    for ids, prompts, ing in rec.calls:
        jids, jings = jdrv._next_batch(left)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(ing, jings)
        assert prompts.dtype == torch.int32
        np.testing.assert_array_equal(prompts.numpy(),
                                      np.asarray(jdrv._prompts(len(ids))))
        left -= len(ids)
    assert left == 0


def test_stream_rate_validation():
    eng, cfg, cat = make_engine()
    with pytest.raises(ValueError):
        StreamDriver(eng, [StreamSpec(demand=demand_api.zipf(cat),
                                      rate=0.0)])
    with pytest.raises(ValueError):
        StreamDriver(eng, [])


def test_latency_ring_is_bounded_with_correct_percentiles():
    for stats in (ServeStats(), DriverStats()):
        ring = stats.batch_latencies_ms
        assert ring.maxlen == LATENCY_WINDOW
        n_extra = 5000
        for v in range(LATENCY_WINDOW + n_extra):
            ring.append(float(v))
        assert len(ring) == LATENCY_WINDOW
        assert stats.latency_percentile(0) == float(n_extra)
        assert stats.p50_ms == pytest.approx(
            n_extra + (LATENCY_WINDOW - 1) / 2.0)
        assert stats.p99_ms <= stats.latency_percentile(100)


# ===================================================================
# the differential against the reference's driver
# ===================================================================
def _record(eng, log):
    serve = eng.serve

    def wrapped(ids, prompts, ingress_ids=None):
        log.append((np.asarray(ids).copy(), np.asarray(ingress_ids).copy()))
        return serve(ids, prompts, ingress_ids=ingress_ids)
    eng.serve = wrapped


def test_stream_driver_matches_reference_driver():
    """The same streams through the port's and the reference's drivers,
    cadence off and one explicit ``refresh_placement()`` between a cold
    and a warm run: the same batch-size sequence, object and ingress ids,
    hits and model calls, and total cost within the f32 tolerance."""
    jcfg = dataclasses.replace(jget_smoke("granite-3-2b"), **SMALL)
    jcat = jcatalog.embedding_catalog(n=300, dim=16, seed=1)
    jeng = JEngine(jcfg, jmodel.init_params(jcfg, 0),
                   JConfig(**ECFG, netduel=False), jcat.coords)
    eng, cfg, cat = make_engine()
    np.testing.assert_array_equal(cat.coords, jcat.coords)
    runs = []
    for e, drv_cls, streams in (
            (jeng, JDriver, _streams(jcat, jdemand, JSpec)),
            (eng, StreamDriver, _streams(cat))):
        log = []
        _record(e, log)
        drv = drv_cls(e, streams, max_batch=32, batch_window=2.0,
                      refresh_every=0)
        cold = drv.run(80)
        e.refresh_placement()
        warm = drv.run(200)
        runs.append(dict(sizes=(cold.batch_sizes, warm.batch_sizes),
                         log=log, slots=np.asarray(e.placement.slots),
                         stats=e.stats))
    ref, got = runs
    assert got["sizes"] == ref["sizes"]
    assert len(got["log"]) == len(ref["log"])
    for (ids, ing), (jids, jing) in zip(got["log"], ref["log"]):
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(ing, jing)
    np.testing.assert_array_equal(got["slots"], ref["slots"])
    a, b = got["stats"], ref["stats"]
    assert (a.n_requests, a.n_hits, a.model_calls) == \
        (b.n_requests, b.n_hits, b.model_calls)
    assert a.n_hits > 0
    assert abs(a.total_cost - b.total_cost) <= \
        0.1 * a.n_hits + 1e-5 * b.total_cost


def test_driver_prompts_on_engine_device():
    eng, cfg, cat = make_engine()
    drv = StreamDriver(eng, _streams(cat), prompt_len=5)
    p = drv._prompts(3)
    assert p.shape == (3, 5) and p.dtype == torch.int32
    assert p.device == eng.device
    assert int(p.max()) < cfg.vocab
