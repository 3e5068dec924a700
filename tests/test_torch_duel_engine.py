"""The online plane inside the port's serving engine, driver and launcher,
against a live JAX replay, on the CPU; and kernels C and D past 8 caches.

The engine is the one of tests/test_trace_replay.py (``_build_engine``:
granite's smoke config at 2 layers, a 300-object catalog, 8/12/16 slots,
h = 0 / 1 / 10, h_model 100, GREEDY, NETDUEL with window 64, arming
probability 0.5, seed 0), built in both packages, and both of its
replays run on each: the 24-batch NETDUEL replay and the streaming
replay (three Poisson streams, a mid-stream background refresh swapped
in at a fixed batch boundary). They are compared with each other, never
with tests/golden/*.json, which no longer replay (ROADMAP queue 3, F4).

What must match: the hits of every batch, the promotion trajectory, the
churn batches, ``placement_events``, the placement version and the final
duel slots exactly, except where a duel decision is an f32 near-tie;
the costs to 0.1 per hit plus 1e-5 relative. A hit's lookup cost
differs between the packages by the matmul-form l2's cancellation noise
(up to ~0.08 at this catalog's radii, tests/test_torch_engine.py), and
the duel prices each request with that cost (``b1_ext``), so a duel
whose saving is that noise is a near-tie: a virtual object already
stored at the same level saves only the noise of its own hit. The
streaming replay has one such duel. Its decision is shown: the event
on the side that promoted won by less than the noise a duel window can
sum (0.1 per request of the window), and the trajectories differ by
exactly that promotion.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import test_trace_replay as reference
from repro.kernels.knn import placement_gains as jgains
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.kernels.gain.gain import gain_cuda
from repro_torch.kernels.knn import placement_gains
from repro_torch.kernels.knn.gains import (J_GROUP, _gain_plan, _j_groups,
                                           gains_cuda)
from repro_torch.launch import serve as launch
from repro_torch.models import model as model_api
from repro_torch.serve import (EngineConfig, SimCacheEngine, StreamDriver,
                               StreamSpec)
from torch_threads import one_thread  # noqa: F401

nd = importlib.import_module("repro_torch.core.placement.netduel")

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=256)


def _build_engine():
    """The reference suite's NETDUEL engine, in the port, on the CPU."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    params = model_api.init_params(cfg, 0, device="cpu")
    cat = catalog_api.embedding_catalog(n=300, dim=16, seed=1)
    ecfg = EngineConfig(k_device=8, k_pod=12, k_global=16,
                        h_ici=1.0, h_dcn=10.0, h_model=100.0,
                        metric="l2", algo="greedy", netduel=True,
                        duel_window=64, duel_arm_prob=0.5, duel_seed=0)
    return SimCacheEngine(cfg, params, ecfg, cat.coords, device="cpu"), \
        cfg, cat


def _replay():
    """The reference's ``_replay``: 4 cold batches, one offline refresh
    (arming the duel plane), 24 warm batches observed by the duel."""
    eng, cfg, cat = _build_engine()
    rng = np.random.default_rng(0)
    dem = demand_api.zipf(cat, alpha=1.1, seed=3)

    def batch():
        ids, _ = dem.sample(16, rng)
        return ids, rng.integers(0, cfg.vocab, (16, 8)).astype(np.int32)

    for _ in range(4):
        eng.serve(*batch())
    eng.refresh_placement()
    assert eng.duel is not None
    cost_traj, hits_traj, churn_batches, promo_traj = [], [], [], []
    for b in range(24):
        before = eng.placement_events
        _, stats = eng.serve(*batch())
        cost_traj.append(stats.total_cost)
        hits_traj.append(stats.n_hits)
        promo_traj.append(eng.duel.n_promotions)
        if eng.placement_events > before:
            churn_batches.append(b)
    return {
        "cost_trajectory": cost_traj,
        "hits_trajectory": hits_traj,
        "promotions_trajectory": promo_traj,
        "churn_batches": churn_batches,
        "placement_events": eng.placement_events,
        "final_duel_slots": [int(s) for s in eng.duel.slots_np],
        "duel_served_cost": eng.duel.served_cost,
    }


def _replay_streaming():
    """The reference's ``_replay_streaming`` through the port's driver."""
    eng, cfg, cat = _build_engine()
    streams = [
        StreamSpec(demand=demand_api.zipf(cat, alpha=1.1, seed=s + 1),
                   rate=[5.0, 9.0, 2.0][s], seed=s + 1, name=f"user{s}")
        for s in range(3)]
    drv = StreamDriver(eng, streams, max_batch=48, batch_window=2.0)
    st_cold = drv.run(64)
    eng.refresh_placement()                    # arms the duel plane
    st1 = drv.run(160)
    assert eng.request_refresh()
    assert eng.wait_refresh(timeout=300)
    assert eng.poll_refresh()
    st2 = drv.run(160)
    return {
        "batch_sizes": st_cold.batch_sizes + st1.batch_sizes
        + st2.batch_sizes,
        "n_hits": eng.stats.n_hits,
        "model_calls": eng.stats.model_calls,
        "total_cost": eng.stats.total_cost,
        "placement_events": eng.placement_events,
        "placement_version": eng.placement.version,
        "n_promotions": eng.duel.n_promotions,
        "final_duel_slots": [int(s) for s in eng.duel.slots_np],
        "duel_served_cost": eng.duel.served_cost,
        "driver_events": [st_cold.placement_events, st1.placement_events,
                          st2.placement_events],
    }


NOISE = 0.1                 # a hit's lookup cost, port against JAX


class _Events:
    """The promotion events (t, slot, object, real_sav, virt_sav) of
    every scan the engines' duel planes run, in both packages: the port's
    scan and the reference's, each made to record its settles."""

    def __init__(self):
        self.port, self.ref = [], []

    def __enter__(self):
        self.jnd = importlib.import_module("repro.core.placement.netduel")
        self.orig, self.jorig = nd._duel_scan, self.jnd._duel_scan
        owner = self

        def scan(dinst, h_slots, on_path, carry, xs, *a, **k):
            a = list(a)
            a[2] = True                              # record_events
            carry2, out = owner.orig(dinst, h_slots, on_path, carry, xs,
                                     *a, **k)
            owner.port += nd._events_from_trace(
                [(int(xs.ts[e[0]]), *e[1:]) for e in out.events])
            return carry2, out

        def jscan(*a, **k):
            a = list(a)
            a[15] = True                             # record_events
            carry2, out = owner.jorig(*a, **k)
            ts = np.asarray(a[9][2])
            promote, virt, rs, vs = (np.asarray(o) for o in out[-4:])
            for s in np.nonzero(promote.any(axis=1))[0]:
                for y in np.nonzero(promote[s])[0]:
                    owner.ref.append((int(ts[s]), int(y), int(virt[s, y]),
                                      float(rs[s, y]), float(vs[s, y])))
            return carry2, out
        nd._duel_scan, self.jnd._duel_scan = scan, jscan
        return self

    def __exit__(self, *exc):
        nd._duel_scan, self.jnd._duel_scan = self.orig, self.jorig


def _cost_close(got, ref, hits):
    """|got − ref| ≤ 0.1 per hit + 1e-5·|ref|, elementwise."""
    got, ref, hits = (np.asarray(v, np.float64) for v in (got, ref, hits))
    assert np.all(np.abs(got - ref) <= NOISE * hits + 1e-5 * np.abs(ref)), \
        (got, ref)


def test_netduel_replay_matches_reference():
    """The reference's NETDUEL trace replay, port against JAX, live:
    every decision agrees."""
    with _Events() as ev:
        ref = reference._replay()
        got = _replay()
    assert got["placement_events"] > 0                # a non-trivial replay
    for key in ("hits_trajectory", "promotions_trajectory",
                "churn_batches", "placement_events", "final_duel_slots"):
        assert got[key] == ref[key], key
    assert [e[:3] for e in ev.port] == [e[:3] for e in ev.ref]
    _cost_close(got["cost_trajectory"], ref["cost_trajectory"],
                got["hits_trajectory"])
    _cost_close(got["duel_served_cost"], ref["duel_served_cost"],
                got["hits_trajectory"][-1])


def test_streaming_replay_matches_reference():
    """The reference's streaming replay (bucketed batches, the duel
    observing each at its bucket shape, a mid-stream swap re-arming the
    duel plane), port against JAX, live. One duel of the final plane is a
    near-tie: the reference promotes virtual 135 into slot 9 at duel time
    155 with virt_sav 0.25 against real_sav 0 — the noise of the lookup's
    cost on hits of object 135, which the level holds — and the port,
    whose noise there is 0, does not. The test shows that and holds
    everything else."""
    with _Events() as ev:
        ref = reference._replay_streaming()
        got = _replay_streaming()
    window = 64
    only_ref = [e for e in ev.ref if e[:3] not in {p[:3] for p in ev.port}]
    only_port = [e for e in ev.port if e[:3] not in {r[:3] for r in ev.ref}]
    # every decision the two sides take differently is a near-tie: the
    # winner's virt_sav beat its threshold by less than a window's noise
    for t, y, obj, rs, vs in only_ref + only_port:
        assert vs - max(np.float32(1.05) * np.float32(rs), 0.0) <= \
            NOISE * (window + 1), (t, y, obj, rs, vs)
    assert [e[:3] for e in only_ref] == [(155, 9, 135)] and not only_port
    assert got["n_promotions"] == ref["n_promotions"] - 1
    diff = [k for k, (a, b) in enumerate(zip(got["final_duel_slots"],
                                             ref["final_duel_slots"]))
            if a != b]
    assert diff == [9] and ref["final_duel_slots"][9] == 135
    for key in ("batch_sizes", "n_hits", "model_calls", "placement_events",
                "placement_version"):
        assert got[key] == ref[key], key
    _cost_close(got["total_cost"], ref["total_cost"], got["n_hits"])
    _cost_close(got["duel_served_cost"], ref["duel_served_cost"],
                got["n_hits"])
    assert sum(got["driver_events"]) == got["placement_events"]


def test_engine_promotion_rebuilds_and_refreshes():
    """With ``refresh_on_promotion`` a promoting batch rebuilds the
    runtime network from the duel's slots and starts the background
    re-solve, whose install re-arms a fresh duel plane."""
    eng, cfg, cat = _build_engine()
    eng.ecfg.refresh_on_promotion = True
    rng = np.random.default_rng(0)
    dem = demand_api.zipf(cat, alpha=1.1, seed=3)
    for _ in range(4):
        ids, _ = dem.sample(16, rng)
        eng.serve(ids, rng.integers(0, 256, (16, 8)).astype(np.int32))
    eng.refresh_placement()
    for _ in range(30):
        ids, _ = dem.sample(16, rng)
        v0, plane = eng.placement.version, eng.duel
        eng.serve(ids, rng.integers(0, 256, (16, 8)).astype(np.int32))
        if eng.placement_events:
            break
    assert eng.placement_events == 1
    assert eng.placement.version == v0 + 1
    np.testing.assert_array_equal(eng.placement.slots, plane.slots_np)
    assert eng.refresh_in_flight
    assert eng.wait_refresh(timeout=300) and eng.poll_refresh()
    assert eng.duel is not plane and eng.duel.n_promotions == 0


def test_calibrate_rearms_the_duel_plane():
    eng, cfg, cat = _build_engine()
    ids = np.arange(32)
    eng.serve(ids, np.zeros((32, 8), np.int32))
    eng.refresh_placement()
    plane = eng.duel
    eng.calibrate(torch.zeros((4, 8), dtype=torch.int32))
    assert eng.duel is not plane
    h_slots, _ = eng.duel._args
    assert float(h_slots.max()) == pytest.approx(eng.ecfg.h_dcn, rel=1e-6)


# ------------------------------------------------------------ launcher
def test_launcher_netduel_streaming(capsys):
    """``--streaming --netduel`` on a CPU engine at the launcher's demo
    sizes: the flags set both engine switches, and the printout carries
    the duel churn."""
    args = launch.parser().parse_args(["--arch", "granite-3-2b",
                                       "--streaming", "--netduel",
                                       "--requests", "256"])
    cfg = get_smoke_config(args.arch)
    cat = catalog_api.embedding_catalog(n=1000, dim=32, seed=0)
    ecfg = EngineConfig(algo=args.algo, netduel=args.netduel,
                        refresh_on_promotion=args.netduel)
    eng = SimCacheEngine(cfg, model_api.init_params(cfg, 0, device="cpu"),
                         ecfg, cat.coords, device="cpu")
    eng.calibrate(torch.zeros((args.batch, 16), dtype=torch.int32))
    launch.run_streaming(eng, cat, args)
    out = capsys.readouterr().out
    assert "duel churn " in out
    line = next(ln for ln in out.splitlines() if "duel churn" in ln)
    assert int(line.split("duel churn ")[1].split(";")[0]) == \
        eng.placement_events
    assert eng.duel is not None and eng.duel.t > 0
    assert not eng.refresh_in_flight


def test_launcher_netduel_is_ported():
    """``--netduel`` is refused by no check of unported flags (the
    launcher has none left) and reaches the device resolution (which
    needs a card here)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would run")
    with pytest.raises(SystemExit, match="no CUDA device"):
        launch.main(["--arch", "granite-3-2b", "--netduel"])


# ------------------------------------------------------ kernels C, D past 8
@pytest.mark.parametrize("J,groups", [
    (1, [(0, 1)]), (8, [(0, 8)]), (9, [(0, 8), (8, 9)]),
    (17, [(0, 8), (8, 16), (16, 17)]),
    (32, [(0, 8), (8, 16), (16, 24), (24, 32)])])
def test_gain_groups_cover_the_caches(J, groups):
    """J caches run in groups of 8 columns, one launch each; every group
    has a plan of its own width (J ≤ 8 is one launch, as before)."""
    assert _j_groups(J) == groups
    assert all(b - a <= J_GROUP for a, b in groups)
    for per_request_h in (False, True):
        for a, b in groups:
            plan = _gain_plan(20_000, 100, 4, b - a, per_request_h)
            assert plan.j_width >= b - a


def test_gain_groups_refuse_no_caches():
    with pytest.raises(ValueError, match="at least one cache"):
        _j_groups(0)


@pytest.mark.parametrize("J", [9, 17])
def test_placement_gains_past_eight_caches_match_reference(J):
    """Kernel C's entry at J > 8 on CPU tensors (its plain version)
    against the reference's Pallas kernel in interpret mode, which
    unrolls any J: 5e-5 relative and absolute, the kernel-level
    tolerance of tests/test_torch_gains.py; and each J ≤ 8 slice of H
    gives the same columns, bitwise."""
    rng = np.random.default_rng(J)
    R, O, D, I = 117, 83, 5, 3
    x = rng.standard_normal((R, D)).astype(np.float32)
    y = rng.standard_normal((O, D)).astype(np.float32)
    lam = rng.random((I, R)).astype(np.float32)
    cur = (rng.random((I, R)) * 4).astype(np.float32)
    h = rng.random((I, J)).astype(np.float32)
    h[1, ::5] = np.inf
    t = torch.as_tensor
    got = placement_gains(t(x), t(y), t(lam), t(cur), t(h)).numpy()
    ref = np.asarray(jgains(x, y, lam, cur, h, use_pallas=True,
                            interpret=True))
    assert got.shape == (O, J)
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=5e-5)
    for a, b in _j_groups(J):
        part = placement_gains(t(x), t(y), t(lam), t(cur),
                               t(h[:, a:b])).numpy()
        np.testing.assert_array_equal(part, got[:, a:b])


def test_gain_kernels_past_eight_caches_on_cpu_tensors():
    """The wrappers of C and D take J > 8 (their plain versions on CPU
    tensors) and count no launch."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((40, 6)).astype(np.float32))
    lam = torch.rand(2, 40)
    c0, d0 = gains_cuda.launches, gain_cuda.launches
    out = gains_cuda(x, x, lam, torch.full((2, 40), 5.0), torch.rand(2, 17))
    assert out.shape == (17, 40)
    out = gain_cuda(x, x, lam[0], torch.full((40,), 5.0), torch.rand(40, 9))
    assert out.shape == (9, 40)
    assert (gains_cuda.launches, gain_cuda.launches) == (c0, d0)
