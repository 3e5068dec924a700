"""The examples' twins (``examples/*_torch.py``) against the reference's
examples, on the CPU.

Each reference example's own ``main()`` runs from its file, with its
``repro`` entry points wrapped to record what they return (the
allocations, states, engines and drivers its printed lines come from);
each twin's ``run(device="cpu")`` returns the same quantities.
Tolerances:

* quickstart and netduel_online (10,000 requests a phase on both sides,
  40,000 in the example): counts (swaps, promotions) exact; host
  costs to 1e-5 relative, as tests/test_torch_placement.py holds them.
  The offline yardstick of netduel_online is GREEDY on a grid whose
  mirror-image objects tie exactly: each package's device GREEDY breaks
  those ties by f32 rounding, and the two part after phase 2's first
  tie (C 0.71848 against 0.71823). There the port's picks are held to
  be best ones (each within 1e-6 of its step's best exact gain, in f64)
  and its cost to 1e-3 relative of the reference's.
* serve_simcache, with ``calibrate()``'s clock pinned to 30 ms for its
  three prefills on both sides (h_model 10 ms): hits and model calls
  exact, total cost within 0.1 per hit plus 1e-5 relative, and the
  predicted C(A) to 1e-4 relative, as tests/test_torch_engine.py holds
  the engines.
* streaming_serve: requests, batches and distinct sizes of both phases
  exact (virtual-time arrivals); the first predicted C(A), which a second
  reference cold start reproduces exactly, to 1e-4 relative. The
  background swaps follow the solves' wall time, so each run is held to
  invariants: at least one swap, no refresh in flight at the end, hits
  after the drift.
* train_lm at a narrow width: the crash and resume give the losses and
  parameters of an uninterrupted run bitwise.
* amazon_trace at 600 items (k 20, 2,000 LOCALSWAP iterations, d* 250,
  450, 800), against the reference's experiment composed from its own
  calls: catalog, λ, shell density, checks and every LOCALSWAP
  allocation exact; the host costs to ``TRACE_REL`` (each package
  prices with its own f32 C_a); the port's fused, looped and sharded
  (one shard, the CPU's one device) lookups bitwise equal, the pruned
  recall and the device GREEDY equal to the reference's; the host
  GREEDY's one difference is shown to be an f32 near-tie.

Every twin refuses to run without a card unless asked for the CPU.
"""
import copy
import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.objective import DeviceInstance as TDeviceInstance
from repro_torch.train import train
from torch_threads import one_thread  # noqa: F401

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "examples")
TWINS = ["quickstart", "netduel_online", "serve_simcache",
         "streaming_serve", "train_lm", "amazon_trace"]
HOST_REL = 1e-5          # host costs (tests/test_torch_placement.py)
PRED_REL = 1e-4          # predicted C(A) (tests/test_torch_engine.py)
N_REQUESTS = 10000       # netduel_online's requests a phase (40,000 in it)
# amazon_trace's host costs: each package builds C_a by the matmul form
# |x|² + |y|² − 2x·y in f32, at |x|² ~ 1e6, and the two round differently
# (by up to 0.61 near the diagonal, where the sqrt amplifies the
# cancellation). Equal allocations are priced 6.6e-5 apart at the test's
# size and 1.4e-5 at the example's.
TRACE_REL = 1e-4
TRACE_SIZES = dict(n_items=600, k=20, h=150.0, ls_iters=2000,
                   dstars=(250.0, 450.0, 800.0))


def load(name: str):
    """An example module loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorder(monkeypatch, owner, name: str, log: list):
    """Wrap ``owner.name`` so that each call's result is appended to
    ``log``."""
    fn = getattr(owner, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        log.append(out)
        return out
    monkeypatch.setattr(owner, name, wrapped)


def close(a: float, b: float, rel: float) -> bool:
    return abs(a - b) <= rel * abs(b)


# -------------------------------------------------------------- quickstart
def test_quickstart_matches_the_reference(monkeypatch):
    from repro.core.placement import continuous as jcontinuous
    ref = load("quickstart")
    got = {k: [] for k in ("inst", "greedy", "ls", "casc", "nd", "cont")}
    for name, key in (("Instance", "inst"), ("greedy", "greedy"),
                      ("localswap", "ls"), ("greedy_then_localswap", "casc"),
                      ("netduel", "nd")):
        recorder(monkeypatch, ref, name, got[key])
    recorder(monkeypatch, jcontinuous, "solve_chain_thresholds",
             got["cont"])
    ref.main()
    inst = got["inst"][0]
    want = {"empty": inst.empty_cost(),
            "greedy": inst.total_cost(got["greedy"][0]),
            "localswap": got["ls"][0].cost(inst),
            "cascade": got["casc"][0].cost(inst),
            "netduel": got["nd"][0].sw.cost(inst),
            "continuous": got["cont"][0][1]}
    out = load("quickstart_torch").run(device="cpu")
    assert out["n_swaps"] == got["ls"][0].n_swaps
    assert out["n_promotions"] == got["nd"][0].n_promotions
    for key, value in want.items():
        assert close(out[key], float(value), HOST_REL), (key, out[key],
                                                          value)


# ---------------------------------------------------------- netduel_online
def greedy_shortfall(inst, picks) -> float:
    """The largest shortfall of a pick's exact (f64, host) marginal gain
    below the best one at its step, relative to that best gain."""
    cur = np.repeat(inst.net.h_repo[:, None].astype(np.float64),
                    inst.cat.n, axis=1)
    free = np.bincount(inst.slot_cache, minlength=inst.net.n_caches)
    worst = 0.0
    for o, j in picks:
        g = inst.add_gain_all(cur)
        g[:, free == 0] = -np.inf
        worst = max(worst, (g.max() - g[o, j]) / g.max())
        free[j] -= 1
        cur = inst.updated_costs(cur, o, j)
    return worst


def test_netduel_online_matches_the_reference(monkeypatch):
    """At 10,000 requests a phase on both sides (the reference example's
    ``Demand.sample`` calls pinned to that count)."""
    from repro.core.demand import Demand
    sample = Demand.sample
    monkeypatch.setattr(Demand, "sample",
                        lambda self, n, rng: sample(self, N_REQUESTS, rng))
    ref = load("netduel_online")
    insts, states, refs = [], [], []
    recorder(monkeypatch, ref, "Instance", insts)
    recorder(monkeypatch, ref, "device_netduel", states)
    recorder(monkeypatch, ref, "offline_reference", refs)
    ref.main()
    (inst1, inst2), (st1, st2) = insts, states
    want = {"c1": inst1.total_cost(st1.slots),
            "c_old": inst2.total_cost(st1.slots),
            "c2": inst2.total_cost(st2.slots)}

    twin = load("netduel_online_torch")
    tinsts, picks, active = [], [], []
    recorder(monkeypatch, twin, "Instance", tinsts)
    greedy = twin.device_greedy

    def device_greedy(dinst):
        picks.append([])
        active.append(True)
        try:
            return greedy(dinst)
        finally:
            active.pop()
    monkeypatch.setattr(twin, "device_greedy", device_greedy)
    apply_pick = TDeviceInstance.apply_pick

    def recording_pick(self, cur, obj, cache):
        if active:
            picks[-1].append((int(obj), int(cache)))
        return apply_pick(self, cur, obj, cache)
    monkeypatch.setattr(TDeviceInstance, "apply_pick", recording_pick)
    out = twin.run(N_REQUESTS, device="cpu")

    assert out["n_promotions1"] == st1.n_promotions
    assert out["n_promotions2"] == st2.n_promotions
    for key, value in want.items():
        assert close(out[key], float(value), HOST_REL), (key, out[key],
                                                          value)
    for inst, ks, key, value in zip(tinsts, picks, ("ref1", "ref2"), refs):
        assert len(ks) == int(inst.net.total_slots)
        assert greedy_shortfall(inst, ks) <= 1e-6
        assert close(out[key], float(value), 1e-3), (key, out[key], value)
    assert close(out["ref1"], float(refs[0]), HOST_REL)


# ---------------------------------------------------------- serve_simcache
def pin_calibration(monkeypatch, engine_module):
    """``calibrate()`` reads its clock twice: 0 s, then 30 ms after its
    three prefills — h_model 10 ms whatever the machine."""
    calibrate = engine_module.SimCacheEngine.calibrate
    clock = engine_module.time

    class Pinned:
        def __init__(self):
            self.ticks = iter([0.0, 0.030])

        def perf_counter(self):
            return next(self.ticks)

    def pinned(self, *args, **kwargs):
        engine_module.time = Pinned()
        try:
            return calibrate(self, *args, **kwargs)
        finally:
            engine_module.time = clock
    monkeypatch.setattr(engine_module.SimCacheEngine, "calibrate", pinned)


def recording_engine(cls, made: list):
    """``cls`` that records its instances, the stats each held when its
    first placement was solved, and each predicted C(A)."""
    class Recording(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.preds, self.stats_at_solve = [], []
            made.append(self)

        def refresh_placement(self, *args, **kwargs):
            self.stats_at_solve.append(copy.deepcopy(self.stats))
            self.preds.append(super().refresh_placement(*args, **kwargs))
            return self.preds[-1]
    return Recording


def same_serving(a, b):
    """Port stats ``a`` against reference stats ``b``."""
    assert (a.n_requests, a.n_hits, a.model_calls) == \
        (b.n_requests, b.n_hits, b.model_calls)
    assert abs(a.total_cost - b.total_cost) <= \
        0.1 * a.n_hits + 1e-5 * b.total_cost


def test_serve_simcache_matches_the_reference(monkeypatch):
    import repro.serve.engine as jengine

    import repro_torch.serve.engine as tengine
    pin_calibration(monkeypatch, jengine)
    pin_calibration(monkeypatch, tengine)
    ref = load("serve_simcache")
    made = []
    monkeypatch.setattr(ref, "SimCacheEngine",
                        recording_engine(ref.SimCacheEngine, made))
    ref.main()
    (jeng,) = made
    out = load("serve_simcache_torch").run(device="cpu")
    assert out["h_model"] == jeng.ecfg.h_model == pytest.approx(10.0)
    same_serving(out["cold"], jeng.stats_at_solve[0])
    same_serving(out["warm"], jeng.stats)
    assert out["predicted"] == pytest.approx(jeng.preds[0], rel=PRED_REL)
    assert out["warm"].n_hits > 0
    assert out["warm"].mean_cost < out["h_model"]


# --------------------------------------------------------- streaming_serve
def reference_cold_start(ref) -> float:
    """The reference example's cold start, rebuilt from its API: the
    predicted C(A) of its first placement."""
    cfg = dataclasses.replace(ref.get_smoke_config("granite-3-2b"),
                              n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=2, head_dim=16, d_ff=128,
                              vocab=256)
    cat = ref.catalog_api.embedding_catalog(n=400, dim=16, seed=1)
    ecfg = ref.EngineConfig(k_device=16, k_pod=24, k_global=32,
                            h_ici=1.0, h_dcn=10.0, h_model=100.0,
                            metric="l2", algo="greedy", netduel=True,
                            duel_window=128, duel_arm_prob=0.5,
                            refresh_on_promotion=True)
    eng = ref.SimCacheEngine(cfg, ref.model_api.init_params(cfg, 0), ecfg,
                             cat.coords)
    rates = [5.0, 9.0, 2.0, 4.0]
    streams = [ref.StreamSpec(
        demand=ref.demand_api.zipf(cat, alpha=1.1, seed=100 + s),
        rate=rates[s], seed=s + 1, name=f"user{s}") for s in range(4)]
    ref.StreamDriver(eng, streams, max_batch=64, batch_window=2.0).run(128)
    return eng.refresh_placement()


def test_streaming_serve_matches_the_reference(monkeypatch):
    ref = load("streaming_serve")
    made, runs = [], []
    monkeypatch.setattr(ref, "SimCacheEngine",
                        recording_engine(ref.SimCacheEngine, made))
    recorder(monkeypatch, ref.StreamDriver, "run", runs)
    ref.main()
    (jeng,) = made
    _, jst1, jst2 = runs                      # cold start, phase 1, phase 2
    monkeypatch.undo()
    assert reference_cold_start(ref) == jeng.preds[0]

    out = load("streaming_serve_torch").run(device="cpu")
    assert out["predicted"] == pytest.approx(jeng.preds[0], rel=PRED_REL)
    for st, jst in ((out["phase1"], jst1), (out["phase2"], jst2)):
        assert (st.n_requests, st.n_batches, st.distinct_batch_sizes) == \
            (jst.n_requests, jst.n_batches, jst.distinct_batch_sizes)
    for eng in (out["engine"], jeng):
        assert eng.swap_count >= 1
        assert not eng.refresh_in_flight
        assert eng.stats.n_hits > 0


# ----------------------------------------------------------------- train_lm
def test_train_lm_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch,
                                                     capsys):
    twin = load("train_lm_torch")
    calls = []

    def recording_train(cfg, tcfg, data, **kwargs):
        calls.append((cfg, tcfg, data))
        return train(cfg, tcfg, data, **kwargs)
    monkeypatch.setattr(twin, "train", recording_train)
    cfg = dataclasses.replace(
        get_smoke_config("granite-3-2b"), n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        tie_embeddings=False)
    out = twin.run(steps=9, ckpt=str(tmp_path / "crash"), device="cpu",
                   cfg=cfg, batch=2, seq=16)
    assert "resumed from step 6" in capsys.readouterr().out
    assert out["crash_at"] == 6 and out["resumed"]["step"] == 9
    assert len(out["first"]["losses"]) == 6

    _, tcfg, data = calls[0]
    whole = train(cfg, dataclasses.replace(
        tcfg, ckpt_dir=str(tmp_path / "whole")), data, device="cpu",
        log=lambda *a: None)
    assert out["losses"] == whole["losses"]
    assert np.isfinite(out["losses"]).all()
    resumed = dict(out["resumed"]["params"].named_parameters())
    for name, p in whole["params"].named_parameters():
        assert torch.equal(resumed[name], p), name


# ------------------------------------------------------------ amazon_trace
def shell_density(cat, dem, n_shells: int = 20):
    """Fig. 8's shell density as the reference experiment computes it
    (benchmarks/fig78_trace.py:43-52)."""
    r = np.linalg.norm(cat.coords, axis=1)
    edges = np.linspace(0, np.quantile(r, 0.99), n_shells + 1)
    dens = []
    for i in range(n_shells):
        m = (r >= edges[i]) & (r < edges[i + 1])
        vol = edges[i + 1] - edges[i]
        dens.append(float(dem.lam[0][m].sum() / max(vol, 1e-9)))
    return edges.tolist(), dens


def reference_trace(n_items, k, h, ls_iters, dstars) -> dict:
    """The reference's §6.2 experiment, composed from its ``repro``
    calls in the order of ``run`` in benchmarks/fig78_trace.py (the
    instance :35-40, Fig. 8 :64-69, Fig. 7 left :71-89, the lookups
    :91-130, the refresh :132-150, the sweep :152-171), without its
    timing columns and the JSON it writes."""
    import jax.numpy as jnp

    from repro.core import catalog, demand, topology
    from repro.core.objective import DeviceInstance, Instance
    from repro.core.placement import device_greedy, greedy, localswap
    from repro.core.placement.localswap import constrained_localswap
    from repro.core.simcache import SimCacheNetwork
    cat = catalog.embedding_catalog(n=n_items, dim=100, seed=0,
                                    radial="decreasing")
    dem = demand.zipf(cat, alpha=0.8, seed=1)
    inst = Instance(net=topology.tandem(k_leaf=k, k_parent=k, h=h,
                                        h_repo=1000.0), cat=cat, dem=dem)
    _, dens = shell_density(cat, dem)
    half = len(dens) // 2
    checks = {"density decreasing":
              float(np.mean(dens[:half])) > float(np.mean(dens[half:]))}
    ls = localswap(inst, n_iters=ls_iters, seed=0)
    radii = np.linalg.norm(cat.coords, axis=1)
    pop_rank = np.argsort(np.argsort(-inst.lam[0]))
    leaf = ls.slots[inst.slot_cache == 0]
    frac = float(np.mean((pop_rank[leaf] < n_items * 0.1)
                         | (radii[leaf] < np.quantile(radii, 0.25))))
    checks["leaf stores popular-or-central"] = frac > 0.5
    net = SimCacheNetwork.from_placement(
        cat.coords, ls.slots, inst.slot_cache, hs=[0.0, h], h_repo=1000.0,
        metric=cat.metric, gamma=cat.gamma, fused=True)
    q = jnp.asarray(cat.coords)
    exact, pruned = net.lookup(q), net.lookup(q, prune="lsh")
    recall = float(np.mean(
        (np.asarray(pruned.payload) == np.asarray(exact.payload))
        & (np.asarray(pruned.level) == np.asarray(exact.level))))
    hg = greedy(inst)
    dg = device_greedy(DeviceInstance.from_instance(inst,
                                                    materialize_ca=False))
    sweep = []
    for dstar in dstars:
        allowed = np.zeros((inst.net.total_slots, cat.n), dtype=bool)
        allowed[inst.slot_cache == 0] = radii[None, :] < dstar
        allowed[inst.slot_cache == 1] = radii[None, :] >= dstar
        st = constrained_localswap(inst, allowed, n_iters=ls_iters, seed=0)
        sweep.append((dstar, st.cost(inst), st.slots))
    best = min(sweep, key=lambda r: r[1])
    checks["constrained close to unconstrained (<15%)"] = \
        best[1] <= ls.cost(inst) * 1.15
    return {"inst": inst, "dens": dens, "checks": checks, "ls": ls,
            "frac": frac, "recall": recall, "host": hg, "device": dg,
            "sweep": sweep, "best": best,
            "overhead": 100.0 * (best[1] / ls.cost(inst) - 1.0)}


def near_tie(jinst, tinst, jpicks, tpicks):
    """Where the two host GREEDY pick sequences first part, the
    reference's gain gap between the two picks (f64 on its C_a) and the
    most the two packages' C_a can move that gap: each gain
    Σ λ·max(0, cur − H − C_a[:, o]) moves by at most Σ λ·(|Δcur| +
    |ΔC_a[:, o]|), with cur the running costs after the common picks."""
    i = next(n for n, (a, b) in enumerate(zip(jpicks, tpicks)) if a != b)
    jcur = np.repeat(jinst.net.h_repo[:, None].astype(np.float64),
                     jinst.cat.n, axis=1)
    tcur = jcur.copy()
    for o, j in jpicks[:i]:
        jcur = jinst.updated_costs(jcur, o, j)
        tcur = tinst.updated_costs(tcur, o, j)
    g = jinst.add_gain_all(jcur)
    (o1, j1), (o2, j2) = jpicks[i], tpicks[i]
    dca = np.abs(jinst.ca.astype(np.float64) - tinst.ca)
    bound = float((jinst.lam * (2 * np.abs(jcur - tcur)
                                + dca[:, o1] + dca[:, o2])).sum())
    return g[o1, j1] - g[o2, j2], bound


def test_amazon_trace_matches_the_reference(monkeypatch):
    import repro.core.objective as jobjective

    import repro_torch.core.objective as tobjective
    twin = load("amazon_trace_torch")
    picks = {"ref": [], "port": []}
    active = []

    def recording(cls, key):
        updated = cls.updated_costs

        def wrapped(self, cur, obj, cache):
            if active == [key]:
                picks[key].append((int(obj), int(cache)))
            return updated(self, cur, obj, cache)
        monkeypatch.setattr(cls, "updated_costs", wrapped)

    def during(owner, name, key):
        fn = getattr(owner, name)

        def wrapped(*args, **kwargs):
            active.append(key)
            try:
                return fn(*args, **kwargs)
            finally:
                active.pop()
        monkeypatch.setattr(owner, name, wrapped)
    recording(jobjective.Instance, "ref")
    recording(tobjective.Instance, "port")
    import repro.core.placement as jplacement
    during(jplacement, "greedy", "ref")
    during(twin, "greedy", "port")

    ref = reference_trace(**TRACE_SIZES)
    out = twin.run(device="cpu", **TRACE_SIZES)
    jinst, tinst = ref["inst"], out["instance"]
    assert np.array_equal(jinst.cat.coords, tinst.cat.coords)
    assert np.array_equal(jinst.lam, tinst.lam)
    assert out["fig8"]["density"] == ref["dens"]
    assert out["checks"] == ref["checks"]
    assert all(out["checks"].values())

    u = out["fig7_unconstrained"]
    assert np.array_equal(u["slots"], ref["ls"].slots)
    assert u["frac_leaf_popular_or_central"] == ref["frac"]
    assert close(u["cost"], ref["ls"].cost(jinst), TRACE_REL)
    for row, (dstar, cost, slots) in zip(out["fig7_constrained"]["sweep"],
                                         ref["sweep"]):
        assert row["dstar"] == dstar
        assert np.array_equal(row["slots"], slots)
        assert close(row["cost"], cost, TRACE_REL)
    c = out["fig7_constrained"]
    if c["best_dstar"] != ref["best"][0]:
        assert close(c["best_cost"], ref["best"][1], TRACE_REL)
    assert close(c["best_cost"], ref["best"][1], TRACE_REL)
    assert abs(out["constrained_overhead_pct"] - ref["overhead"]) <= \
        100.0 * 2 * TRACE_REL * c["best_cost"] / u["cost"]

    lk = out["fused_lookup"]
    assert lk["n_shards"] == 1
    assert lk["fused_equals_looped"] and lk["sharded_equals_fused"]
    assert lk["pruned_recall"] == ref["recall"]

    pr = out["placement_refresh"]
    assert np.array_equal(pr["device"], ref["device"])
    assert np.array_equal(ref["host"], ref["device"])
    if not pr["allocations_equal"]:
        # the port's host GREEDY takes two near-tied picks in the other
        # order, and ends with the same objects in each cache
        gap, bound = near_tie(jinst, tinst, picks["ref"], picks["port"])
        assert 0.0 <= gap <= bound, (gap, bound)
        for j in range(jinst.net.n_caches):
            at = jinst.slot_cache == j
            assert sorted(pr["host"][at]) == sorted(ref["host"][at])


@pytest.mark.gpu
def test_amazon_trace_on_the_card_equals_the_cpu_twin():
    """The twin at the CPU test's sizes on the card (kernels A, B, C)
    and on the CPU (their plain versions): every discrete output equal —
    the checks, every LOCALSWAP allocation and the best d* (host NumPy
    either way), the lookups' agreement, the exact lookup's winners and
    the pruned recall, and the device GREEDY."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    twin = load("amazon_trace_torch")
    card = twin.run(**TRACE_SIZES)
    cpu = twin.run(device="cpu", **TRACE_SIZES)
    assert card["checks"] == cpu["checks"]
    assert np.array_equal(card["fig7_unconstrained"]["slots"],
                          cpu["fig7_unconstrained"]["slots"])
    for a, b in zip(card["fig7_constrained"]["sweep"],
                    cpu["fig7_constrained"]["sweep"]):
        assert np.array_equal(a["slots"], b["slots"])
    assert card["fig7_constrained"]["best_dstar"] == \
        cpu["fig7_constrained"]["best_dstar"]
    lc, lp = card["fused_lookup"], cpu["fused_lookup"]
    assert lc["fused_equals_looped"] and lc["sharded_equals_fused"]
    for f in ("level", "slot", "payload"):
        assert torch.equal(getattr(lc["exact"], f).cpu(),
                           getattr(lp["exact"], f))
    assert lc["pruned_recall"] == lp["pruned_recall"]
    assert np.array_equal(card["placement_refresh"]["device"],
                          cpu["placement_refresh"]["device"])


# --------------------------------------------------------------- no card
@pytest.mark.parametrize("name", TWINS)
def test_twin_refuses_to_run_without_a_card(name, monkeypatch):
    """Without a card and without ``--device cpu`` a twin raises before
    it does any work."""
    twin = load(f"{name}_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [f"{name}_torch.py"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main()
