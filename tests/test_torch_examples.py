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
         "streaming_serve", "train_lm"]
HOST_REL = 1e-5          # host costs (tests/test_torch_placement.py)
PRED_REL = 1e-4          # predicted C(A) (tests/test_torch_engine.py)
N_REQUESTS = 10000       # netduel_online's requests a phase (40,000 in it)


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
