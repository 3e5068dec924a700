"""The port's serving launcher (``python -m repro_torch.launch.serve``)
on the CPU.

Its two loops run on a CPU engine at the reference launcher's sizes
(granite's smoke config, ``embedding_catalog(n=1000, dim=32, seed=0)``,
Zipf α = 1.0, batch 16, 256 requests, ``calibrate()`` first), with and
without ``--warm-start``, and with ``--scenario`` through the strategy
plane (no calibration); and the command itself refuses to run without a
card. The loops run on the card in chip_smoke.py's ``launch`` phase.
``--netduel`` is held in tests/test_torch_duel_engine.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.launch import serve as launch
from repro_torch.models import model as model_api
from repro_torch.serve import SimCacheEngine

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir,
                                   "src"))


def _engine(args):
    cfg = get_smoke_config(args.arch)
    cat = catalog_api.embedding_catalog(n=1000, dim=32, seed=0)
    eng = SimCacheEngine(cfg, model_api.init_params(cfg, 0, device="cpu"),
                         launch.engine_config(args), cat.coords,
                         device="cpu")
    eng.calibrate(torch.zeros((args.batch, 16), dtype=torch.int32))
    return eng, cfg, cat


def test_defaults_are_the_reference_launchers():
    args = launch.parser().parse_args(["--arch", "granite-3-2b"])
    assert (args.requests, args.batch, args.algo, args.streaming,
            args.streams, args.refresh_every, args.netduel,
            args.warm_start, args.warm_polish_iters, args.scenario,
            args.strategy, args.cache_budget, args.ingress) == \
        (256, 16, "cascade", False, 4, 16, False, False, 512, None, "lce",
         64, 4)


def test_batch_loop_serves_and_refreshes(capsys):
    args = launch.parser().parse_args(["--arch", "granite-3-2b"])
    eng, cfg, cat = _engine(args)
    launch.run_batch_loop(eng, cfg, demand_api.zipf(cat, alpha=1.0, seed=1),
                          args)
    out = capsys.readouterr().out
    assert "[serve] placement refreshed; predicted C(A)=" in out
    assert eng.stats.n_requests == 256
    assert eng.placement.version == 1
    assert 0.0 < eng.stats.hit_rate < 1.0
    assert eng.stats.mean_cost < eng.ecfg.h_model


def test_streaming_serves_and_swaps(capsys):
    args = launch.parser().parse_args(["--arch", "granite-3-2b",
                                       "--streaming", "--refresh-every",
                                       "4"])
    eng, cfg, cat = _engine(args)
    launch.run_streaming(eng, cat, args)
    out = capsys.readouterr().out
    assert "[serve] initial placement; predicted C(A)=" in out
    assert "[serve] streaming: 256 requests in" in out
    assert "[serve] refreshes" in out
    assert eng.stats.n_requests == 256 + max(256 // 8, 16)
    assert eng.swap_count >= 1 and not eng.refresh_in_flight
    assert eng.stats.n_hits > 0


def test_engine_config_follows_the_flags():
    args = launch.parser().parse_args(
        ["--arch", "granite-3-2b", "--algo", "greedy", "--netduel",
         "--warm-start", "--warm-polish-iters", "64"])
    ecfg = launch.engine_config(args)
    assert (ecfg.algo, ecfg.netduel, ecfg.refresh_on_promotion,
            ecfg.warm_start, ecfg.warm_polish_iters) == \
        ("greedy", True, True, True, 64)


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["batch_loop", "streaming"])
def test_warm_start_serves(streaming, capsys):
    """``--warm-start``: every refresh is the §4 warm start (the launcher
    hierarchy reduces to a chain), in the batch loop and behind the
    streaming driver's background refreshes."""
    argv = ["--arch", "granite-3-2b", "--warm-start",
            "--warm-polish-iters", "128"]
    if streaming:
        argv += ["--streaming", "--refresh-every", "4"]
    args = launch.parser().parse_args(argv)
    eng, cfg, cat = _engine(args)
    assert eng.ecfg.warm_start and eng.ecfg.warm_polish_iters == 128
    if streaming:
        launch.run_streaming(eng, cat, args)
        assert eng.swap_count >= 1 and not eng.refresh_in_flight
    else:
        launch.run_batch_loop(
            eng, cfg, demand_api.zipf(cat, alpha=1.0, seed=1), args)
        assert eng.placement.version == 1
    out = capsys.readouterr().out
    assert "predicted C(A)=" in out
    assert {"warm_solve_s", "warm_map_s", "warm_polish_s",
            "warm_swaps"} <= set(eng.solve_timings)
    assert eng.stats.n_hits > 0
    assert eng.stats.mean_cost < eng.ecfg.h_model


@pytest.mark.parametrize("strategy", ["lce", "sim-lru"])
@pytest.mark.parametrize("streaming", [False, True],
                         ids=["batch_loop", "streaming"])
def test_scenario_serves_through_the_strategy_plane(strategy, streaming,
                                                    capsys):
    """``--scenario scale_free --strategy …``: the generated multi-ingress
    network served by the strategy plane, with no calibration and no
    placement refresh, in both loops."""
    argv = ["--arch", "granite-3-2b", "--scenario", "scale_free",
            "--strategy", strategy]
    if streaming:
        argv += ["--streaming", "--requests", "128"]
    args = launch.parser().parse_args(argv)
    cfg = get_smoke_config(args.arch)
    cat = catalog_api.embedding_catalog(n=1000, dim=32, seed=0)
    eng, dem = launch.build_engine(
        args, cfg, model_api.init_params(cfg, 0, device="cpu"), cat, "cpu")
    assert eng.routing is not None and eng.routing.strategy == strategy
    assert eng.net.n_ingress == args.ingress == dem.n_ingress
    assert eng.net.total_slots == args.cache_budget
    if streaming:
        launch.run_streaming(eng, cat, args)
        assert eng.stats.n_requests == 128 + 16
    else:
        launch.run_batch_loop(eng, cfg, dem, args)
        assert eng.stats.n_requests == 256
    out = capsys.readouterr().out
    assert "[serve] scenario scale_free: " in out
    assert f"strategy {strategy}" in out and "predicted C(A)" not in out
    assert eng.placement.version == 0 and eng.refresh_count == 0
    assert eng.ecfg.h_model == 10.0                   # not calibrated
    assert len(np.unique(eng.counts.nonzero()[0])) > 1  # several ingresses
    assert eng.stats.n_hits > 0
    assert eng.stats.mean_cost < float(eng.net.h_repo.max())


def test_choices_are_the_reference_names():
    from repro.core.routing import STRATEGIES
    from repro.core.scenarios import GENERATORS
    choices = {a.dest: a.choices for a in launch.parser()._actions}
    assert tuple(choices["strategy"]) == STRATEGIES
    assert tuple(choices["scenario"]) == tuple(sorted(GENERATORS))


def test_command_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would run")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", "granite-3-2b"], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
    assert "hit-rate" not in res.stdout
