"""Twins of tests/test_trainer_ft.py, tests/test_system.py's train-then-
serve test and tests/test_arch_smoke.py's one-step SGD drop, for the
port's training path on the CPU, against the reference where one exists:

* the data pipeline's batches bitwise the reference's;
* ``cosine_schedule`` over steps 0 to total + 10 (f32; one f32 ulp of
  slack for ``cos``);
* three AdamW updates from identical numpy gradients, for f32, bf16 and
  int8 moments, against ``repro.optim.adamw_update``: parameters within
  a few f32 ulps (2e-6 relative), moments within a few ulps of their
  dtype at the leaf's largest moment (one int8 step where a payload sits
  on a rounding edge);
* int8 AdamW tracking f32 on the reference's quadratic problem, and
  within 1e-3 of the reference's own int8 run there (2 % of an update:
  an ulp upstream flips a payload on a rounding edge by one int8 step);
* the int8 gradient codec's round trip (``ft.quantize_int8``);
* checkpoints: atomic and pruned; a reference run's checkpoint (f32 and
  int8 moments) resumed by the port's trainer, whose losses then follow
  the reference's own resumed run (2e-5 relative with f32 moments, 1e-3
  with int8 ones, whose edge flips move a loss by ~3e-4); a port run's
  checkpoint restored by
  the reference, every leaf bitwise the port's, and resumed by the
  reference's trainer; bf16 moments round-trip through the ``|V2``
  records numpy keeps for bf16;
* the trainer's first 10 losses from the reference's initial weights
  against the reference trainer's (f32 compute, 2e-5 relative: a tenth
  of the reference's own resume tolerance); the loss decreasing; kill
  and resume (bitwise on the CPU, within the reference's 2e-4 in any
  case);
* train, then serve through the port's ``SimCacheEngine``;
* hedged dispatch, each request's result and latency and the stats
  equal to the reference dispatcher's on the same replicas;
* ``launch.train``'s loop on a CPU device, and its exit without a card.

The gpu-marked twins of the card's holds are in
tests/test_torch_train_gpu.py.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from family_cases import make_batch, to_torch
from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.configs.registry import get_smoke_config as jsmoke
from repro.data.pipeline import SyntheticLMData as JData
from repro.ft import straggler as jstraggler
from repro.models import model as jmodel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import train as jtrain
from repro_torch.checkpoint import (latest_step, restore,
                                    restore_for_device, save)
from repro_torch.configs.registry import get_smoke_config, list_archs
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.data import SyntheticLMData
from repro_torch.ft import (HedgedDispatcher, dequantize_int8,
                            quantize_int8, simulated_replica)
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import model as model_api
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.serve import EngineConfig, SimCacheEngine
from repro_torch.train import TrainConfig, train
from torch_threads import one_thread  # noqa: F401

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=128)
QUIET = dict(log=lambda *a: None)
RESUME_RTOL = {"float32": 2e-5, "int8": 1e-3}


def small_cfgs(**fields):
    """(reference config, port config): test_trainer_ft.py's small
    granite, with ``fields`` replaced."""
    jcfg = dataclasses.replace(jsmoke("granite-3-2b"), **SMALL, **fields)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL,
                              **fields)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def both_trainers(tcfg_kw: dict, opt_kw: dict | None = None):
    """(JTrainConfig, TrainConfig) with the same fields."""
    opt_kw = opt_kw or {}
    return (JTrainConfig(**tcfg_kw, opt=JAdamWConfig(**opt_kw)),
            TrainConfig(**tcfg_kw, opt=AdamWConfig(**opt_kw)))


# ------------------------------------------------------------ pipeline
@pytest.mark.parametrize("seed,shard", [(0, 0), (7, 0), (3, 2)])
def test_pipeline_batches_bitwise_reference(seed, shard):
    kw = dict(vocab=49155, batch=4, seq=64, seed=seed, n_shards=4,
              shard=shard)
    d, jd = SyntheticLMData(**kw), JData(**kw)
    for step in (0, 1, 42, 10_000):
        b, jb = d.batch_at(step), jd.batch_at(step)
        for key in ("tokens", "labels"):
            assert b[key].dtype == jb[key].dtype == np.int32
            np.testing.assert_array_equal(b[key], jb[key])


def test_data_pipeline_deterministic():
    d = SyntheticLMData(vocab=128, batch=4, seq=16, seed=7)
    b1, b2 = d.batch_at(42), d.batch_at(42)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], d.batch_at(43)["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


# ------------------------------------------------------------ schedule
@pytest.mark.parametrize("warmup,total,floor", [(50, 300, 0.1),
                                                (0, 20, 0.1),
                                                (10, 10, 0.0)])
def test_cosine_schedule_matches_reference(warmup, total, floor):
    steps = np.arange(total + 11)
    got = np.array([float(cosine_schedule(s, warmup=warmup, total=total,
                                          floor=floor)) for s in steps])
    ref = np.array([float(jcosine(s, warmup=warmup, total=total,
                                  floor=floor)) for s in steps])
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -23, atol=1e-7)
    vec = cosine_schedule(torch.as_tensor(steps), warmup=warmup,
                          total=total, floor=floor)
    assert vec.dtype == torch.float32
    np.testing.assert_array_equal(vec.numpy(), got.astype(np.float32))


# --------------------------------------------------------------- AdamW
SHAPES = {"w": (6, 40), "b": (40,), "k": (3, 5, 7)}


def _grads(rng):
    return {n: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1)
                ).astype(np.float32) for n, s in SHAPES.items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_reference(moment_dtype):
    rng = np.random.default_rng(5)
    p0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in SHAPES.items()}
    kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0,
              moment_dtype=moment_dtype)
    cfg, jcfg = AdamWConfig(**kw), JAdamWConfig(**kw)
    params = {n: torch.tensor(v) for n, v in p0.items()}
    jparams = {n: jnp.asarray(v) for n, v in p0.items()}
    state, jstate = adamw_init(params, cfg), jadamw_init(jparams, jcfg)
    for it in range(3):
        g = _grads(rng)
        lr_scale = np.float32(0.5 + 0.25 * it)
        adamw_update({n: torch.tensor(v) for n, v in g.items()}, state,
                     params, cfg, lr_scale=torch.tensor(lr_scale))
        jparams, jstate = jadamw_update(
            {n: jnp.asarray(v) for n, v in g.items()}, jstate, jparams,
            jcfg, lr_scale=jnp.asarray(lr_scale))
    assert int(state["step"]) == int(jstate["step"]) == 3
    for n in SHAPES:
        np.testing.assert_allclose(params[n].numpy(), np.asarray(jparams[n]),
                                   rtol=2e-6, atol=1e-7)
        for key in ("m", "v"):
            got, ref = state[key][n], jstate[key][n]
            if moment_dtype == "int8":
                s, js = got["s"].numpy(), np.asarray(ref["s"])
                np.testing.assert_allclose(s, js, rtol=1e-6)
                dq = got["q"].numpy().astype(np.float32) * s
                jdq = np.asarray(ref["q"]).astype(np.float32) * js
                np.testing.assert_allclose(dq, jdq, rtol=0,
                                           atol=1.01 * float(js.max()))
                assert np.mean(got["q"].numpy() != np.asarray(ref["q"])) \
                    < 0.05
            else:
                assert got.dtype == getattr(torch, moment_dtype)
                # a few ulps of the leaf's largest moment: the clip scale
                # (the global norm, summed in another order) moves every
                # g by an ulp, which a moment near cancellation keeps
                ref = np.asarray(ref, np.float32)
                ulp = 2.0 ** (-7 if moment_dtype == "bfloat16" else -21)
                np.testing.assert_allclose(
                    got.float().numpy(), ref, rtol=0,
                    atol=ulp * float(np.abs(ref).max()))


def test_int8_moment_adamw_tracks_f32():
    """The reference's quadratic problem: int8-moment AdamW stays close to
    f32 AdamW over 50 steps, both converge, and the port's int8 run
    follows the reference's."""
    rng = np.random.default_rng(0)
    target_np = rng.standard_normal(64).astype(np.float32)
    target = torch.tensor(target_np)

    def loss(p):
        return ((p - target) ** 2).sum()

    results = {}
    for md in ("float32", "int8"):
        cfg = AdamWConfig(lr=0.05, weight_decay=0.0, moment_dtype=md)
        params = {"p": torch.zeros(64)}
        st = adamw_init(params, cfg)
        for _ in range(50):
            p = params["p"].clone().requires_grad_(True)
            (g,) = torch.autograd.grad(loss(p), [p])
            adamw_update({"p": g}, st, params, cfg)
        results[md] = params["p"]
    err = float((results["int8"] - results["float32"]).abs().max())
    assert err < 0.5, err
    base = float(loss(torch.zeros(64)))
    assert float(loss(results["int8"])) < 0.003 * base
    assert float(loss(results["float32"])) < 0.003 * base

    jcfg = JAdamWConfig(lr=0.05, weight_decay=0.0, moment_dtype="int8")
    jtarget = jnp.asarray(target_np)
    jp = jnp.zeros(64)
    jst = jadamw_init(jp, jcfg)
    for _ in range(50):
        jg = jax.grad(lambda p: jnp.sum((p - jtarget) ** 2))(jp)
        jp, jst = jadamw_update(jg, jst, jp, jcfg)
    # an ulp of the clip scale flips the int8 payloads that sit on a
    # rounding edge (one step of max|m| / 127): within 2 % of one update
    np.testing.assert_allclose(results["int8"].numpy(), np.asarray(jp),
                               atol=1e-3)


def test_int8_codec_roundtrip(rng):
    x = torch.tensor(rng.standard_normal((16, 256)).astype(np.float32) * 5)
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s)
    rel = float((back - x).abs().max()) / float(x.abs().max())
    assert rel < 1.0 / 100


# --------------------------------------------------------- checkpoints
def test_checkpoint_atomic_and_pruned(tmp_path):
    tree = {"a": np.arange(10.0), "b": {"c": torch.ones((3, 3))}}
    for s in (1, 2, 3, 4):
        save(str(tmp_path), s, tree, keep=2)
    assert latest_step(str(tmp_path)) == 4
    step, back = restore(str(tmp_path))
    assert step == 4
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"]["c"], np.ones((3, 3)))
    kept = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(kept) == 2
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"))


def test_bf16_leaves_round_trip(tmp_path):
    """bf16 is written as the ``|V2`` records numpy keeps for the
    reference's bf16 arrays, and read back as bf16, bit for bit, by
    :func:`restore_for_device`; a reference bf16 checkpoint reads the
    same way."""
    x = torch.randn(5, 7).to(torch.bfloat16)
    save(str(tmp_path / "p"), 1, {"m": {"x": x}})
    _, raw = restore(str(tmp_path / "p"))
    assert raw["m"]["x"].dtype.str == "|V2"
    _, back = restore_for_device(str(tmp_path / "p"), "cpu")
    assert back["m"]["x"].dtype == torch.bfloat16
    assert torch.equal(back["m"]["x"], x)
    jsave(str(tmp_path / "j"), 1,
          {"m": {"x": jnp.asarray(x.float().numpy(), jnp.bfloat16)}})
    _, jback = restore_for_device(str(tmp_path / "j"), "cpu")
    assert torch.equal(jback["m"]["x"], x)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_reference_checkpoint_resumes_in_port(tmp_path, moment_dtype):
    """The reference trains 3 of 6 steps and checkpoints; the port's
    trainer and the reference's each resume that checkpoint for the last
    3; the port restores every leaf bitwise and its losses follow the
    reference's."""
    jcfg, cfg = small_cfgs(compute_dtype="float32")
    data = SyntheticLMData(vocab=cfg.vocab, batch=4, seq=16)
    jdata = JData(vocab=cfg.vocab, batch=4, seq=16)
    kw = dict(steps=6, ckpt_every=3, log_every=1000, warmup=2)
    opt = dict(lr=1e-3, weight_decay=0.01, moment_dtype=moment_dtype)
    jt, _ = both_trainers(dict(kw, ckpt_dir=str(tmp_path / "j")), opt)
    jtrain(jcfg, jt, jdata, stop_after=3, **QUIET)
    _, jtree = jrestore(str(tmp_path / "j"))
    # the port's own checkpoint directory, seeded with the reference's
    os.makedirs(tmp_path / "p")
    os.rename(tmp_path / "j" / "step_00000003",
              tmp_path / "p" / "step_00000003")
    _, pt = both_trainers(dict(kw, ckpt_dir=str(tmp_path / "p")), opt)
    out = train(cfg, pt, data, device="cpu", **QUIET)
    jsave(str(tmp_path / "j"), 3, jtree)
    jout = jtrain(jcfg, jt, jdata, **QUIET)
    assert out["step"] == jout["step"] == 6
    np.testing.assert_allclose(out["losses"], jout["losses"],
                               rtol=RESUME_RTOL[moment_dtype])

    # the restore itself: every leaf of the model and the moments
    model = convert.from_jax_params(cfg, jtree["params"], "cpu")
    back = flat(convert.to_jax_params(cfg, model))
    for key, ref in flat(jtree["params"]).items():
        np.testing.assert_array_equal(back[key], ref)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_port_checkpoint_restores_in_reference(tmp_path, moment_dtype):
    """The port trains 3 of 6 steps and checkpoints; the reference
    restores it (the same keys and shapes as its own, every leaf the
    port's bit for bit) and its trainer resumes it, following the port's
    own resumed run."""
    jcfg, cfg = small_cfgs(compute_dtype="float32")
    data = SyntheticLMData(vocab=cfg.vocab, batch=4, seq=16)
    kw = dict(steps=6, ckpt_every=3, log_every=1000, warmup=2)
    opt = dict(lr=1e-3, weight_decay=0.01, moment_dtype=moment_dtype)
    jt, pt = both_trainers(dict(kw, ckpt_dir=str(tmp_path / "p")), opt)
    first = train(cfg, pt, data, stop_after=3, device="cpu", **QUIET)
    shutil.copytree(tmp_path / "p", tmp_path / "j")
    jt = dataclasses.replace(jt, ckpt_dir=str(tmp_path / "j"))
    step, tree = jrestore(str(tmp_path / "j"))
    assert step == 3
    # the reference's own layout: its init and its optimizer's state
    jparams = jax.tree.map(np.asarray, jmodel.init_params(jcfg, 0))
    jopt = jax.tree.map(np.asarray, jadamw_init(jparams, JAdamWConfig(**opt)))
    want = {f"params/{k}": v.shape for k, v in flat(jparams).items()}
    want.update({f"opt/{k}": np.shape(v) for k, v in flat(jopt).items()})
    assert {k: v.shape for k, v in flat(tree).items()} == want
    np.testing.assert_array_equal(
        flat(tree)["params/embed"],
        first["params"].embed.detach().numpy())

    jdata = JData(vocab=cfg.vocab, batch=4, seq=16)
    jout = jtrain(jcfg, jt, jdata, **QUIET)
    out = train(cfg, pt, data, device="cpu", **QUIET)
    assert out["step"] == jout["step"] == 6
    np.testing.assert_allclose(jout["losses"], out["losses"],
                               rtol=RESUME_RTOL[moment_dtype])


# ------------------------------------------------------------- trainer
def test_first_losses_match_reference_trainer(tmp_path):
    """Ten steps from the reference's initial weights (handed over as a
    step-0 checkpoint) against the reference trainer's own ten."""
    jcfg, cfg = small_cfgs(compute_dtype="float32")
    kw = dict(steps=10, ckpt_every=1000, log_every=1000, warmup=3)
    opt = dict(lr=1e-3, weight_decay=0.01)
    jt, pt = both_trainers(dict(kw, ckpt_dir=str(tmp_path / "p")), opt)
    jparams = jmodel.init_params(jcfg, jt.seed)
    jsave(str(tmp_path / "p"), 0, {"params": jparams,
                                   "opt": jadamw_init(jparams, jt.opt)})
    out = train(cfg, pt, SyntheticLMData(vocab=cfg.vocab, batch=8,
                                         seq=32), device="cpu", **QUIET)
    jt = dataclasses.replace(jt, ckpt_dir=str(tmp_path / "j"))
    jout = jtrain(jcfg, jt, JData(vocab=cfg.vocab, batch=8, seq=32),
                  **QUIET)
    assert len(out["losses"]) == len(jout["losses"]) == 10
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=2e-5)
    assert len(out["step_ms"]) == 10


def test_loss_decreases_on_synthetic_data(tmp_path):
    _, cfg = small_cfgs()
    tcfg = TrainConfig(steps=60, ckpt_dir=str(tmp_path / "ck"),
                       ckpt_every=1000, log_every=1000,
                       opt=AdamWConfig(lr=2e-3, weight_decay=0.0))
    data = SyntheticLMData(vocab=cfg.vocab, batch=8, seq=32)
    out = train(cfg, tcfg, data, device="cpu", **QUIET)
    first, last = np.mean(out["losses"][:10]), np.mean(out["losses"][-10:])
    assert last < first - 0.2, (first, last)
    assert not any(p.requires_grad for p in out["params"].parameters())


def test_kill_and_resume_matches_uninterrupted_run(tmp_path):
    _, cfg = small_cfgs()
    data = SyntheticLMData(vocab=cfg.vocab, batch=8, seq=32)
    t_a = TrainConfig(steps=30, ckpt_dir=str(tmp_path / "a"), ckpt_every=10,
                      log_every=1000)
    full = train(cfg, t_a, data, device="cpu", **QUIET)
    t_b = dataclasses.replace(t_a, ckpt_dir=str(tmp_path / "b"))
    train(cfg, t_b, data, stop_after=20, device="cpu", **QUIET)
    assert latest_step(str(tmp_path / "b")) == 20
    logs = []
    resumed = train(cfg, t_b, data, device="cpu", log=logs.append)
    assert logs[0] == "[train] resumed from step 20"
    np.testing.assert_allclose(resumed["losses"], full["losses"][20:],
                               rtol=2e-4, atol=2e-4)
    assert resumed["losses"] == full["losses"][20:]     # bitwise on the CPU
    for a, b in zip(resumed["params"].parameters(),
                    full["params"].parameters()):
        assert torch.equal(a, b)


def test_no_checkpoint_with_ckpt_every_zero(tmp_path):
    _, cfg = small_cfgs()
    tcfg = TrainConfig(steps=2, ckpt_dir=str(tmp_path), ckpt_every=0)
    train(cfg, tcfg, SyntheticLMData(vocab=cfg.vocab, batch=2, seq=8),
          device="cpu", **QUIET)
    assert latest_step(str(tmp_path)) is None


@pytest.mark.parametrize("arch", list_archs())
def test_one_train_gradient_step(arch):
    """Every gradient finite; one SGD step of 0.3 on the same batch lowers
    the loss (test_arch_smoke.py's form, on the port's own weights)."""
    cfg = get_smoke_config(arch)
    model = model_api.init_params(cfg, 0, device="cpu")
    batch = to_torch(make_batch(cfg, np.random.default_rng(0)))
    loss0, _, grads = model_api.loss_and_grads(cfg, model, batch)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values()), arch
    assert not any(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.sub_(0.3 * grads[name])
        loss1, _ = model_api.loss_fn(cfg, model, batch)
    loss0 = float(loss0)
    assert float(loss1) < loss0, (arch, loss0, float(loss1))


def test_train_then_serve_smoke(tmp_path):
    """Train a tiny LM a few steps, then serve it behind the cache network
    (the port's ``SimCacheEngine``)."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                              **dict(SMALL, vocab=256))
    tcfg = TrainConfig(steps=20, ckpt_dir=str(tmp_path), ckpt_every=10,
                       log_every=100, opt=AdamWConfig(lr=1e-3))
    data = SyntheticLMData(vocab=cfg.vocab, batch=4, seq=32)
    out = train(cfg, tcfg, data, device="cpu", **QUIET)
    assert np.isfinite(out["losses"][-1])

    cat = catalog_api.embedding_catalog(n=200, dim=8, seed=0)
    eng = SimCacheEngine(cfg, out["params"],
                         EngineConfig(k_device=8, k_pod=16, k_global=16,
                                      h_ici=1.0, h_dcn=5.0, h_model=50.0),
                         cat.coords, device="cpu")
    rng = np.random.default_rng(0)
    dem = demand_api.zipf(cat, alpha=1.2, seed=1)
    for _ in range(4):
        ids, _ = dem.sample(8, rng)
        eng.serve(ids, rng.integers(0, cfg.vocab, (8, 8)).astype(np.int32))
    eng.refresh_placement()
    eng.stats = type(eng.stats)()
    for _ in range(6):
        ids, _ = dem.sample(8, rng)
        eng.serve(ids, rng.integers(0, cfg.vocab, (8, 8)).astype(np.int32))
    assert eng.stats.hit_rate > 0.3
    assert eng.stats.mean_cost < 50.0


# ------------------------------------------------------------- hedging
def _hedge_twins(replicas, n: int = 100, **kw):
    """The port's and the reference's dispatcher, each on fresh replicas
    made by ``replicas(simulated_replica)`` and the same settings, over
    requests 0 … n-1: each request's result and latency, and the stats,
    must be equal. Returns the port's dispatcher and latencies."""
    runs = []
    for disp, rep in ((HedgedDispatcher, simulated_replica),
                      (jstraggler.HedgedDispatcher,
                       jstraggler.simulated_replica)):
        hd = disp(replicas(rep), **kw)
        runs.append((hd, [hd(i) for i in range(n)]))
    (hd, got), (ref, want) = runs
    assert got == want
    assert dataclasses.asdict(hd.stats) == dataclasses.asdict(ref.stats)
    return hd, [lat for _, lat in got]


def test_hedged_dispatch_cuts_tail_latency():
    hd, lats = _hedge_twins(
        lambda rep: [rep(0.010, slow_every=5, slow_factor=100.0),
                     rep(0.012)], hedge_after_s=0.02)
    assert max(lats) < 0.05
    assert hd.stats.n_hedged == 20


def test_hedged_approx_fallback():
    def fallback(r):
        return ("approx", r), 0.0
    hd, lats = _hedge_twins(
        lambda rep: [rep(0.010, slow_every=3, slow_factor=50.0),
                     rep(0.012, slow_every=4, slow_factor=20.0)],
        hedge_after_s=0.02, deadline_s=0.1, approx_fallback=fallback)
    st = hd.stats
    assert min(st.n_primary, st.n_hedged, st.n_fallback) > 0
    assert st.n_primary + st.n_hedged + st.n_fallback == 100
    assert max(lats) == 0.1
    hd, _ = _hedge_twins(lambda rep: [rep(1.0), rep(1.0)], n=1,
                         hedge_after_s=0.01, deadline_s=0.1,
                         approx_fallback=fallback)
    assert hd(7) == (("approx", 7), 0.1)
    assert hd.stats.n_fallback == 2
    with pytest.raises(ValueError):
        HedgedDispatcher([simulated_replica(1.0)], hedge_after_s=0.01)


# ------------------------------------------------------------ launcher
def test_launch_train_loop_on_cpu(tmp_path, capsys):
    args = launch_train.parser().parse_args(
        ["--arch", "granite-3-2b", "--steps", "4", "--batch", "2",
         "--seq", "16", "--ckpt", str(tmp_path)])
    assert args.smoke
    out = launch_train.run(args, "cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (f"[launch.train] done at step 4; final loss "
                    f"{out['losses'][-1]:.4f}")
    assert np.isfinite(out["losses"][-1])
    assert latest_step(str(tmp_path)) == 4


def test_launch_train_needs_a_card():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src),
               CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "granite-3-2b"], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 1
    assert "no CUDA device is available" in p.stderr
