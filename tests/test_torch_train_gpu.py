"""The training path on the card against the port's CPU path.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) when no CUDA
device is available. Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

No kernel of the port runs here (training never reaches kernel E); the
card's autograd, AdamW and trainer are held against the CPU's on the
same weights and batches:

* every parameter's gradient, for every arch at its smoke config in f32
  compute, within 1e-4 of the leaf's largest |g| (the CPU suite's
  tolerance against the reference; the card sums in other orders, the
  embedding gather's backward and the MoE scatters among them);
* one AdamW update for f32, bf16 and int8 moments from identical
  gradients: parameters within 2e-6 relative, moments within a few ulps
  of the leaf's largest (one int8 step where a payload sits on an edge);
* the trainer's losses on the card against the CPU's (f32 compute, 1e-4
  relative), and kill and resume on the card (2e-4, the reference
  test's);
* ``flash_attention`` refusing a CUDA input that requires a gradient.
"""
import copy
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import on_device, train_batch  # noqa: E402
from repro_torch.checkpoint import save
from repro_torch.configs.registry import get_smoke_config, list_archs
from repro_torch.data import SyntheticLMData
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import convert
from repro_torch.models import model as model_api
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train import TrainConfig, train
from repro_torch.train.trainer import opt_state_tree

pytestmark = pytest.mark.gpu
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=128, compute_dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("arch", list_archs())
def test_grad_on_card_matches_cpu(cuda, arch):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    model = model_api.init_params(cfg, 0, device="cpu")
    batch = train_batch(cfg, np.random.default_rng(0), 2, 24)
    loss_c, _, g_c = model_api.loss_and_grads(cfg, model,
                                              on_device(torch, batch, "cpu"))
    gpu = copy.deepcopy(model).to(cuda)
    loss_g, _, g_g = model_api.loss_and_grads(cfg, gpu,
                                              on_device(torch, batch, cuda))
    assert float(loss_g) == pytest.approx(float(loss_c), rel=1e-5)
    for name, gc in g_c.items():
        gg = g_g[name].cpu()
        assert bool(torch.isfinite(gg).all()), name
        scale = float(gc.abs().max())
        assert float((gg - gc).abs().max()) <= 1e-4 * scale + 1e-30, name


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_on_card_matches_cpu(cuda, moment_dtype):
    g = torch.Generator().manual_seed(1)
    shapes = {"w": (64, 300), "b": (300,), "k": (3, 5, 7)}
    p0 = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
    cfg = AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    runs = []
    for dev in ("cpu", cuda):
        params = {n: v.clone().to(dev) for n, v in p0.items()}
        state = adamw_init(params, cfg)
        gg = torch.Generator().manual_seed(2)
        for _ in range(3):
            grads = {n: (torch.randn(s, generator=gg) * 0.1).to(dev)
                     for n, s in shapes.items()}
            adamw_update(grads, state, params, cfg, lr_scale=0.5)
        runs.append((params, state))
    (pc, sc), (pg, sg) = runs
    assert int(sg["step"]) == 3
    for n in shapes:
        torch.testing.assert_close(pg[n].cpu(), pc[n], rtol=2e-6, atol=1e-7)
        for key in ("m", "v"):
            c, d = sc[key][n], sg[key][n]
            if moment_dtype == "int8":
                c = c["q"].float() * c["s"]
                d = d["q"].float().cpu() * d["s"].cpu()
                tol = 1.01 * float(sc[key][n]["s"].max())
            else:
                d = d.float().cpu()
                c = c.float()
                ulp = 2.0 ** (-7 if moment_dtype == "bfloat16" else -21)
                tol = ulp * float(c.abs().max())
            assert float((d - c).abs().max()) <= tol, (n, key)


def test_trainer_on_card_matches_cpu(cuda, tmp_path):
    """Both trainers resume one step-0 checkpoint of the CPU's initial
    weights (a card's generator draws other ones)."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), **SMALL)
    data = SyntheticLMData(vocab=cfg.vocab, batch=4, seq=32)
    quiet = dict(log=lambda *a: None)
    opt = AdamWConfig(lr=1e-3, weight_decay=0.01)
    model = model_api.init_params(cfg, 0, device="cpu")
    state = {"params": convert.to_jax_params(cfg, model),
             "opt": opt_state_tree(
                 cfg, model, adamw_init(dict(model.named_parameters()),
                                        opt))}
    outs = []
    for dev in ("cpu", "cuda"):
        save(str(tmp_path / dev), 0, state)
        tcfg = TrainConfig(steps=8, ckpt_dir=str(tmp_path / dev),
                           ckpt_every=0, warmup=2, opt=opt)
        outs.append(train(cfg, tcfg, data, device=dev, **quiet))
    np.testing.assert_allclose(outs[1]["losses"], outs[0]["losses"],
                               rtol=1e-4)
    assert len(outs[1]["step_ms"]) == 8
    tcfg = TrainConfig(steps=8, ckpt_dir=str(tmp_path / "kill"),
                       ckpt_every=4, warmup=2, opt=opt)
    save(tcfg.ckpt_dir, 0, state)
    train(cfg, tcfg, data, stop_after=4, device=cuda, **quiet)
    resumed = train(cfg, tcfg, data, device=cuda, **quiet)
    np.testing.assert_allclose(resumed["losses"], outs[1]["losses"][4:],
                               rtol=2e-4, atol=2e-4)


def test_flash_attention_refuses_a_gradient_on_card(cuda):
    q = torch.randn(1, 16, 4, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 16, 2, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, k)
