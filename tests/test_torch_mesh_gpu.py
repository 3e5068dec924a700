"""The mesh layer (item 14d) on the card, at smoke size.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) when no CUDA
device is available. Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mesh_gpu.py

* Every arch's train-mode loss under the (2, 4) mesh's train policy (the
  KV heads repeated 2 → 4 where there are fewer than 4) against
  NO_SHARD's on the card (1e-6 relative) and the CPU's (1e-5, f32).
* A flash prefill under the prefill policy: kernel E at the repeated
  head count, one launch a layer, the logits bitwise NO_SHARD's flash
  prefill; E held against ``flash_ref`` at H 32 / KH 16 (the production
  policy's granite shape, a short sequence).
* Serve steps under the decode policy bitwise NO_SHARD's.
* The dry run's argument bytes of a smoke train cell equal the bytes of
  the state the trainer builds on the card.
* ``compressed_crosspod_mean`` on a 1-rank NCCL group bitwise
  dequantize ∘ quantize.
* A checkpoint re-meshed onto (4, 2), (2, 4) and (8, 1) by
  ``restore_for_mesh`` on the card reassembles bitwise.
"""
import dataclasses
import datetime
import pathlib
import socket
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import on_device, train_batch  # noqa: E402
from repro_torch.checkpoint import restore_for_mesh, save
from repro_torch.configs.registry import get_smoke_config, list_archs
from repro_torch.data import SyntheticLMData
from repro_torch.ft import (compressed_crosspod_mean, dequantize_int8,
                            plan_mesh, quantize_int8, reshard_plan)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import flash_cuda, flash_ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import ShardMesh
from repro_torch.launch.sharding import MeshShardPolicy, shard_slices
from repro_torch.launch.specs import ShapeCell, build_cell
from repro_torch.models import convert
from repro_torch.models import model as model_api
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.trainer import _device_batch

pytestmark = pytest.mark.gpu
MESH = ShardMesh(("data", "model"), (2, 4))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def batch_of(cfg, device, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                               device=device) for k in ("tokens", "labels")}


@pytest.mark.parametrize("arch", list_archs())
def test_kv_repeat_loss_on_card(cuda, arch):
    cfg = get_smoke_config(arch)
    model = model_api.init_params(cfg, 0, device="cpu")
    policy = MeshShardPolicy.create(cfg, MESH, "train")
    host = train_batch(cfg, np.random.default_rng(0), 2, 24)
    cpu, _ = model_api.loss_fn(cfg, model, on_device(torch, host, "cpu"))
    model = model.to(cuda)
    batch = on_device(torch, host, cuda)
    with torch.no_grad():
        got, _ = model_api.loss_fn(cfg, model, batch, policy)
        plain, _ = model_api.loss_fn(cfg, model, batch)
    assert abs(float(got) - float(plain)) <= 1e-6 * abs(float(plain))
    assert abs(float(got) - float(cpu)) <= 1e-5 * abs(float(cpu))


def test_flash_prefill_under_the_prefill_policy(cuda):
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                              compute_dtype="bfloat16",
                              use_flash_attention=True)
    model = model_api.init_params(cfg, 0, device=cuda)
    policy = MeshShardPolicy.create(cfg, MESH, "prefill")
    assert policy.kv_repeat == 2
    toks = {"tokens": batch_of(cfg, cuda, S=128)["tokens"]}
    reset_launch_counts()
    got, _ = model_api.make_prefill(cfg, policy)(model, toks)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == cfg.n_layers
    want, _ = model_api.make_prefill(cfg)(model, toks)
    assert torch.equal(got, want)


def test_kernel_e_at_the_production_head_ratio(cuda):
    """H 32 / KH 16, Dh 64, causal, bf16: the tolerance of chip_smoke's
    ``hold_kernel_e`` against ``flash_ref``."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 256, 32, 64, generator=g, device=cuda).bfloat16()
    k = torch.randn(2, 256, 16, 64, generator=g, device=cuda).bfloat16()
    v = torch.randn(2, 256, 16, 64, generator=g, device=cuda).bfloat16()
    got = flash_cuda(q, k, v, causal=True).float()
    ref = flash_ref(q, k, v, causal=True).float()
    abs_v = flash_ref(q.float(), k.float(), v.float().abs(), causal=True)
    tol = 2.0 ** -7 * ref.abs() + 2.0 ** -7 * abs_v + 1e-4
    assert bool(((got - ref).abs() <= tol).all())


def test_decode_policy_is_bitwise_no_shard(cuda):
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                              compute_dtype="bfloat16")
    model = model_api.init_params(cfg, 0, device=cuda)
    policy = MeshShardPolicy.create(cfg, MESH, "decode")
    toks = batch_of(cfg, cuda, S=20)["tokens"]
    _, caches = model_api.make_prefill(cfg)(model, {"tokens": toks[:, :16]})
    with torch.inference_mode():
        caches = model_api._pad_caches(cfg, caches, 20)
        other = [{k: t.clone() for k, t in c.items()} for c in caches]
    step, base = (model_api.make_serve_step(cfg, policy),
                  model_api.make_serve_step(cfg))
    for t in range(16, 20):
        a, caches = step(model, toks[:, t:t + 1], caches, t)
        b, other = base(model, toks[:, t:t + 1], other, t)
        assert torch.equal(a, b), t


def test_argument_bytes_equal_the_state_on_the_card(cuda):
    cfg = get_smoke_config("granite-3-2b")
    opt = AdamWConfig(moment_dtype="int8")
    mem = dryrun.argument_bytes(build_cell(
        cfg, ShapeCell("smoke", 32, 4, "train"),
        ShardMesh(("data", "model"), (1, 1)), opt))
    model = model_api.init_params(cfg, 0, device=cuda)
    named = dict(model.named_parameters())

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()
    batch = _device_batch(SyntheticLMData(vocab=cfg.vocab, batch=4,
                                          seq=32).batch_at(0), cuda)
    assert mem == dict(params=nbytes(named),
                       opt_state=nbytes(adamw_init(named, opt)),
                       batch=nbytes(batch),
                       argument_size_in_bytes=nbytes(named) + nbytes(
                           adamw_init(named, opt)) + nbytes(batch))


def test_crosspod_mean_on_one_nccl_rank(cuda):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("pod", "data"))
        g = torch.randn(64, 256, device=cuda)
        out = compressed_crosspod_mean({"g": g, "s": g[0, 0]}, mesh)
        assert torch.equal(out["g"], dequantize_int8(*quantize_int8(g)))
        assert torch.equal(out["s"], dequantize_int8(
            *quantize_int8(g[0, 0])).reshape(()))
    finally:
        dist.destroy_process_group()


def test_remesh_on_the_card(cuda, tmp_path):
    cfg = get_smoke_config("granite-3-2b")
    model = model_api.init_params(cfg, 0, device=cuda)
    tree = convert.to_jax_params(cfg, model)
    save(str(tmp_path), 1, {"params": tree})
    for shape in ((4, 2), (2, 4), (8, 1)):
        mesh = plan_mesh(shape[0] * shape[1], model_parallelism=shape[1])
        specs = reshard_plan(cfg, mesh)
        for name in ("embed", "lm_head"):
            if name not in tree:
                continue
            full = torch.zeros(tree[name].shape, device=cuda)
            for d in range(shape[0]):
                for m in range(shape[1]):
                    coords = {"data": d, "model": m}
                    _, st = restore_for_mesh(str(tmp_path),
                                             {"params": specs}, mesh, coords)
                    block = st["params"][name]
                    assert block.device.type == "cuda"
                    full[shard_slices(tuple(full.shape), specs[name], mesh,
                                      coords)] = block
            assert torch.equal(full.cpu(), torch.as_tensor(tree[name]))
