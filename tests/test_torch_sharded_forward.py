"""Every arch's forward under a mesh shard policy (models/sharding_api.py,
launch/sharding.py), on the CPU at smoke size.

On plain tensors a policy's ``shard(x, axes)`` returns ``x``, so the one
knob that changes what the model computes is ``kv_repeat``: under the
train and prefill policies of a (2, 4) mesh (model axis 4) the smoke
configs' 2 KV heads are repeated to 4 before the attention. The same
attention up to f32 rounding (the grouped products take other shapes):
the loss within 1e-6 relative and the logits within 1e-5 of the port's
NO_SHARD forward, and within the arch suite's tolerances (1e-5 relative,
1e-4 absolute) of the reference's NO_SHARD forward. whisper's and
xlstm's heads are not fewer than 4 (kv_repeat 1), so theirs are bitwise
NO_SHARD's. The decode policy ("kv_seq") changes nothing on one process:
four serve steps bitwise NO_SHARD's, within 1e-4 of the reference's.
NO_SHARD is the default and gives today's loss bitwise: the loss's 2-D
gather equals the 3-D one it replaced.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from family_cases import (ATOL, make_batch, reference_pair, to_jax,
                          to_torch)
from repro.models import model as jmodel
from repro_torch.configs.registry import list_archs
from repro_torch.launch.mesh import ShardMesh
from repro_torch.launch.sharding import MeshShardPolicy
from repro_torch.models import model as model_api
from repro_torch.models.sharding_api import NO_SHARD
from torch_threads import one_thread  # noqa: F401

ARCHS = list_archs()
MESH = ShardMesh(("data", "model"), (2, 4))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return reference_pair(request.param)


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def test_kv_repeat_policy_matches_no_shard_and_reference(pair):
    jcfg, cfg, params, model = pair
    policy = MeshShardPolicy.create(cfg, MESH, "train")
    expect = 4 // cfg.n_kv_heads if cfg.n_kv_heads < 4 and not cfg.xlstm \
        else 1
    assert (policy.attn_strategy, policy.kv_repeat) == ("heads", expect)
    batch = make_batch(cfg, np.random.default_rng(0))
    loss, m = model_api.make_train_forward(cfg, policy)(model,
                                                        to_torch(batch))
    plain, pm = model_api.make_train_forward(cfg)(model, to_torch(batch))
    ref, rm = jax.jit(jmodel.make_train_forward(jcfg))(params,
                                                       to_jax(batch))
    if policy.kv_repeat == 1:
        assert torch.equal(loss, plain)
    assert rel(loss, plain) <= 1e-6
    assert rel(loss, ref) <= 1e-5 and rel(m["ce"], rm["ce"]) <= 1e-5

    pre = MeshShardPolicy.create(cfg, MESH, "prefill")
    assert pre.kv_repeat == policy.kv_repeat
    fwd = {k: v for k, v in batch.items() if k != "labels"}
    got, caches = model_api.make_prefill(cfg, pre)(model, to_torch(fwd))
    base, base_caches = model_api.make_prefill(cfg)(model, to_torch(fwd))
    want, _ = jax.jit(jmodel.make_prefill(jcfg))(params, to_jax(fwd))
    torch.testing.assert_close(got, base, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL["float32"], rtol=0)
    # the cache keeps the unrepeated KV heads
    for c, b in zip(caches, base_caches):
        assert sorted(c) == sorted(b)
        for key in c:
            assert c[key].shape == b[key].shape


def test_decode_policy_matches_no_shard_bitwise(pair):
    jcfg, cfg, params, model = pair
    policy = MeshShardPolicy.create(cfg, MESH, "decode")
    assert (policy.attn_strategy, policy.kv_repeat) == ("kv_seq", 1)
    B, S, n = 2, 12, 4
    batch = make_batch(cfg, np.random.default_rng(1), B=B, S=S + n)
    toks = batch["tokens"]
    fwd = {"tokens": toks[:, :S]}
    if cfg.is_encdec:
        fwd["audio_embeds"] = batch["audio_embeds"]
    if cfg.mrope:        # a text prompt: positions on all three streams
        fwd["mrope_positions"] = np.broadcast_to(
            np.arange(S)[None, None], (3, B, S)).astype(np.int32)
    _, caches = model_api.make_prefill(cfg)(model, to_torch(fwd))
    caches = model_api._pad_caches(cfg, caches, S + n)
    _, jcaches = jax.jit(jmodel.make_prefill(jcfg))(params, to_jax(fwd))
    jcaches = jmodel._pad_caches(jcfg, jcaches, S + n)
    sharded, plain = copy.deepcopy(caches), caches
    step, base = (model_api.make_serve_step(cfg, policy),
                  model_api.make_serve_step(cfg))
    jstep = jax.jit(jmodel.make_serve_step(jcfg))
    for t in range(n):
        tok = toks[:, S + t:S + t + 1]
        got, sharded = step(model, torch.as_tensor(tok).long(), sharded,
                            S + t)
        want, plain = base(model, torch.as_tensor(tok).long(), plain,
                           S + t)
        ref, jcaches = jstep(params, jax.numpy.asarray(tok), jcaches,
                             S + t)
        assert torch.equal(got, want), t
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=ATOL["float32"], rtol=0)


def test_no_shard_is_the_default_and_todays_loss(pair):
    _, cfg, _, model = pair
    batch = to_torch(make_batch(cfg, np.random.default_rng(2)))
    loss, m = model_api.loss_fn(cfg, model, batch)
    again, _ = model_api.loss_fn(cfg, model, batch, NO_SHARD)
    assert torch.equal(loss, again)
    # the loss as it was computed before the policy: the 3-D gather
    logits, _, aux = model_api.forward(cfg, model, batch)
    labels = batch["labels"]
    lf = logits[:, -labels.shape[1]:, :].float()
    logz = torch.logsumexp(lf, dim=-1)
    nll = logz - torch.gather(lf, -1, labels[..., None])[..., 0]
    ce = nll.sum() / nll.numel()
    total = ce + model_api.AUX_LOSS_WEIGHT * aux + \
        model_api.Z_LOSS_WEIGHT * (logz ** 2).sum() / nll.numel()
    assert torch.equal(m["ce"], ce) and torch.equal(loss, total)
