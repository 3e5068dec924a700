"""The port's repository model against the JAX reference: granite-3-2b
at smoke width, the same weights (the JAX ``init_params`` tree loaded
through repro_torch.models.convert), the same prompts.

Tolerances:
* f32 compute (the algorithm): 1e-4 absolute on logits of order 1 —
  two f32 implementations of the same ops, summed in different orders;
* bf16 compute (the dtype policy): 3e-2 absolute — bf16 keeps 8 bits of
  mantissa (a relative step of 2^-8 ≈ 4e-3) and the two frameworks round
  to bf16 at different points of each block.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jget_smoke
from repro.models import model as jmodel
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models import convert
from repro_torch.models import model as model_api


def _pair(compute_dtype):
    jcfg = dataclasses.replace(jget_smoke("granite-3-2b"),
                               compute_dtype=compute_dtype)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                              compute_dtype=compute_dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    params = jmodel.init_params(jcfg, 0)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, convert.from_jax_params(cfg, tree,
                                                      device="cpu")


@pytest.mark.parametrize("compute_dtype,atol", [("float32", 1e-4),
                                                ("bfloat16", 3e-2)])
def test_prefill_logits_match_reference(compute_dtype, atol):
    jcfg, cfg, params, model = _pair(compute_dtype)
    toks = np.random.default_rng(0).integers(0, cfg.vocab,
                                             (3, 8)).astype(np.int32)
    ref, _ = jax.jit(jmodel.make_prefill(jcfg))(params,
                                                {"tokens": jnp.asarray(toks)})
    got, caches = model_api.make_prefill(cfg)(
        model, {"tokens": torch.as_tensor(toks).long()})
    assert got.shape == (3, 8, cfg.padded_vocab)
    assert got.dtype == getattr(torch, compute_dtype)
    assert len(caches) == cfg.n_layers
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)
    # the serving decision: argmax of the last position
    if compute_dtype == "float32":
        np.testing.assert_array_equal(
            got[:, -1].argmax(-1).numpy(),
            np.asarray(jnp.argmax(ref[:, -1], axis=-1)))


def test_init_params_shapes_and_seed():
    cfg = get_smoke_config("granite-3-2b")
    a = model_api.init_params(cfg, 0, device="cpu")
    b = model_api.init_params(cfg, 0, device="cpu")
    c = model_api.init_params(cfg, 1, device="cpu")
    ref = jax.tree.map(np.shape, jmodel.init_params(
        jget_smoke("granite-3-2b"), 0))
    assert tuple(a.embed.shape) == ref["embed"]
    blk = ref["blocks"]["b0_attn_mlp"]
    for name, shape in blk.items():
        assert tuple(getattr(a.blocks[0], name).shape) == shape[1:]
    assert len(a.blocks) == cfg.n_layers
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    assert float(a.blocks[0].attn_norm.min()) == 1.0
    assert abs(float(a.embed.std()) - 0.02) < 2e-3


def test_full_width_config_is_granite():
    cfg = get_config("granite-3-2b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab) == (40, 2048, 32, 8, 8192, 49155)
    assert cfg.tie_embeddings and not cfg.use_flash_attention
