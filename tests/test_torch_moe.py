"""The port's MoE layer (models/moe.py) against the JAX reference
(repro.models.moe), on the CPU: the same inputs drawn with numpy, both
dispatches (the one-hot einsum and the slot gather), at a capacity that
drops tokens (1.25, with the router skewed) and at no drop (−1), and the
load-balance aux loss; then granite-moe-3b-a800m's and dbrx-132b's smoke
models on the reference's weights (constants redrawn,
tests/family_cases.py).

Tolerances:
* the layer in f32: 1e-5 relative (+ 1e-6 absolute for outputs near 0)
  — the same ops summed in other orders; the aux loss 1e-6 relative;
* the layer in bf16: 3e-2 absolute, the dense family's
  (tests/test_torch_model.py) — the two frameworks round to bf16 at
  other points;
* routing, capacity positions and drops: equal (the router's f32
  probabilities are far from ties on these inputs, and exact ties are
  broken toward the lower expert in both);
* model logits: 1e-4 (f32) and 3e-2 (bf16) absolute; the loss and its
  parts 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from family_cases import ATOL, make_batch, reference_pair, to_jax, to_torch
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.models import model as model_api
from repro_torch.models import moe

B, S, D, E, F_, K = 2, 32, 64, 4, 96, 2


def _inputs(seed=0, skew=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    router = (0.3 * rng.standard_normal((D, E))).astype(np.float32)
    if skew:        # expert 0 favoured: its capacity overflows at 1.25
        x[..., :4] += 1.0
        router[:4, 0] += 1.0
    w = [(0.1 * rng.standard_normal(s)).astype(np.float32)
         for s in ((E, D, F_), (E, D, F_), (E, F_, D))]
    return x, router, w


def _run(x, router, w, dtype, cf, dispatch, group=16):
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref, raux = jmoe.moe_mlp(jx, jnp.asarray(router),
                             *(jnp.asarray(a) for a in w), topk=K,
                             capacity_factor=cf, group_size=group,
                             dispatch=dispatch)
    got, aux = moe.moe_mlp(torch.as_tensor(x).to(getattr(torch, dtype)),
                           torch.as_tensor(router),
                           *(torch.as_tensor(a) for a in w), topk=K,
                           capacity_factor=cf, group_size=group,
                           dispatch=dispatch)
    return (np.asarray(ref, np.float32), float(raux),
            got.float().numpy(), float(aux))


def _drops(x, router, cf, group=16):
    """Token-slots the capacity drops (the port's routing, held equal to
    the reference's below)."""
    T = B * S
    G, Tg = moe._groups(T, group)
    _, idx, _ = moe._route(torch.as_tensor(x).reshape(T, D),
                           torch.as_tensor(router), K)
    cap = moe._capacity(Tg, K, E, cf)
    _, keep = moe._positions_in_expert(idx.reshape(G, Tg, K), E, cap)
    return int((~keep).sum())


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("cf", [1.25, -1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_reference(dtype, cf, dispatch):
    x, router, w = _inputs()
    ref, raux, got, aux = _run(x, router, w, dtype, cf, dispatch)
    assert got.shape == (B, S, D)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, atol=ATOL[dtype])
    np.testing.assert_allclose(aux, raux, rtol=1e-6)
    assert (_drops(x, router, cf) > 0) == (cf > 0)   # drops at 1.25 only


def test_routing_and_capacity_equal_the_reference():
    """Gate values, expert ids, the capacity positions and the keep mask
    of the port's helpers against the reference's, at the dropping
    capacity: ids, positions and drops equal, gates to 1e-5 relative (the
    router's f32 products summed in other orders)."""
    x, router, _ = _inputs()
    T = B * S
    G, Tg = moe._groups(T, 16)
    cap = moe._capacity(Tg, K, E, 1.25)
    assert cap == jmoe._capacity(Tg, K, E, 1.25) == 11
    jv, ji, jaux = jmoe._route(jnp.asarray(x).reshape(T, D),
                               jnp.asarray(router), K)
    v, i, aux = moe._route(torch.as_tensor(x).reshape(T, D),
                           torch.as_tensor(router), K)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5)
    jpos, jkeep = jmoe._positions_in_expert(ji.reshape(G, Tg, K), E, cap)
    pos, keep = moe._positions_in_expert(i.reshape(G, Tg, K), E, cap)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert int((~keep).sum()) > 0


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_group_size_shrinks_until_it_divides(dispatch):
    """30 tokens a batch row and groups of 16: the group shrinks to 15."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 15, D)).astype(np.float32)
    _, router, w = _inputs(3, skew=False)
    assert moe._groups(B * 15, 16) == (2, 15)
    ref, raux = jmoe.moe_mlp(jnp.asarray(x), jnp.asarray(router),
                             *(jnp.asarray(a) for a in w), topk=K,
                             capacity_factor=1.25, group_size=16,
                             dispatch=dispatch)
    got, aux = moe.moe_mlp(torch.as_tensor(x), torch.as_tensor(router),
                           *(torch.as_tensor(a) for a in w), topk=K,
                           capacity_factor=1.25, group_size=16,
                           dispatch=dispatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_tied_router_takes_the_lower_experts(dispatch):
    """A zero router gives every expert the same probability: both pick
    experts 0 … k−1 (``lax.top_k``'s order; ``torch.topk`` promises
    none), so the outputs agree."""
    x, _, w = _inputs(5, skew=False)
    router = np.zeros((D, E), np.float32)
    _, idx, _ = moe._route(torch.as_tensor(x).reshape(-1, D),
                           torch.as_tensor(router), K)
    assert (idx == torch.arange(K)).all()
    ref, raux, got, aux = _run(x, router, w, "float32", 1.25, dispatch)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert aux == pytest.approx(raux, rel=1e-6)


def test_the_two_dispatches_agree():
    """The port's einsum and gather paths compute one function (f32, both
    with drops)."""
    x, router, w = _inputs(7)
    args = (torch.as_tensor(x), torch.as_tensor(router),
            *(torch.as_tensor(a) for a in w))
    a, aux_a = moe.moe_mlp(*args, topk=K, group_size=16, dispatch="einsum")
    b, aux_b = moe.moe_mlp(*args, topk=K, group_size=16, dispatch="gather")
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert float(aux_a) == float(aux_b)
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_mlp(*args, topk=K, dispatch="dense")


def test_router_gaps():
    """The k-th minus the (k+1)-th router probability of each token."""
    x, router, _ = _inputs(9, skew=False)
    gaps = moe.router_gaps(torch.as_tensor(x), torch.as_tensor(router), K)
    p = np.sort(np.asarray(jax.nn.softmax(
        jnp.asarray(x) @ jnp.asarray(router), axis=-1)), axis=-1)[..., ::-1]
    np.testing.assert_allclose(gaps.numpy(), p[..., K - 1] - p[..., K],
                               atol=1e-6)
    assert torch.isinf(moe.router_gaps(torch.as_tensor(x),
                                       torch.as_tensor(router), E)).all()


ARCHS = ["granite-moe-3b-a800m", "dbrx-132b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return reference_pair(request.param)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("cf", [1.25, -1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_model_prefill_matches_reference(pair, dtype, cf, dispatch):
    """The smoke model's prefill logits and caches (batch of 2 × 24, one
    group), at the configured capacity and at none, in both dispatches."""
    jcfg0, cfg0, params, model = pair
    jcfg, cfg = (dataclasses.replace(c, compute_dtype=dtype,
                                     capacity_factor=cf,
                                     moe_dispatch=dispatch)
                 for c in (jcfg0, cfg0))
    batch = make_batch(cfg, np.random.default_rng(0))
    ref, jc = jax.jit(jmodel.make_prefill(jcfg))(
        params, {"tokens": jnp.asarray(batch["tokens"])})
    got, caches = model_api.make_prefill(cfg)(
        model, {"tokens": to_torch(batch)["tokens"]})
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=ATOL[dtype])
    assert len(caches) == cfg.n_layers and all(
        sorted(c) == ["k", "v"] for c in caches)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_loss_with_aux_matches_reference(pair, dispatch):
    """``loss_fn``: total, cross-entropy, z-loss and the aux loss (summed
    over the MoE layers) as the reference's, f32."""
    jcfg0, cfg0, params, model = pair
    jcfg, cfg = (dataclasses.replace(c, moe_dispatch=dispatch)
                 for c in (jcfg0, cfg0))
    batch = make_batch(cfg, np.random.default_rng(1))
    ref_total, ref = jax.jit(jmodel.make_train_forward(jcfg))(
        params, to_jax(batch))
    total, got = model_api.loss_fn(cfg, model, to_torch(batch))
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-5)
    for name in ("ce", "aux", "zloss"):
        np.testing.assert_allclose(float(got[name]), float(ref[name]),
                                   rtol=1e-5)
    assert float(got["aux"]) > 0.0
