"""The gradient of the port's ``loss_fn`` against the reference's, for all
ten architectures, on the CPU.

* For each arch at its smoke config, on the reference's weights with
  their constants redrawn (``family_cases.reference_pair``), the port's
  loss and its gradient (``model.loss_and_grads``, autograd with a zero
  gradient where a parameter is unused, as ``jax.grad`` gives) are held
  against ``jax.value_and_grad`` of the reference's ``loss_fn``, leaf by
  leaf in the reference's layout (``convert.to_jax_tree``: per-layer
  gradients stacked on the super-block axis). Each leaf's error is
  measured against its own largest |g|: within 1e-4 of it in f32 compute
  (two implementations summing in other orders; the largest seen is
  ~5e-6) and 2^-4 in bf16 (activations rounded at other points, 2^-8
  each; the largest seen ~5e-2, whisper's encoder bias).
* In bf16 a router near-tie (``BF16_ROUTER_GAP``) may swap an expert
  between the two runs, which changes the swapped position and, through
  attention and the recurrences, every later one of its row. Both runs'
  expert ids are recorded (``expert_ids``), and each row's loss is
  masked (``loss_mask``) from the first position where they differ on;
  that position must be a near-tie. The masked positions are printed,
  and at least half of the batch must stay scored (``MIN_SCORED``).
  At this batch only jamba's experts differ (row 1 from position 10 on,
  at one of its seven near-ties: 34 of 48 positions scored).
* Remat (``cfg.remat``, each super-block under
  ``torch.utils.checkpoint``) leaves the loss and every gradient
  bitwise as without it.
* Kernel E has no backward: ``flash_attention`` raises on an input that
  requires a gradient while grad mode is on (a train step with
  ``use_flash_attention`` included) and runs under ``torch.no_grad``.
"""
import contextlib
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from family_cases import (BF16_ROUTER_GAP, make_batch, near_ties,
                          reference_pair, router_gaps, to_jax, to_torch)
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_smoke_config, list_archs
from repro_torch.kernels.flash_attention import flash_attention, flash_ref
from repro_torch.models import convert
from repro_torch.models import model as model_api
from repro_torch.models import moe as tmoe
from torch_threads import one_thread  # noqa: F401

ARCHS = list_archs()
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -4}
MIN_SCORED = 0.5        # the share of positions a bf16 near-tie mask keeps


def flat(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def port_grads(cfg, model, batch: dict):
    """(loss, the gradient of every parameter by port name), as the
    trainer's step takes them (``model.loss_and_grads``)."""
    loss, _, grads = model_api.loss_and_grads(cfg, model, batch)
    return loss, grads


@contextlib.contextmanager
def expert_ids():
    """Record the expert ids (T, K) that each MoE layer's routing
    (``_route`` of either package) chooses inside the block: yields
    (the port's list, the reference's list). The reference's come from
    its compiled run through an ordered callback, in the order its
    layers route (and, with remat, route again in the backward)."""
    port, ref = [], []
    t_route, j_route = tmoe._route, jmoe._route

    def t_rec(x, router, topk):
        out = t_route(x, router, topk)
        port.append(out[1].numpy().copy())
        return out

    def j_rec(x, router, topk):
        out = j_route(x, router, topk)
        jax.debug.callback(lambda ids: ref.append(np.array(ids)), out[1],
                           ordered=True)
        return out
    tmoe._route, jmoe._route = t_rec, j_rec
    try:
        yield port, ref
    finally:
        tmoe._route, jmoe._route = t_route, j_route


def diverged(port: list, ref: list, shape: tuple) -> np.ndarray:
    """(B, S_lab) mask of the scored positions where some layer of the
    reference's forward chose other experts than the port's (its first
    ``len(port)`` routings, layer by layer). Each further routing of the
    reference (the recomputation under remat, in the backward's order)
    must repeat one of its forward's."""
    fwd, again = ref[:len(port)], ref[len(port):]
    assert port and len(fwd) == len(port), (len(port), len(ref))
    assert all(any(np.array_equal(a, f) for f in fwd) for a in again)
    out = np.zeros(shape, bool)
    for p, r in zip(port, fwd):
        assert p.shape == r.shape and p.shape[0] % shape[0] == 0
        d = np.any(np.sort(p, -1) != np.sort(r, -1), -1)
        out |= d.reshape(shape[0], -1)[:, -shape[1]:]
    return out


def causal_mask(skip: np.ndarray) -> np.ndarray:
    """(B, S) loss mask: 0 from each row's first marked position on."""
    mask = np.ones(skip.shape, np.float32)
    for r, row in enumerate(skip):
        hits = np.flatnonzero(row)
        if hits.size:
            mask[r, hits[0]:] = 0.0
    return mask


def first_marks(skip: np.ndarray) -> list:
    """(row, position) of each row's first marked position."""
    return [(r, int(np.flatnonzero(row)[0]))
            for r, row in enumerate(skip) if row.any()]


@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    """``reference_pair(arch)``, built once for both compute dtypes (the
    weights do not depend on it)."""
    return reference_pair(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grad_matches_reference(arch, dtype):
    jcfg, cfg, params, model = _pair(arch)
    jcfg, cfg = (dataclasses.replace(c, compute_dtype=dtype)
                 for c in (jcfg, cfg))
    batch = make_batch(cfg, np.random.default_rng(2))

    def ref_fn():          # traced anew each call: ``expert_ids`` hooks it
        return jax.jit(jax.value_and_grad(
            functools.partial(jmodel.loss_fn, jcfg), has_aux=True))
    masked = dtype == "bfloat16" and cfg.moe_experts
    if masked:
        shape = batch["labels"].shape
        batch["loss_mask"] = np.ones(shape, np.float32)
        with torch.no_grad(), router_gaps() as gaps, \
                expert_ids() as (port_ids, ref_ids):
            model_api.loss_fn(cfg, model, to_torch(batch))
            jax.block_until_ready(ref_fn()(params, to_jax(batch)))
            jax.effects_barrier()
        ties = near_ties(gaps, shape, BF16_ROUTER_GAP)
        swaps = diverged(port_ids, ref_ids, shape)
        print(f"{arch}: near-ties at (row, position) "
              f"{[tuple(map(int, p)) for p in np.argwhere(ties)]}; "
              f"experts differ first at {first_marks(swaps)}")
        assert all(ties[rc] for rc in first_marks(swaps)), arch
        batch["loss_mask"] = causal_mask(swaps)
        assert batch["loss_mask"].mean() >= MIN_SCORED, arch
    loss, grads = port_grads(cfg, model, to_torch(batch))
    with expert_ids() as (_, ref_again):
        (ref_loss, _), ref_grads = ref_fn()(params, to_jax(batch))
        jax.effects_barrier()
    if masked:             # the scored run routed as the recorded one
        assert len(ref_again) == len(ref_ids)
        assert all(np.array_equal(a, b)
                   for a, b in zip(ref_again, ref_ids)), arch
    np.testing.assert_allclose(float(loss), float(ref_loss),
                               rtol=GRAD_TOL[dtype] / 10)
    got = flat(convert.to_jax_tree(cfg, model, grads))
    ref = flat(jax.tree.map(np.asarray, ref_grads))
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        assert np.all(np.isfinite(got[key])), key
        scale = float(np.abs(ref[key]).max())
        err = float(np.abs(got[key] - ref[key]).max())
        assert err <= GRAD_TOL[dtype] * scale + 1e-30, (key, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_no_remat(arch):
    cfg = get_smoke_config(arch)
    model = model_api.init_params(cfg, 0, device="cpu")
    batch = to_torch(make_batch(cfg, np.random.default_rng(3)))
    runs = [port_grads(dataclasses.replace(cfg, remat=remat), model, batch)
            for remat in (True, False)]
    (l1, g1), (l0, g0) = runs
    assert cfg.remat
    assert torch.equal(l1, l0), arch
    for name in g0:
        assert torch.equal(g1[name], g0[name]), name


def test_remat_recomputes_each_super_block():
    """With remat the backward starts every layer's forward a second time
    (one super-block of ``block_pattern`` under each checkpoint; the
    recomputation may stop inside a super-block's last layer once every
    saved tensor is back, so the layers' starts are counted)."""
    cfg = get_smoke_config("jamba-1.5-large-398b")
    model = model_api.init_params(cfg, 0, device="cpu")
    batch = to_torch(make_batch(cfg, np.random.default_rng(3)))
    calls = []
    hooks = [blk.register_forward_pre_hook(lambda *a: calls.append(1))
             for blk in model.blocks]
    try:
        port_grads(cfg, model, batch)
    finally:
        for h in hooks:
            h.remove()
    assert len(calls) == 2 * cfg.n_layers


def _qkv(requires_grad: bool):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(2, 16, n, 16, generator=g,
                        requires_grad=requires_grad) for n in (4, 2, 2)]


def test_flash_attention_refuses_a_gradient():
    q, k, v = _qkv(True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v)
    k.requires_grad_(False)
    v.requires_grad_(False)
    with pytest.raises(RuntimeError, match="use_flash_attention=False"):
        flash_attention(q.detach().requires_grad_(False), k,
                        v.requires_grad_(True))


def test_flash_attention_runs_under_no_grad():
    q, k, v = _qkv(True)
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert torch.equal(out, flash_ref(q.detach(), k.detach(), v.detach()))
    plain = [t.detach() for t in (q, k, v)]
    assert torch.equal(flash_attention(*plain), out)


def test_train_step_through_flash_raises():
    """A train-mode loss with the gradient on and ``use_flash_attention``
    reaches kernel E and raises; the forward alone (no gradient) runs."""
    cfg = get_smoke_config("granite-3-2b")
    model = model_api.init_params(cfg, 0, device="cpu")
    fcfg = dataclasses.replace(cfg, use_flash_attention=True)
    batch = to_torch(make_batch(cfg, np.random.default_rng(4)))
    loss, _ = model_api.loss_fn(fcfg, model, batch)
    assert torch.isfinite(loss)
    with pytest.raises(RuntimeError, match="no backward"):
        port_grads(fcfg, model, batch)
