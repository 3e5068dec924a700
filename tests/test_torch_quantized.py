"""The port's int8 quantized first-pass lookup (kernels/quant.py,
kernels/knn/ops.quantized_fused_lookup, SimCacheNetwork.lookup with
``quantize``) on the CPU: its own contracts, mirrored from
tests/test_quantized.py, and the JAX reference's entries on identical
inputs.

What must hold:
* **exactness** — ``lookup(quantize=True, verify=True)`` is bit for bit
  the exact fused lookup, over the reference suite's configurations
  (B = 1 and a 700-query batch), metrics, γ ≠ 1 and rescore widths, and
  composed with LSH pruning;
* **admissibility** — unverified, the cost is never below the exact
  cost and never above h_repo; a ``top_t`` covering every key is a pure
  re-indexing of the exact scan (bitwise, bound +INF); rows that beat
  their certificate are exact even unverified;
* **oracle** — the entry and its plain twin (``quantized_fused_lookup_
  ref``) agree: same winners, costs to 1e-6, bounds to 1e-6;
* **the reference** — ``_quantized_select`` and ``quantized_fused_
  lookup`` against the JAX ones (``use_pallas=False``, its plain path):
  the T-th score vT agrees to 4e-6·|vT| + 1e-6 (a few f32 ulps: the lb
  blocks' arithmetic differs between the frameworks,
  tests/test_torch_quant.py); the candidate sets and the winners are
  equal on every query whose T-th and (T+1)-th scores are apart by more
  than twice that (a near-tie at the cut may keep another key), and
  costs agree to tests/test_torch_lookup.py's ``cost_tol``. The test
  names the queries it leaves out, and leaves out none at its seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lookup import (assert_port_results_equal, cost_tol,
                               make_nets)

from repro.kernels import quant as jquant
from repro.kernels.knn import quantized_fused_lookup as jqfl
from repro.kernels.knn.ops import _quantized_select as jselect
from repro_torch import tracecount
from repro_torch.kernels import quant
from repro_torch.kernels.knn import (SimHashPolicy, quantized_fused_lookup,
                                     quantized_fused_lookup_ref)
from repro_torch.kernels.knn.ops import _quantized_select

CONFIGS = [
    (0, [5, 9, 3], [0.0, 0.5, 1.0], 2.0, 23),
    (1, [17, 2, 31, 8], [0.0, 0.2, 0.7, 1.3], 3.0, 1),       # B=1
    (5, [200, 150, 250], [0.0, 0.4, 0.8], 2.5, 700),   # a large batch
]


def net_q(seed, sizes, hs, h_repo, metric="l2", gamma=1.0, nq=23, **kw):
    _, net, rng = make_nets(seed, sizes, hs, h_repo, metric, gamma)
    for k, v in kw.items():
        setattr(net, k, v)
    q = torch.as_tensor((rng.standard_normal((nq, 6)) * 2)
                        .astype(np.float32))
    return net, q


# ------------------------------------------------------------- exactness
@pytest.mark.parametrize("metric,gamma", [("l2", 1.0), ("l1", 1.0),
                                          ("l2sq", 1.0), ("l2", 2.0)])
@pytest.mark.parametrize("top_t", [2, 16])
def test_quantized_verify_bit_identical(metric, gamma, top_t):
    for seed, sizes, hs, h_repo, nq in CONFIGS:
        net, q = net_q(seed, sizes, hs, h_repo, metric, gamma, nq)
        res = net.lookup(q, quantize=True, verify=True, top_t=top_t)
        assert_port_results_equal(res, net._lookup_fused(q))


def test_quantized_composes_with_lsh_pruning():
    """quantize under prune="lsh" sub-cuts the LSH union by the int8
    ranks; verify closes both gaps; unverified stays admissible."""
    net, q = net_q(9, [100, 300], [0.2, 0.8], 3.0, nq=32,
                   candidate_policy=SimHashPolicy(n_tables=2, n_bits=4,
                                                  n_probes=2))
    exact = net._lookup_fused(q)
    res = net.lookup(q, prune="lsh", verify=True, quantize=True, top_t=8)
    assert_port_results_equal(res, exact)
    got = net.lookup(q, prune="lsh", quantize=True, top_t=8)
    assert bool((got.cost >= exact.cost).all())


def test_quantized_full_width_equals_exact_without_verify():
    net, q = net_q(2, [64, 64], [0.0, 1.0], 5.0)
    assert_port_results_equal(net.lookup(q, quantize=True, top_t=4096),
                              net._lookup_fused(q))
    keys, h_key, meta = net.fused_layout()
    *_, bound = quantized_fused_lookup_ref(q, keys, h_key, meta,
                                           top_t=int(keys.shape[0]),
                                           h_repo=5.0)
    assert bool((bound >= 1e38).all())


# ---------------------------------------------------------- admissibility
@pytest.mark.parametrize("metric,gamma", [("l2", 1.0), ("l1", 0.7),
                                          ("l2sq", 1.0), ("l2", 2.0)])
def test_quantized_unverified_admissible(metric, gamma):
    net, q = net_q(3, [80, 120, 60], [0.0, 0.4, 0.9], 2.5, metric, gamma,
                   nq=64)
    exact = net._lookup_fused(q)
    for tt in (1, 4, 32):
        got = net.lookup(q, quantize=True, top_t=tt)
        assert bool((got.cost >= exact.cost).all()), tt
        assert bool((got.cost <= net.h_repo + 1e-6).all())


def test_quantized_certificate_is_honest():
    net, q = net_q(4, [150, 90], [0.0, 0.6], 3.0, nq=64)
    exact = net._lookup_fused(q)
    keys, h_key, meta = net.fused_layout()
    cost, ac, level, slot, payload, bound = quantized_fused_lookup(
        q, keys, h_key, meta, net._quant_rows(), top_t=4,
        metric=net.metric, gamma=net.gamma, h_repo=net.h_repo)
    safe = cost < bound
    assert bool(safe.any())
    for got, want in [(cost, exact.cost), (ac, exact.approx_cost),
                      (level, exact.level), (slot, exact.slot),
                      (payload, exact.payload)]:
        np.testing.assert_array_equal(got[safe].numpy(),
                                      want[safe].numpy())


# ----------------------------------------------------- ops — ref oracle
def test_quantized_ops_matches_ref_oracle():
    net, q = net_q(7, [40, 25], [0.0, 0.4], 2.0, "l2", 2.0, nq=19)
    keys, h_key, meta = net.fused_layout()
    kq = quant.quantize_rows(keys, "l2")
    out_k = quantized_fused_lookup(q, keys, h_key, meta, kq, top_t=8,
                                   metric="l2", gamma=2.0, h_repo=2.0)
    out_r = quantized_fused_lookup_ref(q, keys, h_key, meta, kq=kq, top_t=8,
                                       metric="l2", gamma=2.0, h_repo=2.0)
    for a, b in zip(out_k, out_r):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_select_tiles_equal_one_tile():
    """The tiled first pass keeps what one tile over every key keeps:
    each tile's top-T reaches the merge, so the merged top-T and vT are
    the same (scores of equal value tie to the lower key either way)."""
    net, q = net_q(12, [300, 211], [0.0, 0.3], 4.0, nq=37)
    keys, h_key, meta = net.fused_layout()
    kq = net._quant_rows()
    one = _quantized_select(q, h_key, meta[3] > 0, kq, 8, keys.shape[0],
                            "l2", 1.0)
    for tile in (8, 64, 100):
        got = _quantized_select(q, h_key, meta[3] > 0, kq, 8, tile, "l2",
                                1.0)
        np.testing.assert_array_equal(got[1].numpy(), one[1].numpy())
        np.testing.assert_array_equal(np.sort(got[0].numpy(), 1),
                                      np.sort(one[0].numpy(), 1))


# --------------------------------------------------------------- plumbing
def test_quant_rows_memo_and_invalidation():
    net, q = net_q(11, [50, 80], [0.2, 0.8], 3.0, nq=8)
    net.lookup(q, quantize=True)
    assert any(k[0] == "quant_rows" for k in net._tables)
    net.lookup(q, quantize=True)
    assert sum(k[0] == "quant_rows" for k in net._tables) == 1   # a hit
    net.invalidate_layout()
    assert not net._tables


def test_quantized_signatures_counted_once():
    net, q = net_q(13, [31, 7], [0.0, 0.5], 2.0, nq=3)
    with tracecount.snapshot() as s:
        for _ in range(3):
            net.lookup(q, quantize=True, top_t=5)
    assert s.delta("quantized_fused_lookup") == 1


def test_verify_counts_its_rescans():
    net, q = net_q(14, [120, 90], [0.0, 0.4], 2.5, nq=64)
    res = net.lookup(q, quantize=True, top_t=1)
    keys, h_key, meta = net.fused_layout()
    *_, bound = quantized_fused_lookup(q, keys, h_key, meta,
                                       net._quant_rows(), top_t=1,
                                       h_repo=2.5)
    flagged = int((res.cost >= bound).sum())
    assert flagged > 0
    net.lookup(q, quantize=True, verify=True, top_t=1)
    assert (net.rescan_calls, net.rescan_queries) == (1, flagged)


# ----------------------------------------------------------- the reference
# per-score tolerance of the first pass against the reference: a few f32
# ulps of a score of size |v| (the lb blocks' arithmetic differs between
# the frameworks, tests/test_torch_quant.py), plus 1e-6
SCORE_RTOL, SCORE_ATOL = 4e-6, 1e-6


def _scores(q, kq, h_key, valid, metric, gamma) -> np.ndarray:
    lb = quant.lb_approx_cost_tiles(q, kq, metric, gamma)
    return torch.where(valid[None], lb + h_key[None].float(),
                       torch.full_like(lb, 3.0e38)).double().numpy()


@pytest.mark.parametrize("metric,gamma", [("l2", 1.0), ("l1", 1.0),
                                          ("l2sq", 1.0), ("l2", 0.7)])
@pytest.mark.parametrize("top_t", [3, 16])
def test_quantized_matches_reference(metric, gamma, top_t):
    jnet, net, rng = make_nets(6, [90, 140, 60], [0.0, 0.4, 0.9], 2.5,
                               metric, gamma)
    qn = (rng.standard_normal((41, 6)) * 2).astype(np.float32)
    q = torch.as_tensor(qn)
    keys, h_key, meta = net.fused_layout()
    jkeys, jh, jmeta = jnet.fused_layout()
    kq = net._quant_rows()
    jkq = jquant.quantize_rows(jkeys, metric)
    valid = meta[3] > 0
    cand, vt = _quantized_select(q, h_key, valid, kq, top_t, 64, metric,
                                 gamma)
    jcand, jvt = jselect(jnp.asarray(qn), jh, jmeta[3] > 0, jkq, top_t, 64,
                         metric, gamma)
    jcand, jvt = np.asarray(jcand), np.asarray(jvt)
    srt = np.sort(_scores(q, kq, h_key, valid, metric, gamma), axis=1)
    T = top_t
    tol = SCORE_RTOL * np.abs(srt[:, T - 1]) + SCORE_ATOL
    assert np.all(np.abs(vt.double().numpy() - jvt) <= tol)
    clear = srt[:, T] - srt[:, T - 1] > 2 * tol
    assert clear.all(), np.nonzero(~clear)[0]      # none left out here
    np.testing.assert_array_equal(np.sort(cand.numpy()[clear], 1),
                                  np.sort(jcand[clear], 1))
    # the whole entry, rescored: winners and costs
    out = quantized_fused_lookup(q, keys, h_key, meta, kq, top_t=top_t,
                                 metric=metric, gamma=gamma, h_repo=2.5)
    jout = jqfl(jnp.asarray(qn), jkeys, jh, jmeta, jkq, top_t=top_t,
                metric=metric, gamma=gamma, h_repo=2.5, use_pallas=False)
    for i in (2, 3, 4):                       # level, slot, payload
        np.testing.assert_array_equal(out[i].numpy()[clear],
                                      np.asarray(jout[i])[clear])
    ca = np.asarray(jout[1])
    tol = cost_tol(qn, keys.numpy(), ca, metric, gamma)
    assert np.all(np.abs(out[0].numpy() - np.asarray(jout[0])) <= tol)
