"""repro_torch.core.costs against repro.core.costs.

The same seeded numpy inputs go through both packages on the CPU.

Tolerances:
* l1 and the broadcast (stable) forms differ only in summation order:
  rtol 1e-5 on values of order 1–10.
* The l2 matmul form cancels |x|² + |y|² − 2x·y: its error is about
  eps·(|x|² + |y|²) in d² space, so at d near 0 it is ~sqrt of that after
  the square root. :func:`l2_tol` carries that bound to d, per pair.
* The stable form's own contract is exact: one pair gives the same f32
  bits at any batch shape.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costs as jcosts
from repro_torch.core import costs

U32 = 2.0 ** -24


def l2_tol(x, y, d):
    """Per-pair bound on a matmul-form l2 distance's rounding: 16 unit
    roundoffs of |x|² + |y|² in d² space (both frameworks' dot products
    over D terms), carried to d by |√a − √b| ≤ |a − b| / (√a + √b)."""
    t2 = 16 * U32 * ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :])
    return t2 / (d + np.sqrt(t2))


def _xy(seed, n=37, m=23, d=6, scale=3.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((n, d)) * scale).astype(np.float32),
            (rng.standard_normal((m, d)) * scale).astype(np.float32))


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
def test_pairwise_distance_matches_reference(metric):
    x, y = _xy(0)
    ref = np.asarray(jcosts.pairwise_distance(jnp.asarray(x),
                                              jnp.asarray(y), metric))
    got = costs.pairwise_distance(torch.as_tensor(x), torch.as_tensor(y),
                                  metric).numpy()
    if metric == "l1":
        tol = 1e-5 * np.abs(ref) + 1e-6
    elif metric == "l2":
        tol = l2_tol(x, y, ref) + 1e-6 * ref
    else:       # d² space: the bound before the square root
        tol = 16 * U32 * ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :])
    np.testing.assert_array_less(np.abs(got - ref), tol)


@pytest.mark.parametrize("gamma", [1.0, 0.5, 2.0])
def test_power_law_matches_reference(gamma):
    d = np.random.default_rng(4).random((9, 7)).astype(np.float32) * 50
    ref = np.asarray(jcosts.approx_cost_from_distance(jnp.asarray(d), gamma))
    got = costs.approx_cost_from_distance(torch.as_tensor(d), gamma).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
def test_stable_form_matches_reference(metric):
    x, y = _xy(1)
    ref = np.asarray(jcosts.approx_cost_stable(
        jnp.asarray(x), jnp.asarray(y), metric, 1.0))
    got = costs.approx_cost_stable(torch.as_tensor(x), torch.as_tensor(y),
                                   metric).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
def test_stable_form_is_shape_stable(metric):
    """Bitwise pair equality across a column, a k-batch, a row block and
    the full matrix — the contract the incremental ops rely on."""
    x, y = _xy(2, n=300, m=40, d=17, scale=200.0)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    full = costs.pairwise_distance_stable(xt, yt, metric)
    for j in (0, 13, 39):
        assert torch.equal(costs.pairwise_distance_stable(
            xt, yt[j:j + 1], metric), full[:, j:j + 1])
    assert torch.equal(costs.pairwise_distance_stable(xt, yt[5:29], metric),
                       full[:, 5:29])
    assert torch.equal(costs.pairwise_distance_stable(xt[100:170], yt,
                                                      metric),
                       full[100:170])


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_approx_cost_np_matches_reference(metric):
    x, y = _xy(3, n=50, m=50)
    ref = jcosts.approx_cost_np(x, y, metric, block=16)
    got = costs.approx_cost_np(x, y, metric, block=16)
    assert got.dtype == np.float32 and got.shape == ref.shape
    tol = 1e-5 * np.abs(ref) + 1e-5
    if metric == "l2":
        tol = tol + l2_tol(x, y, ref)
    np.testing.assert_array_less(np.abs(got - ref), tol)


def test_unknown_metric_raises():
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError):
        costs.pairwise_distance(x, x, "cosine")
    with pytest.raises(ValueError):
        costs.pairwise_distance_stable(x, x, "cosine")
