"""The port's int8 quantizer and lower-bound blocks (kernels/quant.py)
against the JAX reference, on the CPU.

Mirrors tests/test_compress.py and the quantizer half of
tests/test_quantized.py. The same numpy inputs go through both packages.

What must match, and to what tolerance:
* ``quantize_int8``, ``dequantize_int8``, ``quant_row_radius`` and the
  ``q``/``scale``/``radius`` of ``quantize_rows``: bit for bit, zero rows
  and sub-denormal rows included (XLA flushes denormal inputs to zero;
  the port flushes them explicitly). One exception, named in the test:
  a radius whose value is denormal (a sub-denormal row's) is flushed to
  0 by XLA and kept by the port, the larger and admissible value;
* ``sq_norm`` (a sum over D whose order differs between XLA and torch):
  4·D unit roundoffs relative;
* the lower-bound blocks (l1, l2, l2sq; γ 1, 0.7, 2), compared in
  distance space (the γ-th root, and the square root for l2sq): for the
  l2 family |Δd| ≤ t2 / (d + √t2) + 2e-6·d with t2 = 16·u·(|q|² + |k|²),
  the cancellation bound of the |q|² + |k|² − 2q·k form (u = 2⁻²⁴); for
  l1, 1e-5 relative plus 1e-6;
* admissibility, inside the port: every lower bound ≤ the exact C_a of
  the original rows computed in f64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jq
from repro_torch.kernels import quant

U32 = 2.0 ** -24
METRICS = ("l1", "l2", "l2sq")
GAMMAS = (1.0, 0.7, 2.0)


def _rows(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((40, 37)).astype(np.float32)
    if kind == "wide_range":
        x = rng.standard_normal((30, 19)).astype(np.float32)
        return x * np.logspace(-6, 6, 30, dtype=np.float32)[:, None]
    if kind == "zero_rows":
        x = rng.standard_normal((6, 11)).astype(np.float32)
        x[[0, 3]] = 0.0
        return x
    if kind == "sub_denormal":
        # amax below 127·F32_TINY: the scale clamps to the smallest
        # normal f32; elements below F32_TINY are denormal
        x = (rng.standard_normal((20, 8)) * 1e-36).astype(np.float32)
        x[0] = 0.0
        x[1, 3] = 1e-40                      # a lone denormal
        x[2] = (rng.standard_normal(8) * 1e-39).astype(np.float32)
        return x
    if kind == "halves":
        # x / scale lands on .5 exactly: round half to even
        x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -126.5]],
                     np.float32)
        return np.repeat(x, 3, axis=0) * np.float32(2.0) ** np.arange(
            -2, 1, dtype=np.float32)[:, None]
    raise ValueError(kind)


KINDS = ("normal", "wide_range", "zero_rows", "sub_denormal", "halves")


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_int8_bitwise(kind):
    x = _rows(kind)
    jqq, jqs = jq.quantize_int8(jnp.asarray(x))
    qq, qs = quant.quantize_int8(torch.as_tensor(x))
    np.testing.assert_array_equal(qq.numpy(), np.asarray(jqq))
    assert qq.dtype == torch.int8
    np.testing.assert_array_equal(_bits(qs.numpy()), _bits(jqs))
    deq = quant.dequantize_int8(qq, qs).numpy()
    np.testing.assert_array_equal(_bits(deq),
                                  _bits(jq.dequantize_int8(jqq, jqs)))
    zero = ~x.any(axis=1)
    assert np.all(qs.numpy()[zero] == 0.0) and np.all(deq[zero] == 0.0)


def test_quantize_int8_scalar_and_1d():
    for x in (np.float32(2.5), np.array([0.3, -7.0, 1e-3], np.float32)):
        jqq, jqs = jq.quantize_int8(jnp.asarray(x))
        qq, qs = quant.quantize_int8(torch.as_tensor(x))
        np.testing.assert_array_equal(qq.numpy(), np.asarray(jqq))
        np.testing.assert_array_equal(_bits(qs.numpy()), _bits(jqs))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_rows_side_tables(metric, kind):
    x = _rows(kind)
    jr = jq.quantize_rows(jnp.asarray(x), metric)
    r = quant.quantize_rows(torch.as_tensor(x), metric)
    np.testing.assert_array_equal(r.q.numpy(), np.asarray(jr.q))
    np.testing.assert_array_equal(_bits(r.scale.numpy()), _bits(jr.scale))
    rad, jrad = _bits(r.radius.numpy()), _bits(jr.radius)
    # XLA flushes a denormal result to zero; the port keeps it where its
    # thread does not flush (larger, so still an admissible radius).
    # Read on the bits: importing JAX may set flush-to-zero in this
    # process, which would hide a denormal from a float compare.
    tiny = rad < _bits(np.float32(quant.F32_TINY))
    assert np.all(jrad[tiny] == 0)
    np.testing.assert_array_equal(rad[~tiny], jrad[~tiny])
    assert tiny.any() == (kind in ("sub_denormal", "zero_rows"))
    js = np.asarray(jr.sq_norm)
    np.testing.assert_allclose(r.sq_norm.numpy(), js,
                               rtol=4 * x.shape[1] * U32, atol=0.0)
    for d in (3, 64):                      # the padded-width override
        got = quant.quant_row_radius(r.scale[:, 0], d, metric).numpy()
        want = np.asarray(jq.quant_row_radius(jr.scale[:, 0], d, metric))
        ok = _bits(got) >= _bits(np.float32(quant.F32_TINY))
        np.testing.assert_array_equal(_bits(got)[ok], _bits(want)[ok])


def _pair_inputs(seed: int, B: int = 23, K: int = 57, D: int = 13):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, D)) * 2).astype(np.float32)
    k = (rng.standard_normal((K, D)) * 2).astype(np.float32)
    k[:3] = q[:3] + 1e-3 * rng.standard_normal((3, D)).astype(np.float32)
    k[5] = 0.0                                      # a zero key
    return q, k


def _to_distance(lb: np.ndarray, metric: str, gamma: float) -> np.ndarray:
    d = np.asarray(lb, np.float64) ** (1.0 / gamma)
    return np.sqrt(d) if metric == "l2sq" else d


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("gamma", GAMMAS)
def test_lb_blocks_match_reference(metric, gamma):
    q, k = _pair_inputs(1)
    jlb = np.asarray(jq.lb_approx_cost_tiles(
        jnp.asarray(q), jq.quantize_rows(jnp.asarray(k), metric), metric,
        gamma))
    lb = quant.lb_approx_cost_tiles(
        torch.as_tensor(q), quant.quantize_rows(torch.as_tensor(k), metric),
        metric, gamma).numpy()
    dj, dp = _to_distance(jlb, metric, gamma), _to_distance(lb, metric,
                                                            gamma)
    if metric == "l1":
        tol = 1e-5 * dj + 1e-6
    else:
        t2 = 16 * U32 * ((q.astype(np.float64) ** 2).sum(1)[:, None]
                         + (k.astype(np.float64) ** 2).sum(1)[None, :])
        tol = t2 / (dj + np.sqrt(t2)) + 2e-6 * dj
    assert np.all(np.abs(dp - dj) <= tol), float(np.max(np.abs(dp - dj)
                                                        - tol))
    # the block entry, on dequantized rows, is the tiles entry's value
    qq, qs = quant.quantize_int8(torch.as_tensor(q))
    kq = quant.quantize_rows(torch.as_tensor(k), metric)
    blk = quant.lb_approx_cost_block(
        quant.dequantize_int8(qq, qs), quant.dequantize_int8(kq.q, kq.scale),
        quant.quant_row_radius(qs[:, 0], q.shape[1], metric), kq.radius,
        metric, gamma, k_sq=kq.sq_norm)
    np.testing.assert_array_equal(blk.numpy(), lb)


def _exact_ca64(q: np.ndarray, k: np.ndarray, metric: str,
                gamma: float) -> np.ndarray:
    diff = q.astype(np.float64)[:, None, :] - k.astype(np.float64)[None]
    if metric == "l1":
        d = np.abs(diff).sum(-1)
    else:
        d = (diff ** 2).sum(-1)
        d = d if metric == "l2sq" else np.sqrt(d)
    return d ** gamma


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("gamma", GAMMAS)
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_lb_admissible_in_f64(metric, gamma, scale):
    q, k = _pair_inputs(2)
    q, k = q * np.float32(scale), k * np.float32(scale)
    lb = quant.lb_approx_cost_tiles(
        torch.as_tensor(q), quant.quantize_rows(torch.as_tensor(k), metric),
        metric, gamma).numpy().astype(np.float64)
    exact = _exact_ca64(q, k, metric, gamma)
    assert np.all(lb <= exact), float(np.max(lb - exact))
    assert np.all(lb >= 0.0)
    # and it is a useful bound: far pairs keep most of their distance
    far = exact > np.quantile(exact, 0.5)
    assert np.median(lb[far] / exact[far]) > 0.5


def test_lb_admissible_on_duplicate_and_padded_rows():
    """Zero padding of the feature axis quantizes exactly (error 0), so a
    padded-width radius keeps the bound admissible; a key equal to its
    query bounds at 0."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((9, 5)).astype(np.float32)
    qp = np.concatenate([q, np.zeros((9, 3), np.float32)], axis=1)
    kq = quant.quantize_rows(torch.as_tensor(qp), "l2", dim=5)
    lb = quant.lb_approx_cost_tiles(torch.as_tensor(qp), kq, "l2", 1.0,
                                    dim=5).numpy()
    assert np.all(np.diag(lb) == 0.0)
    assert np.all(lb <= _exact_ca64(qp, qp, "l2", 1.0) + 0.0)
