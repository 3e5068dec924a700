"""The port's GREEDY gain entry (``greedy_gain``, kernel D's wrapper)
against the JAX reference, on the CPU.

Mirrors tests/test_kernels_gain.py: the same shapes and seeds, the
reference's Pallas kernel run in interpret mode and its ``gain_ref``,
the port's ``greedy_gain`` on CPU tensors (its plain version,
``gain_ref``, blocked over requests). Kernel D itself is held against
``gain_ref`` and against kernel C on the card in tests/test_torch_gpu.py.

Tolerances: 5e-5 relative and absolute, the reference's own between its
kernel and its oracle (the same f32 terms summed over requests in
another order); 1e-4 relative against the host f64 objective, as the
reference. Against the port's own ``placement_gains`` (kernel C's entry)
at I = 1, 1e-5 relative: the same f32 terms, folded in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.gain import gain_ref as jgain_ref
from repro.kernels.gain import greedy_gain as jgreedy_gain
from repro_torch.core import catalog, demand, topology
from repro_torch.core.objective import Instance
from repro_torch.kernels.gain import gain_cuda, gain_ref, greedy_gain
from repro_torch.kernels.gain import ref as gain_ref_mod
from repro_torch.kernels.knn import placement_gains


def _inputs(rng, R, O, D, J, spread=1.0):
    x = (rng.standard_normal((R, D)) * spread).astype(np.float32)
    y = (rng.standard_normal((O, D)) * spread).astype(np.float32)
    lam = rng.random(R).astype(np.float32)
    cur = (rng.random(R) * 4 * spread).astype(np.float32)
    h = rng.random((R, J)).astype(np.float32)
    return x, y, lam, cur, h


def _port(*arrs, **kw):
    return greedy_gain(*(torch.as_tensor(a) for a in arrs), **kw).numpy()


@pytest.mark.parametrize("shape", [
    (1, 1, 2, 1), (100, 50, 4, 2), (300, 300, 64, 3), (33, 17, 2, 5),
    (256, 512, 128, 2),
])
@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
def test_gain_matches_reference(shape, metric):
    R, O, D, J = shape
    rng = np.random.default_rng(R + O)
    x, y, lam, cur, h = _inputs(rng, R, O, D, J)
    h[0, 0] = np.inf                      # off-path entry
    ref = jgreedy_gain(*(jnp.asarray(a) for a in (x, y, lam, cur, h)),
                       metric=metric)
    got = _port(x, y, lam, cur, h, metric=metric)
    assert got.shape == (O, J) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(ref), rtol=5e-5, atol=5e-5)
    oracle = jgain_ref(*(jnp.asarray(a) for a in (x, y, lam, cur)),
                       jnp.asarray(np.where(np.isfinite(h), h, 1e30)),
                       metric)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=5e-5,
                               atol=5e-5)


@pytest.mark.parametrize("metric,gamma", [("l2", 0.5), ("l1", 2.0),
                                          ("l2sq", 0.7)])
def test_gain_power_law_matches_reference(metric, gamma):
    rng = np.random.default_rng(11)
    x, y, lam, cur, h = _inputs(rng, 70, 45, 6, 3, spread=0.5)
    ref = jgreedy_gain(*(jnp.asarray(a) for a in (x, y, lam, cur, h)),
                       metric=metric, gamma=gamma)
    got = _port(x, y, lam, cur, h, metric=metric, gamma=gamma)
    assert np.asarray(ref).max() > 0      # the case has gains to compare
    np.testing.assert_allclose(got, np.asarray(ref), rtol=5e-5, atol=5e-5)


def test_off_path_rows_give_zero_gain():
    """Whole ``inf`` rows of H (requests whose ingress reaches no cache)
    and ``inf`` columns (a cache off every path) contribute nothing."""
    rng = np.random.default_rng(4)
    x, y, lam, cur, h = _inputs(rng, 40, 30, 5, 3)
    h[::3] = np.inf
    h[:, 2] = np.inf
    ref = jgreedy_gain(*(jnp.asarray(a) for a in (x, y, lam, cur, h)))
    got = _port(x, y, lam, cur, h)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=5e-5, atol=5e-5)
    assert np.all(got[:, 2] == 0.0)
    keep = np.isfinite(h[:, 0])
    alone = _port(x[keep], y, lam[keep], cur[keep], h[keep])
    np.testing.assert_allclose(got[:, :2], alone[:, :2], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("R,O", [(257, 129), (1000, 37), (5, 300)])
def test_ragged_shapes_and_request_blocks(R, O, monkeypatch):
    """R and O that are multiples of no tile, and the plain version's
    request blocking (forced small here) summing to the same gains."""
    rng = np.random.default_rng(R * 3 + O)
    x, y, lam, cur, h = _inputs(rng, R, O, 7, 2)
    ref = np.asarray(jgreedy_gain(*(jnp.asarray(a) for a in
                                    (x, y, lam, cur, h))))
    whole = _port(x, y, lam, cur, h)
    monkeypatch.setattr(gain_ref_mod, "_BLOCK_ELEMS", 2 * O * 2 + 1)
    blocked = _port(x, y, lam, cur, h)
    for got in (whole, blocked):
        np.testing.assert_allclose(got, ref, rtol=5e-5, atol=5e-5)


def test_gain_agrees_with_objective_reference():
    """greedy_gain == the host f64 Instance.add_gain_all on the grid
    instance of the reference's test."""
    cat = catalog.grid(L=8)
    net = topology.tandem(k_leaf=3, k_parent=3, h=2.0, h_repo=10.0)
    dem = demand.gaussian_grid(cat, sigma=2.0)
    inst = Instance(net=net, cat=cat, dem=dem)
    cur = np.repeat(inst.net.h_repo[:, None], cat.n, axis=1)
    ref = inst.add_gain_all(cur)
    hreq = np.broadcast_to(inst.net.H[0], (cat.n, 2)).copy()
    got = _port(cat.coords, cat.coords, inst.lam[0].astype(np.float32),
                cur[0].astype(np.float32), hreq, metric="l1", gamma=1.0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_equal_rows_match_placement_gains(metric):
    """With every H row equal, D's function is C's at I = 1."""
    rng = np.random.default_rng(8)
    x, y, lam, cur, _ = _inputs(rng, 150, 90, 12, 3)
    hrow = np.array([[0.0, 0.4, np.inf]], np.float32)
    got = _port(x, y, lam, cur, np.repeat(hrow, 150, axis=0), metric=metric)
    c = placement_gains(*(torch.as_tensor(a) for a in
                          (x, y, lam[None], cur[None], hrow)),
                        metric=metric).numpy()
    np.testing.assert_allclose(got, c, rtol=1e-5, atol=1e-6)


def test_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    args = [torch.as_tensor(a) for a in _inputs(rng, 20, 10, 3, 2)]
    n0 = gain_cuda.launches
    np.testing.assert_array_equal(greedy_gain(*args).numpy(),
                                  gain_ref(*args).numpy())
    assert gain_cuda.launches == n0          # no kernel ran


@settings(max_examples=15, deadline=None)
@given(r=st.integers(1, 60), o=st.integers(1, 60), d=st.integers(1, 20),
       j=st.integers(1, 4))
def test_gain_property_sweep(r, o, d, j):
    rng = np.random.default_rng(r * 7919 + o * 31 + d)
    x = rng.uniform(-3, 3, (r, d)).astype(np.float32)
    y = rng.uniform(-3, 3, (o, d)).astype(np.float32)
    lam = rng.random(r).astype(np.float32)
    cur = (rng.random(r) * 3).astype(np.float32)
    h = rng.random((r, j)).astype(np.float32)
    ref = jgreedy_gain(*(jnp.asarray(a) for a in (x, y, lam, cur, h)),
                       metric="l1", br=32, bo=32)
    got = _port(x, y, lam, cur, h, metric="l1", br=32, bo=32)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=5e-5, atol=5e-5)
    assert np.all(got >= 0.0)             # gains are relu-clamped
