"""The port's NumPy building blocks — catalog, demand, topology — are
byte-equal to the reference's on seeded inputs (they are copies, so any
difference is a porting fault, not rounding)."""
import numpy as np
import pytest

from repro.core import catalog as jcat
from repro.core import demand as jdem
from repro.core import topology as jtop
from repro_torch.core import catalog, demand, topology


def _eq(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("radial", ["decreasing", "uniform_ball"])
def test_embedding_catalog_byte_equal(radial):
    a = jcat.embedding_catalog(n=300, dim=12, seed=5, radial=radial)
    b = catalog.embedding_catalog(n=300, dim=12, seed=5, radial=radial)
    _eq(a.coords, b.coords)
    assert (a.metric, a.gamma, a.name) == (b.metric, b.gamma, b.name)


def test_grid_catalog_byte_equal():
    _eq(jcat.grid(L=9).coords, catalog.grid(L=9).coords)


@pytest.mark.parametrize("make", [
    lambda m, c: m.zipf(c, alpha=0.8, n_ingress=3, seed=2),
    lambda m, c: m.uniform(c, n_ingress=2),
    lambda m, c: m.gaussian_grid(c, sigma=2.5, n_ingress=2,
                                 betas=np.array([1.0, 3.0]))])
def test_demand_byte_equal_and_sample(make):
    cj, ct = jcat.grid(L=7), catalog.grid(L=7)
    a, b = make(jdem, cj), make(demand, ct)
    _eq(a.lam, b.lam)
    _eq(a._cdf, b._cdf)
    ra, rb = np.random.default_rng(11), np.random.default_rng(11)
    for n in (1, 17, 400):
        oa, ia = a.sample(n, ra)
        ob, ib = b.sample(n, rb)
        _eq(oa, ob)
        _eq(ia, ib)


def test_from_trace_byte_equal_and_validates():
    ids = np.array([3, 3, 1, 0, 7])
    ing = np.array([0, 1, 1, 0, 1])
    _eq(jdem.from_trace(8, ids, ing, 2).lam,
        demand.from_trace(8, ids, ing, 2).lam)
    with pytest.raises(ValueError):
        demand.from_trace(8, np.array([], np.int64), np.array([], np.int64))


@pytest.mark.parametrize("build", [
    lambda m: m.chain(4, 3, 2.0, 50.0),
    lambda m: m.tandem(3, 4, 2.0, 10.0),
    lambda m: m.tandem_both(3, 4, 2.0, 10.0),
    lambda m: m.equi_depth_tree(2, 2, [2, 3, 4], [0.0, 5.0, 9.0], 40.0),
    lambda m: m.single_cache(5, 9.0),
    lambda m: m.tpu_hierarchy(64, 128, 256, 15.0, 150.0, 1000.0)])
def test_topology_byte_equal(build):
    a, b = build(jtop), build(topology)
    assert (a.n_caches, a.name) == (b.n_caches, b.name)
    for f in ("capacities", "ingress", "H", "h_repo"):
        _eq(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
    _eq(a.slot_layout(), b.slot_layout())
