"""The NETDUEL re-arm's plain version against the JAX reference, on the
CPU.

``duel_rearm_ref`` (kernels/duel/duel.py, the plain version of kernel
F's second entry) is held bitwise against

* the reference's ``rearm`` closure of ``_duel_scan``
  (``repro/core/placement/netduel.py:254``): ``_best_two_delta_jit`` over
  the promoted slots padded to ``PROMOTE_CAP`` (or ``best_two_tables``
  past it), then ``_fold_repo_rows``;
* the port's full rebuild (``_best_two_rows_pre`` on the new layout)
  folded by ``fold_best_two``.

The cases (tests/rearm_cases.py): 1, 3, 8 and 9 promoted slots and more
dirty rows than ``default_delta_cap``, on a layout with an empty slot,
two slots holding one object and an ingress off the path of a cache;
materialized C_a on and off; l1, l2 and l2sq; γ 1, 0.5, 2 and 1.7. The
reference gets the port's inputs, indices as int32. Materialized, both
get one explicit C_a matrix. Streamed, each package computes C_a in its
own shape-stable form, and those agree to rounding only (JAX sums the
feature axis with ``jnp.sum`` and its CPU sqrt and pow are not torch's;
tests/test_torch_netduel.py), so the reference's re-arm runs on the
port's canonical C_a passed as its explicit matrix; where the integer
coordinates make C_a exact in both (l1 and l2sq at γ 1 and 2) the
reference's own streamed re-arm is held bitwise as well.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rearm_cases import CASES, dirty_rows, rearm_args, rearm_case
from repro.core.objective import _best_two_delta_jit, _fold_repo_rows
from repro.core.objective import best_two_tables as jbest_two_tables
from repro.core.objective import default_delta_cap as jdefault_delta_cap
from repro.core.placement.netduel import PROMOTE_CAP as JPROMOTE_CAP
from repro_torch.core import costs
from repro_torch.core.objective import (_best_two_rows_pre,
                                        default_delta_cap, fold_best_two)
from repro_torch.kernels.duel import (PROMOTE_CAP, duel_rearm_cuda,
                                      duel_rearm_ref)

METRICS = ("l1", "l2", "l2sq")
GAMMAS = (1.0, 0.5, 2.0, 1.7)


def jax_rearm(c: dict, ca, has_ca: bool) -> list:
    """The reference's re-arm on the case's inputs (``ca`` the explicit
    C_a matrix the reference reads with ``has_ca``)."""
    pre = c["pre"]
    K = c["slot_cache"].shape[0]
    coords = jnp.asarray(c["coords"].numpy())
    ca = None if ca is None else jnp.asarray(ca.numpy())
    i32 = lambda t: jnp.asarray(t.numpy().astype(np.int32))  # noqa: E731
    slots_new, slot_cache = i32(c["slots_new"]), i32(c["slot_cache"])
    H = jnp.asarray(c["H"].numpy())
    kw = dict(metric=c["metric"], gamma=c["gamma"], has_ca=has_ca)
    ys = np.nonzero(c["promote"].numpy())[0]
    if len(ys) > JPROMOTE_CAP:
        npre = jbest_two_tables(coords, ca, slots_new, slot_cache, H, **kw)
    else:
        ys = np.r_[ys, np.full(JPROMOTE_CAP - len(ys), K)].astype(np.int32)
        n = coords.shape[0]
        npre = _best_two_delta_jit(
            coords, ca, jnp.asarray(pre[0].numpy()), i32(pre[1]),
            jnp.asarray(pre[2].numpy()), i32(pre[3]), slots_new,
            jnp.asarray(ys), slot_cache, H, **kw,
            cap=min(jdefault_delta_cap(n), n), n_slots=K)
    out = (*npre, *_fold_repo_rows(npre[0], npre[1], npre[2],
                                   jnp.asarray(c["h_repo"].numpy())))
    return [np.asarray(t) for t in out]


def port_rebuild(c: dict) -> list:
    """The port's full rebuild on the new layout, folded."""
    coords, ca, new = c["coords"], c["ca"], c["slots_new"]
    has_ca = ca is not None
    npre = _best_two_rows_pre(ca if has_ca else coords,
                              None if has_ca else coords[new.clamp_min(0)],
                              new, c["slot_cache"], c["H"], c["metric"],
                              c["gamma"], has_ca)
    return [t.numpy() for t in (*npre, *fold_best_two(
        npre[0], npre[1], npre[2], c["h_repo"]))]


def assert_tables_bitwise(got, want, what):
    names = ("b1", "a1", "b2", "a2", "best1", "arg1", "best2")
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype.kind == "f":
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          f"{what}: {name}")
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64),
                                          f"{what}: {name}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("materialize", [True, False])
@pytest.mark.parametrize("gamma", GAMMAS)
@pytest.mark.parametrize("metric", METRICS)
def test_rearm_plain_matches_reference_and_rebuild(metric, gamma,
                                                   materialize, case):
    c = rearm_case(metric, gamma, materialize, case)
    n_prom = len(c["ys"])
    cap = default_delta_cap(c["coords"].shape[0])
    assert cap == jdefault_delta_cap(c["coords"].shape[0])
    assert PROMOTE_CAP == JPROMOTE_CAP
    # the case covers what it names
    if case == "dirty":
        assert dirty_rows(c) > cap and n_prom <= PROMOTE_CAP
    elif case == "9":
        assert n_prom == 9 > PROMOTE_CAP
    else:
        assert n_prom == int(case) and 0 < dirty_rows(c) <= cap
    got = [t.numpy() for t in duel_rearm_ref(*rearm_args(c))]
    assert_tables_bitwise(got, port_rebuild(c), "port rebuild")
    # on CPU tensors the kernel's wrapper is its plain version
    n0 = duel_rearm_cuda.launches
    again = [t.numpy() for t in duel_rearm_cuda(*rearm_args(c))]
    assert duel_rearm_cuda.launches == n0
    assert_tables_bitwise(again, got, "wrapper on the CPU")
    if materialize:
        assert_tables_bitwise(got, jax_rearm(c, c["ca"], True),
                              "reference, materialized")
        return
    canonical = costs.approx_cost_stable(c["coords"], c["coords"], metric,
                                         gamma)
    assert_tables_bitwise(got, jax_rearm(c, canonical, True),
                          "reference on the port's C_a")
    if metric != "l2" and gamma in (1.0, 2.0):
        assert_tables_bitwise(got, jax_rearm(c, None, False),
                              "reference, streamed")


def test_rearm_inputs_untouched():
    """The re-arm returns new tensors and leaves its inputs as they
    were (the caller's carry keeps its tables)."""
    c = rearm_case("l2", 1.0, False, "3")
    before = [t.clone() for t in (*c["pre"], c["slots_new"], c["promote"])]
    out = duel_rearm_ref(*rearm_args(c))
    for a, b in zip(before, (*c["pre"], c["slots_new"], c["promote"])):
        assert torch.equal(a, b)
    assert all(o.data_ptr() != p.data_ptr() for o in out for p in c["pre"])


@pytest.mark.parametrize("n_shards", [1, 2])
def test_rearm_routes_on_shard_count(monkeypatch, n_shards):
    """``_rearm(kernel=True)`` sends every instance to kernel F's second
    entry, sharded or not (the sharded tables are bitwise the unsharded
    ones, so the re-arm needs no mesh), and ``kernel=False`` to the plain
    version, with no mesh either."""
    import importlib

    from repro_torch.core import catalog, demand, topology
    from repro_torch.core.objective import DeviceInstance, Instance
    from repro_torch.launch.mesh import make_lookup_mesh
    nd = importlib.import_module("repro_torch.core.placement.netduel")
    rng = np.random.default_rng(3)
    cat = catalog.Catalog(coords=rng.uniform(0, 4, (40, 2)).astype(
        np.float32), metric="l1", gamma=1.0)
    lam = rng.random((1, 40)) + 0.05
    inst = Instance(net=topology.tandem(k_leaf=4, k_parent=4, h=0.5,
                                        h_repo=3.0),
                    cat=cat, dem=demand.Demand(lam=lam / lam.sum()))
    d = DeviceInstance.from_instance(inst, mesh=make_lookup_mesh(n_shards),
                                     axes=("data",), device="cpu")
    assert d.n_shards == n_shards
    carry = nd._duel_carry(d, np.arange(8))
    promote = torch.zeros(8, dtype=torch.bool)
    promote[3] = True
    slots_new = carry.slots.clone()
    slots_new[3] = 20
    calls = []
    monkeypatch.setattr(nd, "duel_rearm_cuda",
                        lambda *a, **kw: calls.append(("kernel", kw)))
    monkeypatch.setattr(nd, "duel_rearm_ref",
                        lambda *a, **kw: calls.append(("plain", kw)))
    for kernel in (True, False):
        nd._rearm(d, slots_new, promote, tuple(carry[1:5]),
                  incremental=True, kernel=kernel)
    assert calls == [("kernel", {}), ("plain", {})]
