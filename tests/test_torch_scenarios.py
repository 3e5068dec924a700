"""The port's scenario plane (``repro_torch.core.scenarios``) against the
JAX reference's, on the CPU. Mirrors tests/test_scenarios.py.

The module is NumPy only and copied line for line, so everything is held
bitwise: the generated graphs, the metric closure, the routes, the
centralities, the budget split and every array of the emitted network
(``H``, ``h_repo``, ``capacities``, ``cache_nodes``, ``ingress_nodes``,
``paths``, ``dist``). Downstream, the port's warm-start classifier must
fall through on the general graphs and find the chain of a
single-ingress scenario, and the port's device GREEDY (kernel C's plain
version here) must pick the reference host GREEDY's allocation on a
generated scale-free instance, exactly.
"""
import numpy as np
import pytest

from repro.core import catalog as jcatalog
from repro.core import demand as jdemand
from repro.core import scenarios as jscenarios
from repro.core.objective import Instance as JInstance
from repro.core.placement import greedy as jgreedy
from repro_torch.core import catalog as catalog_api
from repro_torch.core import demand as demand_api
from repro_torch.core import scenarios, topology
from repro_torch.core.objective import DeviceInstance, Instance
from repro_torch.core.placement import device_greedy, warmstart

FAMILIES = sorted(scenarios.GENERATORS)


def test_registries_are_the_references():
    assert sorted(scenarios.GENERATORS) == sorted(jscenarios.GENERATORS)
    assert sorted(scenarios.CENTRALITIES) == \
        sorted(jscenarios.CENTRALITIES)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_graphs_closures_and_routes_bitwise(family, seed):
    g = scenarios.GENERATORS[family](seed=seed)
    jg = jscenarios.GENERATORS[family](seed=seed)
    assert g.name == jg.name
    np.testing.assert_array_equal(g.adj, jg.adj)
    np.testing.assert_array_equal(g.degrees(), jg.degrees())
    dist = scenarios.floyd_warshall(g.adj)
    np.testing.assert_array_equal(dist, jscenarios.floyd_warshall(jg.adj))
    rows = np.array([0, 3, 5])
    for method in ("fw", "dijkstra", "auto"):
        np.testing.assert_array_equal(
            scenarios.shortest_paths(g.adj, rows, method=method),
            jscenarios.shortest_paths(jg.adj, rows, method=method))
    np.testing.assert_array_equal(
        scenarios.batched_dijkstra(g.adj, np.arange(g.n_nodes)),
        jscenarios.batched_dijkstra(jg.adj, np.arange(jg.n_nodes)))
    dst = int(np.argmax(g.degrees()))
    for src in range(0, g.n_nodes, 5):
        assert scenarios.route(g.adj, dist[:, dst], src, dst) == \
            jscenarios.route(jg.adj, dist[:, dst], src, dst)
    np.testing.assert_array_equal(scenarios.degree_centrality(g),
                                  jscenarios.degree_centrality(jg))
    np.testing.assert_array_equal(scenarios.betweenness_centrality(g),
                                  jscenarios.betweenness_centrality(jg))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("placement", sorted(scenarios.CENTRALITIES))
def test_generated_network_bitwise(family, placement):
    """Every array of the emitted network and scenario is the
    reference's, and the reference suite's routing-constraint invariants
    hold on the port's copy."""
    sc = scenarios.scenario(family, cache_budget=40, placement=placement,
                            n_ingress=5, seed=4)
    jsc = jscenarios.scenario(family, cache_budget=40, placement=placement,
                              n_ingress=5, seed=4)
    assert isinstance(sc.net, topology.CacheNetwork)
    net, jnet = sc.net, jsc.net
    assert (net.name, net.n_caches, net.n_ingress, sc.name, sc.repo_node,
            sc.placement) == (jnet.name, jnet.n_caches, jnet.n_ingress,
                              jsc.name, jsc.repo_node, jsc.placement)
    for a, b in ((net.H, jnet.H), (net.h_repo, jnet.h_repo),
                 (net.capacities, jnet.capacities),
                 (net.ingress, jnet.ingress),
                 (sc.cache_nodes, jsc.cache_nodes),
                 (sc.ingress_nodes, jsc.ingress_nodes),
                 (sc.dist, jsc.dist), (sc.graph.adj, jsc.graph.adj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert sc.paths == jsc.paths
    np.testing.assert_array_equal(net.slot_layout(), jnet.slot_layout())
    assert net.total_slots == 40
    node_of = {j: int(v) for j, v in enumerate(sc.cache_nodes)}
    for i, p in enumerate(sc.paths):
        assert p[0] == sc.ingress_nodes[i] and p[-1] == sc.repo_node
        on_path = {int(v) for v in p}
        for j in range(net.n_caches):
            assert np.isfinite(net.H[i, j]) == (node_of[j] in on_path)
        assert np.all(net.H[i][np.isfinite(net.H[i])]
                      <= net.h_repo[i] + 1e-6)


@pytest.mark.parametrize("scores,budget", [
    ([4.0, 2.0, 1.0, 1.0], 16), ([0.0, 0.0, 0.0], 7), ([1.0] * 5, 0),
    ([3.0, 1e-9, 2.5, 2.5, 0.0], 11), ([0.3, 0.3, 0.4], 1)])
def test_assign_budget_bitwise(scores, budget):
    caps = scenarios.assign_budget(np.array(scores), budget)
    jcaps = jscenarios.assign_budget(np.array(scores), budget)
    assert caps.dtype == jcaps.dtype
    np.testing.assert_array_equal(caps, jcaps)
    assert caps.sum() == budget


def test_assign_budget_exact_and_proportional():
    caps = scenarios.assign_budget(np.array([4.0, 2.0, 1.0, 1.0]), 16)
    assert caps.sum() == 16 and caps[0] == 8 and caps[1] == 4
    caps = scenarios.assign_budget(np.zeros(3), 7)   # uniform fallback
    assert caps.sum() == 7 and caps.max() - caps.min() <= 1


def test_build_scenario_explicit_nodes_and_errors():
    g = scenarios.isp_like(seed=3)
    jg = jscenarios.isp_like(seed=3)
    kw = dict(cache_budget=30, placement="uniform", repo_node=0,
              ingress_nodes=np.array([30, 31, 40]))
    sc = scenarios.build_scenario(g, **kw)
    jsc = jscenarios.build_scenario(jg, **kw)
    np.testing.assert_array_equal(sc.net.H, jsc.net.H)
    assert sc.paths == jsc.paths
    with pytest.raises(ValueError, match="unknown placement"):
        scenarios.build_scenario(g, 10, placement="pagerank")
    with pytest.raises(ValueError, match="cannot also be an ingress"):
        scenarios.build_scenario(g, 10, repo_node=30,
                                 ingress_nodes=np.array([30]))
    with pytest.raises(ValueError, match="unknown family"):
        scenarios.scenario("ring")


@pytest.mark.parametrize("family", FAMILIES)
def test_classify_topology_none_on_general_graphs(family):
    sc = scenarios.scenario(family, cache_budget=40, placement="degree",
                            n_ingress=5, seed=0)
    assert warmstart.classify_topology(sc.net) is None


def test_classify_topology_single_ingress_scenario_is_chain():
    sc = scenarios.scenario("isp", cache_budget=24, placement="degree",
                            n_ingress=1, seed=0)
    red = warmstart.classify_topology(sc.net)
    assert isinstance(red, warmstart.ChainReduction)
    assert np.all(np.diff(np.asarray(red.spec.hs)) >= 0)


def scale_free_instances(seed=7, n=160, dim=5):
    """The reference suite's ``scale_free_instance``, built twice: the
    port's Instance and the reference's, on byte-equal inputs."""
    out = []
    for sc_api, cat_api, dem_api, inst_cls in (
            (scenarios, catalog_api, demand_api, Instance),
            (jscenarios, jcatalog, jdemand, JInstance)):
        sc = sc_api.scenario("scale_free", cache_budget=30,
                             placement="betweenness", n_ingress=4,
                             seed=seed)
        cat = cat_api.embedding_catalog(n=n, dim=dim, seed=seed)
        dem = dem_api.zipf(cat, alpha=0.9, n_ingress=sc.net.n_ingress,
                           seed=seed + 1)
        out.append(inst_cls(net=sc.net, cat=cat, dem=dem))
    return out


@pytest.mark.parametrize("seed", [7, 9])
def test_device_greedy_matches_reference_host_greedy(seed):
    inst, jinst = scale_free_instances(seed=seed)
    np.testing.assert_array_equal(inst.lam, jinst.lam)
    host = jgreedy(jinst)
    for materialize in (False, True):
        dinst = DeviceInstance.from_instance(
            inst, materialize_ca=materialize, device="cpu")
        np.testing.assert_array_equal(device_greedy(dinst), host)
    slots = np.where(host < 0, 0, host)
    empty = np.zeros_like(slots)
    assert inst.total_cost(slots) < inst.total_cost(empty)
