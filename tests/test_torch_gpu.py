"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) when no CUDA
device is available. Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of the CPU differentials (tests/test_torch_lookup.py
and tests/test_torch_gains.py): the kernels and the plain versions sum in
different orders, so values agree to the matmul-form bound and indices
agree wherever the plain version's decision is not a near-tie.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import catalog, costs, demand, topology
from repro_torch.core.objective import DeviceInstance, Instance
from repro_torch.core.placement import device_greedy, greedy
from repro_torch.kernels.knn import gains as G
from repro_torch.kernels.knn.knn import fused_lookup_cuda, knn_cuda
from repro_torch.kernels.knn.ref import (_dense_ca, fused_lookup_ref,
                                         knn_ref)

pytestmark = pytest.mark.gpu
U32 = 2.0 ** -24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tol(q, k, d, metric):
    if metric == "l1":
        return 1e-5 * d.abs() + 1e-5
    t2 = 16 * U32 * ((q * q).sum(1) + (k * k).sum(1).max())
    return (t2 if metric == "l2sq" else t2 / (d + t2.sqrt())) + 1e-5


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (7, 3, 2), (9, 130, 37),
                                   (300, 1000, 100), (64, 129, 3)])
@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_knn_kernel_matches_plain(cuda, metric, shape, gamma):
    Q, K, D = shape
    g = torch.Generator().manual_seed(Q * 7 + K)
    q = (torch.randn(Q, D, generator=g) * 3).to(cuda)
    k = (torch.randn(K, D, generator=g) * 3).to(cuda)
    n0 = knn_cuda.launches
    c, i = knn_cuda(q, k, metric, gamma)
    cp, ip = knn_ref(q, k, metric, gamma)
    torch.cuda.synchronize()
    assert knn_cuda.launches == n0 + 1
    tol = _tol(q, k, cp ** (1 / gamma), metric)
    assert bool(((c - cp).abs() <= tol * max(1.0, 1 / gamma)).all())
    full = _dense_ca(q, k, metric, gamma)
    rows = torch.nonzero(i != ip).reshape(-1)
    assert bool((full[rows, i[rows].long()] - cp[rows]
                 <= 2 * tol[rows]).all())


def test_knn_kernel_ties_to_lowest_index(cuda):
    q = torch.zeros((5, 40), device=cuda)
    k = torch.zeros((300, 40), device=cuda)
    _, i = knn_cuda(q, k, "l2")
    assert int(i.max()) == 0


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
@pytest.mark.parametrize("fold_repo", [True, False])
def test_fused_kernel_matches_plain(cuda, metric, fold_repo):
    g = torch.Generator().manual_seed(3)
    Q, K, D = 77, 530, 19
    q = (torch.randn(Q, D, generator=g) * 2).to(cuda)
    k = (torch.randn(K, D, generator=g) * 2).to(cuda)
    k[7] = 1e15                                     # a sentinel key
    h = (torch.rand(K, generator=g) * 2).to(cuda)
    valid = (torch.arange(K) % 11 != 7).int()
    meta = torch.stack([torch.arange(K) % 3, torch.arange(K),
                        torch.where(valid > 0, torch.arange(K), -1),
                        valid]).int().to(cuda)
    kw = dict(metric=metric, gamma=1.0, h_repo=4.0, repo_level=-1,
              fold_repo=fold_repo)
    got = fused_lookup_cuda(q, k, h, meta, **kw)
    ref = fused_lookup_ref(q, k, h, meta, **kw)
    torch.cuda.synchronize()
    tol = _tol(q, k[1:], ref[1], metric)
    assert bool(((got[0] - ref[0]).abs() <= tol).all())
    same = got[4] == ref[4]
    assert float(same.float().mean()) > 0.95
    for a, b in zip(got[2:4], ref[2:4]):
        assert torch.equal(a[same], b[same])
    # all keys invalid: the repository (or +INF without the fold)
    meta0 = meta.clone()
    meta0[3] = 0
    z = fused_lookup_cuda(q, k, h, meta0, **kw)
    zr = fused_lookup_ref(q, k, h, meta0, **kw)
    for a, b in zip(z, zr):
        assert torch.equal(a, b)


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("I,J", [(1, 1), (2, 3), (3, 8)])
def test_gains_kernel_matches_plain(cuda, metric, I, J):
    g = torch.Generator().manual_seed(I * 10 + J)
    R, O, D = 333, 257, 13
    x = torch.randn(R, D, generator=g).to(cuda)
    y = torch.randn(O, D, generator=g).to(cuda)
    lam = torch.rand(I, R, generator=g).to(cuda)
    cur = (torch.rand(I, R, generator=g) * 6).to(cuda)
    H = torch.rand(I, J, generator=g).to(cuda)
    H[-1, 0] = G.H_SENTINEL
    got = G.gains_cuda(x, y, lam, cur, H, metric)
    ref = G._gains_tiles(x, y, lam, cur, H, metric, 1.0).T
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=5e-5, atol=5e-4)


def test_stable_form_bitwise_across_shapes(cuda):
    """Shape-stable on the card; against the CPU it agrees to rounding
    (1e-5 relative: a 100-term f32 sum), not bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(500, 100, generator=g) * 200
    y = torch.randn(64, 100, generator=g) * 200
    full = costs.pairwise_distance_stable(x.to(cuda), y.to(cuda), "l2")
    torch.testing.assert_close(full.cpu(), costs.pairwise_distance_stable(
        x, y, "l2"), rtol=1e-5, atol=0.0)
    col = costs.pairwise_distance_stable(x.to(cuda), y[9:10].to(cuda), "l2")
    assert torch.equal(col, full[:, 9:10])


def test_device_greedy_on_card_matches_host(cuda):
    cat = catalog.embedding_catalog(n=600, dim=16, seed=1)
    net = topology.tandem(k_leaf=12, k_parent=20, h=50.0, h_repo=400.0)
    inst = Instance(net=net, cat=cat, dem=demand.zipf(cat, alpha=0.8,
                                                      seed=2))
    d = DeviceInstance.from_instance(inst, materialize_ca=False)
    n0 = G.gains_cuda.launches
    np.testing.assert_array_equal(device_greedy(d), greedy(inst))
    assert G.gains_cuda.launches == n0 + 1
