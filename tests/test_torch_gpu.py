"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) when no CUDA
device is available. Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of the CPU differentials (tests/test_torch_lookup.py,
tests/test_torch_gains.py, tests/test_torch_gain_kernel.py and
tests/test_torch_flash.py): the kernels and the plain versions sum in
different orders, so values agree to the matmul-form bound and indices
agree wherever the plain version's decision is not a near-tie. Kernel E
is held to the reference's flash tolerances (3e-5 in f32: an online and
an offline f32 softmax; 2e-2 in bf16: one rounding of the output). Its
bf16 path (the tensor cores, with p rounded to bf16 before the PV
product) is also held to the bound derived from that rounding,
2^-7·|ref| + 2^-7·flash_ref(q, k, |v|) + 1e-4, and to its plain
counterpart step for step, ``flash_blocked``, within one bf16 output step
plus the slack of a p known to 2^-13 (tests/test_torch_flash_tc.py).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import catalog, costs, demand, topology
from repro_torch.core.objective import DeviceInstance, Instance
from repro_torch.core.placement import device_greedy, device_netduel, greedy
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_blocked, flash_cuda,
                                                 flash_ref)
from repro_torch.kernels.flash_attention.ref import P_REL
from repro_torch.kernels.gain import gain_cuda, gain_ref, greedy_gain
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
                                   (300, 1000, 100), (64, 129, 3),
                                   (300, 20_000, 100)])
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
@pytest.mark.parametrize("shape", [(77, 530, 19), (300, 24_000, 100)])
def test_fused_kernel_matches_plain(cuda, metric, fold_repo, shape):
    g = torch.Generator().manual_seed(3)
    Q, K, D = shape
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
    n0 = fused_lookup_cuda.launches
    got = fused_lookup_cuda(q, k, h, meta, **kw)
    ref = fused_lookup_ref(q, k, h, meta, **kw)
    torch.cuda.synchronize()
    assert fused_lookup_cuda.launches == n0 + 1
    tol = _tol(q, k[valid.to(cuda) > 0], ref[1], metric)
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


def _segmented(cuda, Q, K, D, seed):
    """Catalog-like queries and a three-level key tensor (h 0 / 15 / 150,
    payload = concatenated index, every key valid) on the card."""
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(Q, D, generator=g) * 3).to(cuda)
    k = (torch.randn(K, D, generator=g) * 3).to(cuda)
    lvl = torch.zeros(K, dtype=torch.int32)
    lvl[K // 7:] = 1
    lvl[3 * K // 7:] = 2
    h = torch.tensor([0.0, 15.0, 150.0])[lvl.long()]
    slot = torch.arange(K, dtype=torch.int32)
    meta = torch.stack([lvl, slot, slot, torch.ones(K, dtype=torch.int32)])
    return q, k, h.to(cuda), meta.to(cuda)


def _splits(Q, K, D):
    """Key ranges of the plan the wrappers take on this card."""
    from repro_torch.kernels.knn.knn import _sm_count, _split_plan
    return _split_plan(Q, K, D, _sm_count(torch.device("cuda"))).ranges()


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bitwise(a, b):
    for x, y in zip(a, b):
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
@pytest.mark.parametrize("K", [448, 65_536])
def test_lookup_kernels_bitwise_independent_of_batch(cuda, metric, K):
    """A row's outputs do not depend on the batch around it: Q 1, 8 and
    256 take different query tiles and split plans, and give the same
    bits in every output of kernels A and B."""
    q, k, h, meta = _segmented(cuda, 256, K, 100, K)
    kw = dict(metric=metric, h_repo=100.0, repo_level=-1)
    full_a = fused_lookup_cuda(q, k, h, meta, **kw)
    full_b = knn_cuda(q, k, metric)
    plans = {len(_splits(Q, K, 100)) for Q in (1, 8, 256)}
    if K == 65_536:
        assert max(plans) > 1
    for Q in (1, 8):
        for s in (0, 100, 256 - Q):
            na, nb = fused_lookup_cuda.launches, knn_cuda.launches
            part_a = fused_lookup_cuda(q[s:s + Q], k, h, meta, **kw)
            part_b = knn_cuda(q[s:s + Q], k, metric)
            assert fused_lookup_cuda.launches == na + 1
            assert knn_cuda.launches == nb + 1
            _assert_bitwise(part_a, [x[s:s + Q] for x in full_a])
            _assert_bitwise(part_b, [x[s:s + Q] for x in full_b])


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
def test_lookup_ties_across_split_boundaries(cuda, metric):
    """The same key stored at three indices in three different splits:
    the lowest index wins in A and in B. In A, equal costs from keys of
    different levels resolve to the lowest index as well."""
    Q, K, D = 64, 65_536, 100
    q, k, h, meta = _segmented(cuda, Q, K, D, 11)
    ranges = _splits(Q, K, D)
    assert len(ranges) >= 3
    picks = [ranges[1][0] + 5, ranges[len(ranges) // 2][0] + 77,
             ranges[-1][1] - 1]
    for i in picks:
        k[i] = q[0]
    na, nb = fused_lookup_cuda.launches, knn_cuda.launches
    _, idx = knn_cuda(q, k, metric)
    assert int(idx[0]) == picks[0]
    # A: the copies sit in levels 1 and 2 (h 15 and 150); give them equal
    # h so their costs tie across levels
    h2 = h.clone()
    h2[picks] = 7.0
    got = fused_lookup_cuda(q, k, h2, meta, metric=metric, h_repo=1e9)
    assert int(got[4][0]) == picks[0]
    assert len({int(meta[0, i]) for i in picks}) >= 2
    assert fused_lookup_cuda.launches == na + 1
    assert knn_cuda.launches == nb + 1


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
def test_lookup_masks_a_wholly_invalid_split(cuda, metric):
    """Every key of one split (and of the first) is a sentinel (1e15, one
    NaN row) with valid 0: no winner comes from them, and the outputs are
    bitwise those of the same call with those rows zeroed."""
    Q, K, D = 256, 65_536, 100
    q, k, h, meta = _segmented(cuda, Q, K, D, 12)
    ranges = _splits(Q, K, D)
    dead = [ranges[0], ranges[len(ranges) // 2]]
    meta = meta.clone()
    k_zero = k.clone()
    for a, b in dead:
        k[a:b] = 1e15
        k[a + 3] = float("nan")
        k_zero[a:b] = 0.0
        meta[3, a:b] = 0
        meta[2, a:b] = -1
    kw = dict(metric=metric, h_repo=1e9, repo_level=-1)
    got = fused_lookup_cuda(q, k, h, meta, **kw)
    _assert_bitwise(got, fused_lookup_cuda(q, k_zero, h, meta, **kw))
    pay = got[4]
    assert bool((pay >= 0).all())
    for a, b in dead:
        assert not bool(((pay >= a) & (pay < b)).any())
    ref = fused_lookup_ref(q, k_zero, h, meta, **kw)
    tol = _tol(q, k_zero, ref[1], metric)
    assert bool(((got[0] - ref[0]).abs() <= tol).all())


def test_lookup_no_valid_key_without_the_fold(cuda):
    """No valid key at all at K 65,536 with ``fold_repo=False``: every
    query gets (3e38, 0, repo_level, 0, −1) exactly."""
    q, k, h, meta = _segmented(cuda, 256, 65_536, 100, 13)
    meta = meta.clone()
    meta[3] = 0
    cost, ca, lvl, slot, pay = fused_lookup_cuda(
        q, k, h, meta, metric="l2", h_repo=5.0, repo_level=-7,
        fold_repo=False)
    assert bool((cost == torch.tensor(3.0e38, device=cuda)).all())
    assert bool((ca == 0).all()) and bool((lvl == -7).all())
    assert bool((slot == 0).all()) and bool((pay == -1).all())


@pytest.mark.parametrize("K", [448, 20_000])
@pytest.mark.parametrize("D", [3, 19, 100, 130])
def test_lookup_staging_paths(cuda, D, K):
    """D 3, 19 and 130 (D % 4 != 0) take the 4-byte staging path, D 100
    the 16-byte one; a key view 4 bytes off a 16-byte boundary takes the
    4-byte path and gives the same bits as an aligned copy of the same
    keys."""
    Q = 77
    q, k, h, meta = _segmented(cuda, Q, K, D, D + K)
    kw = dict(metric="l2", h_repo=100.0, repo_level=-1)
    got = fused_lookup_cuda(q, k, h, meta, **kw)
    ref = fused_lookup_ref(q, k, h, meta, **kw)
    tol = _tol(q, k, ref[1], "l2")
    assert bool(((got[0] - ref[0]).abs() <= tol).all())
    cb, ib = knn_cuda(q, k, "l2")
    cp, _ = knn_ref(q, k, "l2")
    assert bool(((cb - cp).abs() <= _tol(q, k, cp, "l2")).all())
    flat = torch.empty(K * D + 1, device=cuda)
    view = flat[1:].view(K, D)
    view.copy_(k)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    _assert_bitwise(fused_lookup_cuda(q, view, h, meta, **kw), got)
    _assert_bitwise(knn_cuda(q, view, "l2"), (cb, ib))


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
@pytest.mark.parametrize("D", [5000, 6000, 8190, 8192])
def test_lookup_wide_rows(cuda, metric, D):
    """Rows too wide for a resident query tile (D 6000, 8190, 8192) stream
    it through the key ring; D 5000 stays resident. On small-integer
    coordinates every sum is exact in f32, so both kernels must give the
    plain version's outputs bit for bit, ties to the lowest index
    included; a Q 1 call gives the same bits as its row of the batch."""
    from repro_torch.kernels.knn.knn import _sm_count, _split_plan
    Q, K = 77, 3000
    g = torch.Generator().manual_seed(D)
    q = torch.randint(-2, 3, (Q, D), generator=g).float().to(cuda)
    k = torch.randint(-2, 3, (K, D), generator=g).float().to(cuda)
    k[100] = k[2000] = q[5]                   # a tie across key tiles
    lvl = (torch.arange(K) * 3 // K).int()
    h = (lvl * 8).float().to(cuda)
    valid = (torch.arange(K) % 13 != 4).int()
    meta = torch.stack([lvl, torch.arange(K).int(),
                        torch.where(valid > 0, torch.arange(K), -1).int(),
                        valid]).to(cuda)
    plan = _split_plan(Q, K, D, _sm_count(q.device))
    assert plan.q_stream is (D > 5000)
    kw = dict(metric=metric, h_repo=1e9, repo_level=-1)
    na, nb = fused_lookup_cuda.launches, knn_cuda.launches
    got_a = fused_lookup_cuda(q, k, h, meta, **kw)
    got_b = knn_cuda(q, k, metric)
    assert fused_lookup_cuda.launches == na + 1
    assert knn_cuda.launches == nb + 1
    _assert_bitwise(got_a, fused_lookup_ref(q, k, h, meta, **kw))
    _assert_bitwise(got_b, knn_ref(q, k, metric))
    assert int(got_b[1][5]) == 100 and int(got_a[4][5]) == 100
    _assert_bitwise(fused_lookup_cuda(q[5:6], k, h, meta, **kw),
                    [x[5:6] for x in got_a])
    _assert_bitwise(knn_cuda(q[5:6], k, metric), [x[5:6] for x in got_b])


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


FLASH_CASES = [
    # (B, Sq, Skv, H, KH, Dh, causal): tests/test_torch_flash.py's cases,
    # plus granite-shaped ones (H 32, KH 8, Dh 64): a ragged length and
    # a stream-phase miss-prefill bucket
    (2, 64, 64, 4, 2, 32, True),
    (1, 100, 100, 8, 8, 64, True),
    (2, 37, 37, 4, 1, 16, True),
    (1, 64, 128, 4, 2, 32, False),
    (2, 256, 256, 8, 2, 128, True),
    (1, 1, 64, 4, 4, 32, False),
    (3, 203, 203, 32, 8, 64, True),
    (8, 128, 128, 32, 8, 64, True),
    # the Dh-128 dense decoders' prefill attention: phi3-medium-14b (4
    # query heads a KV head), deepseek-coder-33b (7) and deepseek-67b
    # (8), and a ragged length at the odd group
    (1, 1024, 1024, 40, 10, 128, True),
    (1, 1024, 1024, 56, 8, 128, True),
    (1, 1024, 1024, 64, 8, 128, True),
    (1, 1000, 1000, 56, 8, 128, True),
    # the other families' attention: whisper-small's encoder (non-causal,
    # 1,500 frames), qwen2-vl-7b (7 query heads a KV head), dbrx-132b and
    # granite-moe-3b-a800m
    (2, 1500, 1500, 12, 12, 64, False),
    (2, 512, 512, 28, 4, 128, True),
    (2, 512, 512, 48, 8, 128, True),
    (2, 512, 512, 24, 8, 64, True),
]


def _hold_bf16(got, q, k, v, causal, kv_len=None):
    """The bf16 kernel's two bounds: the one derived from rounding p
    (against the exact softmax) and one bf16 step plus slack (against
    ``flash_blocked``)."""
    ref = flash_ref(q, k, v, causal=causal, kv_len=kv_len).float()
    abs_v = flash_ref(q.float(), k.float(), v.float().abs(), causal=causal,
                      kv_len=kv_len)
    blk, slack = flash_blocked(q, k, v, causal=causal, kv_len=kv_len,
                               p_dtype=torch.bfloat16, p_rel=P_REL)
    got, blk = got.float(), blk.float()
    tol = 2.0 ** -7 * ref.abs() + 2.0 ** -7 * abs_v + 1e-4
    assert ((got - ref).abs() <= tol).all(), float(((got - ref).abs()
                                                    / tol).max())
    tol_b = 2.0 ** -7 * blk.abs() + slack + 1e-4
    assert ((got - blk).abs() <= tol_b).all(), float(((got - blk).abs()
                                                      / tol_b).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case, dtype, tol):
    B, Sq, Skv, H, KH, Dh, causal = case
    g = torch.Generator().manual_seed(Sq * 7 + Skv)
    q = torch.randn(B, Sq, H, Dh, generator=g).to(cuda, dtype)
    k = torch.randn(B, Skv, KH, Dh, generator=g).to(cuda, dtype)
    v = torch.randn(B, Skv, KH, Dh, generator=g).to(cuda, dtype)
    n0, by0 = flash_cuda.launches, dict(flash_cuda.launches_by_dtype)
    got = flash_attention(q, k, v, causal=causal)
    ref = flash_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_cuda.launches == n0 + 1
    # f32 went to the CUDA-core kernel, bf16 to the tensor-core one
    assert flash_cuda.launches_by_dtype == {
        t: n + (t == dtype) for t, n in by0.items()}
    assert got.dtype == dtype and got.shape == (B, Sq, H, Dh)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        _hold_bf16(got, q, k, v, causal)


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_serve_step_on_card_matches_cpu(cuda, kv):
    """granite-3-2b at full width and 2 layers, f32 compute: a prefill, its
    padded cache and three ``make_serve_step`` steps on the card against
    the same calls on the CPU, on the same weights. Logits to 1e-3 (f32
    sums in other orders over d 2048, logits of order 1) and f32 K/V to
    1e-4; an int8 payload within ±1 (the card's matmuls move K/V by ulps,
    which can carry a value across a rounding boundary) and its scale to
    1e-5 relative."""
    from repro_torch.models import model as model_api
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=2,
                              compute_dtype="float32", kv_cache_dtype=kv)
    host = model_api.init_params(cfg, 0, device="cpu")
    card = copy.deepcopy(host).to(cuda)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    runs = []
    for model, dev in ((host, "cpu"), (card, cuda)):
        logits, caches = model_api.make_prefill(cfg)(
            model, {"tokens": prompt.to(dev)})
        caches = model_api._pad_caches(cfg, caches, 20)
        out = [logits[:, -1:]]
        step = model_api.make_serve_step(cfg)
        for t in range(3):
            tok = torch.full((2, 1), 7 + t, device=dev)
            lg, caches = step(model, tok, caches, 16 + t)
            out.append(lg)
        runs.append((torch.cat(out, 1).cpu(),
                     [{k: x.cpu() for k, x in c.items()} for c in caches]))
    (ref, ref_c), (got, got_c) = runs
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)
    for g, r in zip(got_c, ref_c):
        for key in ("k", "v"):
            if kv == "int8":
                assert g[key].dtype == torch.int8
                assert (g[key].int() - r[key].int()).abs().max() <= 1
                torch.testing.assert_close(g[key + "_s"], r[key + "_s"],
                                           rtol=1e-5, atol=0)
            else:
                torch.testing.assert_close(g[key], r[key], rtol=0,
                                           atol=1e-4)


FAMILIES = ["granite-moe-3b-a800m", "dbrx-132b", "jamba-1.5-large-398b",
            "xlstm-350m", "whisper-small", "qwen2-vl-7b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_on_card_matches_cpu(cuda, arch):
    """Each family's smoke config in f32 with flash on (kernel E in the
    prefill on the card, ``flash_ref`` on the CPU): a prefill (whisper
    with 64 audio frames, qwen2-vl with 8 image patches before the text
    and a patch grid of M-RoPE ids), its padded cache and three serve
    steps on the card against the same calls on the CPU, on the same
    weights. Logits to 1e-4 and every cache entry (K/V, cross K/V,
    Mamba, mLSTM and sLSTM states) to 1e-4: f32 sums in other orders at
    smoke width."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import model as model_api
    cfg = dataclasses.replace(get_smoke_config(arch),
                              use_flash_attention=True)
    host = model_api.init_params(cfg, 0, device="cpu")
    card = copy.deepcopy(host).to(cuda)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)))}
    if cfg.is_encdec:
        batch["audio_embeds"] = torch.as_tensor(
            rng.standard_normal((2, cfg.cross_len, 128)), dtype=torch.float32)
    if cfg.mrope:
        batch["image_embeds"] = torch.as_tensor(
            rng.standard_normal((2, 8, 1280)), dtype=torch.float32)
        i = np.arange(8)
        ids = np.concatenate([np.stack([0 * i, i // 4, i % 4]),
                              np.broadcast_to(2 + np.arange(16), (3, 16))],
                             axis=1)
        batch["mrope_positions"] = torch.as_tensor(
            np.repeat(ids[:, None], 2, axis=1))
    S = 24 if cfg.mrope else 16
    runs = []
    for model, dev in ((host, "cpu"), (card, cuda)):
        n0 = flash_cuda.launches
        logits, caches = model_api.make_prefill(cfg)(
            model, {k: v.to(dev) for k, v in batch.items()})
        n_attn = sum(b.kind.startswith("attn") for b in model.blocks)
        assert flash_cuda.launches - n0 == (
            0 if dev == "cpu" else n_attn + len(model.enc_blocks))
        caches = model_api._pad_caches(cfg, caches, S + 3)
        out = [logits[:, -1:]]
        step = model_api.make_serve_step(cfg)
        for t in range(3):
            tok = torch.full((2, 1), 7 + t, device=dev)
            lg, caches = step(model, tok, caches, S + t)
            out.append(lg)
        runs.append((torch.cat(out, 1).cpu(),
                     [{k: x.cpu() for k, x in c.items()} for c in caches]))
    (ref, ref_c), (got, got_c) = runs
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    for g, r in zip(got_c, ref_c):
        assert sorted(g) == sorted(r)
        for key in g:
            torch.testing.assert_close(g[key], r[key], rtol=0, atol=1e-4)


def test_flash_kernel_reads_strided_layout_and_kv_len(cuda):
    """A (B, S, H, Dh) view with a padded head axis (non-contiguous, unit
    stride on Dh) and a ``kv_len`` shorter than Skv: the kernel reads the
    strides and masks like the plain version."""
    g = torch.Generator().manual_seed(5)
    big = torch.randn(2, 50, 6, 32, generator=g).to(cuda)
    q = big[:, :, :4]
    kv = torch.randn(2, 90, 4, 32, generator=g).to(cuda)[:, :, :2]
    assert not q.is_contiguous() and q.stride(-1) == 1
    for causal in (True, False):
        got = flash_cuda(q, kv, kv, causal=causal, kv_len=61)
        ref = flash_ref(q, kv, kv, causal=causal, kv_len=61)
        torch.testing.assert_close(got, ref, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("layout", ["padded heads", "72-byte head stride",
                                    "8-byte offset"])
def test_flash_bf16_reads_strided_layout_and_kv_len(cuda, layout):
    """The bf16 twin of the test above. A padded head axis keeps every
    stride a multiple of 16 bytes, so TMA reads the view in place; a
    72-byte head stride or an address 8 bytes off 16 makes the wrapper
    copy it first. Either way the kernel masks ``kv_len`` like the plain
    version."""
    g = torch.Generator().manual_seed(6)
    if layout == "padded heads":
        q = torch.randn(2, 50, 6, 32, generator=g).to(cuda).bfloat16()[
            :, :, :4]
        kv = torch.randn(2, 90, 4, 32, generator=g).to(cuda).bfloat16()[
            :, :, :2]
    elif layout == "72-byte head stride":
        q = torch.randn(2, 50, 4, 36, generator=g).to(cuda).bfloat16()[
            ..., :32]
        kv = torch.randn(2, 90, 2, 36, generator=g).to(cuda).bfloat16()[
            ..., :32]
    else:
        flat = torch.randn(2 * 50 * 4 * 32 + 4, generator=g).to(cuda)
        q = flat.bfloat16()[4:].view(2, 50, 4, 32)
        kv = torch.randn(2, 90, 2, 32, generator=g).to(cuda).bfloat16()
        assert q.data_ptr() % 16 == 8
    assert not (q.is_contiguous() and q.data_ptr() % 16 == 0)
    for causal in (True, False):
        n0 = flash_cuda.launches_by_dtype[torch.bfloat16]
        got = flash_cuda(q, kv, kv, causal=causal, kv_len=61)
        torch.cuda.synchronize()
        assert flash_cuda.launches_by_dtype[torch.bfloat16] == n0 + 1
        _hold_bf16(got, q, kv, kv, causal, kv_len=61)


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros(1, 4, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 4, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="float16"):
        flash_attention(q.half(), q.half(), q.half())


@pytest.mark.parametrize("metric,gamma", [("l1", 1.0), ("l2", 1.0),
                                          ("l2sq", 1.0), ("l2", 0.5)])
@pytest.mark.parametrize("R,O,D,J", [(1, 1, 2, 1), (333, 257, 13, 3),
                                     (300, 300, 64, 5), (1000, 70, 100, 8)])
def test_gain_kernel_matches_plain(cuda, metric, gamma, R, O, D, J):
    g = torch.Generator().manual_seed(R + O)
    x = torch.randn(R, D, generator=g).to(cuda)
    y = torch.randn(O, D, generator=g).to(cuda)
    lam = torch.rand(R, generator=g).to(cuda)
    cur = (torch.rand(R, generator=g) * 6).to(cuda)
    H = torch.rand(R, J, generator=g).to(cuda)
    H[::5, 0] = float("inf")                     # off-path entries
    n0 = gain_cuda.launches
    got = greedy_gain(x, y, lam, cur, H, metric, gamma)
    Hs = torch.where(torch.isfinite(H), H, torch.full_like(H, 1e30))
    ref = gain_ref(x, y, lam, cur, Hs, metric, gamma)
    torch.cuda.synchronize()
    assert gain_cuda.launches == n0 + 1
    torch.testing.assert_close(got, ref, rtol=5e-5, atol=5e-4)


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_gain_kernel_matches_kernel_c_on_equal_rows(cuda, metric):
    """With every H row equal, kernel D computes kernel C's function at
    I = 1, in the same order: the two agree bit for bit."""
    g = torch.Generator().manual_seed(9)
    R, O, D = 777, 301, 37
    x = torch.randn(R, D, generator=g).to(cuda)
    y = torch.randn(O, D, generator=g).to(cuda)
    lam = torch.rand(R, generator=g).to(cuda)
    cur = (torch.rand(R, generator=g) * 6).to(cuda)
    hrow = torch.tensor([[0.0, 0.5, 2.0]], device=cuda)
    d = gain_cuda(x, y, lam, cur, hrow.expand(R, 3), metric)
    c = G.gains_cuda(x, y, lam[None], cur[None], hrow, metric)
    torch.cuda.synchronize()
    assert torch.equal(d, c)


def _gain_inputs(cuda, seed, R, O, D, I, J):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(R, D, generator=g).to(cuda)
    y = torch.randn(O, D, generator=g).to(cuda)
    lam = torch.rand(I, R, generator=g).to(cuda)
    cur = (torch.rand(I, R, generator=g) * 6).to(cuda)
    H = torch.rand(I, J, generator=g).to(cuda)
    Hr = torch.rand(R, J, generator=g).to(cuda)
    return x, y, lam, cur, H, Hr


def _both_gains(x, y, lam, cur, H, Hr, metric="l2"):
    """Kernel C at I ingresses, and kernel D on the first ingress."""
    return (G.gains_cuda(x, y, lam, cur, H, metric),
            gain_cuda(x, y, lam[0], cur[0], Hr, metric))


def _forced_plan(monkeypatch, y_stream):
    def plan(O, D, I, J, per_request_h):
        jw = G._j_width(J, y_stream)
        return G.GainPlan(y_stream, jw, G._smem_bytes(
            D, I, jw, per_request_h, y_stream), O)
    monkeypatch.setattr(G, "_gain_plan", plan)


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("R,O,D", [(333, 1000, 100), (700, 16_385, 37),
                                   (129, 5000, 1000)])
def test_gains_bitwise_under_candidate_subsets_and_permutations(
        cuda, metric, R, O, D):
    """Each candidate's gain has one fixed order whatever the candidate
    tiling: a slice or a permutation of the candidates gives its columns
    of the full call bit for bit, for C and for D, with the candidate
    tile resident (D 100, 37) and streamed (D 1000)."""
    x, y, lam, cur, H, Hr = _gain_inputs(cuda, O + D, R, O, D, 2, 3)
    full = _both_gains(x, y, lam, cur, H, Hr, metric)
    for a, b in ((0, 1), (O - 1, O), (127, 129), (1, O - 300),
                 (O // 3, O // 3 + 257)):
        for f, s in zip(full, _both_gains(x, y[a:b], lam, cur, H, Hr,
                                          metric)):
            assert torch.equal(s, f[:, a:b]), (a, b)
    perm = torch.randperm(O, generator=torch.Generator().manual_seed(3))
    for f, s in zip(full, _both_gains(x, y[perm.to(cuda)], lam, cur, H, Hr,
                                      metric)):
        assert torch.equal(s, f[:, perm.to(cuda)])
    torch.cuda.synchronize()


@pytest.mark.parametrize("y_stream", [False, True])
@pytest.mark.parametrize("R,O,D,J", [(333, 1000, 100, 8), (200, 700, 19, 3)])
def test_gains_bitwise_across_plans(cuda, monkeypatch, y_stream, R, O, D,
                                    J):
    """A resident and a streamed candidate tile (which also runs at J
    width 8 where J is 3) give the same bits."""
    x, y, lam, cur, H, Hr = _gain_inputs(cuda, 5, R, O, D, 3, J)
    ref = _both_gains(x, y, lam, cur, H, Hr)
    _forced_plan(monkeypatch, y_stream)
    for r, got in zip(ref, _both_gains(x, y, lam, cur, H, Hr)):
        assert torch.equal(got, r)


@pytest.mark.parametrize("D", [3, 19, 100, 130])
def test_gains_staging_paths(cuda, D):
    """D % 4 != 0 and views 4 bytes off take the 4-byte copies; the bits
    are those of the 16-byte path on the same values."""
    R, O = 300, 600
    x, y, lam, cur, H, Hr = _gain_inputs(cuda, D, R, O, D, 1, 3)
    ref = _both_gains(x, y, lam, cur, H, Hr)
    xb = torch.empty(R * D + 1, device=cuda)
    yb = torch.empty(O * D + 1, device=cuda)
    xv, yv = xb[1:].view(R, D), yb[1:].view(O, D)
    xv.copy_(x)
    yv.copy_(y)
    assert xv.data_ptr() % 16 != 0 and yv.data_ptr() % 16 != 0
    for r, got in zip(ref, _both_gains(xv, yv, lam, cur, H, Hr)):
        assert torch.equal(got, r)
    torch.testing.assert_close(
        ref[0], G._gains_tiles(x, y, lam, cur, H, "l2", 1.0).T,
        rtol=5e-5, atol=5e-4)


@pytest.mark.parametrize("I", [1, 2, 3])
@pytest.mark.parametrize("J", list(range(1, 9)))
def test_gains_every_ingress_and_cache_count(cuda, I, J):
    """Every J width (1, 3, 8, and the J they cover) against the plain
    versions; D equals C bitwise on equal H rows."""
    R, O, D = 257, 300, 20
    x, y, lam, cur, H, Hr = _gain_inputs(cuda, 10 * I + J, R, O, D, I, J)
    H[-1, 0] = G.H_SENTINEL
    got = G.gains_cuda(x, y, lam, cur, H)
    torch.testing.assert_close(
        got, G._gains_tiles(x, y, lam, cur, H, "l2", 1.0).T,
        rtol=5e-5, atol=5e-4)
    d = gain_cuda(x, y, lam[0], cur[0], Hr)
    torch.testing.assert_close(d, gain_ref(x, y, lam[0], cur[0], Hr).T,
                               rtol=5e-5, atol=5e-4)
    c1 = G.gains_cuda(x, y, lam[:1], cur[:1], H[:1])
    assert torch.equal(gain_cuda(x, y, lam[0], cur[0],
                                 H[:1].expand(R, J).contiguous()), c1)


# ------------------------------------------------- kernels C, D past 8 caches
def _j_slices(J):
    """Each group of 8 caches, and slices of at most 8 across groups."""
    out = G._j_groups(J)
    out += [(a, min(J, a + w)) for a, w in ((4, 8), (7, 2), (J - 3, 3),
                                           (J // 2, 5))]
    return sorted({s for s in out if s[1] - s[0] <= G.J_GROUP})


@pytest.mark.parametrize("J", [9, 17, 32])
@pytest.mark.parametrize("I", [1, 4])
def test_gains_past_eight_caches(cuda, I, J):
    """Kernel C at J > 8 (the scenario networks' 17–32 caches): ⌈J/8⌉
    launches, against the plain version, and bitwise what J ≤ 8 slices
    of H give the same columns (groups, and slices across them)."""
    R, O, D = 333, 1000, 100
    x, y, lam, cur, H, _ = _gain_inputs(cuda, 100 * I + J, R, O, D, I, J)
    H[-1, ::7] = G.H_SENTINEL
    n0 = G.gains_cuda.launches
    got = G.gains_cuda(x, y, lam, cur, H)
    assert G.gains_cuda.launches == n0 + -(-J // G.J_GROUP)
    torch.testing.assert_close(
        got, G._gains_tiles(x, y, lam, cur, H, "l2", 1.0).T,
        rtol=5e-5, atol=5e-4)
    for a, b in _j_slices(J):
        part = G.gains_cuda(x, y, lam, cur, H[:, a:b].contiguous())
        assert torch.equal(part, got[a:b]), (a, b)


def test_gain_kernel_past_eight_caches(cuda):
    """Kernel D at J 9: two launches, against its plain version, bitwise
    its J ≤ 8 slices, and bitwise kernel C on equal H rows."""
    R, O, D, J = 333, 1000, 100, 9
    x, y, lam, cur, H, Hr = _gain_inputs(cuda, 909, R, O, D, 1, J)
    Hr[::5, 3] = G.H_SENTINEL
    n0 = gain_cuda.launches
    got = gain_cuda(x, y, lam[0], cur[0], Hr)
    assert gain_cuda.launches == n0 + 2
    torch.testing.assert_close(got, gain_ref(x, y, lam[0], cur[0], Hr).T,
                               rtol=5e-5, atol=5e-4)
    for a, b in _j_slices(J):
        part = gain_cuda(x, y, lam[0], cur[0], Hr[:, a:b].contiguous())
        assert torch.equal(part, got[a:b]), (a, b)
    c = G.gains_cuda(x, y, lam, cur, H)
    assert torch.equal(gain_cuda(x, y, lam[0], cur[0],
                                 H.expand(R, J).contiguous()), c)


# ------------------------------------------------------ kernel F (duel scan)
def _duel_instance(metric, gamma=1.0, n=700, dim=24, seed=1):
    cat = catalog.embedding_catalog(n=n, dim=dim, seed=seed)
    cat = catalog.Catalog(coords=cat.coords, metric=metric, gamma=gamma)
    net = topology.tandem(k_leaf=24, k_parent=40, h=50.0, h_repo=400.0)
    return Instance(net=net, cat=cat,
                    dem=demand.zipf(cat, alpha=0.8, seed=seed + 1))


def _assert_duel_bitwise(a, b):
    for f in ("slots", "virt", "deadline", "real_sav", "virt_sav",
              "b1_trace"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert a.promotions == b.promotions
    assert a.n_promotions == b.n_promotions
    assert a.served_cost == b.served_cost
    assert a.cost_trace == b.cost_trace


def _expected_launches(st, T):
    """One launch per promoting step, plus the one that reaches T."""
    steps = sorted({e[0] for e in st.promotions})
    return len(steps) + (0 if steps and steps[-1] == T - 1 else 1)


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
@pytest.mark.parametrize("materialize", [True, False])
def test_duel_kernel_matches_plain_scan(cuda, metric, materialize):
    """Kernel F against the plain scan on the card, bitwise: events,
    slots, virt, deadlines, both savings, the per-step served cost and
    the cost trace; one launch per promoting step plus the last. On a
    materialized C_a it is also the host policy, bit for bit."""
    from repro_torch.core.placement import netduel
    from repro_torch.kernels.duel import duel_scan_cuda
    inst = _duel_instance(metric)
    d = DeviceInstance.from_instance(inst, materialize_ca=materialize,
                                     device=cuda)
    T = 3000
    kw = dict(n_iters=T, seed=3, window=300, arm_prob=0.35,
              record_events=True, record_every=250)
    n0 = duel_scan_cuda.launches
    got = device_netduel(d, **kw)
    launches = duel_scan_cuda.launches - n0
    ref = device_netduel(d, plain=True, **kw)
    assert duel_scan_cuda.launches - n0 == launches
    assert got.n_promotions > 0
    _assert_duel_bitwise(got, ref)
    assert launches == _expected_launches(got, T)
    if materialize:
        host = netduel(inst, **{k: v for k, v in kw.items()
                                if k != "record_events"})
        assert host.promotions == got.promotions
        np.testing.assert_array_equal(host.sw.slots, got.slots)
        np.testing.assert_array_equal(host.virt_sav, got.virt_sav)


@pytest.mark.parametrize("gamma", [0.5, 2.0, 0.7])
def test_duel_kernel_gamma(cuda, gamma):
    """d^γ in F as torch's pow computes it (its special cases 0.5 and 2,
    then powf): the streamed scan bitwise the plain one."""
    inst = _duel_instance("l2", gamma=gamma)
    d = DeviceInstance.from_instance(inst, materialize_ca=False, device=cuda)
    kw = dict(n_iters=2000, seed=5, window=200, arm_prob=0.4,
              record_events=True)
    got = device_netduel(d, **kw)
    _assert_duel_bitwise(got, device_netduel(d, plain=True, **kw))
    assert got.n_promotions > 0


@pytest.mark.parametrize("materialize", [True, False])
def test_duel_kernel_masked_windows(cuda, materialize):
    """``DuelPlane`` as the engine drives it — bucketed batches, padding
    rows, external b1 prices — through F and through the plain scan: the
    carries bitwise after every batch, and the padded plane bitwise the
    unpadded one."""
    from repro_torch.core.placement import DuelPlane
    inst = _duel_instance("l2", n=900)
    d = DeviceInstance.from_instance(inst, materialize_ca=materialize,
                                     device=cuda)
    slots0 = np.random.default_rng(3).integers(0, inst.cat.n, 64)
    kw = dict(window=150, arm_prob=0.6, seed=9)
    planes = [DuelPlane(d, slots0, **kw), DuelPlane(d, slots0, plain=True,
                                                    **kw),
              DuelPlane(d, slots0, **kw)]
    rng = np.random.default_rng(1)
    best1 = planes[0].carry.best1[0].cpu().numpy()
    for n in (37, 64, 5, 100, 128, 77, 256, 3):
        objs, _ = inst.dem.sample(n, rng)
        b1 = best1[objs] * np.float32(1.02)
        m = 8 if n <= 8 else 1 << (n - 1).bit_length()
        objs_p = np.concatenate([objs, np.repeat(objs[:1], m - n)])
        b1_p = np.concatenate([b1, np.repeat(b1[:1], m - n)])
        changed = [p.observe(objs_p, b1_ext=torch.as_tensor(b1_p,
                                                            device=cuda),
                             n_valid=n) for p in planes[:2]]
        changed.append(planes[2].observe(objs, b1_ext=b1))
        assert changed[0] == changed[1] == changed[2]
        for other in planes[1:]:
            for a, b in zip(planes[0].carry, other.carry):
                assert torch.equal(a, b)
            assert planes[0].served_cost == other.served_cost
    assert planes[0].n_promotions > 0


@pytest.mark.parametrize("materialize", [True, False])
def test_duel_kernel_settle_past_promote_cap(cuda, materialize):
    """Twelve duels expire with wins at one step: F settles them in one
    launch, the full rebuild re-arms, and F, the plain scan and the full
    re-arm end bitwise equal."""
    import importlib
    nd = importlib.import_module("repro_torch.core.placement.netduel")
    from repro_torch.kernels.duel import DuelXs
    n_slots, w = 12, 5
    coords = np.zeros((n_slots + 2, 1), np.float32)
    coords[1:] = 100.0
    cat = catalog.Catalog(coords=coords, metric="l1")
    inst = Instance(net=topology.single_cache(k=n_slots, h_repo=1000.0),
                    cat=cat, dem=demand.uniform(cat))
    d = DeviceInstance.from_instance(inst, materialize_ca=materialize,
                                     device=cuda)
    objs = np.r_[np.arange(1, n_slots + 1), n_slots + 1, 1, 2]
    ts = np.r_[np.zeros(n_slots), w, w + 1, w + 2].astype(np.int64)
    T = len(objs)
    xs = DuelXs(*(torch.as_tensor(a, device=cuda) for a in (
        objs, np.zeros(T, np.int64), ts, np.ones(T, bool),
        np.zeros(T, np.float32))))
    h_slots, on_path = nd._scan_args(d)
    runs = [nd._duel_scan(d, h_slots, on_path,
                          nd._duel_carry(d, np.zeros(n_slots, np.int64)),
                          xs, float(np.float32(1.05)), w, True, False, 0,
                          incremental=inc, kernel=k)
            for k, inc in ((True, True), (False, True), (True, False))]
    carry, out = runs[0]
    assert int(carry.n_prom.sum()) == n_slots > nd.PROMOTE_CAP
    for c2, o2 in runs[1:]:
        for a, b in zip(carry, c2):
            assert torch.equal(a, b)
        assert torch.equal(out.b1, o2.b1)



def _f_case(cuda, K, D, metric, materialize, masked, I=2, seed=0, O=3000,
            T=1200):
    """Raw inputs of kernel F: a random layout's serving tables, I
    ingresses (the second off the path of the second cache), a skewed
    window of T requests, window 60, so that duels promote."""
    from repro_torch.core.objective import _best_two_rows_pre, fold_best_two
    from repro_torch.kernels.duel import DuelXs
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=cuda)
    i64 = dict(dtype=torch.int64, device=cuda)
    coords = torch.as_tensor(rng.standard_normal((O, D)), **f32)
    ca = costs.approx_cost(coords, coords, metric).contiguous() \
        if materialize else None
    slots = torch.as_tensor(rng.integers(0, O, K), **i64)
    slot_cache = torch.arange(K, device=cuda) % 2
    H = torch.tensor([[0.5, 3.0], [np.inf, 1.0]] +
                     [[0.5 + j, 3.0 - 0.1 * j] for j in range(I - 2)], **f32)
    pre = _best_two_rows_pre(ca if materialize else coords,
                             None if materialize else coords[slots],
                             slots, slot_cache, H, metric, 1.0, materialize)
    h_repo = torch.full((I,), 2.0 * D ** 0.5, **f32)
    tables = tuple(t.contiguous() for t in fold_best_two(
        pre[0], pre[1], pre[2], h_repo))
    h_slots = H[:, slot_cache].contiguous()
    objs = np.minimum(rng.zipf(1.3, T), O) - 1
    b1 = tables[0][0, torch.as_tensor(objs, device=cuda)] * 1.01
    xs = DuelXs(torch.as_tensor(objs, **i64),
                torch.as_tensor(rng.integers(0, I, T), **i64),
                torch.arange(T, **i64),
                torch.as_tensor(rng.random(T) < 0.5, device=cuda),
                torch.as_tensor(rng.random(T), **f32),
                b1.contiguous() if masked else None,
                torch.as_tensor(rng.random(T) < 0.9, device=cuda)
                if masked else None)
    state = (slots, torch.full((K,), -1, **i64), torch.zeros(K, **f32),
             torch.zeros(K, **f32), torch.zeros(K, **i64),
             torch.zeros(1, **i64))
    return coords, ca, tables, h_slots, state, xs


def _f_run(fn, coords, ca, metric, tables, h_slots, state0, xs, t0):
    """Launch F (or its plain version) from ``t0`` again and again, from
    the step after each promotion, the tables fixed: every stop, every
    event and the final state and served costs."""
    K, T = h_slots.shape[1], xs.objs.shape[0]
    dev = coords.device
    state = tuple(t.clone() for t in state0)
    out = torch.zeros(T, dtype=torch.float32, device=dev)
    event = (torch.zeros(K, dtype=torch.bool, device=dev),
             torch.zeros(K, dtype=torch.int64, device=dev),
             torch.zeros(K, dtype=torch.float32, device=dev),
             torch.zeros(K, dtype=torch.float32, device=dev))
    stops, events, s = [], [], t0
    while s < T:
        stop = fn(coords, ca, metric, 1.0, tables, h_slots, state, xs, s,
                  float(np.float32(1.05)), 60, out, event)
        stops.append(stop)
        if stop >= T:
            break
        events.append(tuple(e.clone() for e in event))
        s = stop + 1
    return stops, events, state, out


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
@pytest.mark.parametrize("K,D,materialize,masked,t0,I", [
    (1300, 24, False, False, 0, 2),   # K > 992: runs, carry in shared memory
    (1000, 16, False, False, 0, 2),   # runs just past one thread a slot
    (8000, 3, False, False, 0, 2),    # runs, carry in device memory
    (2500, 8, False, True, 0, 6),     # h_slots read from device memory
    (8000, 3, False, False, 0, 4),    # ... and the carry too
    (448, 200, False, False, 0, 2),   # K·D too large for the resident rows
    (448, 37, False, True, 0, 2),     # rows not 16-byte aligned
    (448, 3, False, False, 0, 2),
    (77, 24, False, False, 0, 2),     # K not a multiple of 32
    (77, 24, True, True, 0, 2),       # materialized C_a
    (1300, 24, True, False, 5, 2),    # runs, materialized, mid-ring start
    (448, 100, False, True, 13, 2),   # the engine's shape, mid-ring start
    (448, 24, False, False, 0, 10),   # h_slots resident, 10 ingresses
    (77, 24, False, True, 3, 10),     # ... K % 4 != 0
])
def test_duel_kernel_bitwise_plain_steps(cuda, metric, K, D, materialize,
                                         masked, t0, I):
    """Kernel F against its plain version, ``duel_steps_ref``, launch by
    launch: the stopping steps, each promoting step's event, the carry
    and the served costs, bitwise, at each shape its design handles
    apart (registers or runs of slots, carry and h_slots rows on chip or
    not, resident or device rows, 16- or 4-byte staging) and from a
    step that is not the ring's first."""
    from repro_torch.kernels.duel import duel_scan_cuda, duel_steps_ref
    coords, ca, tables, h_slots, state, xs = _f_case(cuda, K, D, metric,
                                                     materialize, masked, I)
    n0 = duel_scan_cuda.launches
    got = _f_run(duel_scan_cuda, coords, ca, metric, tables, h_slots, state,
                 xs, t0)
    assert duel_scan_cuda.launches - n0 == len(got[0])
    want = _f_run(duel_steps_ref, coords, ca, metric, tables, h_slots, state,
                  xs, t0)
    assert got[0] == want[0]
    assert len(got[0]) > 2                       # duels promoted
    for eg, ew in zip(got[1], want[1]):
        for a, b in zip(eg, ew):
            assert torch.equal(_bits(a), _bits(b))
    for a, b in zip((*got[2], got[3]), (*want[2], want[3])):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("case", ["1", "3", "8", "9", "dirty", "20"])
@pytest.mark.parametrize("materialize", [True, False])
@pytest.mark.parametrize("gamma", [1.0, 0.5, 2.0, 1.7])
@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
def test_duel_rearm_kernel_matches_plain(cuda, metric, gamma, materialize,
                                         case):
    """Kernel F's re-arm against its plain version on the card, bitwise,
    over the CPU differential's cases (tests/rearm_cases.py) and twenty
    promoted slots; one launch a call, the inputs untouched."""
    from rearm_cases import rearm_args, rearm_case
    from repro_torch.kernels.duel import duel_rearm_cuda, duel_rearm_ref
    c = rearm_case(metric, gamma, materialize, case, device=cuda)
    before = [t.clone() for t in c["pre"]]
    n0 = duel_rearm_cuda.launches
    got = duel_rearm_cuda(*rearm_args(c))
    assert duel_rearm_cuda.launches - n0 == 1
    want = duel_rearm_ref(*rearm_args(c))
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(before, c["pre"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["1", "9", "dirty", "20"])
@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
def test_duel_rearm_kernel_at_width(cuda, metric, case):
    """The re-arm at the engine's width (D 100, 20,000 objects, normal
    coordinates: the first pass's staged tiles, many blocks, the dirty
    pass's staged keys), bitwise its plain version."""
    from rearm_cases import rearm_args, rearm_case
    from repro_torch.kernels.duel import duel_rearm_cuda, duel_rearm_ref
    c = rearm_case(metric, 1.0, False, case, device=cuda, n=20_000,
                   dim=100, integer=False)
    for a, b in zip(duel_rearm_cuda(*rearm_args(c)),
                    duel_rearm_ref(*rearm_args(c))):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("case", ["1", "dirty", "20"])
@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
def test_duel_rearm_kernel_at_shared_memory_limit(cuda, metric, case):
    """999 slots at D 57: the dirty pass's staged slot keys and its
    other dynamic arrays come to 232,012 B, within the card's 232,448 B
    opt-in limit alone but not beside the pass's 512 B of static shared
    arrays; the kernel reads the keys from device memory there, bitwise
    its plain version."""
    from rearm_cases import rearm_args, rearm_case
    from repro_torch.kernels.duel import duel_rearm_cuda, duel_rearm_ref
    c = rearm_case(metric, 1.0, False, case, device=cuda, dim=57, per=333)
    assert c["slots_new"].shape[0] == 999
    for a, b in zip(duel_rearm_cuda(*rearm_args(c)),
                    duel_rearm_ref(*rearm_args(c))):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("materialize", [True, False])
def test_duel_window_rearms_through_the_kernel(cuda, materialize):
    """``device_netduel`` on the card: one re-arm launch per promoting
    step, and the whole window bitwise the plain scan (whose re-arms are
    torch ops)."""
    from repro_torch.kernels.duel import duel_rearm_cuda
    inst = _duel_instance("l1", n=800)
    d = DeviceInstance.from_instance(inst, materialize_ca=materialize,
                                     device=cuda)
    kw = dict(n_iters=2500, seed=4, window=250, arm_prob=0.4,
              record_events=True)
    n0 = duel_rearm_cuda.launches
    got = device_netduel(d, **kw)
    steps = len({e[0] for e in got.promotions})
    assert steps > 0 and duel_rearm_cuda.launches - n0 == steps
    _assert_duel_bitwise(got, device_netduel(d, plain=True, **kw))


# ------------------------------------- the Che hit-rate plane on the card
def _che_case(n=2000):
    """A 2,000-object catalog rescaled by the reference bench's rule
    (``rescaled_coords``) on a multi-ingress scale-free scenario."""
    from repro_torch.core import scenarios
    from repro_torch.core.analysis import rescaled_coords
    sc = scenarios.scenario("scale_free", cache_budget=256,
                            placement="degree", n_ingress=6, seed=0)
    cat = catalog.embedding_catalog(n=n, dim=100, seed=1)
    coords, theta = rescaled_coords(sc.net, cat.coords, 1)
    dem = demand.zipf(cat, alpha=0.9, n_ingress=6, seed=7)
    return sc.net, coords, theta, dem.lam


@pytest.mark.parametrize("q_mode", ["hard", "rnd"])
def test_hitrate_plane_on_card_matches_cpu(cuda, q_mode):
    """``similarity_balls`` and ``predict_hitrates`` on the card against
    the same calls on the CPU: ``idx`` equal, ``q`` equal (1e-6 in the
    RND-LRU mode), ``dist`` to one f32 step; T to 1e-4 relative, π and
    the hit probabilities to 1e-5, the hit rate and mean cost to 1e-5
    relative — the tolerances the CPU holds the reference to
    (tests/test_torch_hitrate.py): the card's expm1, log1p, exp and scan
    orders differ from the CPU's by ulps."""
    from repro_torch.core.analysis import predict_hitrates, similarity_balls
    net, coords, theta, lam = _che_case()
    b = similarity_balls(coords, theta, q_mode=q_mode, device=cuda)
    bc = similarity_balls(coords, theta, q_mode=q_mode, device="cpu")
    assert b.mean_size > 2.0
    np.testing.assert_array_equal(b.idx, bc.idx)
    np.testing.assert_allclose(b.q, bc.q, rtol=0,
                               atol=1e-6 if q_mode == "rnd" else 0.0)
    np.testing.assert_allclose(b.dist, bc.dist, rtol=2.0 ** -23, atol=0)
    p = predict_hitrates(net, lam, b, device=cuda)
    pc = predict_hitrates(net, lam, bc, device="cpu")
    fin = np.isfinite(pc.T)
    np.testing.assert_array_equal(np.isfinite(p.T), fin)
    np.testing.assert_allclose(p.T[fin], pc.T[fin], rtol=1e-4)
    for f in ("occupancy", "hit_prob", "serve_prob"):
        np.testing.assert_allclose(getattr(p, f), getattr(pc, f), rtol=0,
                                   atol=1e-5, err_msg=f)
    assert p.hit_rate == pytest.approx(pc.hit_rate, rel=1e-5)
    assert p.mean_cost == pytest.approx(pc.mean_cost, rel=1e-5)


def test_cache_pass_scatter_is_bitwise_run_to_run(cuda):
    """The reset-rate scatter (``index_put_`` with accumulate, which sorts
    its indices on CUDA) gives the same bits on every run, on balls
    whose members repeat across rows, padding left out."""
    from repro_torch.core.analysis import hitrate, similarity_balls
    net, coords, theta, lam = _che_case()
    b = similarity_balls(coords, theta, device=cuda)
    n = b.n_objects
    g = torch.Generator().manual_seed(5)
    pi = torch.rand(n, generator=g).to(cuda)
    rate = torch.rand(n, generator=g).to(cuda)
    idx = torch.as_tensor(b.idx.astype(np.int64), device=cuda)
    q = torch.as_tensor(b.q, device=cuda)
    dist = torch.as_tensor(b.dist, device=cuda)
    first = hitrate._cache_pass(pi, rate, idx, q, dist)
    for _ in range(5):
        again = hitrate._cache_pass(pi, rate, idx, q, dist)
        for x, y in zip(first, again):
            assert torch.equal(x, y)
    # padding left out of the scatter changes no bit
    members = (idx.reshape(-1) < n).nonzero()[:, 0]
    for x, y in zip(first, hitrate._cache_pass(pi, rate, idx, q, dist,
                                               members)):
        assert torch.equal(x, y)


def test_surrogate_cost_is_bitwise_run_to_run(cuda):
    """The refresh gate compares surrogate costs across calls: on the
    card they repeat to the bit (exact-hit balls, and similarity balls
    with their repeated members)."""
    from repro_torch.core.analysis import similarity_balls, surrogate_cost
    net, coords, theta, lam = _che_case()
    hier = topology.tpu_hierarchy(64, 128, 256, 15.0, 150.0, 1000.0)
    lam1 = lam.sum(axis=0, keepdims=True)
    costs = {surrogate_cost(hier, lam1, device=cuda) for _ in range(4)}
    assert len(costs) == 1
    b = similarity_balls(coords, theta, device=cuda)
    costs = {surrogate_cost(net, lam, balls=b, device=cuda)
             for _ in range(4)}
    assert len(costs) == 1


# ------------------------------------------ the compressed and pruned plane
def _plane_net(cuda, K: int, metric: str, seed: int = 0):
    """A three-level network of K keys (D 100, unit normals) on the card,
    and 256 queries near its keys plus some far ones."""
    from repro_torch.core.simcache import CacheLevel, SimCacheNetwork
    g = torch.Generator().manual_seed(seed)
    keys = torch.randn(K, 100, generator=g)
    sizes = (K // 8, K // 4, K - K // 8 - K // 4)
    levels, a = [], 0
    for j, (n, h) in enumerate(zip(sizes, (0.0, 0.5, 2.0))):
        levels.append(CacheLevel(keys=keys[a:a + n].to(cuda),
                                 values=torch.arange(a, a + n,
                                                     dtype=torch.int32,
                                                     device=cuda), h=h))
        a += n
    net = SimCacheNetwork(levels=levels, h_repo=14.0, metric=metric)
    pick = torch.randint(0, K, (192,), generator=g)
    q = torch.cat([keys[pick] + 0.05 * torch.randn(192, 100, generator=g),
                   2.0 * torch.randn(64, 100, generator=g)]).to(cuda)
    return net, q


def _bits_equal(a, b) -> bool:
    fields = ("cost", "approx_cost", "level", "slot", "payload", "hit")
    view = (lambda t: t.view(torch.int32)            # noqa: E731
            if t.dtype == torch.float32 else t)
    return all(torch.equal(view(getattr(a, f)), view(getattr(b, f)))
               for f in fields)


@pytest.mark.parametrize("K", [448, 65_536])
@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("flags", [dict(quantize=True), dict(prune="lsh"),
                                   dict(prune="kmeans"),
                                   dict(prune="lsh", quantize=True)],
                         ids=["quantize", "lsh", "kmeans", "lsh+quantize"])
def test_verified_lookups_bitwise_exact_on_card(cuda, K, metric, flags):
    """``verify=True`` through kernel A over the gathered rows and the
    re-scans: every field bit for bit the exact fused lookup (kernel A
    over all K keys), launches one per rescore plus one per re-scan."""
    net, q = _plane_net(cuda, K, metric)
    exact = net.lookup(q)
    n0, r0 = fused_lookup_cuda.launches, net.rescan_calls
    res = net.lookup(q, verify=True, top_t=16, **flags)
    torch.cuda.synchronize()
    assert _bits_equal(res, exact)
    assert fused_lookup_cuda.launches - n0 == 1 + net.rescan_calls - r0


@pytest.mark.parametrize("K", [448, 65_536])
def test_quantized_certificate_honest_on_card(cuda, K):
    """Rows that beat their certificate unverified are exact; the int8
    lower bound stays below the f64 C_a on a sampled tile."""
    from repro_torch.kernels import quant
    from repro_torch.kernels.knn import quantized_fused_lookup
    net, q = _plane_net(cuda, K, "l2", seed=1)
    exact = net.lookup(q)
    keys, h_key, meta = net.fused_layout()
    out = quantized_fused_lookup(q, keys, h_key, meta, net._quant_rows(),
                                 top_t=4, h_repo=net.h_repo)
    safe = out[0] < out[5]
    assert bool(safe.any())
    for got, want in zip(out[:5], (exact.cost, exact.approx_cost,
                                   exact.level, exact.slot, exact.payload)):
        assert torch.equal(got[safe], want[safe])
    lb = quant.lb_approx_cost_tiles(q, quant.quantize_rows(keys[:2048],
                                                           "l2"), "l2", 1.0)
    d64 = torch.cdist(q.double(), keys[:2048].double())
    assert bool((lb.double() <= d64).all())


def test_quantized_gains_admissible_against_kernel_c(cuda):
    """``placement_gains(quantize=True)`` runs no kernel C and bounds
    kernel C's gains from above, less their C_a tolerance."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2000, 100, generator=g).to(cuda)
    lam = torch.rand(1, 2000, generator=g).to(cuda)
    cur = torch.full((1, 2000), 30.0, device=cuda)
    H = torch.tensor([[0.0, 1.5, 15.0]], device=cuda)
    exact = G.placement_gains(x, x, lam, cur, H)
    n0 = G.gains_cuda.launches
    quant_g = G.placement_gains(x, x, lam, cur, H, quantize=True)
    torch.cuda.synchronize()
    assert G.gains_cuda.launches == n0
    n2 = (x * x).sum(1)
    d = _dense_ca(x, x, "l2", 1.0)
    t2 = 16 * U32 * (n2[:, None] + n2[None, :])
    tol = (lam @ (t2 / (d + t2.sqrt()))).T            # (O, 1)
    assert bool((quant_g >= exact - tol - 1e-4 * exact.abs()).all())


# ------------------------------------------------------ the sharded planes
@pytest.mark.parametrize("D", [100, 37, 3])
@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_shard_local_entry_matches_plain_on_chunks(cuda, n_shards, D):
    """Kernel A's shard-local entry (``fold_repo=False``) on each chunk
    view of a shard-padded layout — views at offsets whose address is
    16-byte aligned or not (D 37, 3 take the 4-byte staging), and chunks
    of padding only — against its plain version, and the chunks' reduced
    minima bitwise the unsharded launch."""
    from repro_torch.kernels.knn.ops import _shard_chunks
    from repro_torch.kernels.knn.ref import pad_to_shards
    q, k, h, meta = _segmented(cuda, 64, 1001, D, n_shards + D)
    S = -(-1001 // n_shards)
    # two more chunks of S than the keys fill: padding only
    kp, hp, mp = pad_to_shards(k, h, meta, (n_shards + 2) * S)
    kw = dict(metric="l2", gamma=1.0, h_repo=100.0, repo_level=-1)
    parts = []
    for kc, hc, mc in _shard_chunks(kp, hp, mp, n_shards + 2):
        n0 = fused_lookup_cuda.launches
        got = fused_lookup_cuda(q, kc, hc, mc, fold_repo=False, **kw)
        assert fused_lookup_cuda.launches == n0 + 1
        ref = fused_lookup_ref(q, kc, hc, mc, fold_repo=False, **kw)
        if not bool((mc[3] > 0).any()):               # padding only
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
            assert bool((got[0] == 3.0e38).all() and (got[4] == -1).all())
        else:
            tol = _tol(q, kc, ref[1], "l2")
            assert bool(((got[0] - ref[0]).abs() <= tol).all())
        parts.append(got)
    stk = [torch.stack([p[i] for p in parts]) for i in range(5)]
    from repro_torch.kernels.knn.ref import reduce_shard_minima
    _assert_bitwise(reduce_shard_minima(*stk, h_repo=100.0, repo_level=-1),
                    fused_lookup_cuda(q, k, h, meta, **kw))


@pytest.mark.parametrize("K", [448, 65_536])
@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_sharded_lookup_bitwise_on_card(cuda, K, n_shards):
    """A sharded network serves the fused network's bits, exact and with
    every verified flag, with n launches of kernel A per exact lookup."""
    from repro_torch.launch.mesh import make_lookup_mesh
    net, q = _plane_net(cuda, K, "l2", seed=n_shards)
    snet = dataclasses.replace(net, sharded=True,
                               mesh=make_lookup_mesh(n_shards))
    exact = net.lookup(q)
    n0 = fused_lookup_cuda.launches
    got = snet.lookup(q)
    torch.cuda.synchronize()
    assert fused_lookup_cuda.launches - n0 == n_shards
    assert _bits_equal(got, exact)
    for flags in (dict(quantize=True), dict(prune="lsh"),
                  dict(prune="kmeans"), dict(prune="lsh", quantize=True)):
        assert _bits_equal(snet.lookup(q, verify=True, top_t=16, **flags),
                           exact)


@pytest.mark.parametrize("n_shards,J", [(2, 3), (3, 37), (4, 3)])
def test_sharded_gains_bitwise_on_card(cuda, n_shards, J):
    """Kernel C per candidate shard, ⌈J/8⌉ launches a shard: every column
    bitwise the unsharded call's."""
    from repro_torch.launch.mesh import make_lookup_mesh
    g = torch.Generator().manual_seed(J)
    R, O, D, I = 3000, 2900, 100, 4
    x = torch.randn(R, D, generator=g).to(cuda)
    y = torch.randn(O, D, generator=g).to(cuda)
    lam = torch.rand(I, R, generator=g).to(cuda)
    cur = (torch.rand(I, R, generator=g) * 20).to(cuda)
    h = (torch.rand(I, J, generator=g) * 10).to(cuda)
    want = G.placement_gains(x, y, lam, cur, h)
    n0 = G.gains_cuda.launches
    got = G.sharded_placement_gains(x, y, lam, cur, h,
                                    make_lookup_mesh(n_shards), ("data",))
    torch.cuda.synchronize()
    assert G.gains_cuda.launches - n0 == n_shards * -(-J // 8)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_control_plane_bitwise_on_card(cuda, n_shards):
    """A sharded streaming ``DeviceInstance``: GREEDY's allocation, the
    best-two tables and a forced full rebuild of the delta refresh are
    the unsharded instance's, bit for bit."""
    from repro_torch.launch.mesh import make_lookup_mesh
    cat = catalog.embedding_catalog(n=5000, dim=100, seed=2)
    net = topology.tpu_hierarchy(16, 32, 64, 15.0, 150.0, 1000.0)
    inst = Instance(net=net, cat=cat, dem=demand.zipf(cat, alpha=0.9,
                                                      seed=2))
    kw = dict(materialize_ca=False, device=cuda)
    d = DeviceInstance.from_instance(inst, **kw)
    ds = DeviceInstance.from_instance(inst, mesh=make_lookup_mesh(n_shards),
                                      axes=("data",), **kw)
    slots = device_greedy(ds)
    np.testing.assert_array_equal(slots, device_greedy(d))
    for a, b in zip(ds.best_two_tables(slots), d.best_two_tables(slots)):
        assert torch.equal(_bits(a), _bits(b))
    pre = ds.best_two_tables(slots)
    new = slots.copy()
    new[:40] = np.arange(4000, 4040)
    ys = np.arange(40)
    for a, b in zip(ds.best_two_delta(*pre, new, ys, cap=1),
                    d.best_two_tables(new)):
        assert torch.equal(_bits(a), _bits(b))
