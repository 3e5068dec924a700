"""The plain version of kernels A and B's cross-split merge, and the
split plan, on the CPU.

Mirrors the mesh-free oracle of tests/test_sharded_lookup.py: the port's
``sharded_fused_lookup_ref`` (pad to the shard count, each contiguous
chunk's minimum with ``fold_repo=False``, a lexicographic reduction) is
held against the JAX ``sharded_fused_lookup_ref`` with the tolerance of
tests/test_torch_lookup.py (costs within the matmul-form bound, winners
equal wherever the reference's decision is not an f32 near-tie). Inside
the port it must equal the unsharded ``fused_lookup_ref`` bit for bit at
every shard count: that is the exactness the kernel's split merge keeps.
``_split_plan`` is the wrapper's cut of the key axis; the kernel walks
exactly the ranges ``SplitPlan.ranges`` lists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.knn.ref import sharded_fused_lookup_ref as j_sharded
from repro_torch.kernels.knn import fused_lookup_ref
from repro_torch.kernels.knn.knn import (KEY_TILE, SMEM_LIMIT, _smem_bytes,
                                         _split_plan)
from repro_torch.kernels.knn.ref import (_pair_ca, pad_to_shards,
                                         reduce_shard_minima,
                                         sharded_fused_lookup_ref)

U32 = 2.0 ** -24
_INF = 3.0e38


def cost_tol(q, k, ca, metric):
    """Per-query tolerance on a winning cost near ``ca`` (γ = 1), as in
    tests/test_torch_lookup.py."""
    if metric == "l1":
        return 1e-5 * np.abs(ca) + 1e-5
    t2 = 16 * U32 * ((q * q).sum(1) + (k * k).sum(1).max())
    tol_d = t2 if metric == "l2sq" else t2 / (ca + np.sqrt(t2))
    return tol_d + 1e-5 * np.abs(ca) + 1e-5


def segmented(seed, Q=29, K=53, D=6):
    """Queries and a three-level segmented key tensor: one sentinel key
    marked invalid, payload = concatenated index."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((Q, D)) * 2).astype(np.float32)
    k = (rng.standard_normal((K, D)) * 2).astype(np.float32)
    k[4] = 1e15
    bounds = [0, K // 5, K // 2, K]
    level = np.zeros(K, np.int32)
    slot = np.zeros(K, np.int32)
    h = np.zeros(K, np.float32)
    for lv, (a, b) in enumerate(zip(bounds, bounds[1:])):
        level[a:b], slot[a:b] = lv, np.arange(b - a)
        h[a:b] = (0.0, 0.4, 1.1)[lv]
    valid = (np.arange(K) != 4).astype(np.int32)
    pay = np.where(valid > 0, np.arange(K), -1).astype(np.int32)
    return q, k, h, np.stack([level, slot, pay, valid])


def port(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("fold_repo", [True, False])
@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_sharded_ref_matches_reference(n_shards, metric, fold_repo):
    q, k, h, meta = segmented(n_shards * 10 + len(metric))
    h_repo = 2.5
    got = [a.numpy() for a in sharded_fused_lookup_ref(
        *port(q, k, h, meta), n_shards=n_shards, metric=metric,
        h_repo=h_repo, repo_level=-1, fold_repo=fold_repo)]
    # without the fold the reference's reduction is taken with a
    # repository that never wins (h_repo = +INF): its shard minima stand
    ref = [np.asarray(a) for a in j_sharded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(h), jnp.asarray(meta),
        n_shards=n_shards, metric=metric,
        h_repo=h_repo if fold_repo else _INF, repo_level=-1)]
    tol = cost_tol(q, k[meta[3] > 0], ref[1], metric)
    np.testing.assert_array_less(np.abs(got[0] - ref[0]), tol)
    same = got[4] == ref[4]
    assert same.mean() > 0.9
    full = np.where(meta[3][None, :] > 0, _pair_ca(
        *port(q, k), metric, 1.0).numpy() + h[None, :], _INF)
    for r in np.nonzero(~same)[0]:           # a near-tie of the port's own
        at_ref = full[r, ref[4][r]] if ref[4][r] >= 0 else h_repo
        assert at_ref - got[0][r] <= 2 * tol[r]
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(a[same], b[same])


@pytest.mark.parametrize("metric", ["l1", "l2", "l2sq"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 5, 8])
def test_sharded_ref_equals_unsharded_bitwise(n_shards, metric):
    """Ties placed across every shard boundary (the same key stored in
    each shard) go to the lowest index, and a shard whose keys are all
    invalid (sentinels and NaN) is masked: bitwise the unsharded
    lookup, with and without the repository fold."""
    q, k, h, meta = segmented(100 + n_shards, Q=31, K=64)
    S = -(-64 // n_shards)
    k[S - 1::S] = q[0]                        # the last key of each shard
    h[S - 1::S] = 0.0
    dead = slice(S, 2 * S) if n_shards > 2 else slice(40, 44)
    k[dead] = 1e15
    k[dead.start] = np.nan
    meta[3, dead] = 0
    meta[2, dead] = -1
    for fold_repo in (True, False):
        kw = dict(metric=metric, h_repo=1.7, repo_level=-1,
                  fold_repo=fold_repo)
        a = sharded_fused_lookup_ref(*port(q, k, h, meta), n_shards, **kw)
        b = fused_lookup_ref(*port(q, k, h, meta), **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert int(a[4][0]) in (S - 1, -1)    # the lowest of the copies
        live = (a[4] >= 0)
        assert not bool(((a[4] >= dead.start) & (a[4] < dead.stop)
                         & live).any())


@pytest.mark.parametrize("n_shards", [1, 2, 3, 7])
def test_pad_to_shards_masks_its_padding(n_shards):
    _, k, h, meta = segmented(7, K=23)
    kp, hp, mp = pad_to_shards(*port(k, h, meta), n_shards)
    assert kp.shape[0] % n_shards == 0 and kp.shape[0] - 23 < n_shards
    assert torch.equal(kp[:23], torch.as_tensor(k))
    pad = slice(23, None)
    assert bool((kp[pad] == 0).all()) and bool((hp[pad] == 0).all())
    assert bool((mp[3, pad] == 0).all()) and bool((mp[2, pad] == -1).all())


def test_reduce_shard_minima_ties_to_lowest_shard():
    c = torch.tensor([[1.0, 5.0, _INF], [1.0, 2.0, _INF]])
    ca = torch.tensor([[0.5, 4.0, 0.0], [0.7, 1.0, 0.0]])
    lvl = torch.tensor([[0, 0, -1], [1, 1, -1]], dtype=torch.int32)
    slot = torch.tensor([[3, 4, 0], [5, 6, 0]], dtype=torch.int32)
    pay = torch.tensor([[30, 40, -1], [50, 60, -1]], dtype=torch.int32)
    out = reduce_shard_minima(c, ca, lvl, slot, pay, h_repo=1.5)
    assert out[4].tolist() == [30, -1, -1]   # tie → shard 0; 2.0 > h_repo
    assert out[0].tolist() == [1.0, 1.5, 1.5]
    raw = reduce_shard_minima(c, ca, lvl, slot, pay, h_repo=1.5,
                              fold_repo=False)
    assert raw[4].tolist() == [30, 60, -1]
    assert raw[0][2].item() == pytest.approx(_INF)


PLAN_CASES = [(1, 1, 3), (8, 448, 100), (16, 448, 100), (32, 448, 100),
              (64, 448, 100), (256, 448, 100), (256, 65_536, 100),
              (1, 65_536, 100), (300, 20_000, 100), (256, 45_056, 100),
              (77, 530, 19), (4096, 129, 700), (5, 1_000_000, 2000),
              (77, 3000, 8192), (1, 200, 100_000)]


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("Q,K,D", PLAN_CASES)
def test_split_plan_covers_the_keys(Q, K, D, n_sm):
    plan = _split_plan(Q, K, D, n_sm)
    assert plan.q_tile in (64, 8)
    assert _smem_bytes(plan.q_tile, D, plan.q_stream) <= SMEM_LIMIT
    ranges = plan.ranges()
    assert len(ranges) == plan.n_splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c                          # contiguous, ascending
    for a, b in ranges:
        assert a < b and a % KEY_TILE == 0     # non-empty whole tiles
        assert b % KEY_TILE == 0 or b == K


@pytest.mark.parametrize("Q", [8, 16, 32, 64, 256])
def test_split_plan_small_k_is_one_split(Q):
    assert _split_plan(Q, 448, 100, 132).n_splits == 1


@pytest.mark.parametrize("n_sm", [132, 114])
def test_split_plan_fills_the_card_at_large_k(n_sm):
    plan = _split_plan(256, 65_536, 100, n_sm)
    blocks = -(-256 // plan.q_tile) * plan.n_splits
    assert plan.q_tile == 64 and blocks >= 2 * n_sm
    assert plan.n_splits > 1


@pytest.mark.parametrize("D,q_stream", [(100, False), (5000, False),
                                         (5500, False), (5600, True),
                                         (8192, True), (100_000, True)])
def test_split_plan_streams_the_query_tile_only_when_none_fits(D, q_stream):
    """A row width that leaves no resident query tile room in shared
    memory streams the tile through the key ring; any narrower one keeps
    a resident tile."""
    plan = _split_plan(8, 1000, D, 132)
    assert plan.q_stream is q_stream
    assert plan.q_tile == 8 or not q_stream    # the one streamed tile
    resident_fits = any(_smem_bytes(t, D) <= SMEM_LIMIT for t in (64, 8))
    assert resident_fits is not q_stream
    assert _smem_bytes(plan.q_tile, D, plan.q_stream) <= SMEM_LIMIT
