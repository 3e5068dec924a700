"""The port's LSH / k-means candidate tables and query side
(kernels/knn/lsh.py) against the JAX reference, on the CPU.

Mirrors the table and helper parts of tests/test_lsh_pruning.py. The same
numpy inputs go through both packages.

What must match, and to what tolerance:
* the built tables (SimHash hyperplanes and buckets, k-means centroids
  and buckets, the resolved probe counts and capacities, the stacked
  shard tables): bit for bit — the build side is the reference's NumPy;
* ``candidate_union``, ``gather_candidate_rows`` and
  ``unscanned_h_bound`` on the same candidate matrices: bit for bit;
* ``candidate_matrix``: equal on every query whose SimHash margins all
  exceed 1e-5·‖q‖·‖plane‖ in magnitude (torch's einsum may round a
  margin within an ulp of zero to the other sign than XLA's, which flips
  one bit of the code) and, for k-means, whose probed centroid distances
  are apart by more than 1e-5 relative at the probe boundary (the same
  rounding can reorder two equal-within-an-ulp centroids). Each test
  names the queries it leaves out, and leaves out none at its seeds.
  Exact ties (duplicate keys, equal |margins|) keep the lower index
  first in both: the port sorts stably.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.knn import lsh as jlsh
from repro_torch.kernels.knn import lsh

MARGIN_RTOL = 1e-5


def _keys(seed: int, n: int = 600, d: int = 6, dup: int = 0):
    rng = np.random.default_rng(seed)
    keys = (rng.standard_normal((n, d)) * 2).astype(np.float32)
    if dup:                                     # a block of duplicates
        keys[10:10 + dup] = keys[5]
    valid = rng.random(n) > 0.1
    return keys, valid, rng


def _policies():
    return [
        ("lsh-default", dict(), "SimHashPolicy"),
        ("lsh-2x3x2", dict(n_tables=2, n_bits=3, n_probes=2), "SimHashPolicy"),
        ("lsh-cap", dict(n_bits=4, bucket_cap=5, seed=3), "SimHashPolicy"),
        ("lsh-1bit", dict(n_tables=2, n_bits=1, n_probes=2), "SimHashPolicy"),
        ("km-default", dict(), "KMeansPolicy"),
        ("km-small", dict(n_clusters=7, n_probes=3, fit_sample=200, seed=2),
         "KMeansPolicy"),
        ("km-cap", dict(n_clusters=5, bucket_cap=9), "KMeansPolicy"),
    ]


POLICIES = _policies()


def _tables(cls_name, kw, keys, valid):
    jt = getattr(jlsh, cls_name)(**kw).build(keys, valid)
    pol = getattr(lsh, cls_name)(**kw)
    return jt, pol.build(keys, valid), pol


@pytest.mark.parametrize("name,kw,cls_name", POLICIES,
                         ids=[p[0] for p in POLICIES])
@pytest.mark.parametrize("dup", [0, 40])
def test_tables_bitwise(name, kw, cls_name, dup):
    keys, valid, _ = _keys(1, dup=dup)
    jt, t, pol = _tables(cls_name, kw, keys, valid)
    assert (t.kind, t.n_keys, t.n_probes) == (jt.kind, jt.n_keys,
                                              jt.n_probes)
    np.testing.assert_array_equal(t.proj.view(np.int32),
                                  jt.proj.view(np.int32))
    np.testing.assert_array_equal(t.buckets, jt.buckets)
    jpol = getattr(jlsh, cls_name)(**kw)
    for n in (1, 100, 5000, 10 ** 6):
        assert pol.resolve_cap(n) == jpol.resolve_cap(n)
    assert pol.for_shard(2) == type(pol)(**{**kw, "seed":
                                            jpol.for_shard(2).seed})


def test_tables_with_no_valid_key_and_defaults():
    keys, _, _ = _keys(2, n=40)
    none = np.zeros(40, bool)
    for cls_name in ("SimHashPolicy", "KMeansPolicy"):
        jt, t, _ = _tables(cls_name, {}, keys, none)
        np.testing.assert_array_equal(t.buckets, jt.buckets)
        assert np.all(t.buckets == -1)
    for kind in ("lsh", "kmeans"):
        assert lsh.default_policy(kind, 4) == type(
            lsh.default_policy(kind))(seed=4)
        assert type(lsh.default_policy(kind)).__name__ == type(
            jlsh.default_policy(kind)).__name__
    with pytest.raises(ValueError, match="unknown candidate policy"):
        lsh.default_policy("ivf")


def test_stack_shard_tables_bitwise():
    keys, valid, _ = _keys(3, n=400)
    pol, jpol = lsh.SimHashPolicy(n_bits=3), jlsh.SimHashPolicy(n_bits=3)
    ts = [pol.for_shard(s).build(keys[s * 100:(s + 1) * 100],
                                 valid[s * 100:(s + 1) * 100])
          for s in range(4)]
    jts = [jpol.for_shard(s).build(keys[s * 100:(s + 1) * 100],
                                   valid[s * 100:(s + 1) * 100])
           for s in range(4)]
    for a, b in zip(lsh.stack_shard_tables(ts), jlsh.stack_shard_tables(jts)):
        np.testing.assert_array_equal(a, b)


def _excluded(t, q: np.ndarray) -> np.ndarray:
    """Queries left out of the candidate-matrix comparison (module
    docstring): a SimHash margin within 1e-5·‖q‖·‖plane‖ of zero, or a
    k-means probe boundary within 1e-5 relative."""
    qn = np.linalg.norm(q.astype(np.float64), axis=1)
    if t.kind == "lsh":
        m = np.einsum("bd,tdh->bth", q.astype(np.float64),
                      t.proj.astype(np.float64))
        pn = np.linalg.norm(t.proj.astype(np.float64), axis=1)  # (T, bits)
        near = np.abs(m) <= MARGIN_RTOL * qn[:, None, None] * pn[None]
        # equal |margins| within the rounding also reorder the probes
        a = np.sort(np.abs(m), axis=-1)
        close = np.diff(a, axis=-1) <= MARGIN_RTOL * qn[:, None, None] \
            * pn.max()
        return near.any(axis=(1, 2)) | close.any(axis=(1, 2))
    c = t.proj.astype(np.float64)
    d2 = ((q.astype(np.float64)[:, None, :] - c[None]) ** 2).sum(-1)
    s = np.sort(d2, axis=1)
    p = t.n_probes
    if p >= s.shape[1]:
        return np.zeros(q.shape[0], bool)
    return np.abs(s[:, p] - s[:, p - 1]) <= MARGIN_RTOL * s[:, p]


@pytest.mark.parametrize("name,kw,cls_name", POLICIES,
                         ids=[p[0] for p in POLICIES])
def test_candidate_matrix_matches_reference(name, kw, cls_name):
    keys, valid, rng = _keys(4, dup=20)
    jt, t, _ = _tables(cls_name, kw, keys, valid)
    q = (rng.standard_normal((97, 6)) * 2).astype(np.float32)
    q[:5] = keys[:5]                             # stored objects
    want = np.asarray(jlsh.candidate_matrix(
        jt.kind, jnp.asarray(jt.proj), jnp.asarray(jt.buckets),
        jnp.asarray(q), jt.n_probes))
    got = lsh.candidate_matrix(t.kind, torch.as_tensor(t.proj),
                               torch.as_tensor(t.buckets), torch.as_tensor(q),
                               t.n_probes).numpy()
    skip = _excluded(t, q)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[~skip], want[~skip])
    assert not skip.any(), np.nonzero(skip)[0]   # none at these seeds


def _cand(seed: int, B: int, P: int, n_keys: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.integers(-1, n_keys, (B, P)).astype(np.int32)
    c[0] = -1                                      # an all-miss row
    return c


@pytest.mark.parametrize("cap", [1, 17, 120, 600])
def test_union_gather_bound_bitwise(cap):
    """Same candidate matrix, same compact ascending union (with overflow
    drops at small caps), same gathered rows and verify bound."""
    keys, valid, rng = _keys(5, n=300)
    n = keys.shape[0]
    h = rng.choice(np.float32([0.0, 0.5, 2.0]), n).astype(np.float32)
    meta = np.stack([rng.integers(0, 3, n), np.arange(n),
                     rng.integers(-1, 999, n), valid]).astype(np.int32)
    cand = _cand(6, 13, 40, n)
    jk, jm = jlsh.candidate_union(jnp.asarray(cand), n, cap)
    k, m = lsh.candidate_union(torch.as_tensor(cand), n, cap)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    jg = jlsh.gather_candidate_rows(jnp.asarray(keys), jnp.asarray(h),
                                    jnp.asarray(meta), jk)
    g = lsh.gather_candidate_rows(torch.as_tensor(keys), torch.as_tensor(h),
                                  torch.as_tensor(meta), k)
    for a, b in zip(g, jg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jb = jlsh.unscanned_h_bound(jnp.asarray(h), jnp.asarray(meta), jm)
    b = lsh.unscanned_h_bound(torch.as_tensor(h), torch.as_tensor(meta), m)
    assert b.dim() == 0 and float(b) == float(jb)


def test_union_of_everything_bounds_at_inf():
    n = 50
    cand = np.arange(n, dtype=np.int32).reshape(5, 10)
    k, m = lsh.candidate_union(torch.as_tensor(cand), n, n)
    assert k.tolist() == list(range(n)) and bool(m.all())
    meta = torch.ones((4, n), dtype=torch.int32)
    b = lsh.unscanned_h_bound(torch.zeros(n), meta, m)
    assert float(b) >= 1e38
