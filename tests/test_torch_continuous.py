"""The port's continuous-limit module (paper §4) against the JAX
reference, on the CPU. Mirrors tests/test_continuous.py.

The same inputs, made from a seed with numpy, go through
``repro.core.placement.continuous`` and
``repro_torch.core.placement.continuous``.

Tolerances:
* the NumPy and float parts are copies: bitwise equal;
* ``chain_cost`` and ``tandem_both_cost``: values to 1e-6 relative, and
  their autograd gradients to ``jax.grad``'s within GRAD_TOL of the
  gradient's largest entry (both are f32; the frameworks' pow and sum
  orders differ by ulps). Against the hand-coded eq. (15) in f64, the
  reference's own bound (rtol 3e-3, atol 3e-4);
* ``solve_chain``: ``w`` within W_ATOL absolute and the cost within
  COST_RTOL relative — thousands of f32 steps add up ulp-level
  differences;
* ``solve_tandem_both``: ``w1`` within the last step, lr/√(1 + T/100):
  the projected normalized gradient oscillates by up to one step around
  the optimum where the cost is flat, so a one-ulp difference may move
  an entry by that much; the cost, which is flat there, within
  COST_RTOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.placement import continuous as JC
from repro_torch.core.placement import continuous as C

GRAD_TOL = 1e-5
W_ATOL = 1e-4
COST_RTOL = 1e-5


def _specs(**kw):
    return JC.ChainSpec(**kw), C.ChainSpec(**kw)


def _zipf_chain(seed):
    """A random Zipf chain instance, drawn as the reference's
    test_chain_md_matches_thresholds_on_zipf draws it."""
    rng = np.random.default_rng(seed)
    M = int(rng.integers(30, 120))
    lams = 1.0 / (np.arange(1, M + 1) ** [0.6, 1.0, 1.3][seed % 3])
    rng.shuffle(lams)
    ks = tuple(float(k) for k in rng.integers(5, M, 2))
    return lams, dict(ks=ks, hs=(0.0, float(rng.uniform(0.2, 3.0))),
                      h_repo=float(rng.uniform(4.0, 20.0)))


# ------------------------------------------------- copied NumPy parts
def _numpy_cases():
    rng = np.random.default_rng(0)
    lams = rng.gamma(2.0, 1.0, 37)
    spec = dict(ks=(20.0, 35.0, 12.0), hs=(0.0, 1.2, 3.5), h_repo=9.0,
                gamma=1.3)
    cum = np.concatenate([[0.0], np.cumsum(lams)])
    pos = rng.uniform(-1.0, 40.0, 9)
    order = np.argsort(-lams, kind="stable")
    w1 = rng.uniform(0.05, 0.95, 37)
    return {
        "zeta": lambda m: [m.zeta(g) for g in (0.5, 1.0, 1.3, 2.0)],
        "cell_cost": lambda m: m.cell_cost(0.3, 2.0, 1.3),
        "single_cache_allocation":
            lambda m: m.single_cache_allocation(lams, 50.0, 1.3),
        "single_cache_cost": lambda m: m.single_cache_cost(lams, 50.0, 0.7),
        "_interp_prefix": lambda m: m._interp_prefix(cum, pos),
        "_band_cost": lambda m: m._band_cost(
            np.sort(lams)[::-1], np.concatenate(
                [[0.0], np.cumsum(np.sort(lams)[::-1] ** (2 / 3.3))]),
            np.concatenate([[0.0], np.cumsum(np.sort(lams)[::-1])]),
            np.array([4.5, 11.25, 30.0]), m.ChainSpec(**spec)),
        "solve_chain_thresholds":
            lambda m: m.solve_chain_thresholds(lams, m.ChainSpec(**spec)),
        "thresholds_to_w":
            lambda m: m.thresholds_to_w(lams, np.array([3.5, 9.0, 41.0]),
                                        order, 3),
        "tree_cost": lambda m: m.tree_cost(
            lams, np.array([0.5, 2.0]), m.ChainSpec(**spec)),
        "tandem_both_grad":
            lambda m: m.tandem_both_grad(w1, lams, 10.0, 12.0, 0.4, 0.6,
                                         1.3),
        "shifted_tessellation_cost":
            lambda m: [m.shifted_tessellation_cost(100, h, 1.0, 1.0, 0.5)
                       for h in (0.0, 0.03, 0.2)],
        "shifted_tessellation_cost_numeric":
            lambda m: m.shifted_tessellation_cost_numeric(
                64, 0.02, 1.0, 1.0, beta=0.5, gamma=1.5, samples=64),
    }


def _assert_bitwise(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bitwise(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("name", sorted(_numpy_cases()))
def test_numpy_parts_are_bitwise_the_references(name):
    fn = _numpy_cases()[name]
    _assert_bitwise(fn(C), fn(JC))


# ----------------------------------------------- costs and gradients
def test_maximum_splits_a_tie_like_jax():
    """max(x, 0)'s gradient: 1 above, ½ at the tie, 0 below — JAX's
    rule for ``jnp.maximum``, where ``torch.clamp_min`` would give 1."""
    x = np.array([-1.0, 0.0, 2.0], np.float32)
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jnp.maximum(v, 0.0) * jnp.arange(1.0, 4.0)))(
            jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got, = torch.autograd.grad(
        (C._maximum(xt, 0.0) * torch.arange(1.0, 4.0)).sum(), xt)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [0.0, 1.0, 3.0])


def test_steps_are_f32_like_the_references():
    """The step lr/√(1 + t/50) is computed in f32 as the reference's
    jitted loop computes it; XLA rewrites it into an FMA and an rsqrt,
    which agree with the f32 formula within 2 ulp."""
    steps = C._steps(1.0, 4000, 50.0, torch.device("cpu")).numpy()
    t = np.arange(4000, dtype=np.float32)
    want = np.float32(1.0) / np.sqrt(np.float32(1.0) + t / np.float32(50))
    np.testing.assert_array_equal(steps, want)
    assert steps.dtype == np.float32

    @jax.jit
    def ref_steps(lr):
        return jax.lax.fori_loop(
            0, 4000, lambda i, acc: acc.at[i].set(
                lr / jnp.sqrt(1.0 + i / 50.0)), jnp.zeros(4000))
    np.testing.assert_allclose(steps, np.asarray(ref_steps(1.0)),
                               rtol=2 * 2.0 ** -23, atol=0)


@pytest.mark.parametrize("gamma", [0.5, 1.0, 2.0])
def test_chain_cost_and_gradient_match_jax(gamma):
    rng = np.random.default_rng(int(gamma * 10))
    lams = rng.gamma(2.0, 1.0, 40).astype(np.float32)
    w = rng.dirichlet(np.ones(4), 40).astype(np.float32)
    jspec, spec = _specs(ks=(25.0, 10.0, 40.0), hs=(0.0, 1.5, 2.5),
                         h_repo=6.0, gamma=gamma)
    jc = JC.chain_cost(jnp.asarray(w), jnp.asarray(lams), jspec)
    jg = np.asarray(jax.grad(JC.chain_cost)(jnp.asarray(w),
                                            jnp.asarray(lams), jspec))
    wt = torch.tensor(w, requires_grad=True)
    c = C.chain_cost(wt, torch.tensor(lams), spec)
    g, = torch.autograd.grad(c, wt)
    assert float(c.detach()) == pytest.approx(float(jc), rel=1e-6)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                               atol=GRAD_TOL * np.abs(jg).max())


@pytest.mark.parametrize("seed,gamma,beta", [
    (0, 1.0, 0.6), (1, 0.5, 0.0), (2, 2.0, 0.3), (3, 1.0, 2.0)])
def test_tandem_both_gradient_matches_jax_and_eq15(seed, gamma, beta):
    """Autograd of (14) against ``jax.grad`` and against the hand-coded
    eq. (15), over the reference's parameter family (mirrors
    test_eq15_gradient_matches_autodiff*)."""
    rng = np.random.default_rng(seed)
    M = int(rng.integers(8, 40))
    lams = rng.gamma(2.0, 1.0, M)
    w1 = rng.uniform(0.05, 0.95, M)
    k1, k2 = rng.uniform(5.0, 40.0, 2)
    args = (float(k1), float(k2), float(rng.uniform(0.05, 2.0)),
            float(beta), float(gamma))
    jc = JC.tandem_both_cost(jnp.asarray(w1), jnp.asarray(lams), *args)
    jg = np.asarray(jax.grad(JC.tandem_both_cost)(
        jnp.asarray(w1), jnp.asarray(lams), *args))
    wt = torch.tensor(w1, dtype=torch.float32, requires_grad=True)
    c = C.tandem_both_cost(wt, torch.tensor(lams, dtype=torch.float32),
                           *args)
    g, = torch.autograd.grad(c, wt)
    hand = C.tandem_both_grad(w1, lams, *args)
    scale = np.abs(hand).max() + 1e-12
    assert float(c.detach()) == pytest.approx(float(jc), rel=1e-6)
    np.testing.assert_allclose(g.numpy() / scale, jg / scale, rtol=0,
                               atol=GRAD_TOL)
    np.testing.assert_allclose(g.numpy() / scale, hand / scale, rtol=3e-3,
                               atol=3e-4)


def test_tandem_both_cost_in_f32_with_tensor_scalars():
    """With 0-dim f32 tensors for its scalars — as the solve passes them,
    as the reference's jitted solve traces them — the cost matches the
    reference's inside ``jit``."""
    rng = np.random.default_rng(9)
    lams = rng.gamma(2.0, 1.0, 25).astype(np.float32)
    w1 = rng.uniform(0.05, 0.95, 25).astype(np.float32)
    args = (11.0, 23.0, 0.7, 0.4, 1.0)
    jc = jax.jit(JC.tandem_both_cost)(jnp.asarray(w1), jnp.asarray(lams),
                                      *args)
    c = C.tandem_both_cost(torch.tensor(w1), torch.tensor(lams),
                           *(torch.tensor(a) for a in args))
    assert c.dtype == torch.float32
    assert float(c) == pytest.approx(float(jc), rel=1e-6)


# ------------------------------------------------------------ descents
@pytest.mark.parametrize("case", ["gamma0.5", "gamma1", "gamma2", "zipf"])
def test_solve_chain_matches_jax(case):
    if case == "zipf":
        lams, kw = _zipf_chain(4)
        kw["gamma"] = 1.0
    else:
        rng = np.random.default_rng(len(case))
        lams = rng.gamma(2.0, 1.0, 40)
        kw = dict(ks=(25.0, 25.0), hs=(0.0, 1.5), h_repo=6.0,
                  gamma=float(case[5:]))
    jspec, spec = _specs(**kw)
    jw, jcost = JC.solve_chain(lams, jspec)
    w, cost = C.solve_chain(lams, spec, device="cpu")
    assert w.dtype == np.float32 and w.shape == jw.shape
    np.testing.assert_allclose(w, jw, rtol=0, atol=W_ATOL)
    assert cost == pytest.approx(jcost, rel=COST_RTOL)


@pytest.mark.parametrize("seed,gamma,beta", [
    (0, 1.0, 0.3), (1, 0.5, 0.0), (2, 2.0, 2.0), (4, 1.0, 0.3)])
def test_solve_tandem_both_matches_jax(seed, gamma, beta):
    rng = np.random.default_rng(seed)
    M = int(rng.integers(30, 120))
    lams = rng.gamma(2.0, 1.0, M)
    k1, k2 = rng.uniform(5, 40, 2)
    h = float(rng.uniform(0.05, 2.0))
    iters, lr = 3000, 0.05
    jw1, jcost = JC.solve_tandem_both(lams, k1, k2, h, beta, gamma,
                                      iters=iters)
    w1, cost = C.solve_tandem_both(lams, k1, k2, h, beta, gamma,
                                   iters=iters, device="cpu")
    assert w1.dtype == np.float32 and w1.shape == (M,)
    last_step = lr / np.sqrt(1.0 + (iters - 1) / 100.0)
    np.testing.assert_allclose(w1, jw1, rtol=0, atol=last_step)
    assert cost == pytest.approx(jcost, rel=COST_RTOL)


def test_solve_chain_bit_deterministic():
    """Fixed iters/lr ⇒ bit-reproducible across calls — the property that
    keeps warm-started background refreshes replayable."""
    rng = np.random.default_rng(2)
    lams = rng.gamma(2.0, 1.0, 50)
    spec = C.ChainSpec(ks=(20.0, 35.0), hs=(0.0, 1.2), h_repo=7.0,
                       gamma=1.0)
    w1, c1 = C.solve_chain(lams, spec, iters=800, device="cpu")
    w2, c2 = C.solve_chain(lams, spec, iters=800, device="cpu")
    np.testing.assert_array_equal(w1, w2)
    assert c1 == c2
    t1 = C.solve_tandem_both(lams, 20.0, 30.0, 0.5, 0.4, iters=500,
                             device="cpu")
    t2 = C.solve_tandem_both(lams, 20.0, 30.0, 0.5, 0.4, iters=500,
                             device="cpu")
    np.testing.assert_array_equal(t1[0], t2[0])
    assert t1[1] == t2[1]


def test_descents_run_on_the_card_unless_told(monkeypatch):
    """With no card a descent asked for the default device raises; it
    never slides onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = C.ChainSpec(ks=(2.0,), hs=(0.0,), h_repo=5.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.solve_chain(np.ones(4), spec, iters=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.solve_tandem_both(np.ones(4), 2.0, 2.0, 0.5, 0.1, iters=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.tree_cost(np.ones(4), np.ones(2), spec, use_thresholds=False)


# ---------------------------- the reference's invariants, on the port
@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 10_000), gamma=st.sampled_from([0.5, 1.0, 2.0]))
def test_chain_md_matches_thresholds_on_zipf(seed, gamma):
    """Mirror descent on (11) and the Prop 4.2 threshold solver find the
    same optimum (the reference's tolerances)."""
    lams, kw = _zipf_chain(seed)
    spec = C.ChainSpec(**kw, gamma=gamma)
    _, c_md = C.solve_chain(lams, spec, iters=6000, device="cpu")
    _, c_th, _ = C.solve_chain_thresholds(lams, spec)
    assert c_md == pytest.approx(c_th, rel=3e-2)
    assert c_th <= c_md + 1e-5 * max(1.0, c_th)


def test_prop42_threshold_monotonicity():
    """The optimal w from mirror descent respects Prop 4.2/4.3: regions
    sorted by decreasing λ have nondecreasing dominant servers, barring
    boundary regions."""
    rng = np.random.default_rng(7)
    lams = np.sort(rng.gamma(2.0, 1.0, 60))[::-1].copy()
    spec = C.ChainSpec(ks=(30.0, 30.0), hs=(0.0, 2.0), h_repo=8.0,
                       gamma=1.0)
    w, _ = C.solve_chain(lams, spec, iters=8000, device="cpu")
    changes = np.diff(np.argmax(w, axis=1))
    assert np.all(changes >= 0) or np.sum(changes < 0) <= 2


def test_tandem_both_beta0_recovers_leaf_only_regime():
    """β=0 reduces (14) to the leaf-only tandem of (11): the optima
    agree."""
    rng = np.random.default_rng(5)
    lams = rng.gamma(2.0, 1.0, 30)
    _, c14 = C.solve_tandem_both(lams, 20.0, 20.0, 0.8, beta=0.0,
                                 gamma=1.0, iters=8000, lr=0.1,
                                 device="cpu")
    spec = C.ChainSpec(ks=(20.0, 20.0), hs=(0.0, 0.8), h_repo=1e9,
                       gamma=1.0)
    _, c11, _ = C.solve_chain_thresholds(lams, spec)
    assert c14 == pytest.approx(c11, rel=2e-2)
