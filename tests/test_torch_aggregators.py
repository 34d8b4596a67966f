"""The port's aggregators (repro_torch.fl.state: subset, guarded, weighted and
scheme aggregation, the guard and scheme weights) against the JAX
package's, on flat ``[R, W]`` rows made from a seed with numpy.

The JAX package rounds eq. 3 three ways (its CPU path divides a masked sum
by K, its TPU kernel multiplies each row by ``m·w/K``, its weighted CPU path
multiplies by ``a``); the port runs one plain version and one kernel.  So
aggregates are held to rtol 1e-5, atol 1e-6, and weights and norms to rtol
1e-6 (``update_norms`` sums one flat row where JAX sums each leaf, then the
leaves).  Finite inputs are held against JAX's jnp path; rows with NaN/Inf
against JAX's Pallas kernel in interpret mode (``use_pallas=True``), whose
weighted mode zeroes non-finite elements as the port does on both devices.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import faults as jfaults
from repro.fl import state as jstate
from repro_torch.fl import faults as tfaults
from repro_torch.fl import state as tstate

AGG_RTOL, AGG_ATOL = 1e-5, 1e-6
W_RTOL = 1e-6
RS = [1, 5, 64]
WS = [129, 1000]

AGGS = [("paper", "constant"), ("fedasync", "constant"),
        ("fedasync", "hinge"), ("fedasync", "poly"), ("csmaafl", "constant"),
        ("age", "constant")]          # tests/test_scheme_parity.py:25-32
GUARDS = {
    "none": None,
    "off": dict(quarantine=False),
    "quarantine": dict(),
    "clip": dict(quarantine=False, clip_norm=0.05),
    "stale": dict(quarantine=False, staleness_power=0.5, staleness_cap=3),
    "all": dict(clip_norm=0.05, staleness_power=0.5, staleness_cap=3),
}


def guards(name):
    kw = GUARDS[name]
    if kw is None:
        return None, None
    return jfaults.GuardConfig(**kw), tfaults.GuardConfig(**kw)


def aggs(kind, sfn):
    return (jstate.AggregatorConfig(kind=kind, staleness_fn=sfn),
            tstate.AggregatorConfig(kind=kind, staleness_fn=sfn))


def rows(R, W, seed, poison=False):
    """g [W], deltas [R, W], a 0/1 mask, staleness and probabilities;
    ``poison`` puts NaN and Inf into some rows (some of them delivered)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=W).astype(np.float32)
    d = (rng.normal(size=(R, W)) * rng.uniform(0.005, 0.05, (R, 1))) \
        .astype(np.float32)
    mask = (rng.uniform(size=R) < 0.6).astype(np.float32)
    mask[0] = 1.0
    stale = rng.integers(0, 8, R).astype(np.int32)
    probs = rng.uniform(0.0, 1.0, R).astype(np.float32)
    if poison:
        d[0, W // 2] = np.nan
        if R > 1:
            d[R - 1, :3] = np.inf
            mask[R - 1] = 1.0
        if R > 3:
            d[2] = -np.inf
    return g, d, mask, stale, probs


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(a)


def close(got, want, rtol=AGG_RTOL, atol=AGG_ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("R", RS)
def test_subset_aggregate_matches_jax(R, W):
    g, d, mask, _, _ = rows(R, W, 1)
    for k in (R, 3 * R, torch.tensor(3 * R)):
        want = jstate.subset_aggregate(j(g), j(d), j(mask), int(k),
                                       use_pallas=False)
        close(tstate.subset_aggregate(t(g), t(d), t(mask), k), want)


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("R", RS)
def test_finite_rows_and_update_norms_match_jax(R, W):
    """JAX sums each leaf of the pytree, then the leaves; the port one flat
    row: the same norm to rtol 1e-6."""
    _, d, _, _, _ = rows(R, W, 2, poison=True)
    split = W // 3
    tree = {"a": j(d[:, :split]), "b": j(d[:, split:].reshape(R, -1, 1))}
    np.testing.assert_array_equal(tstate.finite_rows(t(d)).numpy(),
                                  np.asarray(jstate.finite_rows(tree)))
    close(tstate.update_norms(t(d)), jstate.update_norms(tree), rtol=W_RTOL,
          atol=0)
    assert tstate.update_norms(t(d)).dtype == torch.float32


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("name", [n for n in GUARDS if GUARDS[n] is not None])
@pytest.mark.parametrize("R", RS)
def test_guard_weights_match_jax(R, name, poison):
    _, d, _, stale, _ = rows(R, 129, 3, poison=poison)
    jg, tg = guards(name)
    jw, jout = jstate.guard_weights(j(d), j(stale), jg)
    tw, tout = tstate.guard_weights(t(d), t(stale), tg)
    close(tw, jw, rtol=W_RTOL, atol=0)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tg.active == jg.active


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("name", list(GUARDS))
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("R", RS)
def test_guarded_aggregate_matches_jax(R, W, name, poison):
    g, d, mask, stale, _ = rows(R, W, 4, poison=poison)
    jg, tg = guards(name)
    K = R
    got = tstate.guarded_aggregate(t(g), t(d), t(mask), K, t(stale), tg)
    if poison and (tg is None or not tg.active):
        # the plain mode: 0 · NaN = NaN, as in JAX (row 0 is delivered)
        want = jstate.guarded_aggregate(j(g), j(d), j(mask), K, j(stale), jg,
                                        use_pallas=False)
        np.testing.assert_array_equal(np.isnan(got.numpy()),
                                      np.isnan(np.asarray(want)))
        return
    want = jstate.guarded_aggregate(j(g), j(d), j(mask), K, j(stale), jg,
                                    use_pallas=poison)
    close(got, want)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("name", ["none", "quarantine", "all"])
@pytest.mark.parametrize("R", RS)
def test_guarded_subset_aggregate_matches_jax(R, name, poison):
    g, d, valid, stale, _ = rows(R, 1000, 5, poison=poison)
    jg, tg = guards(name)
    K = 4 * R
    got = tstate.guarded_subset_aggregate(t(g), t(d), t(valid), K, t(stale),
                                          tg)
    want = jstate.guarded_subset_aggregate(j(g), j(d), j(valid), K, j(stale),
                                           jg, use_pallas=poison)
    if poison and tg is None:
        np.testing.assert_array_equal(np.isnan(got.numpy()),
                                      np.isnan(np.asarray(want)))
    else:
        close(got, want)


def test_aggregator_config_matches_jax():
    """Validation errors with JAX's messages; ``params`` as float32 0-dim
    tensors with JAX's values."""
    for kw in (dict(kind="nope"), dict(staleness_fn="nope"),
               dict(kind="FedAsync")):
        with pytest.raises(ValueError) as want:
            jstate.AggregatorConfig(**kw)
        with pytest.raises(ValueError) as got:
            tstate.AggregatorConfig(**kw)
        assert str(got.value) == str(want.value)
    for kind, sfn in AGGS:
        ja, ta = aggs(kind, sfn)
        ta = dataclasses.replace(ta, mix=0.3, age_a=1.5)
        ja = dataclasses.replace(ja, mix=0.3, age_a=1.5)
        jp, tp = ja.params(), ta.params("cpu")
        assert tp._fields == jp._fields
        for name in jp._fields:
            x = getattr(tp, name)
            assert x.dtype == torch.float32 and x.shape == ()
            assert x.item() == float(getattr(jp, name)), name


@pytest.mark.parametrize("kind,sfn", AGGS)
def test_staleness_scale_matches_jax(kind, sfn):
    ja, ta = aggs(kind, sfn)
    s = np.r_[np.arange(0, 200), [1000, 10_000, 100_000]].astype(np.int32)
    close(tstate.staleness_scale(t(s), ta.params("cpu")),
          jstate.staleness_scale(j(s), ja.params()), rtol=W_RTOL, atol=0)


K7 = 7


def weights_case(case, seed=11):
    """tests/test_scheme_properties.py:135-160: the grid's cases, and the
    fuzz's draws for an int seed."""
    rng = np.random.default_rng(seed)
    if case == "fuzz":
        return (rng.integers(0, 2, K7).astype(np.float32),
                rng.integers(0, 10_000, K7).astype(np.int32),
                rng.uniform(0.0, 1.0, K7).astype(np.float32))
    mask = {"all": np.ones(K7), "none": np.zeros(K7), "one": np.eye(K7)[2],
            "stale": rng.integers(0, 2, K7), "tiny-p": np.ones(K7)}[case]
    staleness = {"stale": rng.integers(0, 200, K7)}.get(
        case, rng.integers(0, 5, K7))
    probs = (np.full(K7, 1e-9) if case == "tiny-p"
             else rng.uniform(0.01, 1.0, K7))
    return (mask.astype(np.float32), staleness.astype(np.int32),
            probs.astype(np.float32))


@pytest.mark.parametrize("case", ["all", "none", "one", "stale", "tiny-p"]
                         + [f"fuzz-{s}" for s in range(25)])
@pytest.mark.parametrize("kind,sfn", AGGS)
def test_scheme_weights_match_jax(kind, sfn, case):
    mask, stale, probs = (weights_case("fuzz", int(case[5:]))
                          if case.startswith("fuzz") else weights_case(case))
    ja, ta = aggs(kind, sfn)
    want = np.asarray(jstate.scheme_weights(j(mask), j(stale), j(probs),
                                            ja.params(), K7))
    got = tstate.scheme_weights(t(mask), t(stale), t(probs),
                                ta.params("cpu"), K7)
    close(got, want, rtol=W_RTOL, atol=1e-9)
    a = got.numpy()
    assert np.isfinite(a).all() and (a >= 0).all()
    assert (a[mask == 0] == 0).all()
    if kind == "paper":
        np.testing.assert_allclose(a.sum(), mask.sum() / K7, rtol=1e-5)
    elif mask.sum() > 0:
        np.testing.assert_allclose(a.sum(), ta.mix, rtol=1e-5)
    else:
        assert a.sum() == 0.0


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("R", RS)
def test_weighted_aggregate_matches_jax(R, W, poison):
    g, d, mask, _, probs = rows(R, W, 6, poison=poison)
    a = mask * probs / R
    want = jstate.weighted_aggregate(j(g), j(d), j(a), use_pallas=poison)
    close(tstate.weighted_aggregate(t(g), t(d), t(a)), want)


@pytest.mark.parametrize("guard", ["none", "quarantine", "all"])
@pytest.mark.parametrize("kind,sfn", AGGS)
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("R", RS)
def test_scheme_aggregate_matches_jax(R, W, kind, sfn, guard):
    g, d, mask, stale, probs = rows(R, W, 7)
    ja, ta = aggs(kind, sfn)
    jg, tg = guards(guard)
    want = jstate.scheme_aggregate(j(g), j(d), j(mask), R, j(stale), j(probs),
                                   ja, guards=jg, use_pallas=False)
    for agg in (ta, ta.params("cpu")):          # a config or its params
        close(tstate.scheme_aggregate(t(g), t(d), t(mask), R, t(stale),
                                      t(probs), agg, guards=tg), want)


@pytest.mark.parametrize("guard", ["none", "quarantine", "all"])
@pytest.mark.parametrize("kind,sfn", AGGS)
@pytest.mark.parametrize("R", [5, 64])
def test_scheme_aggregate_with_poison_matches_kernel(R, kind, sfn, guard):
    """NaN/Inf rows: JAX's Pallas kernel (interpret mode) zeroes their
    non-finite elements, as the port does; with quarantine the rows also
    get weight 0."""
    g, d, mask, stale, probs = rows(R, 129, 8, poison=True)
    ja, ta = aggs(kind, sfn)
    jg, tg = guards(guard)
    want = jstate.scheme_aggregate(j(g), j(d), j(mask), R, j(stale), j(probs),
                                   ja, guards=jg, use_pallas=True)
    got = tstate.scheme_aggregate(t(g), t(d), t(mask), R, t(stale), t(probs),
                                  ta, guards=tg)
    close(got, want)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("guard", ["none", "all"])
@pytest.mark.parametrize("kind,sfn", AGGS)
def test_scheme_subset_aggregate_matches_jax(kind, sfn, guard):
    P, K = 8, 50
    g, d, valid, stale, probs = rows(P, 1000, 9)
    valid[-3:] = 0.0                           # the bucket's padding lanes
    ja, ta = aggs(kind, sfn)
    jg, tg = guards(guard)
    want = jstate.scheme_subset_aggregate(j(g), j(d), j(valid), K, j(stale),
                                          j(probs), ja, guards=jg,
                                          use_pallas=False)
    close(tstate.scheme_subset_aggregate(t(g), t(d), t(valid), K, t(stale),
                                         t(probs), ta, guards=tg), want)
