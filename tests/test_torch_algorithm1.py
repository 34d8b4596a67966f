"""Offline Algorithm 1 of the port (repro_torch.core.algorithm1, fractional,
convergence) against the JAX package's, on the same inputs made from a seed.

Tolerances:
- the convergence expressions and the fractional targets and Newton step:
  elementwise float32 math and short sums, rtol 1e-6; the residuals, which
  are differences r − 1 of terms near 1, also atol 1e-6 (8 ulp of 1);
- (P3) on a fixed α: rtol 1e-4, atol 1e-5.  The row sums are recomputed at
  every step, as JAX does, but the target row sums s = (…)^{1/3} are a
  float64 power rounded once against XLA's float32 power, and 60 sweeps of
  a clipped Gauss–Seidel iteration carry that ulp to ~5e-5;
- the subgradient dual loop (33): rtol 1e-6 against JAX's, and within 0.05
  of the bisection (tests/test_algorithm1.py's case);
- the whole solve at K 10 × T 8, K 10 × T 12 and K 2 × T 1: ``p`` and ``w``
  within rtol 1e-4, atol 1e-5, ``objective`` within rtol 1e-4.  ``iters``
  is printed beside JAX's and held only to ±2: the stop test compares a
  residual near float32's floor (≈ 9.5e-10 at the stop) with ``tol`` =
  1e-9, so one iteration more or less is rounding, not a fault.
The port's solves run once each, in a module fixture (seconds apiece on the
CPU).
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CellConfig as JCell
from repro.core import ProblemSpec as JSpec
from repro.core import algorithm1 as ja1
from repro.core import convergence as jconv
from repro.core import fractional as jfrac
from repro.core.channel import channel_gains as j_channel_gains
from repro.core.channel import sample_positions as j_sample_positions
from repro_torch.core import CellConfig, ProblemSpec
from repro_torch.core import algorithm1 as ta1
from repro_torch.core import convergence as tconv
from repro_torch.core import fractional as tfrac

RTOL, ATOL = 1e-4, 1e-5


def t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def specs(K, T, rho=0.05, lam=0.01):
    return (JSpec(cell=JCell(num_clients=K), rho=rho, lam=lam, num_rounds=T),
            ProblemSpec(cell=CellConfig(num_clients=K), rho=rho, lam=lam,
                        num_rounds=T))


def instance(K, T, seed=0):
    cell = JCell(num_clients=K)
    h = j_channel_gains(jax.random.PRNGKey(seed + 1),
                        j_sample_positions(jax.random.PRNGKey(seed), cell),
                        T).T
    return np.asarray(h)                                  # [K, T]


INSTANCES = {
    "K10xT8": dict(K=10, T=8),
    "K10xT12": dict(K=10, T=12),
    "K2xT1": dict(K=2, T=1, rho=0.2),   # tests/test_algorithm1.py:60
}


@pytest.fixture(scope="module")
def solved():
    out = {}
    for name, kw in INSTANCES.items():
        K, T = kw["K"], kw["T"]
        jspec, tspec = specs(K, T, rho=kw.get("rho", 0.05))
        h = (np.array([[3e-13], [4e-14]], np.float32) if name == "K2xT1"
             else instance(K, T))
        out[name] = (jspec, tspec, h, ja1.solve(jnp.asarray(h), jspec),
                     ta1.solve(t32(h), tspec, device="cpu"))
    return out


@pytest.mark.parametrize("name", list(INSTANCES))
def test_solve_matches_jax(solved, name):
    jspec, tspec, h, want, got = solved[name]
    print(f"{name}: iters port {int(got.iters)}, JAX {int(want.iters)}; "
          f"residual port {float(got.residual):.3e}, "
          f"JAX {float(want.residual):.3e}")
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=RTOL)
    assert abs(int(got.iters) - int(want.iters)) <= 2
    assert got.iters.dtype == torch.int32
    # the feasibility of tests/test_algorithm1.py, on the port's result
    p, w = got.p.numpy(), got.w.numpy()
    assert p.shape == w.shape == (tspec.K, tspec.T)
    assert (p >= tspec.lam - 1e-6).all() and (p <= 1.0 + 1e-6).all()
    assert (w >= 0).all() and (w.sum(axis=0) <= 1.0 + 1e-4).all()
    assert float(got.residual) <= 1e-9 or int(got.iters) == 400
    np.testing.assert_allclose(
        float(ta1.objective_p1(got.p, got.w, t32(h), tspec)),
        float(got.objective), rtol=0)


def test_offline_matches_bruteforce_small(solved):
    """K 2, T 1: the port's optimum is the grid's (tests/test_algorithm1.py's
    exhaustive grid over (p1, p2, w1), through JAX's objective)."""
    jspec, _, h, _, got = solved["K2xT1"]
    ps = jnp.linspace(jspec.lam, 1.0, 61)
    ws = jnp.linspace(1e-3, 1.0 - 1e-3, 121)
    P1, P2, W1 = jnp.meshgrid(ps, ps, ws, indexing="ij")
    objs = jax.jit(jax.vmap(lambda p1, p2, w1: ja1.objective_p1(
        jnp.stack([p1, p2])[:, None], jnp.stack([w1, 1.0 - w1])[:, None],
        jnp.asarray(h), jspec)))(P1.ravel(), P2.ravel(), W1.ravel())
    assert float(got.objective) <= float(jnp.min(objs)) * 1.02 + 1e-6


def test_offline_beats_naive_allocations(solved):
    _, tspec, h, _, got = solved["K10xT8"]
    K, T = tspec.K, tspec.T
    for p_const in (0.05, 0.1, 0.3, 0.7, 1.0):
        naive = float(ta1.objective_p1(torch.full((K, T), p_const),
                                       torch.full((K, T), 1.0 / K),
                                       t32(h), tspec))
        assert float(got.objective) <= naive * 1.001, p_const


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_objective_p1_matches_jax(seed):
    K, T = 6, 5
    jspec, tspec = specs(K, T)
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.01, 1.0, (K, T)).astype(np.float32)
    w = rng.dirichlet(np.ones(K), T).T.astype(np.float32)
    h = instance(K, T, seed)
    want = ja1.objective_p1(jnp.asarray(p), jnp.asarray(w), jnp.asarray(h),
                            jspec)
    got = ta1.objective_p1(t32(p), t32(w), t32(h), tspec)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("K,T", [(10, 8), (3, 1), (1, 4)])
def test_solve_p3_matches_jax(seed, K, T):
    """(P3) alone on a fixed α (1/R of random bandwidths) from mid p."""
    jspec, tspec = specs(K, T)
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(K), T).T.astype(np.float32)
    h = instance(K, T, seed)
    c = tspec.cell
    R = ta1.rate_nats(t32(w), t32(h), c.tx_power_w, c.bandwidth_hz,
                      c.noise_w_per_hz)
    alpha = (1.0 / R).numpy()
    p0 = np.full((K, T), 0.5, np.float32)
    want = np.asarray(ja1.solve_p3(jnp.asarray(alpha), jspec,
                                   jnp.asarray(p0)))
    p0_t = t32(p0)
    got = ta1.solve_p3(t32(alpha), tspec, p0_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(p0_t, t32(p0))          # the start is not written


def test_subgradient_matches_jax_and_bisection():
    """tests/test_algorithm1.py:119: the paper's subgradient loop and the
    bisection find the same allocation."""
    jcell, cell = JCell(num_clients=6), CellConfig(num_clients=6)
    ab = jnp.abs(jax.random.normal(jax.random.PRNGKey(3), (6,))) * 1e-7 \
        + 1e-8
    h = jnp.logspace(-14, -12, 6)
    got = ta1.solve_p4_subgradient(t32(ab), t32(h), cell, iters=4000)
    want = ja1.solve_p4_subgradient(ab, h, jcell, iters=4000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    w_b = ta1.solve_p4(t32(ab), t32(h), cell)
    np.testing.assert_allclose(got.numpy(), w_b.numpy(), atol=0.05)


# ---------------------------------------------------------------------------
# convergence (eqs. 6-10) and the fractional machinery (eqs. 34-40)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("K,T", [(1, 1), (4, 12), (10, 20)])
def test_convergence_matches_jax(seed, K, T):
    p = np.random.default_rng(seed).uniform(0.01, 1.0, (K, T)) \
        .astype(np.float32)
    jp, tp = jnp.asarray(p), t32(p)
    args = dict(eta=0.01, L=1.0, g_max=5.0, sigma=0.1, f_max=2.0)
    for name in ("expected_delta", "delta_prime", "convergence_metric"):
        np.testing.assert_allclose(getattr(tconv, name)(tp).numpy(),
                                   np.asarray(getattr(jconv, name)(jp)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(tconv.theorem1_bound(p=tp, **args)),
                               float(jconv.theorem1_bound(p=jp, **args)),
                               rtol=1e-6)
    delta = t32(np.arange(1, K + 1))
    np.testing.assert_allclose(
        float(tconv.lemma1_bound(T=T, delta=delta, **args)),
        float(jconv.lemma1_bound(T=T, delta=jnp.asarray(delta.numpy()),
                                 **args)), rtol=1e-6)


def frac_inputs(seed, K=5, T=7):
    """Random ``(aux, target, p, R, PkS1r)`` at the solver's magnitudes."""
    rng = np.random.default_rng(seed)
    spec = specs(K, T)[1]
    c = spec.cell
    PkS1r = c.tx_power_w * c.model_size_nats * (1.0 - spec.rho)
    p = rng.uniform(0.01, 1.0, (K, T)).astype(np.float32)
    R = rng.uniform(1e5, 1e7, (K, T)).astype(np.float32)

    def aux(scale):
        return [(a * rng.uniform(1 - scale, 1 + scale, a.shape))
                .astype(np.float32)
                for a in (1.0 / R, p * PkS1r / R,
                          spec.rho * T**2 / (K * p.sum(1) ** 2))]

    return aux(0.3), aux(0.05), p, R, PkS1r, spec


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_residuals_and_targets_match_jax(seed):
    a, _, p, R, PkS1r, spec = frac_inputs(seed)
    K, T, rho = spec.K, spec.T, spec.rho
    jr_ = jfrac.residuals(jfrac.AuxVars(*map(jnp.asarray, a)), jnp.asarray(p),
                          jnp.asarray(R), PkS1r, rho, T, K)
    tr_ = tfrac.residuals(tfrac.AuxVars(*map(t32, a)), t32(p), t32(R), PkS1r,
                          rho, T, K)
    for x, y in zip(tr_, jr_):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(float(tr_.sq_norm), float(jr_.sq_norm),
                               rtol=1e-6)
    jt = jfrac.newton_targets(jnp.asarray(p), jnp.asarray(R), PkS1r, rho, T, K)
    tt = tfrac.newton_targets(t32(p), t32(R), PkS1r, rho, T, K)
    for x, y in zip(tt, jt):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["toward", "away"])
def test_newton_update_matches_jax(seed, case):
    """Toward the targets the search accepts at l = 1 or later; away from
    them, with ``max_l`` 3, it exhausts and falls back to the step ζ."""
    a, tgt, p, R, PkS1r, spec = frac_inputs(seed)
    K, T, rho = spec.K, spec.T, spec.rho
    if case == "away":   # a target past aux, away from the zero set
        tgt = [(2.0 * x - y).astype(np.float32) * 3.0 for x, y in zip(a, tgt)]
    kw = dict(zeta=0.1, max_l=3 if case == "away" else 30)
    jaux, jstep = jfrac.newton_update(
        jfrac.AuxVars(*map(jnp.asarray, a)),
        jfrac.AuxVars(*map(jnp.asarray, tgt)), jnp.asarray(p),
        jnp.asarray(R), PkS1r, rho, T, K, **kw)
    taux, tstep = tfrac.newton_update(
        tfrac.AuxVars(*map(t32, a)), tfrac.AuxVars(*map(t32, tgt)), t32(p),
        t32(R), PkS1r, rho, T, K, **kw)
    assert float(tstep) == float(jstep)
    if case == "away":
        assert float(tstep) == np.float32(0.1)   # the fallback
    for x, y in zip(taux, jaux):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
