"""Paper math of the port (repro_torch.core) against the JAX package: the
channel model, Lambert W, the (P4) bandwidth step and the online (P1') solve,
on the quickstart spec and on a ρ grid that includes 0 and 1.

Tolerances: elementwise float32 math within a few ulps (rtol 1e-6); rtol
1e-5 where the function amplifies an ulp of its input (10^x for path gains,
W near its branch point); the iterative solves to rtol 1e-4 on p and w with
``iters`` within 1 — the two frameworks' exp/log/pow round differently,
which can move a convergence check by one iteration.  The batched port
solve equals its per-lane solve bit for bit.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CellConfig as JCell
from repro.core import ProblemSpec as JSpec
from repro.core import solve_online as j_solve_online
from repro.core.algorithm1 import solve_p4 as j_solve_p4
from repro.core.algorithm1 import w_of_v as j_w_of_v
from repro.core.channel import channel_gains as j_channel_gains
from repro.core.channel import path_gain as j_path_gain
from repro.core.channel import rate_nats as j_rate_nats
from repro.core.channel import sample_positions as j_sample_positions
from repro.core.lambertw import lambertw as j_lambertw
from repro.core.selection import random_policy as j_random_policy
from repro_torch import random as jr
from repro_torch.core import CellConfig, ProblemSpec, lambertw, solve_online
from repro_torch.core.algorithm1 import solve_p4, w_of_v
from repro_torch.core.channel import (channel_gains, path_gain, rate_nats,
                                      sample_positions)
from repro_torch.core.selection import (ProposedOnline, RandomScheme,
                                        as_policy_fn)

K, T = 10, 12
RHOS = [0.0, 0.05, 0.5, 1.0]


def t32(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.fixture(scope="module")
def world():
    cell = JCell(num_clients=K)
    h = j_channel_gains(jax.random.PRNGKey(3),
                        j_sample_positions(jax.random.PRNGKey(2), cell), T).T
    return np.asarray(h)          # [K, T]


@pytest.fixture(scope="module")
def batched(world):
    """One port solve over ρ-grid × round lanes: ``[len(RHOS), T, K]``."""
    spec = ProblemSpec(cell=CellConfig(num_clients=K), num_rounds=T)
    h = t32(world.T).expand(len(RHOS), T, K)
    rho = torch.tensor(RHOS, dtype=torch.float32)[:, None]
    return solve_online(h, spec, rho=rho)


@pytest.mark.parametrize("seed", [2, 5])
def test_positions_and_gains_match(seed):
    jcell, cell = JCell(num_clients=K), CellConfig(num_clients=K)
    jpos = j_sample_positions(jax.random.PRNGKey(seed), jcell)
    pos = sample_positions(jr.PRNGKey(seed), cell)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    jh = j_channel_gains(jax.random.PRNGKey(seed + 1), jpos, T)
    h = channel_gains(jr.PRNGKey(seed + 1), pos, T)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-6)


def test_path_gain_and_rate_match():
    rng = np.random.default_rng(0)
    d = rng.uniform(0.5, 1000.0, 64).astype(np.float32)
    # 10^(-x/10) with x ≈ 130 dB: an ulp of x is ~2e-6 of the gain
    np.testing.assert_allclose(path_gain(t32(d)).numpy(),
                               np.asarray(j_path_gain(jnp.asarray(d))),
                               rtol=1e-5)
    c = CellConfig()
    w = np.concatenate([[0.0, 1e-13], rng.uniform(0, 1, 62)]).astype(
        np.float32)
    h = (rng.uniform(0.1, 3, 64) * 1e-12).astype(np.float32)
    args = (c.tx_power_w, c.bandwidth_hz, c.noise_w_per_hz)
    np.testing.assert_allclose(
        rate_nats(t32(w), t32(h), *args).numpy(),
        np.asarray(j_rate_nats(jnp.asarray(w), jnp.asarray(h), *args)),
        rtol=1e-6)


def test_lambertw_matches():
    x = np.concatenate([np.linspace(-0.3678, 5.0, 200),
                        [-0.3, -0.1, 0.0, 1e-3, 100.0, 1e4]]
                       ).astype(np.float32)
    # rtol 1e-5: the first grid points sit within 1e-5 of the branch point
    np.testing.assert_allclose(lambertw(t32(x)).numpy(),
                               np.asarray(j_lambertw(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-7)


def twelve_halley_steps(x):
    """The Halley loop without its early stop: all 12 steps, always."""
    lw = importlib.import_module("repro_torch.core.lambertw")
    x = torch.as_tensor(x, dtype=torch.float32)
    x = torch.where((x < -lw.INV_E) & (x >= -lw.INV_E - lw.BRANCH_TOL),
                    -lw.INV_E, x)
    w = lw._initial_guess(x)
    for _ in range(12):
        ew = torch.exp(w)
        f = w * ew - x
        wp1 = w + 1.0
        t = (w + 2.0) * f / (wp1 + wp1)
        t = f / (ew * wp1 - t)
        w = w - torch.where(wp1.abs() < 1e-12, 0.0, t)
    w = torch.where(x < -lw.INV_E, torch.nan, w)
    return torch.where((x + lw.INV_E).abs() <= 1e-12, -1.0, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lambertw_early_stop_gives_the_twelve_step_bits(seed):
    """The loop stops once w repeats two steps back; the result equals all
    12 steps bit for bit: the (P4) arguments −e^{−A}, the branch point and
    below it, the mid range, large x, and lanes that never settle (NaN)."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        -np.exp(-(1.0 + rng.exponential(3.0, 4000))),
        -1 / np.e + rng.uniform(-2e-6, 1e-5, 200), [-0.3679, np.nan],
        rng.uniform(-0.36, 3.0, 500), rng.lognormal(3.0, 3.0, 300),
    ]).astype(np.float32)
    for lanes in (t32(x), t32(x[:7]), t32(x[4000:4200]).view(20, 10)):
        got, want = lambertw(lanes), twelve_halley_steps(lanes)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("x,expect", [
    (-1 / np.e, "branch"),            # the branch point itself
    (-0.36787945, "branch"),          # float32 rounding of −1/e
    (-0.3678794 - 5e-7, "branch"),    # just below, within BRANCH_TOL: snaps
    (-0.3679, "nan"),                 # outside the domain
    (-0.3678794, "near"),             # just above: W is ill-conditioned
])
def test_lambertw_branch_point(x, expect):
    x = np.float32(x)
    got = float(lambertw(torch.tensor([x]))[0])
    want = float(j_lambertw(jnp.asarray([x]))[0])
    if expect == "nan":
        assert np.isnan(got) and np.isnan(want)
    elif expect == "branch":
        assert got == want == -1.0
    else:   # dW/dx → ∞ at −1/e: one ulp of e·x + 1 moves W by ~1e-4
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_w_of_v_and_solve_p4_match():
    rng = np.random.default_rng(1)
    cell_j, cell = JCell(num_clients=K), CellConfig(num_clients=K)
    for trial in range(2):
        ab = (rng.uniform(0.1, 10.0, K) * 10.0 ** rng.uniform(-9, -6)
              ).astype(np.float32)
        h = (rng.exponential(1.0, K) * 1e-12).astype(np.float32)
        v = np.float32(rng.uniform(0, 1e-2))
        np.testing.assert_allclose(
            w_of_v(torch.tensor(v), t32(ab), t32(h), cell).numpy(),
            np.asarray(j_w_of_v(jnp.float32(v), jnp.asarray(ab),
                                jnp.asarray(h), cell_j)), rtol=1e-5)
        np.testing.assert_allclose(
            solve_p4(t32(ab), t32(h), cell).numpy(),
            np.asarray(j_solve_p4(jnp.asarray(ab), jnp.asarray(h), cell_j)),
            rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("r", range(len(RHOS)))
def test_solve_online_matches_jax(world, batched, r):
    jspec = JSpec(cell=JCell(num_clients=K), num_rounds=T)
    for t in range(T):
        want = j_solve_online(jnp.asarray(world[:, t]), jspec,
                              rho=jnp.float32(RHOS[r]))
        np.testing.assert_allclose(batched.p[r, t].numpy(),
                                   np.asarray(want.p), rtol=1e-4)
        np.testing.assert_allclose(batched.w[r, t].numpy(),
                                   np.asarray(want.w), rtol=1e-4)
        assert abs(int(batched.iters[r, t]) - int(want.iters)) <= 1
        assert float(batched.residual[r, t]) <= 1e-10 or \
            int(batched.iters[r, t]) == 200


def test_objective_matches_jax(world, batched):
    from repro.core.online import objective_p1_prime as j_objective
    from repro_torch.core.online import objective_p1_prime
    spec = ProblemSpec(cell=CellConfig(num_clients=K), num_rounds=T)
    jspec = JSpec(cell=JCell(num_clients=K), num_rounds=T)
    p, w = batched.p[1, 0], batched.w[1, 0]
    got = objective_p1_prime(p, w, t32(world[:, 0]), spec)
    want = j_objective(jnp.asarray(p.numpy()), jnp.asarray(w.numpy()),
                       jnp.asarray(world[:, 0]), jspec)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_batched_solve_equals_per_lane(world, batched):
    r, t = 1, 0
    spec = ProblemSpec(cell=CellConfig(num_clients=K), num_rounds=T)
    one = solve_online(t32(world[:, t]), spec,
                       rho=torch.tensor(RHOS[r], dtype=torch.float32))
    for name in ("p", "w", "iters", "residual"):
        assert torch.equal(getattr(one, name), getattr(batched, name)[r, t]), \
            name


def test_policies_match(world, batched, monkeypatch):
    """The shims' policy fns: ProposedOnline hands every lane to the (P1')
    solve with its spec (its static-ρ solve is held against JAX end to end
    in tests/test_torch_engine.py); RandomScheme matches JAX's."""
    import repro_torch.core.selection as selection
    spec = ProblemSpec(cell=CellConfig(num_clients=K), num_rounds=T)
    seen = []

    def fake_solve(h, s, rho=None):
        seen.append((h, s, rho))
        return batched._replace(p=batched.p[1], w=batched.w[1])

    monkeypatch.setattr(selection, "solve_online", fake_solve)
    fn = as_policy_fn(ProposedOnline(spec))
    h = t32(world.T)
    probs, w = fn(None, h, None)
    assert fn.state_free and len(seen) == 1
    assert seen[0][0] is h and seen[0][1] is spec and seen[0][2] is None
    assert torch.equal(probs, batched.p[1]) and torch.equal(w, batched.w[1])
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-4)
    rfn = as_policy_fn(RandomScheme(p_bar=0.1, num_clients=K))
    jp, jw = j_random_policy(0.1, K)(0, jnp.asarray(world[:, 0]), None)
    probs, w = rfn(None, t32(world.T), None)
    assert probs.shape == (T, K) and rfn.state_free
    np.testing.assert_array_equal(probs[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(w[0].numpy(), np.asarray(jw))
