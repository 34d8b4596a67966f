"""The port's client-selection policies (repro_torch.core.selection) against
the JAX package's, on the same gains made from a seed with numpy.

Selections are integer outputs: greedy, age, age-aware and random give the
same ``probs`` and ``w`` bit for bit (0/1, p̄ and 1/k); csma's
probabilities are within 1 ulp (its h^β is a float64 power rounded once,
JAX's a float32 one) and its ``w`` within rtol 1e-6; a batched call over
rounds equals the per-round calls bit for bit.  ``average_participants``
is held to rtol 1e-5 (a float32 sum of T·K probabilities, in XLA's order on
one side).  The offline policy's schedule comes from a fake solve here (the
solve itself is held in tests/test_torch_algorithm1.py).
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.selection as jsel
import repro_torch.core.selection as tsel
from repro_torch import random as jr

KS = [1, 5, 10, 32]
SEEDS = [0, 1, 2]
T = 6


def gains(K, T, seed, ties=False):
    """``[K, T]`` float32 gains; ``ties`` repeats values within a round."""
    h = np.random.default_rng(seed).gamma(2.0, 0.5, size=(K, T))
    if ties and K > 2:
        h[1::3] = h[0]
    return h.astype(np.float32)


def jcall(fn, t, h_t, state=None):
    p, w = fn(jnp.int32(t), jnp.asarray(h_t), state)
    return np.asarray(p), np.asarray(w)


def tcall(fn, t, h_t, state=None):
    p, w = fn(t, torch.from_numpy(np.ascontiguousarray(h_t)), state)
    return p.numpy(), w.numpy()


def ks_for(K):
    return sorted({1, max(1, K // 3), K})


def build(name, k, K):
    beta = {"csma-b0": 0.0, "csma-b1": 1.0, "csma-b4": 4.0}.get(name)
    if beta is not None:
        return (jsel.csma_policy(k, K, beta=beta),
                tsel.csma_policy(k, K, beta=beta))
    j = getattr(jsel, f"{name}_policy")
    t = getattr(tsel, f"{name}_policy")
    return j(k, K), t(k, K)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["greedy", "age", "csma-b0", "csma-b1",
                                  "csma-b4"])
def test_state_free_policies_match_jax(name, seed, K):
    h = gains(K, T, seed, ties=seed == 2)
    for k in ks_for(K):
        jfn, tfn = build(name, k, K)
        assert tfn.state_free
        bp, bw = tcall(tfn, torch.arange(T), h.T)       # all rounds at once
        for t in range(T):
            p, w = tcall(tfn, t, h[:, t])
            np.testing.assert_array_equal(bp[t], p)
            np.testing.assert_array_equal(bw[t], w)
            want_p, want_w = jcall(jfn, t, h[:, t])
            if name.startswith("csma"):
                assert (np.abs(p - want_p) <= np.spacing(want_p)).all(), \
                    (p, want_p)
                np.testing.assert_allclose(w, want_w, rtol=1e-6)
            else:
                np.testing.assert_array_equal(p, want_p)
                np.testing.assert_array_equal(w, want_w)
                assert set(np.unique(p)) <= {0.0, 1.0}
                assert int(p.sum()) == min(k, K)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_policy_matches_jax(seed, K):
    h = gains(K, T, seed)
    p_bar = [0.0, 0.3, 1.0][seed]
    jfn, tfn = jsel.random_policy(p_bar, K), tsel.random_policy(p_bar, K)
    bp, bw = tcall(tfn, torch.arange(T), h.T)
    for t in range(T):
        want_p, want_w = jcall(jfn, t, h[:, t])
        np.testing.assert_array_equal(bp[t], want_p)
        np.testing.assert_array_equal(bw[t], want_w)


def ledgers(K, seed):
    """A live ledger (round, last_tx with tied ages) for both packages."""
    rng = np.random.default_rng(100 + seed)
    rnd = 7
    last = rng.integers(0, rnd, size=K).astype(np.int32)
    last[::4] = last[0]
    return (types.SimpleNamespace(round=jnp.int32(rnd),
                                  last_tx=jnp.asarray(last)),
            types.SimpleNamespace(round=torch.tensor(rnd, dtype=torch.int32),
                                  last_tx=torch.from_numpy(last)))


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("seed", SEEDS + [3, 4, 5])
@pytest.mark.parametrize("live", [True, False])
def test_age_aware_policy_matches_jax(live, seed, K):
    """A live ledger and ``state=None``; seeds 2 and 5 tie gains, so the
    order rests on ``mean(h)`` and the stable sort."""
    h = gains(K, T, seed, ties=seed in (2, 5))
    jst, tst = ledgers(K, seed) if live else (None, None)
    for k in ks_for(K):
        jfn, tfn = jsel.age_aware_policy(k, K), tsel.age_aware_policy(k, K)
        assert not getattr(tfn, "state_free", False) and tfn.ledger
        for t in range(T):
            p, w = tcall(tfn, t, h[:, t], tst)
            want_p, want_w = jcall(jfn, t, h[:, t], jst)
            np.testing.assert_array_equal(p, want_p)
            np.testing.assert_array_equal(w, want_w)


def fake_schedule(K, T, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.01, 1.0, (K, T)).astype(np.float32),
            rng.dirichlet(np.ones(K), T).T.astype(np.float32))


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("seed", SEEDS)
def test_offline_policy_matches_jax(monkeypatch, seed, K):
    """Round t reads column t of the solved schedule: ``[K]`` for an int,
    ``[T, K]`` for the engine's ``arange(T)``."""
    p_all, w_all = fake_schedule(K, T, seed)
    monkeypatch.setattr(jsel, "solve_offline", lambda h, spec: types.
                        SimpleNamespace(p=jnp.asarray(p_all),
                                        w=jnp.asarray(w_all)))
    monkeypatch.setattr(tsel, "solve_offline", lambda h, spec, device: types.
                        SimpleNamespace(p=torch.from_numpy(p_all),
                                        w=torch.from_numpy(w_all)))
    h = gains(K, T, seed)
    jfn = jsel.offline_policy(None, jnp.asarray(h))
    tfn = tsel.offline_policy(None, torch.from_numpy(h), device="cpu")
    assert tfn.state_free
    bp, bw = tcall(tfn, torch.arange(T), h.T)
    assert bp.shape == (T, K)
    for t in range(T):
        want_p, want_w = jcall(jfn, t, h[:, t])
        p, w = tcall(tfn, t, h[:, t])
        for got_p, got_w in ((p, w), (bp[t], bw[t])):
            np.testing.assert_array_equal(got_p, want_p)
            np.testing.assert_array_equal(got_w, want_w)
    shim = tsel.ProposedOffline(None, torch.from_numpy(h), device="cpu")
    np.testing.assert_array_equal(shim.decide(2, torch.from_numpy(h[:, 2]))
                                  .probs.numpy(), p_all[:, 2])


@pytest.mark.parametrize("sel", [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                 (0.0, 0.0, 1.0), (0.2, 0.3, 0.5)])
def test_policy_blend_matches_jax(sel):
    K = 7
    h = gains(K, T, 7)
    jfns = [jsel.random_policy(0.3, K), jsel.csma_policy(3, K),
            jsel.greedy_policy(3, K)]
    tfns = [tsel.random_policy(0.3, K), tsel.csma_policy(3, K),
            tsel.greedy_policy(3, K)]
    jb = jsel.policy_blend(jfns, jnp.asarray(sel, jnp.float32))
    tb = tsel.policy_blend(tfns, torch.tensor(sel, dtype=torch.float32))
    assert tb.state_free
    bp, bw = tcall(tb, torch.arange(T), h.T)
    for t in range(T):
        want_p, want_w = jcall(jb, t, h[:, t])
        p, w = tcall(tb, t, h[:, t])
        np.testing.assert_array_equal(bp[t], p)
        if sel[1] == 0.0:     # csma out of the blend: exact
            np.testing.assert_array_equal(p, want_p)
            np.testing.assert_array_equal(w, want_w)
        else:
            np.testing.assert_allclose(p, want_p, rtol=1e-6)
            np.testing.assert_allclose(w, want_w, rtol=1e-6)
        member = tcall(tfns[int(np.argmax(sel))], t, h[:, t])
        if max(sel) == 1.0:   # one-hot: exactly the member
            np.testing.assert_array_equal(p, member[0])
            np.testing.assert_array_equal(w, member[1])


def test_tags_match_jax():
    """tests/test_scheme_properties.py:99's tags, and the blends'."""
    K = 7
    pairs = {
        "random": (jsel.random_policy(0.3, K), tsel.random_policy(0.3, K)),
        "greedy": (jsel.greedy_policy(3, K), tsel.greedy_policy(3, K)),
        "age": (jsel.age_policy(3, K), tsel.age_policy(3, K)),
        "csma": (jsel.csma_policy(3, K), tsel.csma_policy(3, K)),
        "age-aware": (jsel.age_aware_policy(3, K),
                      tsel.age_aware_policy(3, K)),
        "online": (jsel.online_policy(None), tsel.online_policy(None)),
    }

    def untagged(t, h, state=None):
        return h, h

    blends = {
        "sf": ["random", "csma"],
        "ledger": ["random", "csma", "age-aware"],
    }
    for name, (j, t) in pairs.items():
        for tag in ("state_free", "ledger"):
            assert getattr(j, tag, False) == getattr(t, tag, False), name
        assert jsel.policy_ledger_ok(j) == tsel.policy_ledger_ok(t)
    for name, members in blends.items():
        jb = jsel.policy_blend([pairs[m][0] for m in members], jnp.ones(3))
        tb = tsel.policy_blend([pairs[m][1] for m in members], torch.ones(3))
        for tag in ("state_free", "ledger"):
            assert getattr(jb, tag, False) == getattr(tb, tag, False), name
    tb = tsel.policy_blend([pairs["random"][1], untagged], torch.ones(2))
    assert not tsel.policy_ledger_ok(tb)
    assert not jsel.policy_ledger_ok(
        jsel.policy_blend([pairs["random"][0], untagged], jnp.ones(2)))


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("seed", SEEDS)
def test_average_participants_matches_jax(monkeypatch, seed, K):
    h = gains(K, T, seed)
    k = max(1, K // 3)
    pairs = [(jsel.RandomScheme(0.3, K), tsel.RandomScheme(0.3, K)),
             (jsel.GreedyScheme(k, K), tsel.GreedyScheme(k, K)),
             (jsel.AgeBasedScheme(k, K), tsel.AgeBasedScheme(k, K)),
             (jsel.CsmaScheme(k, K), tsel.CsmaScheme(k, K)),
             (jsel.AgeAwareScheme(k, K), tsel.AgeAwareScheme(k, K))]
    for j, t in pairs:
        want = jsel.average_participants(j, jnp.asarray(h))
        got = tsel.average_participants(t, torch.from_numpy(h))
        # a sum of T·K float32 probabilities: XLA's CPU reduction order over
        # more than ~32 elements is not reproduced, hence 1e-5
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=t.name)


@pytest.mark.parametrize("name", ["greedy", "age", "csma", "age-aware",
                                  "random"])
def test_shims_decide_and_coerce(name):
    """``decide(t, h_t)`` of each shim equals JAX's; ``as_policy_fn`` takes
    a shim, a bare function or any object with ``decide``."""
    K, k = 10, 3
    h = gains(K, T, 4)
    args = (0.3, K) if name == "random" else (k, K)
    cls = {"greedy": "GreedyScheme", "age": "AgeBasedScheme",
           "csma": "CsmaScheme", "age-aware": "AgeAwareScheme",
           "random": "RandomScheme"}[name]
    j, t = getattr(jsel, cls)(*args), getattr(tsel, cls)(*args)
    assert t.name == j.name
    for r in range(T):
        want = j.decide(jnp.int32(r), jnp.asarray(h[:, r]))
        got = t.decide(r, torch.from_numpy(np.ascontiguousarray(h[:, r])))
        np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs),
                                   rtol=1e-6)
        np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                                   rtol=1e-6)
    assert tsel.as_policy_fn(t) is t.policy_fn
    assert tsel.as_policy_fn(t.policy_fn) is t.policy_fn
    legacy = types.SimpleNamespace(decide=t.decide)
    p, w = tsel.as_policy_fn(legacy)(1, torch.from_numpy(h[:, 1].copy()))
    assert torch.equal(p, t.decide(1, torch.from_numpy(h[:, 1].copy())).probs)
    with pytest.raises(TypeError):
        tsel.as_policy_fn(3)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("K", KS)
def test_realize_matches_jax(seed, K):
    probs = np.random.default_rng(seed).uniform(0, 1, K).astype(np.float32)
    want = jsel.realize(jax.random.PRNGKey(seed),
                        jsel.RoundDecision(jnp.asarray(probs),
                                           jnp.asarray(probs)))
    dec = tsel.RoundDecision(torch.from_numpy(probs),
                             torch.from_numpy(probs))
    got = tsel.realize(jr.PRNGKey(seed), dec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for bucket in (1, 4, 64):
        ji, jv, jn = jsel.realize_participants(
            jax.random.PRNGKey(seed),
            jsel.RoundDecision(jnp.asarray(probs), jnp.asarray(probs)),
            bucket)
        ti, tv, tn = tsel.realize_participants(jr.PRNGKey(seed), dec, bucket)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert int(tn) == int(jn)


@pytest.mark.parametrize("mask,bucket", [
    ([0, 0, 0, 0, 0], 4),                    # the empty round
    ([1], 1), ([1], 8), ([0], 1),            # K = 1
    ([1, 0, 1, 1, 0, 1], 8),                 # bucket above K
    ([1, 1, 0, 1, 1, 1, 1], 3),              # overflow: truncated
    ([0.5, 0.0, 2.0, 0.0], 2),               # non-binary mask values
])
def test_participants_from_mask_matches_jax(mask, bucket):
    m = np.asarray(mask, np.float32)
    ji, jv, jn = jsel.participants_from_mask(jnp.asarray(m), bucket)
    ti, tv, tn = tsel.participants_from_mask(torch.from_numpy(m), bucket)
    assert ti.dtype == torch.int32 and tn.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tn) == int(jn)


def test_participant_bucket_matches_jax():
    """The cases of tests/test_selection_edges.py and a grid, bit for bit."""
    cases = [(0.0, 1024, 8), (0.0, 4, 8), (0.0, 1, 8), (100.0, 8, 8),
             (0.0, 8, 8), (1.0, 1, 8)]
    cases += [(e, cap, fl) for e in (0.0, 1.0, 3.0, 4.0, 10.0, 16.0, 64.0,
                                     100.0, 256.0, 1024.0, 5000.0, 1e6)
              for cap in (1, 2, 7, 64, 1 << 20) for fl in (1, 8)]
    for e, cap, fl in cases:
        assert (tsel.participant_bucket(e, cap, fl)
                == jsel.participant_bucket(e, cap, fl)), (e, cap, fl)
