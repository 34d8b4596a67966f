"""The port's examples on the CPU against the JAX package's: the quickstart
(``examples/quickstart_torch.py``) and the Fig.-6 driver
(``examples/mnist_fl_schemes_torch.py``), each through its ``main`` and
against the steps of the JAX script on the same flags.  The port draws its
own data from the same keys, so masks must be bit for bit and accuracy,
loss and energy within rtol 1e-4, atol 1e-5."""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import importlib.util
from pathlib import Path

import jax
import numpy as np

from repro.core import CellConfig as JCell
from repro.core import ProblemSpec as JSpec
from repro.core import solve_online as j_solve_online
from repro.core.channel import channel_gains as j_channel_gains
from repro.core.channel import sample_positions as j_sample_positions
from repro.core.selection import AgeBasedScheme as JAge
from repro.core.selection import GreedyScheme as JGreedy
from repro.core.selection import ProposedOnline as JProposed
from repro.core.selection import RandomScheme as JRandom
from repro.core.selection import average_participants as j_avg
from repro.data import make_mnist_like as j_make_mnist_like
from repro.data import shard_noniid as j_shard_noniid
from repro.fl import SimConfig as JSimConfig
from repro.fl import run_simulation as j_run_simulation
from repro.models.small import init_mlp as j_init_mlp
from repro.models.small import mlp_accuracy as j_mlp_accuracy
from repro.models.small import mlp_loss as j_mlp_loss

RTOL, ATOL = 1e-4, 1e-5        # tests/golden/harness.py
REPO = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _world(seed, K, rounds, n_train, n_test, d=5):
    """The JAX drivers' keys: data ``seed``, shards +1, positions +2, gains
    +3, model +4."""
    key = jax.random.PRNGKey
    tr, te = j_make_mnist_like(key(seed), n_train=n_train, n_test=n_test)
    clients = j_shard_noniid(key(seed + 1), tr, K, d=d)
    cell = JCell(num_clients=K)
    h = j_channel_gains(key(seed + 3),
                        j_sample_positions(key(seed + 2), cell), rounds).T
    return clients, te, cell, h, j_init_mlp(key(seed + 4))


def _held(got, want):
    np.testing.assert_array_equal(got.participation,
                                  np.asarray(want.participation))
    for field in ("test_acc", "test_loss", "energy_per_client",
                  "energy_timeline"):
        np.testing.assert_allclose(getattr(got, field),
                                   np.asarray(getattr(want, field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)


def test_quickstart_matches_jax_steps(capsys):
    """examples/quickstart.py's steps on both sides."""
    got = _example("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "selection probabilities p*:" in out and "KKT residual" in out

    K, T = 10, 12
    clients, te, cell, h, params = _world(0, K, T, 4000, 800)
    spec = JSpec(cell=cell, rho=0.05, lam=0.01, num_rounds=T)
    res = j_solve_online(h[:, 0], spec)
    np.testing.assert_allclose(got["p"], np.asarray(res.p), rtol=1e-5)
    np.testing.assert_allclose(got["w"], np.asarray(res.w), rtol=1e-5)
    assert got["residual"] < 1e-6
    cfg = JSimConfig(rounds=T, local_iters=5, batch_size=10, eval_every=4)
    for policy in (JProposed(spec), JRandom(p_bar=0.1, num_clients=K)):
        want = j_run_simulation(params, j_mlp_loss, j_mlp_accuracy, clients,
                                te, policy, h, cell, cfg)
        _held(got["runs"][policy.name], want)


def test_mnist_fl_schemes_matches_jax(capsys):
    """examples/mnist_fl_schemes.py's matched participation and its four
    rows at --rounds 4 (2,000 training examples)."""
    got = _example("mnist_fl_schemes_torch").main(
        ["--rounds", "4", "--train-examples", "2000", "--device", "cpu"])
    assert "matched participation" in capsys.readouterr().out

    K, T = 10, 4
    clients, te, cell, h, params = _world(0, K, T, 2000, 2000)
    spec = JSpec(cell=cell, rho=0.05, num_rounds=T)
    proposed = JProposed(spec)
    avg = j_avg(proposed, h)
    k = max(1, round(avg))
    assert got["k"] == k
    np.testing.assert_allclose(got["avg"], avg, rtol=1e-5)
    cfg = JSimConfig(rounds=T, local_iters=5, batch_size=10, eval_every=1)
    schemes = [proposed, JRandom(min(avg / K, 1.0), K), JGreedy(k, K),
               JAge(k, K)]
    assert [r["scheme"] for r in got["rows"]] == [s.name for s in schemes]
    for row, s in zip(got["rows"], schemes):
        want = j_run_simulation(params, j_mlp_loss, j_mlp_accuracy, clients,
                                te, s, h, cell, cfg)
        _held(row["result"], want)
        e = np.asarray(want.energy_per_client)
        gini = float(np.abs(e[:, None] - e[None, :]).sum()
                     / (2 * K * max(e.sum(), 1e-9)))
        np.testing.assert_allclose(row["gini"], gini, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(row["acc_per_j"],
                                   float(want.test_acc[-1])
                                   / max(e.sum(), 1e-9), rtol=RTOL)
