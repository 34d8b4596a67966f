"""The port's train CLI on the CPU against the JAX package's: paper mode
(``repro_torch.launch.train.main``, run in-process) against the JAX steps
of ``src/repro/launch/train.py`` on the same flags.  The port draws its own
data from the same keys (inputs within a few ulp of JAX's), so masks must
be bit for bit and accuracy, loss and energy within rtol 1e-4, atol 1e-5.
Also: ``--ckpt`` writes the JAX checkpoint format (both packages load it),
and arch mode (``--arch``) runs and checkpoints the global LLM (its lines
against JAX's CLI are in test_torch_train.py).  The examples are in
test_torch_examples.py."""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.core import CellConfig as JCell
from repro.core import ProblemSpec as JSpec
from repro.core.channel import channel_gains as j_channel_gains
from repro.core.channel import sample_positions as j_sample_positions
from repro.core.selection import ProposedOnline as JProposed
from repro.core.selection import RandomScheme as JRandom
from repro.data import make_mnist_like as j_make_mnist_like
from repro.data import shard_noniid as j_shard_noniid
from repro.fl import SimConfig as JSimConfig
from repro.fl import run_simulation as j_run_simulation
from repro.models.small import init_mlp as j_init_mlp
from repro.models.small import mlp_accuracy as j_mlp_accuracy
from repro.models import transformer as JT
from repro.models.small import mlp_loss as j_mlp_loss
from repro_torch import configs
from repro_torch.checkpoint import load_checkpoint
from repro_torch.fl.distributed import row_layout
from repro_torch.launch import train

RTOL, ATOL = 1e-4, 1e-5        # tests/golden/harness.py
CLI = ["--rounds", "4", "--train-examples", "1000", "--local-iters", "1",
       "--device", "cpu"]


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


@pytest.mark.parametrize("scheme", ["random", "proposed"])
def test_train_cli_matches_jax_paper_mode(scheme, capsys, tmp_path):
    """src/repro/launch/train.py's paper_mode on the same flags."""
    ckpt = str(tmp_path / "ck")
    got = train.main(CLI + ["--scheme", scheme, "--ckpt", ckpt])
    out = capsys.readouterr().out
    assert f"[train] scheme={scheme} rounds=4 final_acc=" in out
    assert "total_energy_j=" in out and "checkpoint" in out

    clients, te, cell, h, params = _world(0, 10, 4, 1000, 1000)
    policy = (JProposed(JSpec(cell=cell, rho=0.05, lam=0.01, num_rounds=4))
              if scheme == "proposed" else JRandom(0.1, 10))
    want = j_run_simulation(params, j_mlp_loss, j_mlp_accuracy, clients, te,
                            policy, h, cell,
                            JSimConfig(rounds=4, local_iters=1, batch_size=10,
                                       lr=0.01, eval_every=1, seed=0))
    _held(got, want)
    assert f"final_acc={float(want.test_acc[-1]):.4f}" in out

    # --ckpt: the JAX format, loaded by both packages
    layout = got.state.layout
    row = got.state.global_params
    restored, meta = load_checkpoint(ckpt, layout.unflatten(row))
    assert meta == {"rounds": 4, "scheme": scheme,
                    "acc": float(got.test_acc[-1])}
    torch.testing.assert_close(layout.flatten(restored), row, rtol=0, atol=0)
    jrestored, jmeta = j_load_checkpoint(ckpt, params)
    assert jmeta == meta
    flat = np.concatenate([np.asarray(a).reshape(-1) for a in
                           jax.tree_util.tree_leaves(jrestored)])
    np.testing.assert_array_equal(flat, row.numpy()[:layout.size])


def test_train_cli_refuses_arch_mode(capsys, tmp_path):
    """Arch mode, which the port used to refuse, runs: reduced Llama at its
    flag defaults but 2 rounds on the CPU prints a ``[train] round t:``
    line a round and writes a checkpoint of the global model in JAX's tree
    layout, which JAX's ``load_checkpoint`` restores into
    ``init_params``' tree.  (tests/test_torch_train.py holds the lines
    against JAX's CLI.)  The name is the one the test had while it checked
    the refusal, kept so that its record stays one test's."""
    ckpt = str(tmp_path / "arch")
    state, rounds = train.main(["--arch", "llama3.2-1b", "--reduced",
                                "--rounds", "2", "--device", "cpu",
                                "--ckpt", ckpt])
    out = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in out.splitlines()
            if "round" in ln] == ["[train] round 0", "[train] round 1"]
    assert len(rounds) == 2 and all(np.isfinite(r["loss"]) for r in rounds)
    jcfg = jconfigs.get("llama3.2-1b").reduced()
    like = JT.init_params(jax.random.PRNGKey(0), jcfg)
    restored, meta = j_load_checkpoint(ckpt, like)
    assert meta == {"arch": "llama3.2-1b-smoke", "rounds": 2}
    views = row_layout(configs.get("llama3.2-1b").reduced()).views(
        state.global_params)
    for name in ("embed", "final_norm"):
        np.testing.assert_array_equal(np.asarray(restored[name]),
                                      views[name].numpy())


def test_launch_serve_is_generates_deprecated_alias(monkeypatch):
    """``python -m repro_torch.launch.serve`` warns and forwards its argv to
    ``launch.generate.main``, as ``repro.launch.serve`` does."""
    from repro_torch.launch import serve
    seen = []
    monkeypatch.setattr(serve, "_generate_main",
                        lambda argv=None: seen.append(argv) or "out")
    with pytest.warns(DeprecationWarning, match="launch.generate"):
        assert serve.main(["--arch", "llama3.2-1b"]) == "out"
    assert seen == [["--arch", "llama3.2-1b"]]
