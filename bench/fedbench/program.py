"""The system under test: the port's runner, built through its normal
entry (``repro_torch.fl.make_runner``, which returns the sparse runner
where the configuration resolves to sparse), and what the benchmark reads
of a run's result to judge it."""
from __future__ import annotations

import importlib

import numpy as np
import torch


def _fn(path: str):
    mod, name = path.split(":")
    return getattr(importlib.import_module(mod), name)


def sim_config(cell, world):
    """The port's ``SimConfig`` for the cell."""
    from repro_torch.fl import SimConfig
    cfg, tr = cell.config, cell.traffic
    sparse = tr["engine"] == "sparse"
    return SimConfig(rounds=int(tr["rounds"]),
                     local_iters=int(cfg["local_iters"]),
                     batch_size=int(cfg["batch_size"]), lr=float(cfg["lr"]),
                     eval_every=int(tr["eval_every"]), seed=world.data_seed,
                     eval_batch=int(tr["eval_batch"]), data_path="device",
                     local_mode=tr["local_mode"],
                     participation="sparse" if sparse else "dense",
                     data_stream=tr["data_stream"])


def build_runner(cell, world, devices):
    """``runner(params, h_all, seed) -> SimResult`` over ``devices`` (the
    client axis placed over them when there are several)."""
    from repro_torch.core import CellConfig
    from repro_torch.core.selection import RandomScheme
    from repro_torch.data import Dataset, DeviceDataStore
    from repro_torch.fl import make_runner
    cfg, tr = cell.config, cell.traffic
    if tr["scheme"] != "random":
        raise ValueError(f"unknown scheme {tr['scheme']!r}")
    K = int(tr["clients"])
    c = tr["cell"]
    cellcfg = CellConfig(num_clients=K, cell_radius_m=c["cell_radius_m"],
                         min_radius_m=c["min_radius_m"],
                         bandwidth_hz=c["bandwidth_hz"],
                         tx_power_w=c["tx_power_w"],
                         noise_dbm_per_hz=c["noise_dbm_per_hz"],
                         model_size_bits=float(cfg["model_size_bits"]))
    store = DeviceDataStore(world.x, world.y, world.lengths)
    test = Dataset(world.test_x, world.test_y, int(cfg["num_classes"]))
    return make_runner(_fn(cfg["program"]["loss"]),
                       _fn(cfg["program"]["accuracy"]), store, test,
                       RandomScheme(p_bar=float(tr["p"]), num_clients=K),
                       cellcfg, sim_config(cell, world), device=devices[0],
                       data_path="device", shard_clients=len(devices) > 1)


def sample_clients(cell, seed: int) -> np.ndarray:
    """The clients whose final rows a dense run is judged on, drawn from
    the seed (sorted)."""
    n = int(cell.traffic.get("sample_clients", 0))
    K = int(cell.traffic["clients"])
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 3])
    return np.sort(rng.choice(K, size=min(n, K), replace=False))


def _rows(rows, idx: np.ndarray) -> torch.Tensor:
    """Rows ``idx`` of the client rows, a ``[K, W]`` tensor or a tuple of
    row blocks in row order (a run placed over cards), on the host."""
    blocks = list(rows) if isinstance(rows, tuple) else [rows]
    out, start = [], 0
    for b in blocks:
        n = b.shape[0]
        sel = idx[(idx >= start) & (idx < start + n)] - start
        if len(sel):
            out.append(b[torch.as_tensor(sel, device=b.device)].cpu())
        start += n
    return torch.cat(out) if out else torch.zeros(0)


def outputs(res, clients: np.ndarray) -> dict:
    """What a run is judged on, read from its ``SimResult``: the
    participation masks, ``last_tx``, the energy ledger, the evals, the
    final global row and the sampled clients' final rows."""
    out = {"mask": np.asarray(res.participation) > 0,
           "last_tx": res.state.last_tx.cpu().numpy().astype(np.int64),
           "energy": np.asarray(res.energy_per_client, dtype=np.float64),
           "eval_rounds": np.asarray(res.eval_rounds),
           "loss": np.asarray(res.test_loss, dtype=np.float64),
           "global": res.state.global_params.detach().cpu().clone()}
    if len(clients) and res.state.client_params is not None:
        out["clients"] = _rows(res.state.client_params, clients)
    return out


def k1_counters() -> dict:
    """K1's launch counters, by mode."""
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda as k1
    return {"launches": k1.launches, "subset": k1.subset_launches,
            "guarded": k1.guarded_launches}
