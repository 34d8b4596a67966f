"""The plain reference of a run: the paper's protocol written out in plain
PyTorch, independent of the program (it imports nothing of it).

For one seed lane it draws the participation masks and minibatch indices
from the frozen copy of the random streams (:mod:`.threefry`), keeps the
eq.-5 energy ledger in float64, trains every client (continuous mode) or
every round's transmitters (participants mode) with plain SGD under
autograd on the configuration's reference model, forms the eq.-2
pseudo-gradients against the global model each client last received,
applies eq. 3 with a float64 sum, broadcasts to the transmitters and
evaluates the global model on the test set.

``precision="tf32"`` is the control: the same run with float32 products
in TF32 and the energy ledger's terms in bfloat16, the step below the
configuration's float32 that would tempt a change.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import threefry as tf

LN2 = 0.6931471805599453


@contextlib.contextmanager
def _precision(precision: str):
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[R]``: each client's mean negative log-likelihood over its batch."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, y.long()[..., None])[..., 0].mean(-1)


def sgd_steps(model, layers: list, xb: torch.Tensor, yb: torch.Tensor,
              lr: float) -> list:
    """``L`` steps of plain SGD of R clients at once: ``layers`` stacked
    over R, ``xb [R, L, B, ...]``; each client's gradient is that of its
    own mean loss."""
    for i in range(xb.shape[1]):
        leaves = [{n: v.detach().requires_grad_(True) for n, v in l.items()}
                  for l in layers]
        flat = [v for l in leaves for v in l.values()]
        with torch.enable_grad():
            loss = _cross_entropy(model.forward(leaves, xb[:, i]),
                                  yb[:, i]).sum()
            grads = torch.autograd.grad(loss, flat)
        it = iter(grads)
        layers = [{n: v.detach() - lr * next(it) for n, v in l.items()}
                  for l in leaves]
    return layers


class _Cell:
    def __init__(self, cell):
        c = cell.traffic["cell"]
        self.P = float(c["tx_power_w"])
        self.BW = float(c["bandwidth_hz"])
        self.N0 = 10.0 ** (float(c["noise_dbm_per_hz"]) / 10.0) * 1e-3
        self.S = float(cell.config["model_size_bits"]) * LN2

    def energy(self, mask: torch.Tensor, h: torch.Tensor, K: int,
               precision: str) -> torch.Tensor:
        """Eq. 5's Joules of the round's transmitters at the random
        scheme's equal share w = 1/K: ``P·S / (w·W·ln(1 + P·h/(w·W·N0)))``
        (float64; bfloat16 in the control)."""
        dt = torch.bfloat16 if precision == "tf32" else torch.float64
        hh = h.to(dt)
        w = torch.tensor(1.0 / K, dtype=dt, device=h.device)
        rate = w * self.BW * torch.log1p(self.P * hh / (w * self.BW * self.N0))
        e = self.P * self.S / rate
        return torch.where(mask, e, torch.zeros_like(e)).to(torch.float64)


def _stack(layers: list, n: int, device) -> list:
    return [{k: v.to(device)[None].expand(n, *v.shape).clone()
             for k, v in l.items()} for l in layers]


def _eval_loss(model, g: list, x: torch.Tensor, y: torch.Tensor) -> float:
    one = [{k: v[None] for k, v in l.items()} for l in g]
    return float(_cross_entropy(model.forward(one, x[None]), y[None])[0])


def run(cell, world, lane_seed: int, devices, precision: str = "float32",
        clients: np.ndarray | None = None) -> dict:
    """One run of the cell's traffic on ``world`` for participation seed
    ``lane_seed``; returns what the program's run is judged on, with the
    models as lists of leaves on the host."""
    with _precision(precision), torch.no_grad():
        return _run(cell, world, lane_seed, devices, precision, clients,
                    cell.traffic["local_mode"] == "continuous")


def _run(cell, world, lane_seed, devices, precision, clients, continuous):
    cfg, tr = cell.config, cell.traffic
    model = cell.model
    dev0 = torch.device(devices[0])
    K, T = int(tr["clients"]), int(tr["rounds"])
    L, B, lr = int(cfg["local_iters"]), int(cfg["batch_size"]), \
        float(cfg["lr"])
    every = int(tr["eval_every"])
    cellc = _Cell(cell)
    p32 = torch.tensor(float(tr["p"]), dtype=torch.float32, device=dev0)
    key = tf.prng_key(lane_seed, dev0)
    data_key = tf.fold_in(tf.prng_key(world.data_seed, dev0), tf.DATA_STREAM)
    h = world.h.to(dev0)
    test_x, test_y = world.test_x.to(dev0), world.test_y.to(dev0)
    g0 = [{k: v.detach().to(dev0).clone() for k, v in l.items()}
          for l in world.params]
    g = g0
    # hist[s]: the global model broadcast after round s - 1 (slot 0: g0)
    hist = [{k: torch.empty((T + 1,) + tuple(v.shape), device=dev0)
             for k, v in l.items()} for l in g0]
    for hl, gl in zip(hist, g0):
        for k in hl:
            hl[k][0] = gl[k]
    slot = torch.zeros(K, dtype=torch.int64, device=dev0)
    last_tx = torch.zeros(K, dtype=torch.int64, device=dev0)
    energy = torch.zeros(K, dtype=torch.float64, device=dev0)
    masks, evals, losses = [], [], []
    lengths = world.lengths.to(dev0)

    if continuous:
        nblk = max(1, -(-K // int(cfg["reference_block"])))
        bounds = [(K * b // nblk, K * (b + 1) // nblk) for b in range(nblk)]
        bdev = [torch.device(devices[min(len(devices) - 1,
                                         b * len(devices) // nblk)])
                for b in range(nblk)]
        rows = [_stack(g0, k1 - k0, d) for (k0, k1), d in zip(bounds, bdev)]
        data = {}
        for d in set(bdev):
            lo = min(k0 for (k0, _), bd in zip(bounds, bdev) if bd == d)
            hi = max(k1 for (_, k1), bd in zip(bounds, bdev) if bd == d)
            data[d] = (lo, world.x[lo:hi].to(d), world.y[lo:hi].to(d))

    for t in range(T):
        mask = tf.uniform(tf.fold_in(key, t), (K,)) < p32
        energy += cellc.energy(mask, h[:, t], K, precision)
        masks.append(mask.cpu().numpy())
        acc = [{k: torch.zeros(v.shape, dtype=torch.float64, device=dev0)
                for k, v in l.items()} for l in g]

        def add_deltas(new: list, ids: torch.Tensor, dev):
            """Eq. 2 for clients ``ids`` (rows ``new``), summed into
            ``acc`` in float64."""
            s = slot[ids].to(dev0)
            for al, nl, hl in zip(acc, new, hist):
                for k in al:
                    d = nl[k].to(dev0) - hl[k][s]
                    al[k] += d.to(torch.float64).sum(0)

        if continuous:
            u = tf.uniform(tf.fold_in(data_key, t),
                           (K, L, B))
            idx = tf.uniform_index(u, lengths)
            for b, ((k0, k1), d) in enumerate(zip(bounds, bdev)):
                lo, xs, ys = data[d]
                ar = torch.arange(k0 - lo, k1 - lo, device=d)[:, None, None]
                ib = idx[k0:k1].to(d)
                rows[b] = sgd_steps(model, rows[b], xs[ar, ib], ys[ar, ib],
                                    lr)
                m = mask[k0:k1]
                if bool(m.any()):
                    sel = torch.nonzero(m)[:, 0]
                    add_deltas([{k: v[sel.to(d)] for k, v in l.items()}
                                for l in rows[b]], sel + k0, d)
        else:
            ids = torch.nonzero(mask)[:, 0]
            if len(ids):
                kk = tf.fold_in(tf.fold_in(data_key, t), ids)
                idx = tf.uniform_index(tf.uniform(kk, (L, B)), lengths[ids])
                xb = world.x[ids[:, None, None].to(world.x.device),
                             idx.to(world.x.device)].to(dev0)
                yb = world.y[ids[:, None, None].to(world.y.device),
                             idx.to(world.y.device)].to(dev0)
                anchors = [{k: hl[k][slot[ids]] for k in hl} for hl in hist]
                add_deltas(sgd_steps(model, anchors, xb, yb, lr), ids, dev0)
        g = [{k: (gl[k].to(torch.float64) + al[k] / K).to(torch.float32)
              for k in gl} for gl, al in zip(g, acc)]
        for hl, gl in zip(hist, g):
            for k in hl:
                hl[k][t + 1] = gl[k]
        slot = torch.where(mask, t + 1, slot)
        last_tx = torch.where(mask, t, last_tx)
        if continuous:   # the transmitters receive the new global model
            for b, ((k0, k1), d) in enumerate(zip(bounds, bdev)):
                m = mask[k0:k1].to(d)
                rows[b] = [{k: torch.where(
                    m.view(-1, *([1] * (v.dim() - 1))), gl[k].to(d)[None], v)
                    for k, v in l.items()} for l, gl in zip(rows[b], g)]
        if t % every == 0 or t == T - 1:
            evals.append(t)
            losses.append(_eval_loss(model, g, test_x, test_y))

    out = {"mask": np.stack(masks), "last_tx": last_tx.cpu().numpy(),
           "energy": energy.cpu().numpy(), "eval_rounds": np.asarray(evals),
           "loss": np.asarray(losses, dtype=np.float64),
           "global": [{k: v.cpu() for k, v in l.items()} for l in g],
           "initial": [{k: v.cpu() for k, v in l.items()} for l in g0]}
    if continuous and clients is not None and len(clients):
        picked = []
        for c in clients:
            b = next(i for i, (k0, k1) in enumerate(bounds) if k0 <= c < k1)
            picked.append([{k: v[c - bounds[b][0]].cpu()
                            for k, v in l.items()} for l in rows[b]])
        out["clients"] = [{k: torch.stack([p[i][k] for p in picked])
                           for k in l} for i, l in enumerate(picked[0])]
    return out
