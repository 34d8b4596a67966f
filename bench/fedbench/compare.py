"""The numbers that decide ``correct``: a run of the program against the
reference's run of the same seed lane, each number held to its limit
(``bench/limits/<workload>.json``).

* ``exact`` — integers that must agree bit for bit: participation masks
  ``[T, K]``, ``last_tx`` ``[K]``, the eval rounds; the count of entries
  that differ (limit 0);
* ``energy`` — the eq.-5 ledger: the largest gap of a client's Joules,
  over that client's reference Joules or the median of the non-zero ones,
  whichever is larger;
* ``loss`` — the evals: the largest relative gap of the test loss;
* ``model`` — the global model's change over the run, leaf by leaf (each
  layer's weight and bias): the largest ``‖Δprog − Δref‖`` over that
  leaf's ``‖Δref‖`` or the median leaf's, whichever is larger.  Leaves whose
  reference change is under a thousandth of the median leaf's are left out;
* ``clients`` — continuous mode: the sampled clients' final rows, the
  largest ``‖x_prog − x_ref‖`` of a client over its ``‖x_ref − x_0‖`` or the
  median client's, whichever is larger.

The program's flat rows are decoded by the layout it documents: layers in
order, each layer's keys sorted, the row padded to a multiple of 4.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def decode(row: torch.Tensor, layers: list) -> list:
    """A program's flat ``[..., W]`` row as leaves ``[..., *shape]``."""
    out, off = [], 0
    for layer in layers:
        d = {}
        for name in sorted(layer):
            n = math.prod(layer[name])
            d[name] = row[..., off:off + n].reshape(
                *row.shape[:-1], *layer[name]).to(torch.float64)
            off += n
        out.append(d)
    return out


def encode(leaves: list, layers: list) -> torch.Tensor:
    """Leaves ``[..., *shape]`` as the program's flat float32 row."""
    parts = [leaves[i][name].to(torch.float32).flatten(
        -len(layer[name])) for i, layer in enumerate(layers)
        for name in sorted(layer)]
    row = torch.cat(parts, dim=-1)
    pad = -row.shape[-1] % 4
    return torch.nn.functional.pad(row, (0, pad))


def _leafwise(prog: list, ref: list, base: list, lead: bool):
    """Gaps ``‖(p − b) − (r − b)‖ / max(‖r − b‖, median)``: the largest
    over the leaves, or with ``lead`` (the first axis indexes clients) one
    a client, each judged on its whole row."""
    gaps, norms = [], []
    for pl, rl, bl in zip(prog, ref, base):
        for k in rl:
            r = rl[k].to(torch.float64)
            diff = pl[k].to(torch.float64) - r
            chg = r - bl[k].to(torch.float64)
            flat = (lambda v: v.flatten(1)) if lead else torch.flatten
            gaps.append(flat(diff).norm(dim=-1))
            norms.append(flat(chg).norm(dim=-1))
    if lead:
        gap = torch.stack(gaps).pow(2).sum(0).sqrt()
        norm = torch.stack(norms).pow(2).sum(0).sqrt()
        floor = max(float(norm.median()), 1e-30)
        return (gap / torch.clamp(norm, min=floor)).numpy()
    norm = torch.stack(norms)
    med = max(float(norm.median()), 1e-30)
    keep = norm >= 1e-3 * med
    gap = torch.stack(gaps)[keep]
    return float((gap / torch.clamp(norm[keep], min=med)).max())


def numbers(prog: dict, ref: dict, layers: list) -> dict:
    """Each number of the comparison, by name."""
    exact = int((prog["mask"] != ref["mask"]).sum()) \
        if prog["mask"].shape == ref["mask"].shape else prog["mask"].size
    exact += int((prog["last_tx"] != ref["last_tx"]).sum())
    if not np.array_equal(prog["eval_rounds"], ref["eval_rounds"]):
        exact += max(len(prog["eval_rounds"]), 1)
    out = {"exact": exact}
    er, ep = ref["energy"], prog["energy"]
    nz = np.abs(er[er != 0])
    scale = float(np.median(nz)) if nz.size else 1.0
    out["energy"] = float(np.max(np.abs(ep - er)
                                 / np.maximum(np.abs(er), scale)))
    if prog["loss"].shape == ref["loss"].shape:
        out["loss"] = float(np.max(np.abs(prog["loss"] - ref["loss"])
                                   / np.abs(ref["loss"])))
    else:
        out["loss"] = float("inf")
    g = decode(prog["global"], layers)
    out["model"] = _leafwise(g, ref["global"], ref["initial"], lead=False)
    if "clients" in ref:
        c = decode(prog["clients"], layers)
        base = [{k: v[None].expand_as(c[i][k]) for k, v in l.items()}
                for i, l in enumerate(ref["initial"])]
        out["clients"] = float(_leafwise(c, ref["clients"], base,
                                         lead=True).max())
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number at or under
    its limit (a NaN is over it), and every limit's number present."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        table[name] = {"value": v, "limit": limit}
        if v is None or not (v <= limit):
            ok = False
    return ok, table
