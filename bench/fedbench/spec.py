"""Discovery by name: everything a cell needs is found from the names in
``BENCHMARK.json``, so a later cell, configuration or per-layer metric is
added by adding files.

* a configuration ``<c>``: ``bench/configs/<c>.json`` (its sizes) and
  ``bench/configs/<c>.py`` (its plain reference model: ``forward``,
  ``forward_flops``);
* a traffic mix ``<t>``: ``bench/traffic/<t>.json`` (engine, clients,
  examples a client, scheme, rounds a run, evals);
* a per-layer metric ``<m>``: ``bench/metrics/<m>.py`` with ``read(ctx)``;
  a quantity split by the end-to-end metric it moves (``<m>.<part>``, as
  ``k1_roofline_pct.x4``) is read by ``<m>``'s reader;
* a cell ``<w>``'s limits of ``correct``: ``bench/limits/<w>.json``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    if not path.exists():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names loaded."""

    name: str
    chips: int
    config: dict          # bench/configs/<c>.json
    model: ModuleType     # bench/configs/<c>.py
    traffic: dict         # bench/traffic/<t>.json
    limits: dict          # bench/limits/<w>.json
    end_to_end: list      # the metrics of BENCHMARK.json this cell reports
    per_layer: list
    readers: dict         # per-layer metric name -> module with read(ctx)


def base(name: str) -> str:
    """A metric's name before its first dot: the quantity, whose reader
    (per-layer) or value (end-to-end) serves every part split from it."""
    return name.split(".")[0]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has "
                       f"{sorted(entries)}")
    w = entries[name]
    bench_dir = root / "bench"
    cfg = _json(bench_dir / "configs" / f"{w['config']}.json")
    model = _module(bench_dir / "configs" / f"{w['config']}.py",
                    f"fedbench_config_{w['config']}")
    traffic = _json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _json(bench_dir / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    readers = {m["name"]: _module(
        bench_dir / "metrics" / f"{base(m['name'])}.py",
        f"fedbench_metric_{base(m['name'])}") for m in layer}
    return Cell(name=name, chips=int(w["chips"]), config=cfg, model=model,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=layer, readers=readers)
