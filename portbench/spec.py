"""What ``BENCHMARK.json`` names, found by name under ``portbench/``.

A cell (one entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own: the configuration's file is the one
``configs`` gives it, a traffic mix is ``traffic/<traffic>.json``, the
limits of a cell's output check are ``limits/<workload>.json``, and a
per-layer metric is read by ``metrics/<metric>.py``'s ``read(ctx)``. A
later cell or metric is added by adding files and entries; no file here
needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<workload>.json: number name → limit
    end_to_end: list  # BENCHMARK.json's end_to_end entries this cell reports
    per_layer: list  # and its per_layer entries


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def _applies(metric: dict, workload: str, bench: dict) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    if metric.get("moves"):  # per-layer: every cell that reports its metric
        e2e = {m["name"]: m for m in bench["end_to_end"]}
        return _applies(e2e[metric["moves"]], workload, bench)
    return True


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` with its files read; KeyError names what is
    missing."""
    bench = bench if bench is not None else load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are: {', '.join(sorted(work))})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name, bench)],
                [m for m in bench["per_layer"] if _applies(m, name, bench)])


def metric_reader(name: str):
    """``read(ctx) -> float | None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
