"""What ``BENCHMARK.json`` names, found by name under ``portbench/``.

A cell (one entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own: the configuration's file is the one
``configs`` gives it, a traffic mix is ``traffic/<traffic>.json``, the
limits of a cell's output check are ``limits/<workload>.json``, and a
per-layer metric is read by ``metrics/<metric>.py``'s ``read(ctx)``. A
later cell or metric is added by adding files and entries; no file here
needs an edit for it.

A configuration's file may name two modules under ``portbench/``, each a
``.py`` file given by its path relative to this directory; :func:`cell`
imports them (once a process) and puts them on the :class:`Cell`:

* ``reference`` (default ``reference.py``): the plain reference the check
  holds the program to. It imports nothing of the program, and gives
  ``LANE`` (the floats of one row of the program's tables); ``TABLES``,
  the names of the flat weight and accumulator tables that its state, the
  program's params dict and the check's snapshots share;
  ``initial_weights(model, seed, device)``, the run's initial state made on
  ``device`` from ``seed``: flat tensors keyed by ``TABLES`` and, for each
  tower layer of ``tower_shapes``, ``<name>.w``, ``.b``, ``.w_acc``,
  ``.b_acc``; ``weight_leaves(model)``, the ``[(weight, accumulator)]``
  keys of that state; ``tower_shapes(model)``, ``[(name, fan_in,
  fan_out)]`` of the tower's layers, ``final`` last, or ``[]``; ``Rows(model,
  lr_ids, ffm_ids, labels, batch, device)``, one pass's inputs, with
  ``n``, ``batch`` and ``lr`` (``[n, combos]`` ids); ``FFM_PIECES``, the
  name of the ``Rows`` attribute that holds each FFM entry's slab key
  (``[n, fields]``; the roofline counts the distinct ones), or ``None``
  where the model has no FFM; ``run_pass(model, st, rows, fault=None)``,
  which trains ``st`` over ``rows`` in place and returns each row's
  probability before its step's update, with ``fault`` ``"half"``,
  ``"flip"`` or ``"unchanged"`` planting the faults the check must catch;
  and ``to_dtype(st, dtype)``, a copy of the state in the control's
  precision.
* ``data`` (default ``eatrate.py``): the data schema. It gives
  ``columns(traffic, seed)``, the integer columns a run's rows are made
  from, ``label`` (positive or not) among them; ``write_text(traffic,
  cols, path)``, which writes the rows as the program's text at ``path``
  and the namespace map beside it; and ``ids(model, traffic)``, whose
  ``lr(cols)`` and ``ffm(cols)`` work out each row's LR ids ``[n, combos]``
  and FFM ids ``[n, fields]`` from the columns as the program hashes the
  text.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
# a configuration's modules where its file names none
DEFAULT_MODULES = {"reference": "reference.py", "data": "eatrate.py"}


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<workload>.json: number name → limit
    end_to_end: list  # BENCHMARK.json's end_to_end entries this cell reports
    per_layer: list  # and its per_layer entries
    reference: ModuleType  # the configuration's plain reference
    data: ModuleType  # and its data schema


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def _applies(metric: dict, workload: str, bench: dict) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    if metric.get("moves"):  # per-layer: every cell that reports its metric
        e2e = {m["name"]: m for m in bench["end_to_end"]}
        return _applies(e2e[metric["moves"]], workload, bench)
    return True


def module(rel: str) -> ModuleType:
    """The module of ``portbench/<rel>`` (a ``.py`` file), imported as
    ``portbench.<rel's parts>``; FileNotFoundError names a file that is not
    there."""
    path = HERE / rel
    if path.suffix != ".py" or not path.is_file():
        raise FileNotFoundError(f"no module file {path}")
    parts = Path(rel).with_suffix("").parts
    if not all(p.isidentifier() for p in parts):
        raise ValueError(f"{rel}: each part of a module's path must be an identifier")
    return importlib.import_module(".".join((__package__, *parts)))


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` with its files read and its configuration's
    modules imported; KeyError or FileNotFoundError names what is
    missing."""
    bench = bench if bench is not None else load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are: {', '.join(sorted(work))})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    mods = {k: module(config.get(k, v)) for k, v in DEFAULT_MODULES.items()}
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name, bench)],
                [m for m in bench["per_layer"] if _applies(m, name, bench)],
                **mods)


def metric_reader(name: str):
    """``read(ctx) -> float | None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
