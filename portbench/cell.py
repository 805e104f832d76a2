"""One run of one cell: set-up, the measured window of replay passes, the
output check, and (traced) the per-layer readings.

The system under test is ``fwumious_wabbit_tpu_torch``: its model
(``FwModel``), loaded with the benchmark's own initial weights, and its
training entry ``train.loop.run_train_loop``. Set-up writes the seeded
file (in the configuration's data schema, ``Cell.data``) and trains the
user's first pass from the text with the pack cache on, which records the
packed superbatch stream beside the file (``<file>.fwpack``); the second pass replays that stream. Every later call
replays it too: the window runs whole passes, each one call of
``run_train_loop`` on the same model, until ``seconds`` have passed; one
more replay pass follows the window, with the graphs the window left.

The output check (check.py) holds the program to the configuration's plain
reference (``Cell.reference``; reference.py unless the configuration names
another) over the three checked passes, each from the state the
program had before it: the text pass from the initial weights, set-up's
replay pass from a snapshot taken after the text pass, and the pass after
the window from a snapshot taken after the window. A checked pass writes
its predictions (``-p``) when the cell's limits compare its loss.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from pathlib import Path

import torch

from . import check
from .spec import Cell


def program_args(cell: Cell, data: Path, *extra: str):
    """The program's flags: the configuration's, the traffic's, the data,
    and the pack cache on (the first pass records, later passes replay)."""
    from fwumious_wabbit_tpu_torch.config.cmdline import build_parser

    return build_parser().parse_args(
        [*cell.config["argv"], *cell.traffic["argv"], "--data", str(data),
         "--fwt_pack_cache", "on", *extra])


def to_params(st: dict, ref, model: dict) -> dict:
    """The benchmark's flat state as the program's params dict; ``ref`` is
    the configuration's reference."""
    p = {k: st[k].view(-1, ref.LANE) for k in ref.TABLES}
    shapes = ref.tower_shapes(model)
    if shapes:
        layer = lambda n: {k: st[f"{n}.{k}"] for k in ("w", "b", "w_acc", "b_acc")}
        p["nn"] = [layer(n) for n, _, _ in shapes[:-1]]
        p["final"] = layer("final")
    return p


def snapshot(model, ref) -> dict:
    """The program's weights and accumulators, copied to the host, keyed
    as the state of the reference ``ref``."""
    p = model.params()
    out = {k: p[k].detach().reshape(-1).to("cpu", copy=True) for k in ref.TABLES}
    named = [(f"nn.{i}", l) for i, l in enumerate(p.get("nn", []))]
    if "final" in p:
        named.append(("final", p["final"]))
    for name, layer in named:
        for k in ("w", "b", "w_acc", "b_acc"):
            out[f"{name}.{k}"] = layer[k].detach().to("cpu", copy=True)
    return out


# the checked passes, in the order they run
CHECKED = ("text_pass", "replay_pass", "last_pass")


class Run:
    """One run's state: the data, the program's model and the readings."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, workdir: Path):
        self.cell, self.seed, self.device = cell, seed, device
        self.ref = cell.reference
        self.workdir = Path(workdir)
        self.data = self.workdir / "train.vw"
        t = cell.traffic
        self.lines, self.batch = int(t["lines"]), int(t["batch"])
        self.snap_s = 0.0
        # the passes whose loss the limits compare write -p
        self.predicted = {k.split(".")[0] for k in cell.limits if ".loss_gap" in k}
        self.before: dict = {}  # checked pass → the program's state before it
        self.after: dict = {}  # and after it
        self.detail: dict = {}  # the check's per-leaf and per-step readings
        self.counters: list = []  # the run_train_loop results, in order

    # -- set-up ------------------------------------------------------------

    def write_data(self) -> None:
        data, t = self.cell.data, self.cell.traffic
        self.cols = data.columns(t, self.seed)
        data.write_text(t, self.cols, self.data)

    def build_model(self) -> None:
        from fwumious_wabbit_tpu_torch import native
        from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
        from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
        from fwumious_wabbit_tpu_torch.models.model import FwModel

        native.require()
        args = program_args(self.cell, self.data)
        self.vw = VwNamespaceMap.from_dataset_dir(str(self.data))
        self.mi = ModelInstance.from_cmdline(args, self.vw)
        self.model = FwModel(self.mi, batch_mean_mode=args.fwt_batch_mean or "auto",
                             batch_cap=float(args.fwt_batch_cap or 8.0))
        m = self.cell.config["model"]
        st = self.ref.initial_weights(m, self.seed, self.device)
        self.model.load_params(to_params(st, self.ref, m))

    def train_pass(self, *extra: str) -> dict:
        from fwumious_wabbit_tpu_torch.train.loop import run_train_loop

        args = program_args(self.cell, self.data, *extra)
        r = run_train_loop(args, self.mi, self.vw, self.model)
        self.counters.append(r)
        return r

    def snap(self) -> dict:
        t0 = time.perf_counter()
        s = snapshot(self.model, self.ref)
        self.snap_s += time.perf_counter() - t0
        return s

    def preds_path(self, tag: str) -> Path:
        return self.workdir / f"{tag}_preds.txt"

    def checked_pass(self, tag: str) -> dict:
        """A pass the check follows: ``-p`` when its loss is compared, the
        program's state snapshotted after it."""
        r = self.train_pass(*(("-p", str(self.preds_path(tag)))
                              if tag in self.predicted else ()))
        self.after[tag] = self.snap()
        return r

    def setup(self, predict: tuple | None = None) -> None:
        """Data, model, the text pass (recording the stream) and the
        replay pass, both checked; ``predict`` names the passes that write
        ``-p`` where the cell's limits are not to decide."""
        if predict is not None:
            self.predicted = set(predict)
        t = [time.perf_counter()]
        self.write_data()
        t.append(time.perf_counter())
        self.build_model()
        t.append(time.perf_counter())
        self.checked_pass("text_pass")
        t.append(time.perf_counter())
        self.before["replay_pass"] = self.after["text_pass"]
        self.checked_pass("replay_pass")
        t.append(time.perf_counter())
        self.phases = dict(zip(("data", "model", "text_pass", "replay_pass"),
                               (b - a for a, b in zip(t, t[1:]))))

    def last_pass(self) -> dict:
        """The checked replay pass after the window, from a snapshot of
        the state the window left."""
        self.before["last_pass"] = self.snap()
        return self.checked_pass("last_pass")

    # -- the window --------------------------------------------------------

    def window(self, seconds: float, profile_pass: int | None = None, tracer=None) -> dict:
        """Replay passes until ``seconds`` have passed; pass number
        ``profile_pass`` (0-based) runs under ``tracer``, and its time
        (the profiler's own included) is not counted toward ``seconds``."""
        from torch.profiler import record_function

        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" else (lambda: None)
        first = len(self.counters)
        sync()
        t0 = time.perf_counter()
        passes, traced, untraced_s = [], None, 0.0
        while True:
            i = len(passes)
            p0 = time.perf_counter()
            if i == profile_pass and tracer is not None:
                with tracer:
                    with record_function("portbench.replay_pass"):
                        r = self.train_pass()
                    sync()
                traced = i
            else:
                with record_function("portbench.replay_pass"):
                    r = self.train_pass()
                untraced_s += time.perf_counter() - p0
            passes.append((p0, time.perf_counter(), r["examples"]))
            if untraced_s >= seconds and (profile_pass is None or traced is not None):
                break
        sync()
        t1 = time.perf_counter()
        return {"window_s": t1 - t0, "passes": passes,
                "examples": sum(n for _, _, n in passes), "traced_pass": traced,
                "results": self.counters[first:]}

    def free_program(self) -> None:
        del self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the output check ----------------------------------------------------

    def reference_rows(self):
        """The reference's ``Rows`` of the run's columns."""
        m = self.cell.config["model"]
        ids = self.cell.data.ids(m, self.cell.traffic)
        return self.ref.Rows(m, ids.lr(self.cols), ids.ffm(self.cols),
                             self.cols["label"], self.batch, self.device)

    def check(self, rows, variant=None) -> dict:
        """The check's numbers, per checked pass (``text_pass``,
        ``replay_pass``, ``last_pass``): ``loss_gap_first`` (the worst of
        the first superbatch's steps), ``loss_gap`` (the worst step),
        ``grad_gap`` and ``change_gap``. ``variant(ref, model, st, rows) ->
        preds``, when given, is put in the program's place (the control and
        the planted faults)."""
        m, ref = self.cell.config["model"], self.ref
        leaves = ref.weight_leaves(m)
        dev, first = self.device, int(self.cell.traffic["superbatch"])
        out = {}
        for tag in [t for t in CHECKED if t in self.after]:
            start = (self.before[tag] if tag in self.before
                     else ref.initial_weights(m, self.seed, dev))
            prog_after = self.after[tag]
            st = {k: v.to(dev).clone() for k, v in start.items()}
            before = {k: v.clone() for k, v in st.items()}
            ref_preds = ref.run_pass(m, st, rows).cpu().numpy()
            if variant is not None:
                alt = {k: v.to(dev).clone() for k, v in start.items()}
                prog_preds = variant(ref, m, alt, rows).cpu().numpy()
                prog_after = alt
            elif tag in self.predicted:
                prog_preds = check.read_predictions(self.preds_path(tag))
            else:
                prog_preds = None
            gaps = check.leaf_gaps(check.leaf_norms(leaves, before, prog_after, dev),
                                   check.leaf_norms(leaves, before, st, dev))
            for k in ("grad_gap", "change_gap", "grad_gap_median", "change_gap_median"):
                out[f"{tag}.{k}"] = gaps[k]
            self.detail[tag] = gaps["leaves"]
            if prog_preds is not None:
                per_step = check.loss_gaps(prog_preds, ref_preds, self.cols["label"], self.batch)
                out[f"{tag}.loss_gap_first"] = float(per_step[:first].max())
                out[f"{tag}.loss_gap"] = float(per_step.max())
                self.detail[tag]["loss_gap_by_step"] = [
                    float(per_step[:n].max()) for n in (1, 3, 8, 64, 256) if n <= len(per_step)]
            del st, before
        return out


def make_workdir() -> Path:
    """A fresh directory under ``TMPDIR`` for one run's data."""
    return Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))


def remove_workdir(path: Path) -> None:
    shutil.rmtree(path, ignore_errors=True)
