"""Sharded training across four cards through the port's CLI, each mesh
held against the same CLI on one card in the same call.

    python -m fwumious_wabbit_tpu_torch.multicard [--cpu] [RUN ...]

Every mesh run is the one-command CLI (parallel/launch.py: one rank per
card over NCCL); run ``a`` also goes through the explicit four-rank form
(``--fwt_hosts 4 --fwt_host_id r --fwt_coordinator``, each rank with paths
of its own). The runs (all by default):

===  =============================================  ==========================  ===========
run  model                                          mesh and exchange           data, batch
===  =============================================  ==========================  ===========
a    LR+FFM k=8 at full width (synthetic.py)        --fwt_data_axis 4 (psum)    1M, 1024
b    the same                                       --fwt_table_axis 4 (a2a)    1M, 1024
c    the same                                       --fwt_table_axis 2: a2a,    1M, 1024
                                                    and with --fwt_exchange psum
d    Deep FFM (synthetic.tower_argv)                --fwt_table_axis 2 (a2a)    1M, 1024
e    BASELINE config 4's tables: the LR+FFM flags   --fwt_table_axis 4 (a2a)    1M, 32768
     with --ffm_bit_precision 29
f    Eat-Rate gate 4 (gates.ER_ARGV)                --fwt_data_axis 4 (psum)    10M/10M, 32768
g    ``-t -i`` of run a's one-card model            --fwt_table_axis 4 (a2a)    1M, 1024
h    the deployment chain (deployment.py): v1 and   --fwt_data_axis 2           1M split in
     v2 of the LR+FFM k=8 model trained on the      --fwt_table_axis 2          halves, 1024
     mesh, exported, patched and served             --fwt_exchange a2a
===  =============================================  ==========================  ===========

Checks, each failing the module (exit 1): ``-p`` within 1e-5 per line of
the one-card run (1e-6 for ``g``); every table and tower tensor of ``-f``
within 1e-5·(1+max|·|); a2a drops 0 on every rank. These bounds hold
where the AdaGrad LUT rate is a constant (power_t 0, PERF.md §2). Run d's
tower learns at power_t 0.5: its partial sums meet in an all_reduce, in
another order than one card's matmul, and a last bit that lands on a LUT
bucket edge moves a weight by the bucket's rate step, which training then
carries on; run d is held to its learning quality instead, the
progressive logloss of its ``-p`` within 1e-4 of one card's, and its
largest differences are reported (tests/test_torch_multicard_cuda.py holds
the tower's step to one card within the bounds at power_t 0). Further: run f's test logloss in
gate 4's (0.55, 0.6420] and within 1e-4 of the one-card model's; every path
the user named written by rank 0 alone, and nothing else in the run's
directory but the ranks' counters; the explicit form's ranks' files
byte-equal to each other and to the one-command run's; on the card, each
rank launched every kernel its model's path runs.

Run h is BASELINE config 5 across cards (the JAX test trains it 4×2 on
eight devices; four cards give 2×2): v1 on the first half of the file and
v2 on the second from ``-i v1 --save_resume``, each on the mesh and on one
card, the mesh's within the bounds above of one card's (power_t 0); then
the mesh's v1 and v2 go through deployment.serve_chain — quantized
exports, the patcher's diff and ``recreate`` byte-equal, one daemon on
card 0 (serving is one process per card) detached and soaked under 20 hot
swaps, every reply within 2e-6 of the CPU's plain prediction under v1q or
v2q, the settled replies against ``-t -i`` on both engines, and its device
memory across the swaps.

Numbers per mesh run, each rank's from its FWT_COUNTERS_OUT file: train
ex/s beside the one-card rate, wall ms per step, the sharded steps'
collective bytes per step per rank (``sharded.COLLECTIVE_BYTES``) beside
``sharded.estimate_comm_bytes`` of the tables, the process group's set-up
seconds, the peak device memory, the producer's busy/stall and the
consumer's dispatch/starve seconds, and each kernel's launches per step.
Results go to ``.bench_cache/multicard/<cuda|cpu>/multicard.json``.

On the card it needs four (and exits 1 on fewer). ``--cpu`` runs the same
checks on four gloo ranks over the 10k-line file, with run e's FFM table
cut to 2^25 floats and run f trained and tested on the 10k-line files of
two seeds, without gate 4's bound (the bound is of the 10M-line data).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from . import gates, synthetic
from .parallel import launch

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / ".bench_cache" / "multicard"
CARDS = 4
PRED_BOUND = 1e-5  # -p per line against one card (PERF.md §2)
PREDICT_BOUND = 1e-6  # run g
TENSOR_BOUND = 1e-5  # ·(1+max|·|)
LOGLOSS_GAP = 1e-4
GATE4 = (0.55, 0.6420)
# the C++ ingest's padded ids per example of the Eat-Rate data (PERF.md §4)
WIDTHS = {"lr": 14, "ffm": 4}
KERNELS = ("ffm_triangle", "ffm_triangle_bwd", "sparse_adagrad_update")
RUN_TIMEOUT_S = 1800


class MulticardFailed(RuntimeError):
    """A run failed or a result is outside its bound."""


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise MulticardFailed(msg)


@dataclasses.dataclass
class Run:
    model: str  # a key of MODELS
    meshes: list  # the mesh flags of each mesh command
    batch: int
    data: str  # "train" or "gate4"
    predict: bool = False  # -t -i of the one-card model
    explicit: bool = False  # also the explicit four-rank form
    # False: held to the one-card run's progressive logloss, its largest
    # differences reported (a LUT rate with steps: module docstring)
    strict: bool = True
    chain: bool = False  # the deployment chain (run h)


def _config4() -> list:
    return synthetic.serving_argv() + ["--ffm_bit_precision", "29"]


MODELS = {"lr_ffm": synthetic.serving_argv, "tower": synthetic.tower_argv,
          "config4": _config4, "gate4": lambda: list(gates.ER_ARGV)}
# the kernels each model's training path launches
PATH_KERNELS = {"lr_ffm": KERNELS, "tower": KERNELS, "config4": KERNELS,
                "gate4": ("sparse_adagrad_update",)}
RUNS = {
    "a": Run("lr_ffm", [["--fwt_data_axis", "4"]], 1024, "train", explicit=True),
    "b": Run("lr_ffm", [["--fwt_table_axis", "4"]], 1024, "train"),
    "c": Run("lr_ffm", [["--fwt_table_axis", "2"],
                        ["--fwt_table_axis", "2", "--fwt_exchange", "psum"]],
             1024, "train"),
    "d": Run("tower", [["--fwt_table_axis", "2"]], 1024, "train", strict=False),
    "e": Run("config4", [["--fwt_table_axis", "4"]], 32768, "train"),
    "f": Run("gate4", [["--fwt_data_axis", "4"]], 32768, "gate4"),
    "g": Run("lr_ffm", [["--fwt_table_axis", "4"]], 1024, "train", predict=True),
    "h": Run("lr_ffm", [["--fwt_data_axis", "2", "--fwt_table_axis", "2",
                         "--fwt_exchange", "a2a"]], 1024, "train", chain=True),
}


def model_tensors(path: Path) -> dict:
    """The tables and tower tensors of a model file, read to the CPU."""
    from .persistence.model_file import load_model

    model = load_model(path, device="cpu")[2]
    out = {k: getattr(model, k) for k in ("lr_w", "lr_acc", "ffm_w", "ffm_acc")
           if k in model._buffers}
    if model.has_nn:
        for i, layer in enumerate([*model.layers, model.final]):
            where = "final" if i == len(model.layers) else f"nn[{i}]"
            out.update({f"{where}.{k}": v for k, v in layer.tensors().items()})
    return out


def tensor_errors(got: Path, want: Path, bounded: bool = True) -> dict:
    """Each tensor's max |got − want|, failing past 1e-5·(1+max|want|)
    when ``bounded``."""
    if got.read_bytes() == want.read_bytes():
        return {"identical": 0.0}
    a, b = model_tensors(got), model_tensors(want)
    require(set(a) == set(b), f"{got} holds other tensors than {want}")
    errs = {}
    for key, w in b.items():
        errs[key] = (a[key] - w).abs().max().item()
        bound = TENSOR_BOUND * (1.0 + w.abs().max().item())
        require(errs[key] <= bound or not bounded,
                f"{got}: {key} differs by {errs[key]} > {bound}")
    return errs


class Session:
    """One call's runs: its data, its one-card references (each made once)
    and its results."""

    def __init__(self, cpu: bool, work: Path, train_data: Path | None = None):
        self.cpu = cpu
        self.out = work / ("cpu" if cpu else "cuda")
        shutil.rmtree(self.out, ignore_errors=True)
        self.out.mkdir(parents=True)
        self.data_dir = work / "data"
        rows = 10_000 if cpu else 1_000_000
        self.train = train_data or synthetic.ensure_dataset(self.data_dir, rows)
        self.refs: dict = {}
        self.device = gates.device_name(cpu)
        self._gate4 = None

    def start_gate4_data(self) -> None:
        """Write run f's data in the background (two 10M-line files on the
        card; two 10k-line files of seeds 21 and 22 with --cpu)."""
        def prepare():
            try:
                if self.cpu:
                    for seed, name in ((21, "gate4_train"), (22, "gate4_test")):
                        path = self.data_dir / f"{name}_10k.vw"
                        if not path.exists():
                            synthetic.generate_dataset(path, 10_000, seed=seed)
                else:
                    gates.prepare(("er10m",), gates.WORK)
            except BaseException as e:  # noqa: BLE001 — re-raised by gate4_data
                self._gate4_error = e

        self._gate4_error = None
        self._gate4 = threading.Thread(target=prepare, daemon=True)
        self._gate4.start()

    def gate4_data(self) -> tuple:
        if self._gate4 is None:
            self.start_gate4_data()
        self._gate4.join()
        if self._gate4_error is not None:
            raise self._gate4_error
        if self.cpu:
            synthetic.write_namespace_map(self.data_dir)
            return (self.data_dir / "gate4_train_10k.vw",
                    self.data_dir / "gate4_test_10k.vw")
        return (gates.data_path("er10m_train", gates.WORK),
                gates.data_path("er10m_test", gates.WORK))

    def env(self, counters: Path) -> dict:
        env = dict(os.environ, FWT_COUNTERS_OUT=str(counters))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        env.pop(launch.LAUNCHED_ENV, None)
        if self.cpu:
            env.setdefault("OMP_NUM_THREADS", "1")
        return env

    def cli(self, tag: str, argv: list) -> dict:
        """One command of the port's CLI in a process of its own, its
        output in ``<tag>.log``: ``{"wall_s", "ranks": [each rank's
        counters]}`` (rank 0 first; one entry without a mesh)."""
        d = self.out / tag
        d.mkdir(parents=True, exist_ok=True)
        argv = list(argv) + (["--fwt_platform", "cpu"] if self.cpu else [])
        counters = d / "counters.json"
        t0 = time.perf_counter()
        with open(self.out / f"{tag}.log", "wb") as log:
            rc = subprocess.run([sys.executable, "-m", "fwumious_wabbit_tpu_torch",
                                 *argv], cwd=ROOT, env=self.env(counters),
                                stdout=log, stderr=subprocess.STDOUT,
                                timeout=RUN_TIMEOUT_S).returncode
        wall = time.perf_counter() - t0
        require(rc == 0, f"{tag}: the CLI exited {rc}: {' '.join(argv)}\n"
                + (self.out / f"{tag}.log").read_text(errors="replace")[-3000:])
        ranks = [json.loads(counters.read_text())]
        world = int(np.prod(ranks[0]["mesh"]["shape"])) if "mesh" in ranks[0] else 1
        ranks += [json.loads((d / f"counters.json.rank{r}").read_text())
                  for r in range(1, world)]
        return {"wall_s": wall, "ranks": ranks, "dir": d}

    def argv(self, run: Run) -> list:
        argv = MODELS[run.model]() + ["--fwt_batch_size", str(run.batch)]
        if self.cpu and run.model == "config4":
            argv += ["--ffm_bit_precision", "25"]  # the CPU's memory
        return argv

    def one_card(self, run: Run) -> dict:
        """The one-card training run of ``run``'s model, data and batch
        (``-p`` and ``-f``), made once per call."""
        key = (run.model, run.data, run.batch)
        if key not in self.refs:
            tag = f"one_{run.model}_{run.batch}"
            d = self.out / tag
            data = self.train if run.data == "train" else self.gate4_data()[0]
            res = self.cli(tag, self.argv(run) + [
                "--data", str(data), "-p", str(d / "p.out"), "-f", str(d / "m.fwt"),
                "--save_resume"])
            res.update(preds=d / "p.out", fwt=d / "m.fwt")
            self.refs[key] = res
        return self.refs[key]

    def predict_ref(self, run: Run) -> dict:
        key = ("predict", run.model, run.batch)
        if key not in self.refs:
            model = self.one_card(run)["fwt"]
            d = self.out / "one_predict"
            res = self.cli("one_predict", self.argv(run) + [
                "-t", "-i", str(model), "--data", str(self.train),
                "-p", str(d / "p.out")])
            res.update(preds=d / "p.out")
            self.refs[key] = res
        return self.refs[key]


def _exchange(flags: list) -> str:
    if "--fwt_exchange" in flags:
        return flags[flags.index("--fwt_exchange") + 1]
    if "--fwt_table_axis" in flags:
        return "a2a" if int(flags[flags.index("--fwt_table_axis") + 1]) > 1 else "psum"
    return "psum"


def numbers(res: dict, ref: dict, run: Run, flags: list) -> dict:
    """A mesh command's numbers per rank, beside the one-card run's."""
    from .parallel import sharded

    r0 = res["ranks"][0]
    steps = math.ceil(r0["examples"] / run.batch)
    shape = tuple(r0["mesh"]["shape"])
    exchange = _exchange(flags)
    tables = ["lr"] + (["ffm"] if run.model != "gate4" else [])
    estimate = (None if run.predict else
                sum(sharded.estimate_comm_bytes(run.batch, WIDTHS[t], shape, exchange)
                    for t in tables))
    one = ref["ranks"][0]
    per_rank = []
    for r in res["ranks"]:
        c = r["counters"]
        per_rank.append({
            "rank": r["mesh"]["rank"],
            "collective_bytes_per_step": r["mesh"]["collective_bytes"] / steps,
            "setup_s": r["mesh"]["setup_s"],
            "peak_device_bytes": r.get("peak_device_bytes"),
            "producer_busy_s": c["producer_busy_s"],
            "producer_stall_s": c["producer_stall_s"],
            "dispatch_s": c["dispatch_s"], "consumer_starve_s": c["consumer_starve_s"],
            "elapsed_s": r["elapsed"],
            "launches_per_step": {k: v / steps for k, v in r["launches"].items()}})
    return {"mesh": list(shape), "exchange": exchange, "steps": steps,
            "ex_s": r0["examples"] / r0["elapsed"],
            "one_card_ex_s": one["examples"] / one["elapsed"],
            "wall_ms_per_step": r0["elapsed"] / steps * 1e3,
            "one_card_wall_ms_per_step": one["elapsed"] / steps * 1e3,
            "one_card_peak_device_bytes": one.get("peak_device_bytes"),
            "estimate_comm_bytes_per_step": estimate,
            "command_wall_s": res["wall_s"], "ranks": per_rank}


def check_ranks(what: str, res: dict, run: Run, named: list, cpu: bool) -> None:
    """Drops 0 on every rank, every named path written by rank 0 alone and
    nothing else in the directory but counters, and on the card each
    kernel of the path launched on every rank."""
    world = len(res["ranks"])
    require(world == CARDS, f"{what}: {world} ranks, not {CARDS}")
    for r, rank in enumerate(res["ranks"]):
        require(rank["mesh"]["rank"] == r, f"{what}: counters of rank "
                f"{rank['mesh']['rank']} in rank {r}'s file")
        require(rank["a2a_dropped"] == 0,
                f"{what}: rank {r} dropped {rank['a2a_dropped']} a2a occurrences")
        require(rank["files_written"] == (named if r == 0 else []),
                f"{what}: rank {r} wrote {rank['files_written']}")
        if not cpu:
            kernels = ("ffm_triangle",) if run.predict else PATH_KERNELS[run.model]
            for k in kernels:
                require(rank["launches"][k] > 0,
                        f"{what}: rank {r} never launched the {k} kernel")
    want = {Path(p).name for p in named} | {"counters.json"} | {
        f"counters.json.rank{r}" for r in range(1, world)}
    got = {p.name for p in res["dir"].iterdir()}
    require(got == want, f"{what}: the run's directory holds {sorted(got)}, "
                         f"not {sorted(want)}")


def read_preds(path: Path) -> np.ndarray:
    return np.array(Path(path).read_bytes().split(), np.float64)


def explicit_form(s: Session, run: Run, tag: str, argv: list, flags: list) -> dict:
    """The same mesh started as four explicit ranks, each with its own
    ``-p``, ``-f`` and counters; their files byte-equal to each other."""
    d = s.out / tag
    d.mkdir(parents=True, exist_ok=True)
    coordinator = f"127.0.0.1:{launch.free_port()}"
    cmds = []
    for r in range(CARDS):
        cmds.append(([sys.executable, "-m", "fwumious_wabbit_tpu_torch", *argv, *flags,
                      "-p", str(d / f"p{r}.out"), "-f", str(d / f"m{r}.fwt"),
                      "--save_resume", "--fwt_hosts", str(CARDS), "--fwt_host_id", str(r),
                      "--fwt_coordinator", coordinator]
                     + (["--fwt_platform", "cpu"] if s.cpu else []),
                     s.env(d / f"counters{r}.json")))
    t0 = time.perf_counter()
    with open(s.out / f"{tag}.log", "w") as log:
        rc = launch.supervise(cmds, out=log)
    wall = time.perf_counter() - t0
    require(rc == 0, f"{tag}: the explicit ranks failed:\n"
            + (s.out / f"{tag}.log").read_text(errors="replace")[-3000:])
    for ext, name in (("out", "p"), ("fwt", "m")):
        first = (d / f"{name}0.{ext}").read_bytes()
        for r in range(1, CARDS):
            require((d / f"{name}{r}.{ext}").read_bytes() == first,
                    f"{tag}: rank {r}'s {name}{r}.{ext} differs from rank 0's")
    return {"wall_s": wall, "preds": d / "p0.out", "fwt": d / "m0.fwt",
            "ranks": [json.loads((d / f"counters{r}.json").read_text())
                      for r in range(CARDS)]}


def run_chain(s: Session, name: str) -> dict:
    """Run h: v1 and v2 on the mesh and on one card, each mesh model held to
    one card's, then the deployment chain of the mesh's two models."""
    from . import deployment

    run = RUNS[name]
    flags = run.meshes[0]
    first, last = deployment.split_halves(s.train)
    out = {"run": name, "model": run.model, "batch": run.batch, "meshes": []}
    models = {}
    try:
        for version, data in (("v1", first), ("v2", last)):
            resume = {who: ["-i", str(models[(who, "v1")])] if version == "v2" else []
                      for who in ("one", "mesh")}
            d = s.out / f"{name}_one_{version}"
            ref = s.cli(f"{name}_one_{version}", s.argv(run) + resume["one"] + [
                "--data", str(data), "-p", str(d / "p.out"), "-f", str(d / "m.fwt"),
                "--save_resume"])
            models[("one", version)] = d / "m.fwt"
            d = s.out / f"{name}_{version}"
            named = [str(d / "p.out"), str(d / "m.fwt")]
            res = s.cli(f"{name}_{version}", s.argv(run) + resume["mesh"] + flags + [
                "--data", str(data), "--save_resume", "-p", named[0], "-f", named[1]])
            models[("mesh", version)] = d / "m.fwt"
            what = f"run {name} {version} ({' '.join(flags)})"
            check_ranks(what, res, run, named, s.cpu)
            got, want = read_preds(named[0]), read_preds(s.out / f"{name}_one_{version}" / "p.out")
            require(got.shape == want.shape and np.isfinite(got).all(),
                    f"{what}: {got.shape} predictions, one card {want.shape}")
            pred_err = float(np.abs(got - want).max())
            require(pred_err <= PRED_BOUND,
                    f"{what}: -p differs from one card by {pred_err} > {PRED_BOUND}")
            entry = {"model": run.model, "flags": flags + [version], "pred_err": pred_err,
                     "preds_identical": bool((got == want).all()),
                     "numbers": numbers(res, ref, run, flags),
                     "tensor_err": tensor_errors(d / "m.fwt", models[("one", version)])}
            out["meshes"].append(entry)
            print(summary(name, entry, s.device), flush=True)
        argv = s.argv(run)
        chain = deployment.serve_chain(
            {"v1": models[("mesh", "v1")], "v2": models[("mesh", "v2")]}, s.train,
            s.out / f"{name}_chain", s.cpu, deployment.model_table_bytes(argv))
        deployment.report(chain)
        out["chain"] = chain
    finally:
        for p in (first, last, *models.values()):
            p.unlink(missing_ok=True)
    return out


def run_one(s: Session, name: str) -> dict:
    """Run ``name``: each mesh command against its one-card run."""
    run = RUNS[name]
    if run.chain:
        return run_chain(s, name)
    strict = run.strict
    out = {"run": name, "model": run.model, "batch": run.batch, "meshes": []}
    ref = s.predict_ref(run) if run.predict else s.one_card(run)
    for i, flags in enumerate(run.meshes):
        if s.cpu and "--fwt_data_axis" not in flags:
            # gloo ranks: as many as the mesh asks for, so name the data
            # axis that four cards give
            n_table = int(flags[flags.index("--fwt_table_axis") + 1])
            flags = flags + ["--fwt_data_axis", str(CARDS // n_table)]
        tag = f"{name}{i}"
        d = s.out / tag
        if run.predict:
            argv = s.argv(run) + ["-t", "-i", str(s.one_card(run)["fwt"]),
                                  "--data", str(s.train)]
            named = [str(d / "p.out")]
        else:
            data = s.train if run.data == "train" else s.gate4_data()[0]
            argv = s.argv(run) + ["--data", str(data), "--save_resume"]
            named = [str(d / "p.out"), str(d / "m.fwt")]
        res = s.cli(tag, argv + flags + ["-p", named[0]]
                    + (["-f", named[1]] if not run.predict else []))
        what = f"run {name} ({' '.join(flags)})"
        check_ranks(what, res, run, named, s.cpu)
        got, want = read_preds(d / "p.out"), read_preds(ref["preds"])
        require(got.shape == want.shape and np.isfinite(got).all(),
                f"{what}: {got.shape} predictions, one card {want.shape}")
        bound = PREDICT_BOUND if run.predict else PRED_BOUND
        pred_err = float(np.abs(got - want).max())
        require(pred_err <= bound or not strict,
                f"{what}: -p differs from one card by {pred_err} > {bound}")
        entry = {"model": run.model, "flags": flags, "pred_err": pred_err,
                 "preds_identical": bool((got == want).all()),
                 "numbers": numbers(res, ref, run, flags)}
        if not run.predict:
            entry["tensor_err"] = tensor_errors(d / "m.fwt", ref["fwt"], strict)
        if not strict:
            labels = gates.labels_of(s.train)
            ll = {"mesh": gates.logloss(got, labels), "one_card": gates.logloss(want, labels)}
            ll["gap"] = abs(ll["mesh"] - ll["one_card"])
            require(ll["gap"] <= LOGLOSS_GAP, f"{what}: progressive logloss "
                    f"{ll['mesh']} is {ll['gap']} from one card's {ll['one_card']}")
            entry["progressive_logloss"] = ll
        if run.data == "gate4":
            entry["logloss"] = gate4_logloss(s, run, d / "m.fwt", tag)
        if run.explicit:
            exp = explicit_form(s, run, f"{tag}_explicit", argv, flags)
            for path, named_path in ((exp["preds"], named[0]), (exp["fwt"], named[1])):
                require(Path(path).read_bytes() == Path(named_path).read_bytes(),
                        f"{what}: the explicit form's {Path(path).name} differs "
                        f"from the one-command run's")
            entry["explicit"] = {"wall_s": exp["wall_s"], "files_equal": True,
                                 "ex_s": exp["ranks"][0]["examples"]
                                 / exp["ranks"][0]["elapsed"]}
            for r in range(CARDS):  # up to 4.3 GB each: checked, not kept
                (s.out / f"{tag}_explicit" / f"m{r}.fwt").unlink()
        out["meshes"].append(entry)
        print(summary(name, entry, s.device), flush=True)
        if not run.predict:
            (d / "m.fwt").unlink()
    return out


def gate4_logloss(s: Session, run: Run, model: Path, tag: str) -> dict:
    """Run f: ``-t`` of the mesh's and the one-card model on one card over
    the test file; both loglosses, gate 4's bound on the card."""
    test = s.gate4_data()[1]
    labels = gates.labels_of(test)
    result = {}
    for who, path in (("mesh", model), ("one_card", s.one_card(run)["fwt"])):
        res = s.cli(f"{tag}_test_{who}", s.argv(run) + [
            "-t", "-i", str(path), "--data", str(test),
            "-p", str(s.out / f"{tag}_test_{who}" / "p.out")])
        p = read_preds(s.out / f"{tag}_test_{who}" / "p.out")
        require(p.shape == labels.shape, f"run f: {p.shape} test predictions")
        result[who] = gates.logloss(p, labels)
        result[f"{who}_test_lines_s"] = res["ranks"][0]["examples"] / res["ranks"][0]["elapsed"]
    gap = abs(result["mesh"] - result["one_card"])
    require(gap <= LOGLOSS_GAP, f"run f: test logloss {result['mesh']} is "
                                f"{gap} from one card's {result['one_card']}")
    if not s.cpu:
        lo, hi = GATE4
        require(lo < result["mesh"] <= hi, f"run f: test logloss "
                                           f"{result['mesh']} outside ({lo}, {hi}]")
    result["gap"] = gap
    return result


def summary(name: str, e: dict, device: str) -> str:
    n = e["numbers"]
    r = n["ranks"]
    line = (f"multicard run {name} ({e['model']}) {' '.join(e['flags'])}: mesh {n['mesh'][0]}x"
            f"{n['mesh'][1]} {n['exchange']}, -p max |diff| vs one card "
            f"{e['pred_err']!r}")
    if "tensor_err" in e:
        line += f", tensors {json.dumps(e['tensor_err'])}"
    if "progressive_logloss" in e:
        line += (f", progressive logloss {e['progressive_logloss']['mesh']!r} "
                 f"(one card {e['progressive_logloss']['one_card']!r})")
    if "logloss" in e:
        line += (f", test logloss {e['logloss']['mesh']!r} (one card "
                 f"{e['logloss']['one_card']!r})")
    line += (f"; {n['ex_s']:.0f} ex/s (one card {n['one_card_ex_s']:.0f}), "
             f"{n['wall_ms_per_step']:.3f} ms per step (one card "
             f"{n['one_card_wall_ms_per_step']:.3f}); collective bytes per step "
             f"per rank {[round(x['collective_bytes_per_step']) for x in r]} "
             f"(estimate {n['estimate_comm_bytes_per_step']}); set-up s "
             f"{[round(x['setup_s'], 3) for x in r]}; peak device bytes "
             f"{[x['peak_device_bytes'] for x in r]} (one card "
             f"{n['one_card_peak_device_bytes']}); producer busy/stall s "
             f"{[(round(x['producer_busy_s'], 2), round(x['producer_stall_s'], 2)) for x in r]}; "
             f"dispatch/starve s "
             f"{[(round(x['dispatch_s'], 2), round(x['consumer_starve_s'], 2)) for x in r]}; "
             f"launches per step (rank 0) {json.dumps(r[0]['launches_per_step'])}"
             f" [{device}, {CARDS} ranks]")
    if "explicit" in e:
        line += (f"; the explicit form's files equal, {e['explicit']['ex_s']:.0f} "
                 f"ex/s")
    return line


def require_cards(cpu: bool) -> None:
    if cpu:
        return
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    require(count >= CARDS, f"multicard needs {CARDS} CUDA cards; this host "
                            f"has {count} (--cpu runs on {CARDS} gloo ranks)")


def run_all(names: list, cpu: bool = False, work: Path | None = None,
            train_data: Path | None = None) -> dict:
    """Run ``names`` (keys of :data:`RUNS`) in one session and write the
    results to ``<work>/<cuda|cpu>/multicard.json``."""
    require_cards(cpu)
    s = Session(cpu, work or WORK, train_data)
    if "f" in names:
        s.start_gate4_data()
    t0 = time.perf_counter()
    results = {"device": s.device, "cards": CARDS, "runs": {}}
    for name in names:
        results["runs"][name] = run_one(s, name)
    results["seconds"] = time.perf_counter() - t0
    (s.out / "multicard.json").write_text(json.dumps(results, indent=1))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fwumious_wabbit_tpu_torch.multicard",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="*", metavar="RUN",
                    help=f"any of {' '.join(RUNS)} (all by default)")
    ap.add_argument("--cpu", action="store_true",
                    help="four gloo ranks on the CPU over the 10k-line file")
    args = ap.parse_args(argv)
    unknown = [r for r in args.runs if r not in RUNS]
    if unknown:
        ap.error(f"unknown runs {unknown}: choose from {' '.join(RUNS)}")
    try:
        res = run_all(args.runs or list(RUNS), args.cpu)
    except Exception as e:  # noqa: BLE001 — any failure fails the module
        print(f"multicard: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(f"multicard: PASSED: runs {' '.join(res['runs'])} on {CARDS} ranks "
          f"[{res['device']}], {res['seconds']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
