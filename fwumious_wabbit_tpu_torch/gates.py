"""The JAX package's learning-quality gates, run through the port's CLI on
the card: the counterparts of scripts/ffm_gate.sh, of gates 3 and 4 of
scripts/basic_gate.sh and of scripts/demo_100m.sh, with the same flags,
data, arithmetic and bounds.

    python -m fwumious_wabbit_tpu_torch.gates {ffm,er200k,er10m,multipass,short,full} [--cpu]

* ``ffm``: LR + FFM (k=10, fields A and B, SGD, ``--noconstant``, B=256)
  on the herbivore/carnivore data (synthetic.generate_ffm_dataset: 300
  animals, 200 foods, 30,000 train lines), trained with ``-f
  --save_resume``, converted with ``--convert_inference_regressor``, and
  ``-t`` on test-hard.vw from both files: every line of the two within
  1e-9, more than one distinct prediction, balanced accuracy > 0.80.
* ``er200k`` (gate 3): the Eat-Rate LR model (``--interactions AB``, keep
  A..L, AdaGrad at power_t 0, the batch-mean cap) at B=16,384 over 200,000
  train lines (seed 11), ``-t`` over 50,000 (seed 12): test logloss below
  the exact-online oracle of docs/evidence/gate3_exact_online_200k.json
  plus 0.02, and above 0.5.
* ``er10m`` (gate 4): the same flags at B=32,768 over 10,000,000 lines each
  (seeds 21 and 22): 0.55 < test logloss ≤ 0.6420.
* ``multipass``: gate 4's flags with ``-c``, ten passes over the
  10,000,000-line seed-1 file, each from the previous pass's ``-f``, each
  followed by ``-t`` on a 200,000-line holdout (seed 1234); non-divergent
  when pass 10's holdout logloss is at most pass 1's + 0.01.
* ``short`` runs ``ffm`` and ``er200k``; ``full`` runs ``er10m`` and
  ``multipass``.

Every run goes to the card unless ``--cpu`` passes ``--fwt_platform cpu``
to all of them. A run that exits non-zero, a missing card or a kernel that
fails to build fails the gate: the module exits 1, and no earlier result
stands in for a run. Logloss is computed in float64 with predictions
clipped at 1e-12, balanced accuracy counts p ≥ 0.5 as a positive (the
scripts' formulas). Each gate reports its result against its bound, the
training rate and the ``-t`` rate from the CLI's ``Elapsed`` lines, and the
kernels' launches per training step.

Data is written once under ``.bench_cache/torch_gates/data`` (the two
10M-line gate-4 files and the multipass file by child processes, all at
once) and each gate's outputs and ``<gate>.json`` under
``.bench_cache/torch_gates/<cuda|cpu>/``. The JAX package's records in
docs/evidence/ are read, never written.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import synthetic

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / ".bench_cache" / "torch_gates"
EVIDENCE = ROOT / "docs" / "evidence"
EPS = 1e-12

FFM_ARGV = ["--keep", "A", "--keep", "B", "--interactions", "AB",
            "--ffm_k", "10", "--ffm_field", "A", "--ffm_field", "B",
            "-l", "0.1", "-b", "25", "--sgd", "--loss_function", "logistic",
            "--link", "logistic", "--power_t", "0.0", "--l2", "0.0",
            "--hash", "all", "--noconstant", "--fwt_batch_size", "256"]
ER_ARGV = ["-l", "0.1", "-b", "25", "--adaptive", "--sgd",
           "--loss_function", "logistic", "--link", "logistic",
           "--power_t", "0.0", "--l2", "0.0", "--hash", "all",
           "--interactions", "AB"] + [f for ns in "ABCDEFGHIJKL"
                                      for f in ("--keep", ns)]
# (rows, seed) of each Eat-Rate file, by name
ER_FILES = {"er200k_train": (200_000, 11), "er200k_test": (50_000, 12),
            "er10m_train": (10_000_000, 21), "er10m_test": (10_000_000, 22),
            "multipass_train": (10_000_000, 1), "multipass_eval": (200_000, 1234)}
GATE_FILES = {"ffm": (), "er200k": ("er200k_train", "er200k_test"),
              "er10m": ("er10m_train", "er10m_test"),
              "multipass": ("multipass_train", "multipass_eval")}
GROUPS = {"short": ("ffm", "er200k"), "full": ("er10m", "multipass")}
PASSES = 10


class GateFailed(RuntimeError):
    """A run failed or a result is outside its bound."""


# -- the scripts' arithmetic ---------------------------------------------------


def labels_of(path: Path) -> np.ndarray:
    """1 where a VW line's label is ``1``, else 0 (the scripts' rule)."""
    with open(path, "rb") as f:
        return np.fromiter((line.split(None, 1)[0] == b"1" for line in f),
                           np.float64)


def read_preds(path: Path) -> np.ndarray:
    return np.array(Path(path).read_bytes().split(), np.float64)


def logloss(preds: np.ndarray, labels: np.ndarray) -> float:
    """Mean logloss in float64, each probability clipped at 1e-12."""
    p = np.asarray(preds, np.float64)
    y = np.asarray(labels, np.float64)
    return float(-np.mean(y * np.log(np.maximum(p, EPS))
                          + (1 - y) * np.log(np.maximum(1 - p, EPS))))


def balanced_accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    """½(TPR + TNR) with p ≥ 0.5 a positive."""
    p, y = np.asarray(preds), np.asarray(labels) == 1
    pos, neg = int(y.sum()), int((~y).sum())
    tp = int((y & (p >= 0.5)).sum())
    tn = int((~y & (p < 0.5)).sum())
    return 0.5 * (tp / max(pos, 1) + tn / max(neg, 1))


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailed(msg)


# -- data ----------------------------------------------------------------------


def data_path(name: str, work: Path) -> Path:
    """The Eat-Rate file ``name`` of :data:`ER_FILES` (its namespace map
    beside it) or, for ``"ffm"``, the FFM dataset's directory, under
    ``work/data``."""
    return work / "data" / ("ffm" if name == "ffm" else f"{name}.vw")


def prepare(gates: tuple, work: Path) -> None:
    """Write the data the ``gates`` read, unless it is there: the FFM
    gate's in this process, each missing Eat-Rate file in a child process
    of its own, all at once (~10 s of Python per 1M lines each). Every
    file goes through a temporary name, so that a cut run leaves no
    partial file behind."""
    synthetic.write_namespace_map(work / "data")
    procs = []
    try:
        for gate in gates:
            for name in GATE_FILES[gate]:
                path = data_path(name, work)
                if path.exists():
                    continue
                rows, seed = ER_FILES[name]
                code = ("from pathlib import Path\n"
                        "from fwumious_wabbit_tpu_torch import synthetic\n"
                        f"synthetic.generate_dataset(Path({str(path)!r}), "
                        f"{rows}, seed={seed})\n")
                procs.append(subprocess.Popen([sys.executable, "-c", code],
                                              cwd=ROOT, stderr=subprocess.PIPE,
                                              text=True))
        ffm = data_path("ffm", work)
        if "ffm" in gates and not ffm.is_dir():
            tmp = ffm.with_name("ffm.tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            synthetic.generate_ffm_dataset(tmp, 300, 200, 30000)
            os.replace(tmp, ffm)
        for p in procs:
            _, err = p.communicate()
            require(p.returncode == 0, f"writing a dataset failed: {err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# -- the CLI -------------------------------------------------------------------


class _Log(logging.Handler):
    """The port's log messages during one CLI run."""

    def __init__(self):
        super().__init__()
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def launch_counts() -> dict:
    from .ops import ffm, sparse_update

    return {"ffm_triangle": ffm.LAUNCHES, "ffm_triangle_bwd": ffm.BWD_LAUNCHES,
            "sparse_adagrad_update": sparse_update.LAUNCHES}


def reset_launch_counts() -> None:
    from .ops import ffm, sparse_update

    ffm.LAUNCHES = ffm.BWD_LAUNCHES = sparse_update.LAUNCHES = 0


def cli(argv: list, cpu: bool) -> dict:
    """One run of the port's CLI in this process, ``--fwt_platform cpu``
    with ``cpu``: its wall seconds, the kernels' launches (the counts set
    to 0 just before it) and, for a training or ``-t`` run, the seconds
    and ex/s of its ``Elapsed`` line and its in-run counters
    (``FWT_COUNTERS_OUT``). Raises :class:`GateFailed` when it exits
    non-zero."""
    from .train.loop import main

    argv = list(argv) + (["--fwt_platform", "cpu"] if cpu else [])
    handler = _Log()
    logger = logging.getLogger("fwumious_wabbit_tpu_torch")
    level = logger.level
    logger.setLevel(logging.INFO)  # the Elapsed line is logged at INFO
    logger.addHandler(handler)
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        counters = Path(tmp) / "counters.json"
        outer = os.environ.get("FWT_COUNTERS_OUT")
        os.environ["FWT_COUNTERS_OUT"] = str(counters)
        t0 = time.perf_counter()
        try:
            rc = main(argv)
        finally:
            if outer is None:
                del os.environ["FWT_COUNTERS_OUT"]
            else:
                os.environ["FWT_COUNTERS_OUT"] = outer
            logger.removeHandler(handler)
            logger.setLevel(level)
        out = {"wall_s": time.perf_counter() - t0, "launches": launch_counts()}
        if counters.exists():
            out["counters"] = json.loads(counters.read_text())["counters"]
    require(rc == 0, f"the CLI exited {rc}: {' '.join(argv)}\n"
                     + "\n".join(handler.messages[-20:]))
    for msg in reversed(handler.messages):
        m = re.search(r"Elapsed: ([0-9.]+)s rows: (\d+) \((\d+) ex/s\)", msg)
        if m:
            out.update(elapsed_s=float(m.group(1)), rows=int(m.group(2)),
                       ex_s=float(m.group(3)))
            break
    return out


def per_step(run: dict, batch: int) -> dict:
    """A training run's launches per step of ``batch`` examples."""
    steps = -(-run["rows"] // batch)
    return {k: v / steps for k, v in run["launches"].items()}


def device_name(cpu: bool) -> str:
    """The card's name and power limit (nvidia-smi), or ``cpu``."""
    if cpu:
        return "cpu"
    from .utils.device import nvidia_smi_line

    return nvidia_smi_line()


# -- the gates -----------------------------------------------------------------


def gate_ffm(out: Path, cpu: bool, work: Path) -> dict:
    """scripts/ffm_gate.sh."""
    d = data_path("ffm", work)
    full, inf = out / "full.fwt", out / "inference.fwt"
    train = cli(FFM_ARGV + ["--data", str(d / "train.vw"), "-p",
                            str(out / "training.txt"), "-f", str(full),
                            "--save_resume"], cpu)
    cli(FFM_ARGV + ["-i", str(full), "--convert_inference_regressor", str(inf)],
        cpu)
    hard = d / "test-hard.vw"
    t_full = cli(FFM_ARGV + ["-i", str(full), "--data", str(hard), "-p",
                             str(out / "hard_full.txt"), "-t"], cpu)
    t_inf = cli(FFM_ARGV + ["-i", str(inf), "--data", str(hard), "-p",
                            str(out / "hard_inf.txt"), "-t"], cpu)
    p_full, p_inf = read_preds(out / "hard_full.txt"), read_preds(out / "hard_inf.txt")
    labels = labels_of(hard)
    require(len(p_full) == len(labels) == len(p_inf),
            f"{len(p_full)} and {len(p_inf)} predictions for {len(labels)} lines")
    same = int((np.abs(p_full - p_inf) < 1e-9).sum())
    ba = balanced_accuracy(p_full, labels)
    res = {"inference_equals_full": same, "lines": len(labels),
           "unique_predictions": len(set(p_full.tolist())),
           "balanced_accuracy": ba, "bound": "> 0.80",
           "train": train, "test_full": t_full, "test_inference": t_inf,
           "launches_per_train_step": per_step(train, 256)}
    res["passed"] = bool(same == len(labels) and res["unique_predictions"] > 1
                         and ba > 0.80)
    return res


def _er_train_test(out: Path, cpu: bool, train_file: Path, test_file: Path,
                   batch: int, tag: str) -> dict:
    argv = ER_ARGV + ["--fwt_batch_size", str(batch)]
    model, preds = out / f"{tag}.fwt", out / f"{tag}_test.out"
    train = cli(argv + ["--data", str(train_file), "-f", str(model),
                        "--save_resume"], cpu)
    test = cli(argv + ["-i", str(model), "-t", "--data", str(test_file),
                       "-p", str(preds)], cpu)
    p, labels = read_preds(preds), labels_of(test_file)
    require(len(p) == len(labels), f"{len(p)} predictions for {len(labels)} lines")
    return {"logloss": logloss(p, labels), "lines": len(labels),
            "train": train, "test": test,
            "launches_per_train_step": per_step(train, batch)}


def gate_er200k(out: Path, cpu: bool, work: Path) -> dict:
    """scripts/basic_gate.sh gate 3."""
    oracle = json.loads((EVIDENCE / "gate3_exact_online_200k.json").read_text())
    b1 = float(oracle["test_logloss_b1"])
    res = _er_train_test(out, cpu, data_path("er200k_train", work),
                         data_path("er200k_test", work), 16384, "er200k")
    res.update(bound=f"0.5 < logloss < {b1} + 0.02 (exact-online oracle, "
                     "docs/evidence/gate3_exact_online_200k.json)",
               oracle_b1=b1,
               passed=bool(0.5 < res["logloss"] < b1 + 0.02))
    return res


def gate_er10m(out: Path, cpu: bool, work: Path) -> dict:
    """scripts/basic_gate.sh gate 4, without its fallback to a persisted
    result."""
    res = _er_train_test(out, cpu, data_path("er10m_train", work),
                         data_path("er10m_test", work), 32768, "er10m")
    jax = json.loads((EVIDENCE / "eat_rate_10m.json").read_text())
    res.update(bound="0.55 < logloss <= 0.6420",
               jax_record_logloss=jax["eat_rate_10m_logloss"],
               gap_to_jax_record=res["logloss"] - jax["eat_rate_10m_logloss"],
               passed=bool(0.55 < res["logloss"] <= 0.6420))
    return res


def gate_multipass(out: Path, cpu: bool, work: Path) -> dict:
    """scripts/demo_100m.sh: ten ``-c`` passes, each from the last one's
    model, each with its holdout logloss beside the JAX record's. The
    first pass parses the text and records the record and pack caches
    (any left from an earlier run are removed first); the others replay
    the pack cache."""
    train, holdout = (data_path("multipass_train", work),
                      data_path("multipass_eval", work))
    for suffix in (".fwcache", ".fwpack"):
        Path(str(train) + suffix).unlink(missing_ok=True)
    argv = ER_ARGV + ["--fwt_batch_size", "32768"]
    labels = labels_of(holdout)
    jax = json.loads((EVIDENCE / "demo_100m.json").read_text())["passes"]
    passes, prev = [], None
    for i in range(1, PASSES + 1):
        model = out / f"m{i}.fwt"
        run = cli(argv + ["-c", "--data", str(train), "-f", str(model),
                          "--save_resume"] + (["-i", str(prev)] if prev else []),
                  cpu)
        preds = out / f"eval{i}.out"
        test = cli(argv + ["-i", str(model), "-t", "--data", str(holdout),
                           "-p", str(preds)], cpu)
        ll = logloss(read_preds(preds), labels)
        passes.append({"pass": i, "examples": run["rows"],
                       "train_s": run["elapsed_s"], "ex_s": run["ex_s"],
                       "wall_s": run["wall_s"], "holdout_logloss_200k": ll,
                       "jax_record_holdout_logloss": jax[i - 1]["holdout_logloss_200k"],
                       "test": test,
                       "launches_per_train_step": per_step(run, 32768)})
        print(f"multipass: pass {i}: {run['ex_s']:.0f} ex/s, holdout logloss "
              f"{ll:.6f} (JAX record {jax[i - 1]['holdout_logloss_200k']})",
              flush=True)
        if prev is not None and i > 2:
            prev.unlink()  # the last two models stay
        prev = model
    first, last = passes[0]["holdout_logloss_200k"], passes[-1]["holdout_logloss_200k"]
    non_divergent = bool(last <= first + 0.01)
    return {"passes": passes, "bound": "pass 10 <= pass 1 + 0.01",
            "non_divergent": non_divergent, "passed": non_divergent}


GATES = {"ffm": gate_ffm, "er200k": gate_er200k, "er10m": gate_er10m,
         "multipass": gate_multipass}


def run(gate: str, cpu: bool = False, work: Path | None = None) -> dict:
    """Run one gate (its data written first where missing) and write its
    result to ``work/<cuda|cpu>/<gate>.json``, ``work`` :data:`WORK` by
    default. Returns the result; ``passed`` says whether it met its
    bound."""
    work = work or WORK
    prepare((gate,), work)
    out = work / ("cpu" if cpu else "cuda") / gate
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res = GATES[gate](out, cpu, work)
    res.update(gate=gate, device=device_name(cpu), seconds=time.perf_counter() - t0)
    (out.parent / f"{gate}.json").write_text(json.dumps(res, indent=1))
    return res


def summary(res: dict) -> str:
    gate = res["gate"]
    if gate == "ffm":
        what = (f"balanced accuracy {res['balanced_accuracy']:.4f} (> 0.80), "
                f"inference == full on {res['inference_equals_full']}/"
                f"{res['lines']} lines, {res['unique_predictions']} distinct; "
                f"train {res['train']['ex_s']:.0f} ex/s")
    elif gate == "multipass":
        lls = [round(p["holdout_logloss_200k"], 4) for p in res["passes"]]
        what = f"holdout logloss by pass {lls} ({res['bound']})"
    else:
        what = (f"test logloss {res['logloss']:.6f} ({res['bound']}); train "
                f"{res['train']['ex_s']:.0f} ex/s, -t -i {res['test']['ex_s']:.0f} "
                f"lines/s")
    verdict = "PASSED" if res["passed"] else "FAILED"
    return f"gate {gate}: {verdict}: {what} [{res['device']}, {res['seconds']:.1f} s]"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fwumious_wabbit_tpu_torch.gates",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("gate", choices=[*GATES, *GROUPS])
    ap.add_argument("--cpu", action="store_true",
                    help="pass --fwt_platform cpu to every run")
    args = ap.parse_args(argv)
    gates = GROUPS.get(args.gate, (args.gate,))
    try:
        if not args.cpu:
            import torch

            require(torch.cuda.is_available(), "no CUDA card: the gates run on "
                    "the card (--cpu runs them on the CPU)")
        prepare(gates, WORK)
        ok = True
        for gate in gates:
            res = run(gate, args.cpu)
            print(summary(res), flush=True)
            ok = ok and res["passed"]
        return 0 if ok else 1
    except Exception as e:  # noqa: BLE001 — any failure fails the gate
        print(f"gates: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
