"""A/B of the per-batch train and predict steps on one CUDA card: an
earlier tree's CLI, whose per-batch steps launch their kernels one by one
from Python, against this tree's, which replays one CUDA graph per batch
signature. Each workload runs in turns — earlier, current, current,
earlier — as a process of its own through ``python -m
fwumious_wabbit_tpu_torch`` with ``-p``:

* ``testonly_200k``: ``-t -i`` of an LR+FFM k=8 model (synthetic.
  serving_argv, trained by this tree on chip_smoke.py's 10k file) over the
  first 200,000 lines of its 1,000,000-line file at B=1024, through the
  C++ ingest's batches one at a time;
* ``exact_2000``: ``--fwt_exact`` training of the LR+FFM model over the
  10k file's first 2,000 lines (B=1, a per-batch train step per line);
* ``delay_200k``: ``--prediction_model_delay 4096 --fwt_no_native`` over
  the 200,000 lines at B=1024 (predict, then the delayed train step, per
  batch; the Python ingest, since an earlier tree's default path fails on
  a delay over batches without value arrays);
* ``gate4_t``: Eat-Rate gate 4's ``-t`` (gates.py ``er10m``: the LR model
  at B=32,768) over its 10,000,000-line test file (seed 22), written by a
  child process that starts with the script, of a model of gate 4's flags
  that this tree trains on the 1M file first.

Each run: lines/s (or ex/s) from the CLI's Elapsed line and its in-run
counters (FWT_COUNTERS_OUT): the consumer's dispatch seconds, the
producer's busy and stall, the consumer's starve, the writer's fetch wait,
this tree's per-batch graph counters (graphs captured, batches replayed
and run step by step, and the host seconds of each), the process's
allocator peak (allocated and reserved, read the same way for both trees
when the CLI exits) and the kernels' launches; and whether its -p file is
byte-identical to the first earlier run's. A first run of each tree on the
10k file builds its kernels and host engine outside the timed runs.

The earlier tree is a copy of the port's package, e.g. commit 41c9b61's:

    mkdir -p .chip_proof/parent
    git archive 41c9b61 fwumious_wabbit_tpu_torch | tar -x -C .chip_proof/parent
    python3 scripts/step_graph_ab.py .chip_proof/parent

Writes .bench_cache/chip_smoke/graph_ab/step_graph_ab.json; exits 1 on a
failed run.
"""
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fwumious_wabbit_tpu_torch import gates, synthetic  # noqa: E402

DATA_DIR = ROOT / ".bench_cache" / "chip_smoke"
OUT_DIR = DATA_DIR / "graph_ab"
B1024 = ["--fwt_batch_size", "1024"]
GATE4_ROWS, GATE4_SEED = gates.ER_FILES["er10m_test"]
GATE4_DATA = DATA_DIR / "er10m_test.vw"
GATE4_ARGV = gates.ER_ARGV + ["--fwt_batch_size", "32768"]
# runs the CLI as ``python -m`` does and writes the process's allocator
# peak to $FWT_PEAK_OUT when it exits
CLI_WITH_PEAK = """
import atexit, json, os, runpy, torch
def peak():
    with open(os.environ["FWT_PEAK_OUT"], "w") as f:
        json.dump({"allocated": torch.cuda.max_memory_allocated(),
                   "reserved": torch.cuda.max_memory_reserved()}, f)
atexit.register(peak)
runpy.run_module("fwumious_wabbit_tpu_torch", run_name="__main__", alter_sys=True)
"""
COUNTERS = ("dispatch_s", "producer_busy_s", "producer_stall_s",
            "consumer_starve_s", "fetch_force_s") + tuple(
    f"{kind}_{k}" for kind in ("train", "predict") for k in (
        "graph_captures", "graph_replays", "eager_batches", "capture_s",
        "replay_s", "eager_s"))


def run(tree: Path, argv: list, tag: str) -> dict:
    """One CLI process of ``tree``: its rate, counters and -p file's hash."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    preds, counters = OUT_DIR / f"{tag}.out", OUT_DIR / f"{tag}.json"
    peak = OUT_DIR / f"{tag}_peak.json"
    env = dict(os.environ, FWT_COUNTERS_OUT=str(counters), PYTHONPATH=str(tree),
               FWT_PEAK_OUT=str(peak))
    proc = subprocess.run([sys.executable, "-c", CLI_WITH_PEAK,
                           *argv, "-p", str(preds)],
                          cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"{tag}: exited {proc.returncode}")
    m = re.search(r"Elapsed: .*\((\d+) ex/s\)", proc.stderr)
    if m is None:
        raise SystemExit(f"{tag}: no Elapsed line")
    res, peaks = json.loads(counters.read_text()), json.loads(peak.read_text())
    out = {"tree": str(tree), "rate": float(m.group(1)), "elapsed_s": res["elapsed"],
           "examples": res["examples"],
           "peak_device_bytes": peaks["allocated"],
           "peak_device_reserved_bytes": peaks["reserved"],
           "launches": res.get("launches"),
           "p_sha256": hashlib.sha256(preds.read_bytes()).hexdigest()}
    out.update({k: res["counters"][k] for k in COUNTERS if k in res["counters"]})
    preds.unlink()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    trees = {"earlier": Path(sys.argv[1]).resolve(), "current": ROOT}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    synthetic.write_namespace_map(DATA_DIR)
    writer = None if GATE4_DATA.exists() else subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from pathlib import Path; "
         "from fwumious_wabbit_tpu_torch import synthetic; "
         "synthetic.generate_dataset(Path(sys.argv[1]), int(sys.argv[2]), "
         "seed=int(sys.argv[3]))", str(GATE4_DATA), str(GATE4_ROWS),
         str(GATE4_SEED)], cwd=ROOT)
    try:
        results = ab(trees, card, writer)
    finally:
        if writer is not None and writer.poll() is None:
            writer.kill()
            writer.wait()
    (OUT_DIR / "step_graph_ab.json").write_text(json.dumps(results, indent=1))
    return 0


def head(path: Path, n: int) -> Path:
    out = path.with_name(f"step_graph_ab_head_{n}.vw")
    with open(path, "rb") as fh:
        out.write_bytes(b"".join(fh.readline() for _ in range(n)))
    return out


def ab(trees: dict, card: str, writer) -> dict:
    """Every workload in turns on both trees; ``writer`` is the process
    writing gate 4's test file (None when it is there)."""
    small = synthetic.ensure_dataset(DATA_DIR, 10_000)
    big = synthetic.ensure_dataset(DATA_DIR, 1_000_000)
    for name, tree in trees.items():  # builds each tree's kernels and engine
        run(tree, synthetic.serving_argv() + B1024 + ["--data", str(small)],
            f"warm_{name}")
    model = OUT_DIR / "lr_ffm.fwt"
    gate4_model = OUT_DIR / "gate4.fwt"
    run(ROOT, synthetic.serving_argv() + B1024 + [
        "--data", str(small), "-f", str(model), "--save_resume"], "train_lr_ffm")
    run(ROOT, GATE4_ARGV + ["--data", str(big), "-f", str(gate4_model),
                            "--save_resume"], "train_gate4")
    h200k, h2k = head(big, 200_000), head(small, 2_000)
    workloads = {
        "testonly_200k": ["-t", "-i", str(model), "--data", str(h200k)] + B1024,
        "exact_2000": synthetic.serving_argv() + ["--fwt_exact", "--data", str(h2k)],
        "delay_200k": synthetic.serving_argv() + B1024 + [
            "--prediction_model_delay", "4096", "--fwt_no_native", "--data", str(h200k)],
        "gate4_t": ["-t", "-i", str(gate4_model), "--fwt_batch_size", "32768",
                    "--data", str(GATE4_DATA)],
    }
    results = {"card": card, "runs": {}}
    for work, argv in workloads.items():
        if work == "gate4_t" and writer is not None:
            t0 = time.perf_counter()
            if writer.wait() != 0:
                raise SystemExit(f"writing {GATE4_DATA} failed")
            results["gate4_data_wait_s"] = time.perf_counter() - t0
        runs = []
        for i, name in enumerate(("earlier", "current", "current", "earlier")):
            r = run(trees[name], argv, f"{work}_{i}_{name}")
            r["which"] = name
            r["p_identical_to_first"] = r["p_sha256"] == (runs or [r])[0]["p_sha256"]
            runs.append(r)
            steps = {k: r.get(k) for k in COUNTERS[5:] if r.get(k)}
            print(f"{work} {name}: {r['rate']:.0f} per s over {r['examples']} "
                  f"examples, dispatch {r.get('dispatch_s', 0):.3f} s, producer "
                  f"busy {r.get('producer_busy_s', 0):.3f} s stall "
                  f"{r.get('producer_stall_s', 0):.3f} s, consumer starve "
                  f"{r.get('consumer_starve_s', 0):.3f} s, fetch wait "
                  f"{r.get('fetch_force_s', 0):.3f} s, per-batch graphs "
                  f"{json.dumps(steps)}, allocator peak {r['peak_device_bytes']} "
                  f"bytes allocated, {r['peak_device_reserved_bytes']} reserved, "
                  f"launches {json.dumps(r['launches'])}, -p identical to the "
                  f"first run's: {r['p_identical_to_first']}", flush=True)
        results["runs"][work] = runs
    print(f"  on {card}", flush=True)
    for p in (h200k, h2k, model, gate4_model):
        p.unlink()
    return results


if __name__ == "__main__":
    sys.exit(main())
