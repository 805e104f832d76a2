"""A/B of the default training path's packed step on one CUDA card: an
earlier tree's CLI, whose packed step runs its K train steps one by one
from Python, against this tree's, which replays one CUDA graph per
(layout, K). Each workload runs in turns — earlier, current, current,
earlier — as a process of its own through ``python -m
fwumious_wabbit_tpu_torch`` with ``-p``, the first three over
chip_smoke.py's 1,000,000-line Eat-Rate file at B=1024:

* ``lr_ffm``: the LR+FFM k=8 model (synthetic.serving_argv);
* ``tower``: the same tables with BASELINE config 3's tower
  (synthetic.tower_argv);
* ``pack_cache_replay``: the LR+FFM model with ``--fwt_pack_cache on``,
  replaying a pack cache this tree recorded first (the same bytes for
  both trees);
* ``gate4``: Eat-Rate gate 4's training run (gates.py ``er10m``: the LR
  model at B=32,768) over its 10,000,000-line train file (seed 21),
  written by a child process that starts with the script.

Each run: ex/s from the CLI's Elapsed line and its in-run counters
(FWT_COUNTERS_OUT): the consumer's dispatch seconds, per superbatch (the
superbatch count from this tree's graph counters: both trees pack the same
stream), the producer's busy and stall, the consumer's starve, the
writer's fetch wait, this tree's graph counters (graphs captured,
superbatches replayed and run step by step, and the host seconds of
each), the process's allocator peak (allocated and reserved, read the
same way for both trees when the CLI exits) and the kernels' launches;
and whether its -p file is byte-identical to the first earlier run's. A
first run of each tree on chip_smoke.py's 10k file builds its kernels and
host engine outside the timed runs.

The earlier tree is a copy of the port's package, e.g. commit 4b61527's:

    mkdir -p .chip_proof/parent
    git archive 4b61527 fwumious_wabbit_tpu_torch | tar -x -C .chip_proof/parent
    python3 scripts/packed_graph_ab.py .chip_proof/parent

Writes .bench_cache/chip_smoke/graph_ab/packed_graph_ab.json; exits 1 on a
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
LINES = 1_000_000
B1024 = ["--fwt_batch_size", "1024"]
GATE4_ROWS, GATE4_SEED = gates.ER_FILES["er10m_train"]
GATE4_DATA = DATA_DIR / "er10m_train.vw"
# (flags, data) of each workload; None is the 1M-line file
WORKLOADS = {
    "lr_ffm": (synthetic.serving_argv() + B1024, None),
    "tower": (synthetic.tower_argv() + B1024, None),
    "pack_cache_replay": (synthetic.serving_argv() + B1024
                          + ["--fwt_pack_cache", "on"], None),
    "gate4": (gates.ER_ARGV + ["--fwt_batch_size", "32768"], GATE4_DATA),
}
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
            "consumer_starve_s", "fetch_force_s", "graph_captures",
            "graph_replays", "eager_superbatches", "capture_s", "replay_s",
            "eager_s")


def run(tree: Path, argv: list, tag: str) -> dict:
    """One CLI process of ``tree``: its ex/s, counters and -p file's hash."""
    out_dir = DATA_DIR / "graph_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    preds, counters = out_dir / f"{tag}.out", out_dir / f"{tag}.json"
    peak = out_dir / f"{tag}_peak.json"
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
    out = {"tree": str(tree), "ex_s": float(m.group(1)), "elapsed_s": res["elapsed"],
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
    earlier = Path(sys.argv[1]).resolve()
    trees = {"earlier": earlier, "current": ROOT}
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
    (DATA_DIR / "graph_ab" / "packed_graph_ab.json").write_text(
        json.dumps(results, indent=1))
    return 0


def ab(trees: dict, card: str, writer) -> dict:
    """Every workload in turns on both trees; ``writer`` is the process
    writing gate 4's file (None when it is there)."""
    small = synthetic.ensure_dataset(DATA_DIR, 10_000)
    big = synthetic.ensure_dataset(DATA_DIR, LINES)
    for name, tree in trees.items():  # builds each tree's kernels and engine
        run(tree, synthetic.serving_argv() + B1024 + ["--data", str(small)],
            f"warm_{name}")
    from fwumious_wabbit_tpu_torch.train import pack_cache

    Path(pack_cache.pack_cache_path_for(big)).unlink(missing_ok=True)
    record = run(ROOT, WORKLOADS["pack_cache_replay"][0] + ["--data", str(big)],
                 "record")
    results = {"card": card, "lines": LINES, "record": record, "runs": {}}
    for work, (argv, data) in WORKLOADS.items():
        if data is None:
            data = big
        elif writer is not None:
            t0 = time.perf_counter()
            if writer.wait() != 0:
                raise SystemExit(f"writing {data} failed")
            results["gate4_data_wait_s"] = time.perf_counter() - t0
        runs = []
        for i, name in enumerate(("earlier", "current", "current", "earlier")):
            r = run(trees[name], argv + ["--data", str(data)], f"{work}_{i}_{name}")
            r["which"] = name
            runs.append(r)
        n_sb = runs[1]["graph_replays"] + runs[1]["eager_superbatches"]
        for r in runs:
            r["superbatches"] = n_sb
            r["dispatch_us_per_superbatch"] = r["dispatch_s"] / n_sb * 1e6
            r["p_identical_to_first"] = r["p_sha256"] == runs[0]["p_sha256"]
            if r.get("graph_replays"):
                r["replay_us_per_superbatch"] = r["replay_s"] / r["graph_replays"] * 1e6
                r["eager_us_per_superbatch"] = r["eager_s"] / r["eager_superbatches"] * 1e6
            print(f"{work} {r['which']}: {r['ex_s']:.0f} ex/s, dispatch "
                  f"{r['dispatch_us_per_superbatch']:.1f} us per superbatch, "
                  f"producer busy {r['producer_busy_s']:.3f} s stall "
                  f"{r['producer_stall_s']:.3f} s, consumer starve "
                  f"{r['consumer_starve_s']:.3f} s, fetch wait "
                  f"{r['fetch_force_s']:.3f} s, graphs "
                  f"{r.get('graph_captures')}/{r.get('graph_replays')}/"
                  f"{r.get('eager_superbatches')} (host us per replay "
                  f"{r.get('replay_us_per_superbatch')}, per step-by-step "
                  f"superbatch {r.get('eager_us_per_superbatch')}, captures "
                  f"{r.get('capture_s')} s), allocator peak "
                  f"{r['peak_device_bytes']} bytes allocated, "
                  f"{r['peak_device_reserved_bytes']} reserved, -p identical to the first "
                  f"run's: {r['p_identical_to_first']}", flush=True)
        results["runs"][work] = runs
    print(f"  on {card}", flush=True)
    Path(pack_cache.pack_cache_path_for(big)).unlink(missing_ok=True)
    return results


if __name__ == "__main__":
    sys.exit(main())
