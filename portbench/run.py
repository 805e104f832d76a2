"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program. Set-up (``setup_s``,
from the process's start until the window opens, less the check's
snapshots): the seeded data, the model, the text pass that records the
pack stream and the first replay pass. The window: replay passes, each
one ``run_train_loop`` call on the same model, until ``--seconds`` have
passed; ``train_examples_per_s`` is every example of every pass over the
whole window. With ``--trace 1`` the window's second pass runs under the
profiler and the line carries the cell's per-layer metrics instead.
After the window: the card's peak memory, one more replay pass that the
check follows, the program freed, the output check against the plain
reference. The last line of standard output is the result; the numbers
compared, each beside its limit, close standard error and the result.

Exits 2, printing no result, without a CUDA card (or with fewer than the
cell asks for), 3 when ``jax``, ``jaxlib``, ``flax``, the JAX package or
``bench`` was imported, and 1 on any other failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T_IMPORT = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# whole top-level module names: the port's own name begins with the JAX
# package's
FORBIDDEN = ("jax", "jaxlib", "flax", "fwumious_wabbit_tpu", "bench")
# the loop's counters that count over the model's life, not one call's
MODEL_COUNTERS = ("graph_captures", "graph_replays", "eager_superbatches",
                  "capture_s", "replay_s", "eager_s")


class _Blocker:
    """A meta-path finder that refuses the forbidden top-level modules."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"portbench: {name} may not be imported")
        return None


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def since_start() -> float:
    """Seconds since this process started (``/proc``), or since this
    module was imported where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def environment() -> None:
    """Caches at fixed paths inside the checkout; the program's logging at
    warnings."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("LOG_LEVEL", "WARNING")
    sys.meta_path.insert(0, _Blocker())


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _metric(value, unit):
    return {"value": value, "unit": unit}


def execute(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set-up, window, check; the result's fields and the check's numbers."""
    import torch

    from . import cell as cellmod
    from . import roofline, spec
    from . import trace as tracemod

    workdir = cellmod.make_workdir()
    try:
        run = cellmod.Run(cell, seed, device, workdir)
        run.setup()
        setup_snap_s = run.snap_s
        setup_s = since_start() - setup_snap_s
        tracer = tracemod.profiler() if trace else None
        win = run.window(seconds, profile_pass=1 if trace else None, tracer=tracer)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        summary = (tracemod.summarize(tracer, workdir / "trace.json")
                   if trace else None)
        results, base = win["results"], run.counters[len(run.counters) - len(win["results"]) - 1]
        t_last = time.perf_counter()
        last = run.last_pass()
        t_last = time.perf_counter() - t_last
        run.free_program()
        t_check = time.perf_counter()
        rows = run.reference_rows()
        numbers = run.check(rows)
        print(f"portbench: set-up {setup_s:.3f} s (snapshots {setup_snap_s:.3f} s apart); "
              f"window {win['window_s']:.3f} s, {len(win['passes'])} passes, "
              f"{win['examples']} examples; pass after it {t_last:.3f} s; "
              f"check {time.perf_counter() - t_check:.3f} s; "
              f"peak {peak} B", file=sys.stderr)
        print("portbench: set-up phases " + ", ".join(
            f"{k} {v:.3f} s" for k, v in run.phases.items()), file=sys.stderr)
        prev = base["counters"]
        for (p0, p1, n), r in zip(win["passes"], results):
            c = r["counters"]
            print(f"portbench: pass {p1 - p0:.3f} s, "
                  f"captures {c.get('graph_captures', 0) - prev.get('graph_captures', 0)} "
                  f"in {c.get('capture_s', 0) - prev.get('capture_s', 0):.3f} s, "
                  f"replay {c.get('replay_s', 0) - prev.get('replay_s', 0):.3f} s, "
                  f"dispatch {c.get('dispatch_s', 0):.3f} s, "
                  f"starve {c.get('consumer_starve_s', 0):.3f} s, "
                  f"producer {c.get('producer_busy_s', 0):.3f} s", file=sys.stderr)
            prev = c
        lines = cell.traffic["lines"]
        counts = [n for _, _, n in win["passes"]] + [last["examples"]]
        failed = sum(n != lines for n in counts)
        out = {"passes": len(counts), "failed": failed, "numbers": numbers,
               "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                          "kind": (torch.cuda.get_device_name(device)
                                   if device.type == "cuda" else "cpu"),
                          "count": 1, "memory_peak_bytes": int(peak)}}
        captures = (results[-1]["counters"].get("graph_captures", 0)
                    - base["counters"].get("graph_captures", 0))
        if captures:
            print(f"portbench: {captures} graph capture(s) inside the window",
                  file=sys.stderr)
        if not trace:
            out["metrics"] = {
                "train_examples_per_s": _metric(win["examples"] / win["window_s"], "examples/s"),
                "setup_s": _metric(setup_s, "s")}
            return out
        # per-layer: counters over the untraced passes, the profile of the
        # traced one
        ctr, prev = {}, base["counters"]
        untraced_s = 0.0
        for i, (r, (p0, p1, _)) in enumerate(zip(results, win["passes"])):
            c = r["counters"]
            # the packed graphs' counters run on over the model's life: a
            # pass's own are the differences
            own = {k: v - prev.get(k, 0) if k in MODEL_COUNTERS else v
                   for k, v in c.items()
                   if isinstance(v, (int, float)) and not isinstance(v, bool)}
            prev = c
            if i == win["traced_pass"]:
                continue
            untraced_s += p1 - p0
            for k, v in own.items():
                ctr[k] = ctr.get(k, 0) + v
        sb = ctr.get("graph_replays", 0) + ctr.get("eager_superbatches", 0)
        summary["passes"] = 1
        ctx = {"window_s": untraced_s, "passes": len(results) - 1, "counters": ctr,
               "superbatches": sb, "trace": summary,
               "least": roofline.least_per_pass(rows, cell.config["model"], cell.reference)}
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = _metric(v, m["unit"])
        out["metrics"] = metrics
        out["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
        return out
    finally:
        cellmod.remove_workdir(workdir)


def judge(out: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every pass of the window and the one after it
    complete, and every number the cell's limits name at or under its
    limit."""
    checks = {k: {"value": out["numbers"][k], "limit": v} for k, v in limits.items()}
    correct = (out["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return correct, checks


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    import torch

    from . import spec

    try:
        cell = spec.cell(args.workload)
    except (KeyError, OSError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_loaded()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    nums = out["numbers"]
    correct, checks = judge(out, cell.limits)
    for k in sorted(set(nums) - set(checks)):
        print(f"reading {k} {nums[k]!r} (not compared in this cell)", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=sys.stderr)
    result = {"correct": correct, "attempted": out["passes"], "failed": out["failed"],
              "metrics": out["metrics"], "device": out["device"]}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
