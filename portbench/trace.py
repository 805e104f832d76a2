"""The traced pass: a ``torch.profiler`` window (CPU and CUDA) around one
whole replay pass, and what the benchmark reads from its timeline: the
device's busy time (the union of its kernels, copies and sets), each
kernel's device time by name, and what the host was doing in the device's
idle gaps. Spans come from the benchmark's own files
(``portbench.replay_pass`` around the call into the program)."""

from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
SPAN = "portbench.replay_pass"
TOP = 10


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, path: Path) -> dict:
    """``{window_s, busy_s, kernels: {name: [s, calls]}, device_ops,
    idle_gaps}`` of the traced pass; ``path`` receives the Chrome trace
    and is read back."""
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError(f"the profiler's trace holds no {SPAN} span")
    w0 = min(e["ts"] for e in spans)
    w1 = max(e["ts"] + e["dur"] for e in spans)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    kernels = defaultdict(lambda: [0.0, 0])
    for e in dev:
        kernels[e["name"]][0] += e["dur"] * 1e-6
        kernels[e["name"]][1] += 1
    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev
                   if e["ts"] < w1 and e["ts"] + e["dur"] > w0])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and e.get("name") != SPAN)
    by_host = defaultdict(float)
    active, i = [], 0
    for s, e in gaps:  # in time order: a sweep over the host ops
        mid = 0.5 * (s + e)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        name = min(active, key=lambda h: h[1] - h[0])[2] if active else "(no host op)"
        by_host[name] += (e - s) * 1e-6
    ops = sorted(((n, v[0]) for n, v in kernels.items()), key=lambda x: -x[1])
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernels": {n: list(v) for n, v in kernels.items()},
            "device_ops": [[n, s] for n, s in ops[:TOP]],
            "idle_gaps": [[n, s] for n, s in sorted(by_host.items(),
                                                    key=lambda x: -x[1])[:TOP]]}


def kernel_seconds(trace: dict, *names: str) -> tuple:
    """``(seconds, calls)`` of the kernels whose name holds one of
    ``names`` as a whole word."""
    pats = [re.compile(rf"\b{n}\b") for n in names]
    s = c = 0
    for name, (sec, calls) in trace["kernels"].items():
        if any(p.search(name) for p in pats):
            s += sec
            c += calls
    return s, c
