"""Tiny CPU runs of a cell: its own configuration, fewer lines, the
program on the CPU."""

from __future__ import annotations

import torch

from portbench import run, spec

# by the traffic's batch: (batch, lines): nine batches and a partial one,
# so a run packs a full superbatch, a short tail and a per-batch step;
# B=32,768 runs at 4,096 here, the CPU's share
SIZES = {1024: (1024, 9 * 1024 + 100), 32768: (4096, 9 * 4096 + 300)}


def tiny(workload: str) -> spec.Cell:
    c = spec.cell(workload)  # its files read anew: a copy of its own
    batch, lines = SIZES[int(c.traffic["batch"])]
    c.traffic.update(lines=lines, batch=batch,
                     argv=["--fwt_batch_size", str(batch), "--fwt_superbatch",
                           str(c.traffic["superbatch"]), "--fwt_platform", "cpu"])
    return c


def execute(workload: str, seed: int = 2 ** 31 + 7, trace: bool = False) -> tuple:
    c = tiny(workload)
    out = run.execute(c, seed, 0.01, trace, torch.device("cpu"))
    return c, out


WORKLOADS = [w["name"] for w in spec.load_benchmark()["workloads"]]
