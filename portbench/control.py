"""The readings the check's limits are set from, on the card at a cell's
own size:

    python3 -m portbench.control --workload <name> --seed 11 [--program-only]

One seed a process, as in a benchmark run (a process of the program takes
a bounded number of ``run_train_loop`` calls; PERF.md). The passes of a
benchmark run (set-up's text pass and replay pass, a window of
``run_seconds`` and the replay pass after it, each checked pass with
``-p``), then the check's numbers for the program, and, unless
``--program-only``, for what the check must fail, each put in the
program's place from the program's own start: the control (the cell's
plain reference computed in bfloat16, the precision below the
configuration's float32) and the planted faults (its ``run_pass``'s
``half``, ``flip`` and ``unchanged``). The readings are the last line of
standard output, as JSON; each leaf's norms go to standard error. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import cell as cellmod
from . import run, spec


def bf16_in_place(ref, model, st, rows):
    low = ref.to_dtype(st, torch.bfloat16)
    preds = ref.run_pass(model, low, rows)
    for k in st:
        st[k].copy_(low[k].float())
    return preds


def fault(name):
    return lambda ref, model, st, rows: ref.run_pass(model, st, rows, fault=name)


def f64_in_place(ref, model, st, rows):
    high = {k: v.double() for k, v in st.items()}
    preds = ref.run_pass(model, high, rows)
    for k in st:
        st[k].copy_(high[k].float())
    return preds


KINDS = {"control": bf16_in_place, "half": fault("half"), "flip": fault("flip"),
         "unchanged": fault("unchanged")}
# a witness, not a control: the reference in float64 against itself in f32
WITNESS = {"f64": f64_in_place}


def readings(cell, seed: int, device, seconds: float, program_only: bool = False,
             witness: bool = False) -> dict:
    workdir = cellmod.make_workdir()
    try:
        r = cellmod.Run(cell, seed, device, workdir)
        r.setup(predict=cellmod.CHECKED)
        r.window(seconds)
        r.last_pass()
        r.free_program()
        rows = r.reference_rows()
        out = {"seed": seed, "program": r.check(rows)}
        detail = {"program": r.detail}
        kinds = dict(KINDS, **WITNESS) if witness else KINDS
        if not program_only:
            for kind, variant in kinds.items():
                r.detail = {}
                out[kind] = r.check(rows, variant)
                detail[kind] = r.detail
        print(json.dumps({"seed": seed, "detail": detail}), file=sys.stderr, flush=True)
        return out
    finally:
        cellmod.remove_workdir(workdir)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--program-only", action="store_true")
    p.add_argument("--witness", action="store_true",
                   help="also the reference in float64 in the program's place")
    p.add_argument("--lines", type=int, help="a shorter file, for a look only")
    a = p.parse_args(argv)
    run.environment()
    cell = spec.cell(a.workload)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if a.lines:
        cell.traffic["lines"] = a.lines
    r = readings(cell, a.seed, device, spec.load_benchmark()["run_seconds"],
                 a.program_only, a.witness)
    print(json.dumps(dict(r, workload=a.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
