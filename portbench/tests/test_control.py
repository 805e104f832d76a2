"""The control: the plain reference computed in bfloat16 (the precision
below the configurations' float32), put in the program's place, must
fail the check of every cell. Here on the CPU at a tiny size; on the card
at each cell's own size, on three seeds (``python -m pytest -m cuda
portbench/tests/test_control.py``), each seed a ``portbench.control``
process of its own, which prints the readings."""

import json
import subprocess
import sys

import pytest

from portbench import control, run, spec
from portbench.tests import helpers


def judge(cell, numbers):
    program = run.judge({"failed": 0, "numbers": numbers["program"]}, cell.limits)[0]
    fails = {kind: not run.judge({"failed": 0, "numbers": numbers[kind]}, cell.limits)[0]
             for kind in control.KINDS}
    return program, fails


@pytest.mark.parametrize("workload", helpers.WORKLOADS)
def test_the_control_fails_at_a_tiny_size(workload):
    import torch

    cell = helpers.tiny(workload)
    program, fails = judge(cell, control.readings(cell, 2 ** 31 + 3, torch.device("cpu"), 0.01))
    assert program
    assert fails["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", helpers.WORKLOADS)
def test_the_control_fails_at_the_cells_size(cuda_device, workload):
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        r = subprocess.run([sys.executable, "-m", "portbench.control", "--workload", workload,
                            "--seed", str(seed)], cwd=spec.ROOT, capture_output=True,
                           text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        program, fails = judge(spec.cell(workload), json.loads(r.stdout.splitlines()[-1]))
        assert program and all(fails.values()), (seed, fails)
