"""The check sees a broken timed path: the program on the CPU at a tiny
size with one fault planted underneath each run, and ``correct`` must
come out false. The faults a training cell on one chip can have: a step
that leaves its state unchanged, half of each batch left out with the
mean taken over the rest, an answer altered where it is produced."""

import pytest
import torch

from fwumious_wabbit_tpu_torch.ops import adagrad
from fwumious_wabbit_tpu_torch.train import step as step_mod
from portbench import run
from portbench.tests import helpers


def unchanged(monkeypatch):
    monkeypatch.setattr(adagrad.ScopedOptimizer, "apply_rows",
                        lambda self, w, acc, *a, **k: (w, acc))
    monkeypatch.setattr(adagrad.ScopedOptimizer, "apply_dense",
                        lambda self, w, acc, *a, **k: (w, acc))


def half_batch(monkeypatch):
    forward = step_mod.forward

    def broken(*a, **k):
        x, p, dlogit, res = forward(*a, **k)
        h = dlogit.shape[0] // 2
        return x, p, torch.cat([2.0 * dlogit[:h], torch.zeros_like(dlogit[h:])]), res

    monkeypatch.setattr(step_mod, "forward", broken)


def altered_answer(monkeypatch):
    forward = step_mod.forward

    def broken(*a, **k):
        x, p, dlogit, res = forward(*a, **k)
        return x, torch.cat([1.0 - p[:1], p[1:]]), dlogit, res

    monkeypatch.setattr(step_mod, "forward", broken)


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered_answer])
@pytest.mark.parametrize("workload", helpers.WORKLOADS)
def test_a_broken_step_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    cell, out = helpers.execute(workload)
    correct, checks = run.judge(out, cell.limits)
    assert not correct, checks
