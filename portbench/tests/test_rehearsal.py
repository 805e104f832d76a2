"""Each cell's set-up, window and check, rehearsed on the CPU at a tiny
size through the same code the card runs."""

import pytest

from portbench import run
from portbench.tests import helpers


@pytest.mark.parametrize("workload", helpers.WORKLOADS)
def test_a_tiny_run_is_correct(workload):
    cell, out = helpers.execute(workload, trace=True)
    correct, checks = run.judge(out, cell.limits)
    assert correct, checks
    assert set(checks) == set(cell.limits)
    assert out["passes"] >= 2 and out["failed"] == 0
    names = set(out["metrics"])
    # the CPU has no device trace: only the counters' metrics read
    assert {"input_wait_share.train", "producer_busy_share.train",
            "dispatch_us_per_superbatch.train", "step_mfu.train"} <= names
    assert not any("roofline" in n for n in names)
    assert out["device"]["platform"] == "cpu"


def test_an_untraced_run_reports_the_end_to_end_metrics():
    cell, out = helpers.execute(helpers.WORKLOADS[0])
    assert set(out["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert out["metrics"]["train_examples_per_s"]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0


def test_main_refuses_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", helpers.WORKLOADS[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    captured = capsys.readouterr()
    assert rc == 2 and captured.out == "" and "CUDA" in captured.err
