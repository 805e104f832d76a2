"""The reader of ``graph_pool_mib.train`` (``metrics/graph_pool_mib.train.py``)
on a made-up context: it reads the loop's ``graph_pool_bytes`` over the
untraced passes, and reads nothing where the program has no such counter."""

import pytest

from portbench import spec

NAME = "graph_pool_mib.train"


def ctx(passes=4, **counters):
    return {"window_s": 2.0, "passes": passes, "superbatches": 488,
            "counters": counters, "trace": {}, "least": {}}


@pytest.mark.parametrize("counters, want", [
    ({"graph_pool_bytes": 4 * 600 * 2**20, "graph_captures": 0}, 600.0),
    ({"graph_pool_bytes": 0, "graph_releases": 0}, 0.0),
])
def test_the_reader_reads_the_counter(counters, want):
    assert spec.metric_reader(NAME)(ctx(**counters)) == pytest.approx(want)


@pytest.mark.parametrize("context", [
    ctx(dispatch_s=1.6, graph_captures=40),
    ctx(passes=0, graph_pool_bytes=2**30),
], ids=["no_counter", "no_untraced_pass"])
def test_the_reader_reads_nothing_without_the_counter(context):
    """A program that keeps no such counter (a parent without the byte
    budget) gives no reading, and the reader does not raise."""
    assert spec.metric_reader(NAME)(context) is None


def test_the_entry_lists_every_cell():
    bench = spec.load_benchmark()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert entry["workloads"] == [w["name"] for w in bench["workloads"]]
    assert entry["source"] == "program_counter"
    assert entry["moves"] == "train_examples_per_s" and entry["better"] == "lower"
