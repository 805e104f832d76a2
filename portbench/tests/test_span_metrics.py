"""The readers of the program's spans and per-call counters
(``metrics/<name>.py``) on a made-up context: each reads its counters over
the untraced passes, and reads nothing where the program has no such
counter."""

import pytest

from portbench import spec


def ctx(**counters):
    return {"window_s": 2.0, "passes": 4, "superbatches": 488,
            "counters": counters, "trace": {}, "least": {}}


PASS = {"pass_open_s": 0.03, "consumer_starve_s": 0.06, "dispatch_s": 1.6,
        "writer_stall_s": 0.11, "pass_close_s": 0.05}


@pytest.mark.parametrize("name, counters, want", [
    ("graph_release_ms_per_pass.train", {"graph_release_s": 1.2, "graph_releases": 40}, 300.0),
    ("capture_ms_per_pass.train", {"capture_s": 0.96, "graph_captures": 40}, 240.0),
    ("pass_fixed_ms.train", PASS, 20.0),
    ("consumer_unspanned_share.train", PASS, 7.5),
])
def test_a_reader_reads_its_counters(name, counters, want):
    assert spec.metric_reader(name)(ctx(**counters)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["graph_release_ms_per_pass.train",
                                  "capture_ms_per_pass.train", "pass_fixed_ms.train",
                                  "consumer_unspanned_share.train"])
def test_a_program_without_the_counters_reads_nothing(name):
    """A program that keeps none of the counters (a parent without the
    spans) gives no reading, and the reader does not raise."""
    read = spec.metric_reader(name)
    assert read(ctx(dispatch_s=1.6, consumer_starve_s=0.06)) is None
    assert read({**ctx(**PASS, capture_s=1.0, graph_release_s=1.0),
                 "passes": 0, "window_s": 0.0}) is None


def test_the_entries_list_every_cell():
    bench = spec.load_benchmark()
    cells = [w["name"] for w in bench["workloads"]]
    new = {m["name"]: m for m in bench["per_layer"]
           if m["source"] == "program_span"}
    assert sorted(new) == sorted(["graph_release_ms_per_pass.train",
                                  "capture_ms_per_pass.train", "pass_fixed_ms.train",
                                  "consumer_unspanned_share.train"])
    for m in new.values():
        assert m["workloads"] == cells and m["moves"] == "train_examples_per_s"
