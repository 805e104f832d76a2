"""The port's spans and per-call counters (fwumious_wabbit_tpu_torch/
utils/spans.py, train/loop.py, train/step.py, train/producer.py) on the
CPU, the packed step's graphs through the stand-in capturer of
tests/test_torch_packed_graph.py: a span always feeds its counter and
opens a ``record_function`` range only while a profiler records; a
traced ``run_train_loop`` call exports the consumer's spans, the graph
spans nested in their dispatch; ``graph_releases`` counts one call's
releases, none under the default budget, which a replay call fills with
no capture; the consumer's counted spans fit inside the call;
``--fwt_profile`` records the stage threads' spans too."""

import json
import queue
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from fwumious_wabbit_tpu_torch import native
from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu_torch.models.model import FwModel
from fwumious_wabbit_tpu_torch.train import packed, producer
from fwumious_wabbit_tpu_torch.train.loop import main, run_train_loop
from fwumious_wabbit_tpu_torch.utils.spans import span, spanned

from test_torch_packed_graph import POOL_BYTES, StandInCapturer, with_stand_in
from torch_parity import eat_rate_stream
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

# the consumer's spans that every replay call opens under a budget of one
# graph's pool
CONSUMER_SPANS = ("fwt.pass.open", "fwt.consumer.wait_input", "fwt.dispatch.packed",
                  "fwt.graph.capture", "fwt.graph.replay", "fwt.graph.release",
                  "fwt.consumer.fetch", "fwt.pass.close")
# the counters the consumer's spans feed, disjoint in time
CONSUMER_COUNTERS = ("pass_open_s", "consumer_starve_s", "dispatch_s",
                     "writer_stall_s", "pass_close_s")


def events(prof, path) -> list:
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def test_a_span_counts_and_opens_no_range_without_a_profiler(monkeypatch):
    """With no profiler recording, a span enters no ``record_function``
    and still adds its seconds to its counter; closed twice, it counts
    once."""

    def refuse(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    counts = {"x_s": 0.0}
    with span("fwt.test.off", counts, "x_s") as s:
        time.sleep(0.002)
    s.close()
    assert counts["x_s"] == s.seconds >= 0.002
    with span("fwt.test.uncounted"):
        pass
    assert list(spanned("fwt.test.items", range(3))) == [0, 1, 2]


def test_a_span_is_a_range_under_the_profiler(tmp_path):
    """Under the profiler a span is a range of its name, on the clock of
    the trace's other events, and ``spanned`` opens one per item."""
    counts = {"x_s": 0.0}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("fwt.test.on", counts, "x_s"):
            torch.ones(4).sum()
        assert list(spanned("fwt.test.item", "ab")) == ["a", "b"]
    ev = events(prof, tmp_path / "t.json")
    (on,) = [e for e in ev if e["name"] == "fwt.test.on"]
    assert sum(e["name"] == "fwt.test.item" for e in ev) == 3  # and the end
    inner = [e for e in ev if e["name"] == "aten::sum"]
    assert inner and on["ts"] <= inner[0]["ts"] <= on["ts"] + on["dur"]
    assert counts["x_s"] > 0


@pytest.fixture
def replays(tmp_path, monkeypatch):
    """``call() -> (result, wall seconds)``: one replay call of
    ``run_train_loop`` (``-p`` on) over the pack cache of a 700-line
    Eat-Rate file at B=64, K=2, recorded by a first call on the same
    model, with the packed graphs of the stand-in capturer. Each pass
    meets more (layout, K) than one."""
    _, argv, _ = eat_rate_stream(tmp_path, 700)
    data = tmp_path / "train_700.vw"
    argv = argv + ["--data", str(data), "--fwt_batch_size", "64",
                   "--fwt_superbatch", "2", "--fwt_platform", "cpu",
                   "--fwt_pack_cache", "on", "-p", str(tmp_path / "p.out")]
    native.require()
    args = build_parser().parse_args(argv)
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    mi = ModelInstance.from_cmdline(args, vw)
    model = FwModel(mi)
    model.load_params(model.init_params("cpu"))
    with_stand_in(monkeypatch, StandInCapturer())

    def call():
        t0 = time.perf_counter()
        r = run_train_loop(build_parser().parse_args(argv), mi, vw, model)
        return r, time.perf_counter() - t0

    call()  # the text pass records the pack cache
    call.model = model
    return call


def test_a_traced_call_holds_the_consumer_spans(replays, tmp_path, monkeypatch):
    """A replay call under the profiler, started on the calling thread (the
    consumer), under a budget that one graph's pool fills: its trace holds
    the consumer's spans, each capture, replay and release nested in a
    packed dispatch on the same thread."""
    monkeypatch.setattr(packed, "_PACKED_GRAPH_BUDGET", POOL_BYTES)
    replays()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        replays()
    ev = events(prof, tmp_path / "trace.json")
    names = {e["name"] for e in ev}
    assert set(CONSUMER_SPANS) <= names, set(CONSUMER_SPANS) - names
    dispatches = [e for e in ev if e["name"] == "fwt.dispatch.packed"]
    assert dispatches
    for e in ev:
        if e["name"] in ("fwt.graph.capture", "fwt.graph.replay", "fwt.graph.release"):
            assert any(d["tid"] == e["tid"] and d["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= d["ts"] + d["dur"] + 1
                       for d in dispatches), e
    (opened,) = [e for e in ev if e["name"] == "fwt.pass.open"]
    first_wait = min(e["ts"] for e in ev if e["name"] == "fwt.consumer.wait_input")
    assert opened["ts"] + opened["dur"] <= first_wait + 1


@pytest.mark.parametrize("budget", [None, POOL_BYTES], ids=["default", "one_graph"])
def test_graph_releases_count_one_call(replays, monkeypatch, budget):
    """Of three identical replay calls on one model, the second and the
    third capture and release as many graphs: none under the default
    budget, whose graphs the first replay call completes, and more than
    none under a budget that one graph's pool fills. The counter counts
    the call's releases while the model's count grows, and
    ``graph_pool_bytes`` what the live graphs' pools hold at the call's
    end."""
    if budget is not None:
        monkeypatch.setattr(packed, "_PACKED_GRAPH_BUDGET", budget)
    before = dict(packed.release_counts(replays.model))
    got, captures = [], []
    for _ in range(3):
        got.append(replays()[0]["counters"])
        captures.append(packed.graph_counts(replays.model)["graph_captures"])
    n = [c["graph_releases"] for c in got]
    assert n[1] == n[2], n
    assert captures[2] - captures[1] == captures[1] - captures[0]
    if budget is None:
        assert n[1] == 0 and captures[2] == captures[1], (n, captures)
        assert all(c["graph_release_s"] == 0 for c in got)
        live = len(packed._live_graphs(replays.model))
        assert live > 2 and got[2]["graph_pool_bytes"] == live * POOL_BYTES
    else:
        assert n[1] > 0 and captures[2] > captures[1], (n, captures)
        assert all(c["graph_release_s"] > 0 for c in got)
        assert got[2]["graph_pool_bytes"] == POOL_BYTES
    assert packed.release_counts(replays.model)["graph_releases"] == (
        before["graph_releases"] + sum(n))


def test_the_consumer_spans_fit_in_the_call(replays):
    """The consumer's counted spans are disjoint, so their sum stays
    within the call's wall time taken around it."""
    for _ in range(2):
        r, wall = replays()
        c = r["counters"]
        assert all(c[k] > 0 for k in ("pass_open_s", "dispatch_s", "pass_close_s"))
        assert sum(c[k] for k in CONSUMER_COUNTERS) <= wall


def test_the_transfer_spans_feed_its_counters_and_stats():
    """The transfer stage's spans feed the loop's counters and
    ``xfer_stats`` (the vocabulary encoder's input) the same seconds."""
    q, q2 = queue.Queue(), queue.Queue()
    for i in range(3):
        q.put(("p", np.full((2, 40), i, np.uint32), "layout", 128))
    q.put(None)
    ctr = {k: 0.0 for k in ("xfer_starve_s", "xfer_busy_s", "xfer_stall_s")}
    ctr.update(xfer_bytes=0, xfer_puts=0)
    stats = {"starve_s": 0.0, "xfer_s": 0.0, "put_s": 0.0, "bytes": 0}
    producer.run_transferrer(q, q2, ctr, stats, "cpu")
    assert (stats["starve_s"], stats["xfer_s"], stats["put_s"]) == (
        ctr["xfer_starve_s"], ctr["xfer_busy_s"], ctr["xfer_stall_s"])
    assert ctr["xfer_busy_s"] > 0 and ctr["xfer_puts"] == 3
    assert stats["bytes"] == ctr["xfer_bytes"] == 3 * 2 * 40 * 4


def test_fwt_profile_records_the_stage_threads(tmp_path):
    """``--fwt_profile`` records every thread: the writer's and transfer
    thread's spans appear beside the consumer's."""
    _, argv, _ = eat_rate_stream(tmp_path, 1100)
    prof = tmp_path / "prof"
    argv = argv + ["--data", str(tmp_path / "train_1100.vw"), "--fwt_batch_size", "32",
                   "--fwt_superbatch", "2", "--fwt_platform", "cpu",
                   "-p", str(tmp_path / "p.out"), "--fwt_profile", str(prof)]
    assert main(argv) == 0
    (trace,) = prof.iterdir()
    ev = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    tids = {}
    for e in ev:
        if e["name"].startswith("fwt."):
            tids.setdefault(e["name"].split(".")[1], set()).add(e["tid"])
    assert {"dispatch", "writer", "xfer"} <= set(tids), tids
    assert len(tids["dispatch"] | tids["writer"] | tids["xfer"]) == 3
