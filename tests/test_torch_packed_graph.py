"""The packed step's CUDA-graph policy (fwumious_wabbit_tpu_torch/train/packed.py
``_GraphedStep``, the counterpart of the JAX package's jitted ``lax.scan``)
on the CPU, through a stand-in for the capturer: the first superbatch of a
(layout, K) runs step by step, the second is captured and replayed, later
ones are replayed; a new layout or K captures anew; a tail runs step by
step; a model keeps every graph it captures while their pools hold less
than its byte budget, so a replay pass captures nothing anew, and a
capture at the budget releases the least recently replayed graph; a
failed capture or replay raises and the
superbatch is not run again step by step; the kernels' launch counters add each replay's
captured launches and nothing for the capture; a table rebound after the
capture raises. Through the CLI: the graph policy trains byte-identically
to the step-by-step path, and within the default path's bounds of the JAX
CLI (tests/test_torch_train_native.py); a failed capture exits 1 and names
the step."""

import json
import logging

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu_torch.models.model import FwModel
from fwumious_wabbit_tpu_torch.ops import ffm, sparse_update
from fwumious_wabbit_tpu_torch.synthetic import TOWER_FLAGS
from fwumious_wabbit_tpu_torch.train import packed
from fwumious_wabbit_tpu_torch.train.loop import main
from fwumious_wabbit_tpu_torch.train.producer import SuperbatchProducer

from test_torch_train_cli import assert_same_model
from test_torch_train_native import eat_rate_argv, run
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (  # noqa: F401 (jax_native_loaded: an autouse fixture)
    eat_rate_stream,
    jax_native_loaded,
)

CAPTURE_ERROR = "CUDA error: operation not permitted when stream is capturing"
REPLAY_ERROR = "CUDA error: an illegal memory access was encountered"


# the memory pool the stand-in capturer reports for every graph
POOL_BYTES = 1 << 20


class StandInCapturer:
    """Stands in for packed.CudaGraphCapturer on the CPU. ``capture`` runs
    nothing, as a capture launches nothing, but counts ``launches``
    (forward, backward, update) as the kernels' wrappers count what they
    capture, and reports a pool of ``pool_bytes``; each replay runs the
    captured function and writes its result into the output that
    ``capture`` returned. ``fail`` makes the capture or the replays raise a
    CUDA error."""

    def __init__(self, launches=(0, 0, 0), fail=None, pool_bytes=POOL_BYTES):
        self.launches, self.fail, self.pool_bytes = launches, fail, pool_bytes
        self.captures = self.replays = 0

    def capture(self, fn):
        if self.fail == "capture":
            raise RuntimeError(CAPTURE_ERROR)
        ffm.add_launches(*self.launches[:2])
        sparse_update.add_launches(self.launches[2])
        self.captures += 1
        out = torch.empty(0)

        def replay():
            if self.fail == "replay":
                raise RuntimeError(REPLAY_ERROR)
            res = fn()
            out.resize_(res.shape).copy_(res)
            self.replays += 1

        return replay, out, self.pool_bytes


def producer_items(tmp_path, K, B=64, rows=1100, tower=False):
    """``(mi, items)``: the producer's queue stream over the synthetic
    Eat-Rate file (bitpack and vocab on, host counts) as tensors: packed
    superbatches ``("p", buf [K', words] int32, layout)`` and vocabulary
    snapshots ``("v", snapshot)``."""
    _, argv, _ = eat_rate_stream(tmp_path, rows)
    data = tmp_path / f"train_{rows}.vw"
    args = build_parser().parse_args(argv + (TOWER_FLAGS if tower else [])
                                     + ["--data", str(data)])
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    mi = ModelInstance.from_cmdline(args, vw)
    spec = FwModel(mi).ffm_spec

    class Sink(list):
        put = list.append

    sink, state = Sink(), packed.VocabTransferState()
    SuperbatchProducer(
        args, mi, vw, batch_size=B, K=K, can_pack=True,
        count_keys={"lr": 0, "ffm": (spec.align - 1).bit_length()},
        cut_at=None, holdout_after=None, out_queue=sink,
        ctr={"producer_stall_s": 0.0},
        xfer_stats={"starve_s": 0.0, "xfer_s": 0.0, "put_s": 0.0, "bytes": 0},
        vocab_state=state).run()
    state.close()
    assert sink[-1] is None, sink[-1]
    items = []
    for item in sink[:-1]:
        if item[0] == "v":
            items.append(("v", torch.from_numpy(item[1])))
        else:
            assert item[0] == "p", item[0]
            items.append(("p", torch.from_numpy(item[1].view(np.int32)), item[2]))
    return mi, items


def fresh_model(mi) -> FwModel:
    model = FwModel(mi)
    return model.load_params(model.init_params("cpu"))


def drive(model, items, **kw):
    """Every superbatch of ``items`` through make_packed_train_step with
    the snapshot in force: the predictions of each."""
    vocab, preds = None, []
    for item in items:
        if item[0] == "v":
            vocab = item[1]
            continue
        _, buf, lay = item
        step = packed.make_packed_train_step(model, lay, buf.shape[0], **kw)
        preds.append(step(buf, *((vocab,) if lay.vocabs else ())).clone())
    return preds


def tensors(model) -> dict:
    out = {k: v for k, v in model.params().items() if k not in ("nn", "final")}
    for i, layer in enumerate(model.params().get("nn", [])):
        out.update({f"nn{i}.{k}": v for k, v in layer.items()})
    out.update({f"final.{k}": v for k, v in model.params().get("final", {}).items()})
    return {k: v.clone() for k, v in out.items()}


def assert_bit_identical(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def counts_of(model) -> dict:
    """The model's superbatch counts (packed.graph_counts without its
    seconds)."""
    return {k: v for k, v in packed.graph_counts(model).items()
            if not k.endswith("_s")}


def layout_groups(items):
    """``{(signature, K): count}`` of the stream's superbatches."""
    groups = {}
    for item in items:
        if item[0] == "p":
            key = (item[2].signature, item[1].shape[0])
            groups[key] = groups.get(key, 0) + 1
    return groups


@pytest.mark.parametrize("tower", [False, True], ids=["lr_ffm", "tower"])
def test_eager_then_capture_then_replay(tmp_path, tower):
    """Over a stream with a vocabulary re-signature and a tail, the graph
    policy gives the step-by-step path's predictions and tables bit for
    bit; each (layout, K) runs step by step once, is captured on its
    second superbatch, and every superbatch after its first is replayed."""
    mi, items = producer_items(tmp_path, K=3, tower=tower)
    groups = layout_groups(items)
    assert len({sig for sig, _K in groups}) >= 2  # a re-signature
    assert any(K < 3 for _sig, K in groups)  # a tail
    eager_model, graph_model = fresh_model(mi), fresh_model(mi)
    want = drive(eager_model, items, graph=False)
    cap = StandInCapturer()
    got = drive(graph_model, items, capturer=cap)
    assert len(got) == len(want) == sum(groups.values())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert_bit_identical(tensors(graph_model), tensors(eager_model))
    n = sum(groups.values())
    seen_twice = sum(1 for c in groups.values() if c >= 2)
    assert seen_twice >= 1
    assert counts_of(graph_model) == {
        "graph_captures": seen_twice, "graph_replays": n - len(groups),
        "eager_superbatches": len(groups)}
    assert cap.captures == seen_twice and cap.replays == n - len(groups)
    seconds = packed.graph_counts(graph_model)
    assert min(seconds["eager_s"], seconds["capture_s"], seconds["replay_s"]) > 0
    assert packed.graph_counts(eager_model)["replay_s"] == 0.0
    assert counts_of(eager_model) == {
        "graph_captures": 0, "graph_replays": 0, "eager_superbatches": n}


def test_cpu_steps_run_eager_without_a_capturer(tmp_path):
    """On the CPU there are no graphs: every superbatch runs step by step."""
    mi, items = producer_items(tmp_path, K=3)
    model = fresh_model(mi)
    drive(model, items)
    n = sum(layout_groups(items).values())
    assert counts_of(model) == {
        "graph_captures": 0, "graph_replays": 0, "eager_superbatches": n}


def first_layout(items, K):
    """``(vocab, buf, layout)`` of the first full superbatch, with the
    snapshot in force for it."""
    vocab = None
    for item in items:
        if item[0] == "v":
            vocab = item[1]
        elif item[1].shape[0] == K:
            return vocab, item[1], item[2]
    raise AssertionError("no full superbatch")


def test_a_new_layout_or_K_captures_anew(tmp_path):
    """Each (layout, K) has its own graph: another K of the same layout,
    and another layout, each run step by step first and capture on their
    own second superbatch. Under the default budget the model keeps all
    three graphs: the first (layout, K), when it comes back, replays."""
    mi, items = producer_items(tmp_path, K=3)
    vocab, buf, lay = first_layout(items, 3)
    other = next(i for i in items if i[0] == "p" and i[2].signature != lay.signature)
    model, cap = fresh_model(mi), StandInCapturer()
    calls = [(lay, buf), (lay, buf[:2]), (lay, buf), (lay, buf[:2]),
             (other[2], other[1]), (other[2], other[1]), (lay, buf)]
    counts = []
    for layout, b in calls:
        v = (vocab,) if layout.vocabs else ()
        step = packed.make_packed_train_step(model, layout, b.shape[0], capturer=cap)
        step(b, *v)
        counts.append(dict(counts_of(model)))
    assert [c["graph_captures"] for c in counts] == [0, 0, 1, 2, 2, 3, 3]
    assert [c["eager_superbatches"] for c in counts] == [1, 2, 2, 2, 3, 3, 3]
    assert [c["graph_replays"] for c in counts] == [0, 0, 1, 2, 2, 3, 4]
    assert packed.release_counts(model)["graph_releases"] == 0
    assert len(packed._live_graphs(model)) == 3


def in_force(items, signature):
    """``(vocab, buf, layout)`` of the first superbatch of ``signature``,
    with the snapshot in force for it."""
    vocab = None
    for item in items:
        if item[0] == "v":
            vocab = item[1]
        elif item[2].signature == signature:
            return vocab, item[1], item[2]
    raise AssertionError("no such layout")


def test_graphs_beyond_the_cap_are_released(tmp_path, monkeypatch):
    """Under a budget (packed._PACKED_GRAPH_BUDGET) that two graphs' pools
    fill, a model keeps at most two captured graphs: a capture beyond them
    releases the least recently replayed graph with its inputs, output and
    pool, and a released (layout, K) that comes back is captured anew and
    trains bit for bit as the step-by-step path does."""
    monkeypatch.setattr(packed, "_PACKED_GRAPH_BUDGET", 2 * POOL_BYTES)
    mi, items = producer_items(tmp_path, K=3)
    vocab, buf, lay = first_layout(items, 3)
    sig = next(i[2].signature for i in items
               if i[0] == "p" and i[2].signature != lay.signature)
    o_vocab, o_buf, o_lay = in_force(items, sig)
    calls = [(lay, buf, vocab)] * 2 + [(lay, buf[:2], vocab)] * 2 + \
        [(o_lay, o_buf, o_vocab)] * 2 + [(lay, buf, vocab)] * 2
    eager_model, model, cap = fresh_model(mi), fresh_model(mi), StandInCapturer()
    live = []
    for layout, b, v in calls:
        v = (v,) if layout.vocabs else ()
        K = b.shape[0]
        want = packed.make_packed_train_step(eager_model, layout, K, graph=False)(b, *v)
        step = packed.make_packed_train_step(model, layout, K, capturer=cap)
        assert torch.equal(step(b, *v), want)
        live.append([s.name for s in packed._live_graphs(model)])
    assert_bit_identical(tensors(model), tensors(eager_model))
    assert max(len(names) for names in live) == 2
    full, tail = (f"layout {lay.signature!r}, K={K}" for K in (3, 2))
    assert live[-1] == [f"layout {o_lay.signature!r}, K={o_buf.shape[0]}", full]
    released = packed.make_packed_train_step(model, lay, 2, capturer=cap)
    assert released.name == tail
    assert released.graph_replay is released.out is released.buf is None
    assert released.pool_bytes == 0
    assert counts_of(model) == {
        "graph_captures": 4, "graph_replays": 5, "eager_superbatches": 3}
    assert cap.captures == 4 and cap.replays == 5
    assert packed.release_counts(model)["graph_releases"] == 2
    assert packed.pool_bytes(model) == 2 * POOL_BYTES


def test_a_replay_pass_keeps_its_graphs(tmp_path):
    """Three (layout, K) taken in turns over three passes under the default
    budget, as a multi-pass run's replay passes bring them back: the first
    pass runs each step by step, the second captures each once, the third
    replays them all, and none is released; every prediction and table
    bit-identical to the step-by-step path's."""
    mi, items = producer_items(tmp_path, K=3)
    vocab, buf, lay = first_layout(items, 3)
    sig = next(i[2].signature for i in items
               if i[0] == "p" and i[2].signature != lay.signature)
    o_vocab, o_buf, o_lay = in_force(items, sig)
    one_pass = [(lay, buf, vocab), (lay, buf[:2], vocab), (o_lay, o_buf, o_vocab)]
    eager_model, model, cap = fresh_model(mi), fresh_model(mi), StandInCapturer()
    captures = []
    for _ in range(3):
        for layout, b, v in one_pass:
            v = (v,) if layout.vocabs else ()
            K = b.shape[0]
            want = packed.make_packed_train_step(eager_model, layout, K, graph=False)(b, *v)
            step = packed.make_packed_train_step(model, layout, K, capturer=cap)
            assert torch.equal(step(b, *v), want)
        captures.append(packed.graph_counts(model)["graph_captures"])
    assert_bit_identical(tensors(model), tensors(eager_model))
    assert captures == [0, 3, 3] and cap.captures == 3 and cap.replays == 6
    assert packed.release_counts(model)["graph_releases"] == 0
    assert len(packed._live_graphs(model)) == 3
    assert packed.pool_bytes(model) == 3 * POOL_BYTES


def test_a_tail_seen_once_runs_eager(tmp_path):
    """A short tail (K' < K) of a layout whose full superbatches replay is
    seen once, and runs step by step."""
    mi, items = producer_items(tmp_path, K=3)
    vocab, buf, lay = first_layout(items, 3)
    model, cap = fresh_model(mi), StandInCapturer()
    for b in (buf, buf, buf, buf[:1]):
        packed.make_packed_train_step(model, lay, b.shape[0], capturer=cap)(b, vocab)
    assert counts_of(model) == {
        "graph_captures": 1, "graph_replays": 2, "eager_superbatches": 2}


@pytest.mark.parametrize("where", ["capture", "replay"])
def test_a_failed_graph_raises_and_is_not_run_eagerly(tmp_path, where):
    """A capture or replay that fails raises GraphError naming the layout,
    K and the CUDA error; the superbatch is not run step by step instead:
    the tables stay as the first superbatch left them."""
    mi, items = producer_items(tmp_path, K=3)
    vocab, buf, lay = first_layout(items, 3)
    model, cap = fresh_model(mi), StandInCapturer(fail=where)
    step = packed.make_packed_train_step(model, lay, 3, capturer=cap)
    step(buf, vocab)
    after_first = tensors(model)
    with pytest.raises(packed.GraphError) as e:
        step(buf, vocab)
    msg = str(e.value)
    assert f"failed to {where}" in msg and "K=3" in msg
    assert repr(lay.signature) in msg
    assert (CAPTURE_ERROR if where == "capture" else REPLAY_ERROR) in msg
    assert_bit_identical(tensors(model), after_first)
    counts = counts_of(model)
    assert counts["eager_superbatches"] == 1 and counts["graph_replays"] == 0


def test_launch_counters_add_per_replay(tmp_path):
    """The wrappers' counts of the captured launches are taken back after
    the capture, which launches nothing, and each replay adds them: one
    packed step of K=3 reads forward 1, backward 1, update 2 per step."""
    mi, items = producer_items(tmp_path, K=3)
    vocab, buf, lay = first_layout(items, 3)
    model, cap = fresh_model(mi), StandInCapturer(launches=(3, 3, 6))

    def counts():
        return ffm.LAUNCHES, ffm.BWD_LAUNCHES, sparse_update.LAUNCHES

    step = packed.make_packed_train_step(model, lay, 3, capturer=cap)
    step(buf, vocab)  # step by step: on the CPU no wrapper counts
    before = counts()
    for n in range(1, 5):
        step(buf, vocab)
        assert tuple(a - b for a, b in zip(counts(), before)) == (3 * n, 3 * n, 6 * n)
    assert cap.captures == 1 and cap.replays == 4


@pytest.mark.parametrize("key", ["lr_w", "ffm_acc", "nn0.w"])
def test_a_rebound_table_raises(tmp_path, key):
    """The graph writes the tables at their capture-time addresses: after
    a table (or a tower tensor) is rebound, the next replay raises instead
    of writing freed memory."""
    mi, items = producer_items(tmp_path, K=3, tower=key.startswith("nn"))
    vocab, buf, lay = first_layout(items, 3)
    model = fresh_model(mi)
    step = packed.make_packed_train_step(model, lay, 3, capturer=StandInCapturer())
    step(buf, vocab)
    step(buf, vocab)  # captured
    if key.startswith("nn"):
        model.layers[0].w = model.layers[0].w.clone()
    else:
        setattr(model, key, getattr(model, key).clone())
    with pytest.raises(packed.GraphError, match="rebound"):
        step(buf, vocab)


def with_stand_in(monkeypatch, capturer):
    """The CLI's packed steps with ``capturer``: the graph policy on the
    CPU."""
    make = packed.make_packed_train_step

    def graphed(model, layout, K, graph=True, _capturer=None):
        return make(model, layout, K, graph, capturer)

    monkeypatch.setattr(packed, "make_packed_train_step", graphed)


# the Eat-Rate file's rows and the flags of each CLI case: enough
# superbatches that a (layout, K) repeats after the vocabulary settles
GRAPH_CASES = {
    "vocab_on": (2000, ["--fwt_superbatch", "2", "--fwt_vocab", "on"]),
    "fetch_stack": (2000, ["--fwt_superbatch", "2", "--fwt_fetch_stack", "4"]),
    "tail": (2011, ["--fwt_superbatch", "3"]),
    "holdout": (2000, ["--fwt_superbatch", "2", "--holdout_after", "1500",
                       "--predictions_after", "7"]),
}


@pytest.mark.parametrize("name", GRAPH_CASES)
def test_cli_graph_policy_trains_as_eager_and_as_jax(tmp_path, monkeypatch, name):
    """The port's CLI with the graph policy (the stand-in capturer) on the
    CPU: its -p and -f files byte-identical to the step-by-step run's,
    within the default path's bounds of the JAX CLI's, and its counters
    name the captures, replays and step-by-step superbatches."""
    rows, flags = GRAPH_CASES[name]
    argv = eat_rate_argv(tmp_path, rows) + flags
    jp, jf = run(jax_main, argv, tmp_path, "jax")
    ep, ef = run(main, argv, tmp_path, "eager", ["--fwt_platform", "cpu"])
    counters = tmp_path / "counters.json"
    monkeypatch.setenv("FWT_COUNTERS_OUT", str(counters))
    with_stand_in(monkeypatch, StandInCapturer())
    gp, gf = run(main, argv, tmp_path, "graph", ["--fwt_platform", "cpu"])
    assert (tmp_path / "graph.out").read_bytes() == (tmp_path / "eager.out").read_bytes()
    assert gf.read_bytes() == ef.read_bytes()
    np.testing.assert_allclose(gp, jp, rtol=0, atol=2e-6)
    assert_same_model(jf, gf)
    c = json.loads(counters.read_text())["counters"]
    assert c["graph_captures"] >= 1 and c["graph_replays"] >= 1
    assert c["eager_superbatches"] >= c["graph_captures"]


def test_cli_failed_capture_exits_1(tmp_path, monkeypatch, caplog):
    """A capture that fails ends the run with exit 1, the log naming the
    step and the CUDA error; no model file is written."""
    argv = eat_rate_argv(tmp_path) + ["--fwt_platform", "cpu", "--fwt_superbatch", "2"]
    cap = StandInCapturer(fail="capture")
    with_stand_in(monkeypatch, cap)
    f = tmp_path / "m.fwt"
    with caplog.at_level(logging.ERROR):
        rc = main(argv + ["-p", str(tmp_path / "p.out"), "-f", str(f), "--save_resume"])
    assert rc == 1 and not f.exists()
    msg = " ".join(r.getMessage() for r in caplog.records)
    assert "failed to capture" in msg and "K=2" in msg and CAPTURE_ERROR in msg
