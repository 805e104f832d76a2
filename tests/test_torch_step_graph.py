"""The per-batch train and predict steps' CUDA-graph policy
(fwumious_wabbit_tpu_torch/train/step.py ``BatchStep``, the counterparts of
the JAX package's jitted ``make_train_step`` and ``make_predict_step``) on
the CPU, through a stand-in for the capturer: the first batch of a
signature runs step by step, the second is captured and replayed, later
ones are replayed; a new width, a partial batch or another key set
captures anew; a capture beyond the graphs a step keeps releases the least
recently replayed one; a failed capture or replay raises and the batch is
not run again step by step; the kernels' launch counters add each replay's
captured launches; a table rebound after the capture raises. Through the
CLI (``-t -i``, ``--fwt_no_native``, ``--prediction_model_delay``,
``--holdout_after``, ``--fwt_exact``): the graph policy writes ``-p`` and
model files byte-identical to the step-by-step run's, within the bounds of
tests/test_torch_train_cli.py of the JAX CLI's, and a failed capture exits
1 naming the step. The daemon's ``SharedPredictor`` under 8 predicting
threads and a swapper: every reply the step-by-step reply of one snapshot,
a swapped-out model's graphs released after its last prediction."""

import json
import logging
import random
import threading

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch.config import vwmap as port_vwmap
from fwumious_wabbit_tpu_torch.ingest import Batcher, FeatureTranslator, VowpalParser
from fwumious_wabbit_tpu_torch.models.model import FwModel
from fwumious_wabbit_tpu_torch.ops import ffm, sparse_update
from fwumious_wabbit_tpu_torch.persistence import model_file
from fwumious_wabbit_tpu_torch.serve import server
from fwumious_wabbit_tpu_torch.synthetic import TOWER_FLAGS
from fwumious_wabbit_tpu_torch.train import step as st
from fwumious_wabbit_tpu_torch.train.loop import main, np_counts

from test_torch_packed_graph import (
    CAPTURE_ERROR,
    REPLAY_ERROR,
    StandInCapturer,
    with_stand_in,
)
from test_torch_train_cli import assert_same_model
from test_torch_train_native import eat_rate_argv, run, small_argv
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (  # noqa: F401 (jax_native_loaded: an autouse fixture)
    FFM_ARGV,
    VW_CSV,
    jax_native_loaded,
    make_vw,
    port_config,
    vw_lines,
)


def fresh_model(mi) -> FwModel:
    model = FwModel(mi)
    return model.load_params(model.init_params("cpu"))


def port_vw():
    return port_vwmap.VwNamespaceMap.from_string(VW_CSV)


def train_dicts(mi, n=160, seed=0, batch_size=16) -> list:
    """The port's Python-ingest train batches of ``n`` lines of variable
    width (1–3 features per namespace: the batcher's width buckets vary),
    with the loop's host counts."""
    parser, ft = VowpalParser(port_vw()), FeatureTranslator(mi)
    tes = [ft.translate(parser.parse_line(line)) for line in vw_lines(n, seed)]
    shift = (FwModel(mi).ffm_spec.align - 1).bit_length()
    out = []
    for i in range(0, n, batch_size):
        b = Batcher(batch_size).make_batch(tes[i:i + batch_size])
        bd = st.train_batch_dict(b)
        bd["lr_counts"] = np_counts(b.lr_ids, b.lr_vals, 0)
        bd["ffm_counts"] = np_counts(b.ffm_ids, b.ffm_vals, shift)
        out.append(bd)
    return out


def signatures(dicts, keys) -> list:
    return [st.signature({k: st._as_tensor(d[k]) for k in keys if d.get(k) is not None})
            for d in dicts]


def make(kind, model, **kw):
    return (st.make_train_step if kind == "train" else st.make_predict_step)(model, **kw)


def keys_of(kind) -> tuple:
    return st.TRAIN_KEYS if kind == "train" else st.INPUT_KEYS


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


def counts_of(step) -> dict:
    return {k: v for k, v in step.counts.items() if not k.endswith("_s")}


def config(tmp_path, extra=()):
    make_vw(tmp_path)
    return port_config(tmp_path, FFM_ARGV + ["--power_t", "0", *extra])[1]


@pytest.fixture
def mi(tmp_path):
    """A small LR+FFM model's configuration: AdagradLUT at power_t 0, the
    batch-mean cap."""
    return config(tmp_path)


@pytest.fixture
def tower_mi(tmp_path):
    """The same with tests/test_torch_packed_graph.py's tower."""
    return config(tmp_path, TOWER_FLAGS)


def drive(step, dicts) -> list:
    """Every batch through ``step``: a copy of each output (a graph's is
    overwritten by its next replay)."""
    return [step(d).clone() for d in dicts]


@pytest.mark.parametrize("tower", [False, True], ids=["lr_ffm", "tower"])
@pytest.mark.parametrize("kind", ["train", "predict"])
def test_eager_then_capture_then_replay(mi, tower_mi, kind, tower):
    """Over batches of several signatures, the graph policy gives the
    step-by-step path's outputs and tables bit for bit; each signature
    runs step by step once, is captured on its second batch, and every
    batch after its first is replayed."""
    m = tower_mi if tower else mi
    dicts = train_dicts(m)
    sigs = signatures(dicts, keys_of(kind))
    groups = {s: sigs.count(s) for s in sigs}
    assert len(groups) >= 2 and any(c >= 2 for c in groups.values()), groups
    eager_model, graph_model = fresh_model(m), fresh_model(m)
    eager = make(kind, eager_model, graph=False)
    cap = StandInCapturer()
    graphed = make(kind, graph_model, capturer=cap)
    want, got = drive(eager, dicts), drive(graphed, dicts)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert_bit_identical(tensors(graph_model), tensors(eager_model))
    n, seen_twice = len(dicts), sum(1 for c in groups.values() if c >= 2)
    assert counts_of(graphed) == {"graph_captures": seen_twice,
                                  "graph_replays": n - len(groups),
                                  "eager_batches": len(groups)}
    assert cap.captures == seen_twice and cap.replays == n - len(groups)
    assert min(graphed.counts[k] for k in ("eager_s", "capture_s", "replay_s")) > 0
    assert counts_of(eager) == {"graph_captures": 0, "graph_replays": 0,
                                "eager_batches": n}


@pytest.mark.parametrize("kind", ["train", "predict"])
def test_cpu_steps_run_eager_without_a_capturer(mi, kind):
    """On the CPU there are no graphs: every batch runs step by step."""
    dicts = train_dicts(mi, n=64)
    step = make(kind, fresh_model(mi))
    drive(step, dicts)
    assert not step.graphed and step.graphs == {}
    assert counts_of(step) == {"graph_captures": 0, "graph_replays": 0,
                               "eager_batches": len(dicts)}


def variants(d: dict) -> dict:
    """A batch and batches of other signatures: another width (the LR
    arrays padded by 8 inert columns), a partial batch (the first 5 rows,
    unpadded) and another key set (no importance)."""
    wider = dict(d)
    for k in ("lr_ids", "lr_vals", "lr_combos", "lr_counts"):
        pad = -1 if k == "lr_combos" else 0
        wider[k] = np.pad(d[k], ((0, 0), (0, 8)), constant_values=pad)
    partial = {k: v[:5] for k, v in d.items()}
    keys = {k: v for k, v in d.items() if k != "importance"}
    return {"width": wider, "partial": partial, "keys": keys}


@pytest.mark.parametrize("change", ["width", "partial", "keys"])
@pytest.mark.parametrize("kind", ["train", "predict"])
def test_a_new_signature_captures_anew(mi, kind, change):
    """A new width, a partial batch or another key set is a signature of
    its own: it runs step by step first and captures on its own second
    batch, the first signature's graph replaying meanwhile."""
    d = train_dicts(mi, n=16)[0]
    other = variants(d)[change]
    if kind == "predict" and change == "keys":
        other = {k: v for k, v in d.items() if k != "lr_vals"}
    eager_model, model = fresh_model(mi), fresh_model(mi)
    eager = make(kind, eager_model, graph=False)
    step = make(kind, model, capturer=StandInCapturer())
    calls = [d, d, d, other, other, d, other]
    counts = []
    for b in calls:
        assert torch.equal(step(b), eager(b))
        counts.append(dict(counts_of(step)))
    assert [c["eager_batches"] for c in counts] == [1, 1, 1, 2, 2, 2, 2]
    assert [c["graph_captures"] for c in counts] == [0, 1, 1, 1, 2, 2, 2]
    assert [c["graph_replays"] for c in counts] == [0, 1, 2, 2, 3, 4, 5]
    assert len(step.graphs) == 2
    assert_bit_identical(tensors(model), tensors(eager_model))


@pytest.mark.parametrize("kind", ["train", "predict"])
def test_graphs_beyond_the_cap_are_released(mi, kind, monkeypatch):
    """A step keeps at most step.LIVE_STEP_GRAPHS captured graphs (here 2):
    a capture beyond them releases the least recently replayed graph with
    its inputs and output, and a released signature that comes back is
    captured anew and steps bit for bit as the step-by-step path does."""
    monkeypatch.setattr(st, "LIVE_STEP_GRAPHS", 2)
    d = train_dicts(mi, n=16)[0]
    v = variants(d)
    bs = [d, v["width"], v["partial"]]
    calls = [b for b in bs for _ in range(2)] + [bs[0]] * 2
    eager_model, model = fresh_model(mi), fresh_model(mi)
    eager = make(kind, eager_model, graph=False)
    step = make(kind, model, capturer=StandInCapturer())
    live = []
    for b in calls:
        assert torch.equal(step(b), eager(b))
        live.append(len(step.live))
    assert_bit_identical(tensors(model), tensors(eager_model))
    assert max(live) == 2
    assert counts_of(step) == {"graph_captures": 4, "graph_replays": 5,
                               "eager_batches": 3}
    first, second, third = (step.graphs[s] for s in signatures(bs, keys_of(kind)))
    assert step.live == [third, first]
    assert second.graph_replay is second.out is second.inputs is None


@pytest.mark.parametrize("where", ["capture", "replay"])
@pytest.mark.parametrize("kind", ["train", "predict"])
def test_a_failed_graph_raises_and_is_not_run_eagerly(mi, kind, where):
    """A capture or replay that fails raises GraphError naming the step,
    its signature and the CUDA error; the batch is not run step by step
    instead: the tables stay as the first batch left them."""
    d = train_dicts(mi, n=16)[0]
    model = fresh_model(mi)
    step = make(kind, model, capturer=StandInCapturer(fail=where))
    step(d)
    after_first = tensors(model)
    with pytest.raises(st.GraphError) as e:
        step(d)
    msg = str(e.value)
    assert msg.startswith(f"the {kind} step's CUDA graph (signature ")
    assert f"failed to {where}" in msg and "lr_ids [16, " in msg
    assert (CAPTURE_ERROR if where == "capture" else REPLAY_ERROR) in msg
    assert_bit_identical(tensors(model), after_first)
    assert step.counts["eager_batches"] == 1 and step.counts["graph_replays"] == 0


@pytest.mark.parametrize("kind", ["train", "predict"])
def test_launch_counters_add_per_replay(mi, kind):
    """The wrappers' counts of the captured launches are taken back after
    the capture, which launches nothing, and each replay adds them."""
    d = train_dicts(mi, n=16)[0]
    launches = (1, 1, 2) if kind == "train" else (1, 0, 0)
    step = make(kind, fresh_model(mi), capturer=StandInCapturer(launches=launches))

    def counts():
        return ffm.LAUNCHES, ffm.BWD_LAUNCHES, sparse_update.LAUNCHES

    step(d)  # step by step: on the CPU no wrapper counts
    before = counts()
    for n in range(1, 5):
        step(d)
        assert tuple(a - b for a, b in zip(counts(), before)) == tuple(
            x * n for x in launches)


def test_a_capture_takes_back_only_its_own_threads_launches(mi):
    """While one thread captures, another launches (the daemon's workers):
    the capture takes back only what its own thread's wrappers counted,
    and each replay adds only that; the other thread's launches stay
    counted once."""
    d = train_dicts(mi, n=16)[0]

    class Busy(StandInCapturer):
        def capture(self, fn):
            other = threading.Thread(target=lambda: (ffm.add_launches(5, 5),
                                                     sparse_update.add_launches(5)))
            other.start()
            other.join()
            return super().capture(fn)

    def counts():
        return ffm.LAUNCHES, ffm.BWD_LAUNCHES, sparse_update.LAUNCHES

    step = make("train", fresh_model(mi), capturer=Busy(launches=(1, 1, 2)))
    step(d)
    before = counts()
    step(d)  # captured, then replayed once
    assert tuple(a - b for a, b in zip(counts(), before)) == (6, 6, 7)
    step(d)
    assert tuple(a - b for a, b in zip(counts(), before)) == (7, 7, 9)


@pytest.mark.parametrize("key", ["lr_w", "ffm_acc", "nn0.w"])
@pytest.mark.parametrize("kind", ["train", "predict"])
def test_a_rebound_table_raises(mi, tower_mi, kind, key):
    """The graph reads and writes the tables at their capture-time
    addresses: after a table (or a tower tensor) is rebound, the next
    replay raises instead of touching freed memory."""
    model = fresh_model(tower_mi if key.startswith("nn") else mi)
    d = train_dicts(model.mi, n=16)[0]
    step = make(kind, model, capturer=StandInCapturer())
    step(d)
    step(d)  # captured
    if key.startswith("nn"):
        model.layers[0].w = model.layers[0].w.clone()
    else:
        setattr(model, key, getattr(model, key).clone())
    with pytest.raises(st.GraphError, match="rebound"):
        step(d)


# -- through the CLI ---------------------------------------------------------------


def graph_policy(monkeypatch, fail=None) -> None:
    """The CLI's per-batch and packed steps with stand-in capturers: the
    graph policy on the CPU."""
    for name in ("make_train_step", "make_predict_step"):
        orig = getattr(st, name)

        def graphed(model, graph=True, capturer=None, _orig=orig):
            return _orig(model, graph, StandInCapturer(fail=fail))

        monkeypatch.setattr(st, name, graphed)
    with_stand_in(monkeypatch, StandInCapturer())


# name → (argv maker, flags, the per-batch steps that must replay)
CLI_CASES = {
    "no_native": (small_argv, ["--fwt_no_native"], ("train",)),
    "delay": (small_argv, ["--prediction_model_delay", "40", "--power_t", "0"],
              ("train", "predict")),
    # the Eat-Rate lines' all-ones values, which the C++ ingest drops: the
    # delayed train step reads the ones the predict step made
    "delay_eat_rate": (eat_rate_argv, ["--prediction_model_delay", "200"],
                       ("train", "predict")),
    "holdout": (small_argv, ["--holdout_after", "50", "--predictions_after", "7"],
                ("predict",)),
    "exact": (lambda t: small_argv(t, 40), ["--fwt_exact"], ("train",)),
}


@pytest.mark.parametrize("name", CLI_CASES)
def test_cli_graph_policy_trains_as_eager_and_as_jax(tmp_path, monkeypatch, name):
    """The port's CLI with the graph policy on the CPU: its -p and -f files
    byte-identical to the step-by-step run's, within the bounds of the JAX
    CLI's, and its counters name the per-batch graphs' captures, replays
    and step-by-step batches apart from the packed ones."""
    make_argv, flags, replaying = CLI_CASES[name]
    argv = make_argv(tmp_path) + flags
    jp, jf = run(jax_main, argv, tmp_path, "jax")
    ep, ef = run(main, argv, tmp_path, "eager", ["--fwt_platform", "cpu"])
    counters = tmp_path / "counters.json"
    monkeypatch.setenv("FWT_COUNTERS_OUT", str(counters))
    graph_policy(monkeypatch)
    gp, gf = run(main, argv, tmp_path, "graph", ["--fwt_platform", "cpu"])
    assert (tmp_path / "graph.out").read_bytes() == (tmp_path / "eager.out").read_bytes()
    assert gf.read_bytes() == ef.read_bytes()
    assert gp.shape == jp.shape and gp.size >= 40
    np.testing.assert_allclose(gp, jp, rtol=0, atol=2e-6)
    assert_same_model(jf, gf)
    c = json.loads(counters.read_text())["counters"]
    for kind in replaying:
        assert c[f"{kind}_graph_captures"] >= 1 and c[f"{kind}_graph_replays"] >= 1, c
        assert c[f"{kind}_eager_batches"] >= c[f"{kind}_graph_captures"]


def test_cli_testonly_graph_policy_predicts_as_eager_and_as_jax(tmp_path, monkeypatch):
    """``-t -i``: the C++ ingest's batches through the predict graphs give
    the step-by-step run's -p file byte for byte and the JAX CLI's within
    2e-6."""
    argv = small_argv(tmp_path)
    _, model = run(main, argv, tmp_path, "trained", ["--fwt_platform", "cpu"])
    t_argv = argv + ["-t", "-i", str(model)]

    def predict(fn, tag, extra=()):
        p = tmp_path / f"{tag}.out"
        assert fn(t_argv + ["-p", str(p), *extra]) == 0
        return p.read_bytes()

    jp = predict(jax_main, "t_jax")
    ep = predict(main, "t_eager", ["--fwt_platform", "cpu"])
    counters = tmp_path / "counters.json"
    monkeypatch.setenv("FWT_COUNTERS_OUT", str(counters))
    graph_policy(monkeypatch)
    gp = predict(main, "t_graph", ["--fwt_platform", "cpu"])
    assert gp == ep and gp.count(b"\n") == 120
    np.testing.assert_allclose(np.array(gp.split(), float), np.array(jp.split(), float),
                               rtol=0, atol=2e-6)
    c = json.loads(counters.read_text())["counters"]
    assert c["predict_graph_captures"] >= 1 and c["predict_graph_replays"] >= 1, c
    assert "train_graph_captures" not in c


def test_cli_failed_capture_exits_1(tmp_path, monkeypatch, caplog):
    """A per-batch capture that fails ends the run with exit 1, the log
    naming the step, its signature and the CUDA error; no model file is
    written."""
    argv = small_argv(tmp_path) + ["--fwt_platform", "cpu", "--fwt_no_native"]
    graph_policy(monkeypatch, fail="capture")
    f = tmp_path / "m.fwt"
    with caplog.at_level(logging.ERROR):
        rc = main(argv + ["-p", str(tmp_path / "p.out"), "-f", str(f), "--save_resume"])
    assert rc == 1 and not f.exists()
    msg = " ".join(r.getMessage() for r in caplog.records)
    assert "the train step's CUDA graph (signature " in msg
    assert "failed to capture" in msg and CAPTURE_ERROR in msg


# -- the daemon's predictor ---------------------------------------------------------


def test_shared_predictor_under_threads_and_swaps(mi, tmp_path, monkeypatch):
    """8 threads predict chunks of 1–600 lines (1–3 padded batches of 256,
    lines of varying width) while a swapper alternates two models 12
    times: every reply is the step-by-step prediction of its lines under
    one of the two models, all from one snapshot; each swapped-out
    model's graphs are released once its last prediction returned, and the
    captures stay within the signatures times the models served."""
    import sys

    made = []
    orig = st.make_predict_step

    def graphed(model, graph=True, capturer=None):
        made.append(orig(model, graph, StandInCapturer()))
        return made[-1]

    monkeypatch.setattr(server, "make_predict_step", graphed)
    vw = port_vw()
    paths = []
    for seed in (1, 2):
        model = FwModel(mi)
        params = model.init_params("cpu")
        g = torch.Generator().manual_seed(seed)
        params["lr_w"] = torch.randn(params["lr_w"].shape, generator=g) * 0.3
        params["ffm_w"] = torch.randn(params["ffm_w"].shape, generator=g) * 0.3
        model.load_params(params)
        paths.append(tmp_path / f"m{seed}.fwt")
        model_file.save_model(str(paths[-1]), mi, vw, model)
    parser, ft = VowpalParser(vw), FeatureTranslator(mi)
    lines = vw_lines(600, seed=3)
    examples = [ft.translate(parser.parse_line(line)) for line in lines]
    rng = random.Random(0)
    requests = []
    for _ in range(24):
        i = rng.randrange(600)
        requests.append((i, rng.choice([1, 7, 256, 300, 600 - i])))
    # each request's replies under the two models, step by step: a line's
    # prediction depends on the width its chunk pads to
    want = {}
    for path in paths:
        _, _, m = model_file.load_model(str(path), immutable=True, device="cpu")
        eager = server.SharedPredictor(mi, vw, m)
        eager._current = (m, orig(m, graph=False))
        for i, n in requests:
            want.setdefault((i, n), []).append(
                eager.predict_examples(examples[i:i + n]))
    assert all(not np.array_equal(*w) for w in want.values())
    made.clear()
    _, _, first = model_file.load_model(str(paths[0]), immutable=True, device="cpu")
    pred = server.SharedPredictor(mi, vw, first)
    errors, done = [], threading.Event()

    def client(seed):
        rng = random.Random(seed)
        try:
            while not done.is_set():
                i, n = rng.choice(requests)
                got = pred.predict_examples(examples[i:i + n])
                if not any(np.array_equal(got, w) for w in want[(i, n)]):
                    errors.append((i, n))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for swap in range(12):
            pred.hogwild_load(str(paths[(swap + 1) % 2]))
        done.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors[:3]
    assert pred.swaps == 12 and len(made) == 13
    assert pred._retired == {} and pred._holding == {}
    for step in made[:-1]:
        assert step.live == []
        assert all(g.graph_replay is g.out is g.inputs is None
                   for g in step.graphs.values())
    counts = pred.graph_counts()
    assert counts["graph_replays"] > 0
    assert counts["graph_captures"] <= counts["signatures"] * (pred.swaps + 1)
    assert counts["graph_replays"] + counts["eager_batches"] == sum(
        s.counts["graph_replays"] + s.counts["eager_batches"] for s in made)
