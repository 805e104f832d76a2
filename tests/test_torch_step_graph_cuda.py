"""The per-batch train and predict steps as one CUDA graph per batch
signature on the card (fwumious_wabbit_tpu_torch/train/step.py
``BatchStep``) against the same steps run step by step (``graph=False``),
from identical initial tables, at the full width of the LR+FFM k=8
configuration (fwumious_wabbit_tpu_torch/synthetic.py: -b 25,
--ffm_bit_precision 25) and of the same tables with the tower: every
prediction, table, accumulator and tower tensor bit-identical over
batches of several signatures (the Python batcher's widths, a partial
batch, the C++ ingest's slim key set); the daemon's ``SharedPredictor``
answering 8 threads while a swapper hot-swaps two full-width models (a
swap's host→device load runs while the workers capture), every reply the
step-by-step reply of one model, each swapped-out model's graphs released
and its memory returned; and graphs released beyond the cap captured anew,
the card's reserved memory bounded. Skips without a card. This file
imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_step_graph_cuda.py
"""

import random
import threading

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu_torch import synthetic
from fwumious_wabbit_tpu_torch.ingest import Batcher, FeatureTranslator, VowpalParser
from fwumious_wabbit_tpu_torch.models.model import FwModel
from fwumious_wabbit_tpu_torch.ops import ffm, sparse_update
from fwumious_wabbit_tpu_torch.persistence import model_file
from fwumious_wabbit_tpu_torch.serve import server
from fwumious_wabbit_tpu_torch.train import step as st
from fwumious_wabbit_tpu_torch.train.loop import np_counts

B = 1024
ROWS = 12 * B


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def launches() -> tuple:
    return ffm.LAUNCHES, ffm.BWD_LAUNCHES, sparse_update.LAUNCHES


def host_batches(tmp_path, config, batch_size=B) -> tuple:
    """``(mi, batches)``: the synthetic file's lines as the Python ingest
    batches them (host counts included), then the same lines' variants:
    a partial batch, a wider one (the LR arrays padded by 8 inert columns)
    and the C++ ingest's slim key set (no value arrays, u8 labels), each
    twice so that it replays."""
    data = synthetic.ensure_dataset(tmp_path, ROWS)
    mi, vw = config(data)
    shift = (FwModel(mi).ffm_spec.align - 1).bit_length()
    parser, ft = VowpalParser(vw), FeatureTranslator(mi)
    tes = [ft.translate(parser.parse_line(line))
           for line in data.read_bytes().splitlines(True)]
    out = []
    for i in range(0, len(tes), batch_size):
        b = Batcher(batch_size).make_batch(tes[i:i + batch_size])
        bd = st.train_batch_dict(b)
        bd["lr_counts"] = np_counts(b.lr_ids, b.lr_vals, 0)
        bd["ffm_counts"] = np_counts(b.ffm_ids, b.ffm_vals, shift)
        out.append(bd)
    d = out[0]
    partial = {k: v[:100] for k, v in d.items()}
    wider = dict(d)
    for k in ("lr_ids", "lr_vals", "lr_combos", "lr_counts"):
        wider[k] = np.pad(d[k], ((0, 0), (0, 8)),
                          constant_values=-1 if k == "lr_combos" else 0)
    slim = {k: v for k, v in d.items() if k not in ("lr_vals", "ffm_vals")}
    slim["label"] = d["label"].astype(np.uint8)
    out += [partial, partial, wider, wider, slim, slim]
    return mi, out


def fresh_model(mi, device) -> FwModel:
    model = FwModel(mi)
    return model.load_params(model.init_params(device))


def tensors(model) -> dict:
    params = model.params()
    out = {k: v for k, v in params.items() if k not in ("nn", "final")}
    for i, layer in enumerate(params.get("nn", [])):
        out.update({f"nn{i}.{k}": v for k, v in layer.items()})
    out.update({f"final.{k}": v for k, v in params.get("final", {}).items()})
    return out


def make(kind, model, **kw):
    return (st.make_train_step if kind == "train" else st.make_predict_step)(model, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "predict"])
@pytest.mark.parametrize("tower", [False, True], ids=["lr_ffm", "tower"])
def test_graph_equals_eager_bit_for_bit(cuda, tmp_path, tower, kind):
    config = synthetic.tower_training_config if tower else synthetic.training_config
    mi, batches = host_batches(tmp_path, config)
    eager, graphed = fresh_model(mi, cuda), fresh_model(mi, cuda)
    e_step, g_step = make(kind, eager, graph=False), make(kind, graphed)
    assert g_step.graphed and not e_step.graphed
    # device inputs too, as the default path's "s" items arrive
    batches += [{k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
                 for k, v in b.items()} for b in batches[:3]]
    want = [e_step(b).cpu() for b in batches]
    before = launches()
    got = [g_step(b).clone().cpu() for b in batches]
    launched = [a - b for a, b in zip(launches(), before)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"batch {i}"
    ta, tb = tensors(graphed), tensors(eager)
    for key in ta:
        assert torch.equal(ta[key], tb[key]), key
    sigs = [st.signature({k: st._as_tensor(b[k]) for k in g_step.keys if k in b})
            for b in batches]
    distinct = set(sigs)
    assert len(distinct) >= 4
    c = g_step.counts
    assert c["eager_batches"] == len(distinct), c
    assert c["graph_captures"] == sum(1 for s in distinct if sigs.count(s) >= 2), c
    n = len(batches)
    assert c["graph_replays"] == n - len(distinct), c
    assert launched == ([n, n, 2 * n] if kind == "train" else [n, 0, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "predict"])
def test_released_graphs_capture_anew_and_free_their_pools(cuda, tmp_path, kind):
    """One more signature than a step keeps graphs (LIVE_STEP_GRAPHS),
    taken in turns for six rounds: the first round runs step by step, the
    second captures each, its last capture releasing the least recently
    replayed graph, and every later round captures each anew; the card's
    reserved memory at the end of each round stays at the second round's,
    and every prediction and table equals the step-by-step run's bit for
    bit."""
    mi, batches = host_batches(tmp_path, synthetic.training_config)
    base = batches[0]
    picks = []
    for n in range(st.LIVE_STEP_GRAPHS + 1):  # partial batches of 9 sizes
        picks.append({k: v[:B - 8 * n] for k, v in base.items()})
    eager, graphed = fresh_model(mi, cuda), fresh_model(mi, cuda)
    e_step, g_step = make(kind, eager, graph=False), make(kind, graphed)
    want = [e_step(b).cpu() for _ in range(6) for b in picks]
    got, reserved = [], []
    for _ in range(6):
        got += [g_step(b).clone().cpu() for b in picks]
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(cuda))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ta, tb = tensors(graphed), tensors(eager)
    for key in ta:
        assert torch.equal(ta[key], tb[key]), key
    assert g_step.counts["graph_captures"] == 5 * len(picks)
    assert len(g_step.live) == st.LIVE_STEP_GRAPHS
    assert max(reserved[2:]) <= reserved[1], reserved
    g_step.release()
    assert g_step.live == []
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved(cuda) <= reserved[1]


@pytest.mark.cuda
def test_daemon_hot_swaps_under_concurrent_clients(cuda, tmp_path):
    """8 threads predict chunks of 1–600 lines of the synthetic file
    through a ``SharedPredictor`` of the full-width serving model while a
    swapper alternates two models 10 times: each swap's host→device load
    runs while workers run step by step and capture the new model's
    graphs. Every reply equals the step-by-step reply of one of the two
    models; afterwards every swapped-out model's graphs are released, the
    predict graphs replayed, captured at most once per signature and model,
    and the card holds one model's tables and little more."""
    data = synthetic.ensure_dataset(tmp_path, 2000)
    mi, vw = synthetic.serving_config(data)
    paths = []
    for seed in (1, 2):
        model = FwModel(mi)
        params = model.init_params("cpu")
        g = torch.Generator().manual_seed(seed)
        params["lr_w"] = torch.randn(params["lr_w"].shape, generator=g) * 0.1
        params["ffm_w"] = torch.randn(params["ffm_w"].shape, generator=g) * 0.1
        model.load_params(params)
        paths.append(tmp_path / f"m{seed}.fwt")
        model_file.save_model(str(paths[-1]), mi, vw, model)
        del model, params
    parser, ft = VowpalParser(vw), FeatureTranslator(mi)
    lines = data.read_bytes().splitlines(True)[:600]
    # three blocks of lines of other widths (the last namespaces dropped):
    # the padded chunks' signatures vary
    lines = [b" |".join(line.rstrip(b"\n").split(b" |")[:13 - 4 * (i // 200)]) + b"\n"
             for i, line in enumerate(lines)]
    examples = [ft.translate(parser.parse_line(line)) for line in lines]
    rng = random.Random(0)
    requests = []
    for _ in range(16):
        i = rng.randrange(600)
        requests.append((i, rng.choice([1, 7, 256, 300, 600 - i])))
    want = {}
    for path in paths:
        _, _, m = model_file.load_model(str(path), immutable=True, device=cuda)
        eager = server.SharedPredictor(mi, vw, m)
        eager._current = (m, st.make_predict_step(m, graph=False))
        for i, n in requests:
            want.setdefault((i, n), []).append(eager.predict_examples(examples[i:i + n]))
        del eager, m
    torch.cuda.empty_cache()
    _, _, first = model_file.load_model(str(paths[0]), immutable=True, device=cuda)
    before = ffm.LAUNCHES
    pred = server.SharedPredictor(mi, vw, first)
    del first
    errors, done = [], threading.Event()

    def client(seed):
        r = random.Random(seed)
        try:
            while not done.is_set():
                i, n = r.choice(requests)
                got = pred.predict_examples(examples[i:i + n])
                if not any(np.array_equal(got, w) for w in want[(i, n)]):
                    errors.append((i, n))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for swap in range(10):
        pred.hogwild_load(str(paths[(swap + 1) % 2]))
    done.set()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    pred.note_resident()
    counts = pred.graph_counts()
    assert counts["graph_replays"] > 0 and counts["graph_captures"] > 0, counts
    assert counts["graph_captures"] <= counts["signatures"] * (pred.swaps + 1), counts
    assert pred._retired == {}
    # every batch launched the forward once, step by step or replayed,
    # whatever the other threads captured meanwhile
    assert ffm.LAUNCHES - before == counts["graph_replays"] + counts["eager_batches"]
    table_bytes = sum(b.numel() * b.element_size() for b in pred.model.buffers())
    held = pred.resident_bytes
    assert 2 in held and pred.swaps in held, held
    assert abs(held[pred.swaps] - held[2]) < table_bytes, (held, table_bytes)
