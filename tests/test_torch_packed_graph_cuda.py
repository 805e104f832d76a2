"""The packed step as one CUDA graph per (layout, K) on the card
(fwumious_wabbit_tpu_torch/train/packed.py ``_GraphedStep``) against the
same step run step by step (``graph=False``), from identical initial
tables, over the producer's stream of the synthetic Eat-Rate file at small
widths (-b 18, --ffm_bit_precision 18): 16 full superbatches and more, a
vocabulary re-signature, a short tail and a padded partial batch. Every
prediction, table, accumulator and tower tensor bit-identical, for the
LR+FFM model and the tower, directly and through the fetch ring; and
through the CLI (the transfer and writer threads running while it
captures), the -p and -f files byte-identical, with and without
``--fwt_fetch_stack``; under a budget that one graph's pool fills, the
released graphs captured anew and the card's reserved memory bounded,
and under the default budget every graph kept; and one process making 41
``run_train_loop`` calls, 40 of them replay passes that capture nothing
anew. Skips without a card. This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_packed_graph_cuda.py
"""

import json

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu_torch import synthetic
from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu_torch.models.model import FwModel
from fwumious_wabbit_tpu_torch.ops import ffm, sparse_update
from fwumious_wabbit_tpu_torch.train import packed
from fwumious_wabbit_tpu_torch.train.loop import main, run_train_loop
from fwumious_wabbit_tpu_torch.train.producer import SuperbatchProducer

K, B = 4, 256
# 24 superbatches' lines (the vocabulary's growth flushes the first groups
# short), a tail of two batches and a padded partial batch
ROWS = 24 * K * B + 2 * B + 100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def argv_of(tower: bool) -> list:
    argv = synthetic.tower_argv() if tower else synthetic.serving_argv()
    argv[argv.index("-b") + 1] = "18"
    argv[argv.index("--ffm_bit_precision") + 1] = "18"
    return argv


def stream(tmp_path, tower: bool, device):
    """``(mi, items)``: the producer's queue stream on the card — packed
    superbatches ``("p", buf, layout)`` and snapshots ``("v", snapshot)``."""
    data = synthetic.ensure_dataset(tmp_path, ROWS)
    args = build_parser().parse_args(argv_of(tower) + ["--data", str(data)])
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
            items.append(("v", torch.from_numpy(item[1]).to(device)))
        else:
            buf = torch.from_numpy(item[1].view(np.int32)).to(device)
            items.append(("p", buf, item[2]))
    sizes = [i[1].shape[0] for i in items if i[0] == "p"]
    assert sizes.count(K) >= 16 and min(sizes) < K, sizes
    assert len({i[2].signature for i in items if i[0] == "p"}) >= 2
    return mi, items


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


def drive(model, items, ring: bool, **kw) -> list:
    """Every superbatch through the packed step (through a fetch ring of 4
    with ``ring``, a tail through the plain step as the loop does): the
    predictions of each, copied off the card."""
    vocab, preds, M = None, [], 4
    ring_t = torch.zeros((M, K, B), device=items[0][1].device) if ring else None
    for item in items:
        if item[0] == "v":
            vocab = item[1]
            continue
        _, buf, lay = item
        v = (vocab,) if lay.vocabs else ()
        kk = buf.shape[0]
        if ring and kk == K:
            slot = len(preds) % M
            packed.make_packed_train_step_ring(model, lay, K, M, **kw)(buf, ring_t, slot, *v)
            preds.append(ring_t[slot].cpu())
        else:
            preds.append(packed.make_packed_train_step(model, lay, kk, **kw)(buf, *v).cpu())
    torch.cuda.synchronize()
    return preds


def assert_identical(got: list, want: list, a: FwModel, b: FwModel):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"superbatch {i}"
    ta, tb = tensors(a), tensors(b)
    assert sorted(ta) == sorted(tb)
    for key in ta:
        assert torch.equal(ta[key], tb[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [False, True], ids=["direct", "ring"])
@pytest.mark.parametrize("tower", [False, True], ids=["lr_ffm", "tower"])
def test_graph_equals_eager_bit_for_bit(cuda, tmp_path, tower, ring):
    mi, items = stream(tmp_path, tower, cuda)
    eager, graphed = fresh_model(mi, cuda), fresh_model(mi, cuda)
    want = drive(eager, items, ring, graph=False)
    launches0 = (ffm.LAUNCHES, ffm.BWD_LAUNCHES, sparse_update.LAUNCHES)
    got = drive(graphed, items, ring)
    launched = [a - b for a, b in zip(
        (ffm.LAUNCHES, ffm.BWD_LAUNCHES, sparse_update.LAUNCHES), launches0)]
    assert_identical(got, want, graphed, eager)
    counts = packed.graph_counts(graphed)
    assert counts["graph_captures"] >= 1 and counts["graph_replays"] >= 14
    n_steps = sum(i[1].shape[0] for i in items if i[0] == "p")
    # per launch made, replays included: forward 1, backward 1, update 2
    assert launched == [n_steps, n_steps, 2 * n_steps]


@pytest.mark.cuda
def test_eager_steps_are_deterministic(cuda, tmp_path):
    """The premise of bit identity: two step-by-step runs from the same
    tables agree bit for bit (the LR sum's scatter_add_ takes atomics on
    the card)."""
    mi, items = stream(tmp_path, False, cuda)
    a, b = fresh_model(mi, cuda), fresh_model(mi, cuda)
    assert_identical(drive(a, items, False, graph=False),
                     drive(b, items, False, graph=False), a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [[], ["--fwt_fetch_stack", "4"]],
                         ids=["fetch", "fetch_stack"])
@pytest.mark.parametrize("tower", [False, True], ids=["lr_ffm", "tower"])
def test_cli_graph_equals_eager_byte_for_byte(cuda, tmp_path, monkeypatch, tower, extra):
    """The CLI's default path on the card replays its graphs while the
    transfer and writer threads run; its -p and -f files equal those of
    the same run with every packed step run step by step."""
    data = synthetic.ensure_dataset(tmp_path, ROWS)
    argv = argv_of(tower) + ["--data", str(data), "--fwt_batch_size", str(B),
                             "--fwt_superbatch", str(K), *extra]
    counters = tmp_path / "counters.json"
    monkeypatch.setenv("FWT_COUNTERS_OUT", str(counters))

    def train(tag):
        ffm.LAUNCHES = ffm.BWD_LAUNCHES = sparse_update.LAUNCHES = 0
        p, f = tmp_path / f"{tag}.out", tmp_path / f"{tag}.fwt"
        assert main(argv + ["-p", str(p), "-f", str(f), "--save_resume"]) == 0
        return p.read_bytes(), f.read_bytes(), json.loads(counters.read_text())

    gp, gf, gc = train("graph")
    make = packed.make_packed_train_step
    monkeypatch.setattr(packed, "make_packed_train_step",
                        lambda model, layout, k, graph=True, capturer=None:
                        make(model, layout, k, False, capturer))
    ep, ef, ec = train("eager")
    assert gp.count(b"\n") == ROWS
    assert gp == ep and gf == ef
    assert gc["counters"]["graph_replays"] >= 14 and ec["counters"]["graph_replays"] == 0
    assert gc["launches"] == ec["launches"]


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [1, None], ids=["one_graph", "default"])
def test_released_graphs_capture_anew_and_free_their_pools(cuda, tmp_path, monkeypatch,
                                                           budget):
    """Three (layout, K) taken in turns for six rounds: the first round
    runs step by step, the second captures each. Under a budget of one
    byte, which every graph's pool fills, each capture releases the graph
    before it, and so every later round captures each anew; under the
    default budget the model keeps all three, each pool measured, and
    later rounds only replay. The card's reserved memory at the end of
    each round stays at the second round's, and every prediction and
    table equals the step-by-step run's bit for bit."""
    if budget is not None:
        monkeypatch.setattr(packed, "_PACKED_GRAPH_BUDGET", budget)
    mi, items = stream(tmp_path, False, cuda)
    groups, vocab = {}, None
    for item in items:
        if item[0] == "v":
            vocab = item[1]
            continue
        _, buf, lay = item
        groups.setdefault((lay.signature, buf.shape[0]), (buf, lay, vocab))
    picks = list(groups.values())[:3]
    assert len(picks) == 3

    def round_of(model, **kw) -> list:
        return [packed.make_packed_train_step(model, lay, buf.shape[0], **kw)(
                    buf, *((v,) if lay.vocabs else ())).cpu()
                for buf, lay, v in picks]

    eager, graphed = fresh_model(mi, cuda), fresh_model(mi, cuda)
    want = [p for _ in range(6) for p in round_of(eager, graph=False)]
    got, reserved = [], []
    for _ in range(6):
        got += round_of(graphed)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(cuda))
    assert_identical(got, want, graphed, eager)
    live = packed._live_graphs(graphed)
    assert all(step.pool_bytes > 0 for step in live)
    if budget is None:
        assert packed.graph_counts(graphed)["graph_captures"] == len(picks) == len(live)
        assert packed.release_counts(graphed)["graph_releases"] == 0
    else:
        assert packed.graph_counts(graphed)["graph_captures"] == 5 * len(picks)
        assert packed.release_counts(graphed)["graph_releases"] == 5 * len(picks) - 1
        assert len(live) == 1
    assert max(reserved[2:]) <= reserved[1], reserved


@pytest.mark.cuda
def test_forty_replay_calls_in_one_process(cuda, tmp_path):
    """One process, one model, 41 ``run_train_loop`` calls: the text pass
    recording the pack cache, then 40 replay passes, more than PyTorch's
    pool of 32 streams (a transfer stream taken per call came round to the
    graphs' capture stream there). Every call trains every line; from the
    second replay pass on, no call captures or releases a graph, and the
    kept graphs' pools hold the same bytes at the end of each."""
    data = synthetic.ensure_dataset(tmp_path, ROWS)
    argv = argv_of(False) + ["--data", str(data), "--fwt_batch_size", str(B),
                             "--fwt_superbatch", str(K), "--fwt_pack_cache", "on"]
    args = build_parser().parse_args(argv)
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    mi = ModelInstance.from_cmdline(args, vw)
    model = fresh_model(mi, cuda)
    results, captures = [], []
    for _ in range(41):
        results.append(run_train_loop(build_parser().parse_args(argv), mi, vw, model))
        captures.append(packed.graph_counts(model)["graph_captures"])
    torch.cuda.synchronize()
    assert [r["examples"] for r in results] == [ROWS] * 41
    counters = [r["counters"] for r in results]
    assert captures[1] >= 1 and captures[2:] == [captures[1]] * 39, captures
    assert all(c["graph_releases"] == 0 for c in counters[1:])
    pools = {c["graph_pool_bytes"] for c in counters[2:]}
    assert len(pools) == 1 and pools.pop() > 0
