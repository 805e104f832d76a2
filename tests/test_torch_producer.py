"""The port's producer stages (fwumious_wabbit_tpu_torch/train/producer.py)
against the JAX package's: the vocab-flip policy's verdicts on the windows
of tests/test_producer.py; ``SuperbatchProducer.run`` into a list sink
yielding the same items — kinds, layouts, packed bytes, vocabulary
snapshots, single batches — with host counts, a holdout cut and the fused
emit; the pack cache recorded and replayed through the CLI, its file equal
to the one the JAX CLI records; and the transfer stage on the CPU."""

import logging
import queue

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu.train import packed as jpacked
from fwumious_wabbit_tpu.train import producer as jproducer
from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch.train import packed as ppacked
from fwumious_wabbit_tpu_torch.train import producer as pproducer
from fwumious_wabbit_tpu_torch.train.loop import main

from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (  # noqa: F401 (jax_native_loaded: an autouse fixture)
    both_configs,
    eat_rate_stream,
    jax_native_loaded,
)


def window(groups=3, ex=3 * 8 * 32768, t_work=2.0, t_put=0.1):
    return {"probe": (0.24e-6, 62.0), "t_work": t_work, "t_put": t_put,
            "ex": ex, "groups": groups, "t_mark": 0.0}


def xfer(starve_s=3.0, xfer_s=1.0, put_s=0.0, ex=3 * 8 * 32768):
    return {"starve_s": starve_s, "xfer_s": xfer_s, "put_s": put_s,
            "bytes": int(38 * ex)}


HOT, COLD = xfer(starve_s=3.0, xfer_s=0.2), xfer(starve_s=0.1, xfer_s=4.0)
POLICY_CASES = {
    "incomplete": ("auto", [(None, window(), xfer()),
                            ((0.24e-6, 62.0), window(groups=2), xfer())]),
    "two_windows": ("auto", [(window()["probe"], window(), HOT)] * 2),
    "noisy_resets": ("auto", [(window()["probe"], window(), HOT),
                              (window()["probe"], window(), COLD),
                              (window()["probe"], window(), HOT)]),
    "transfer_bound": ("auto", [(window()["probe"], window(),
                                 xfer(starve_s=0.5, xfer_s=3.5))] * 5),
    "force": ("force", [(None, window(groups=0), xfer())]),
}


@pytest.mark.parametrize("name", list(POLICY_CASES))
def test_vocab_flip_policy_matches_jax(name):
    mode, windows = POLICY_CASES[name]
    pol = (pproducer.VocabFlipPolicy(mode), jproducer.VocabFlipPolicy(mode))
    verdicts = [[p.evaluate(*w) + (p.votes,) for w in windows] for p in pol]
    assert verdicts[0] == verdicts[1]
    assert {v[0] for v in verdicts[0]} & {"flip", "keep", "incomplete"}


class ListSink:
    def __init__(self):
        self.items = []

    def put(self, item):
        self.items.append(item)


def fresh_ctr():
    return {"producer_busy_s": 0.0, "producer_stall_s": 0.0,
            "xfer_starve_s": 0.0, "xfer_busy_s": 0.0, "xfer_stall_s": 0.0,
            "xfer_bytes": 0, "xfer_puts": 0, "consumer_starve_s": 0.0,
            "dispatch_s": 0.0, "writer_stall_s": 0.0, "fetch_force_s": 0.0,
            "fetch_count": 0, "fetch_bytes": 0, "write_s": 0.0}


def produce(module, packed, args, mi, vw, **kw):
    sink, ctr = ListSink(), fresh_ctr()
    state = packed.VocabTransferState()
    module.SuperbatchProducer(
        args, mi, vw, out_queue=sink, ctr=ctr,
        xfer_stats={"starve_s": 0.0, "xfer_s": 0.0, "put_s": 0.0, "bytes": 0},
        vocab_state=state, **kw).run()
    state.close()
    return sink.items, ctr


def assert_same_items(got, want):
    assert [None if i is None else i[0] for i in got] == \
        [None if i is None else i[0] for i in want]
    for a, b in zip(got, want):
        if a is None:
            continue
        if a[0] == "p":
            assert a[2].signature == b[2].signature and a[3] == b[3]
            assert a[1].dtype == b[1].dtype and a[1].tobytes() == b[1].tobytes()
        elif a[0] == "v":
            assert a[1].tobytes() == b[1].tobytes()
        else:
            assert a[2] == b[2] and sorted(a[1]) == sorted(b[1])
            for k in a[1]:
                assert a[1][k].tobytes() == b[1][k].tobytes(), k


def cli_args(argv, data):
    from fwumious_wabbit_tpu.config.cmdline import build_parser as jparse
    from fwumious_wabbit_tpu_torch.config.cmdline import build_parser as pparse

    return (jparse().parse_args(argv + ["--data", str(data)]),
            pparse().parse_args(argv + ["--data", str(data)]))


@pytest.mark.parametrize("case", ["counts", "holdout"])
def test_producer_stream_matches_jax(tmp_path, case):
    """The Eat-Rate stream with FFM, LR and FFM host counts, K=3: packed
    groups, canonical tail splits, the padded partial batch, vocabulary
    snapshots; with a holdout cut, single batches past it."""
    csv, argv, _ = eat_rate_stream(tmp_path, 2500)
    data = tmp_path / "train_2500.vw"
    (jmi, jvw), (pmi, pvw) = both_configs(csv, argv)
    jargs, pargs = cli_args(argv, data)
    kw = dict(batch_size=256, K=3, can_pack=True,
              count_keys={"lr": 0, "ffm": 3}, cut_at=None, holdout_after=None)
    if case == "holdout":
        kw.update(cut_at=1799, holdout_after=1800)
    want, _ = produce(jproducer, jpacked, jargs, jmi, jvw, **kw)
    got, ctr = produce(pproducer, ppacked, pargs, pmi, pvw, **kw)
    assert got[-1] is None
    assert_same_items(got, want)
    kinds = {i[0] for i in got[:-1]}
    assert kinds >= ({"p", "v", "s"} if case == "holdout" else {"p", "v"})
    assert sum(i[3] for i in got[:-1] if i[0] == "p") + sum(
        i[2] for i in got[:-1] if i[0] == "s") == 2500
    assert set(ctr["cpu_s_by_thread"]) >= {"producer", "producer_ingest",
                                           "producer_prepare", "producer_pack"}


def test_fused_emit_stream_matches_jax(tmp_path, monkeypatch):
    """Small vocabularies that saturate in the first batch, so the fused
    emit carries the later batches: the same stream as JAX's, and the
    port's fused emit did engage."""
    (tmp_path / "vw_namespace_map.csv").write_text("A,animal\nB,food\n")
    rng = np.random.default_rng(11)
    data = tmp_path / "d.vw"
    data.write_text("".join(f"{1 if rng.integers(0, 2) else -1} |A a{rng.integers(0, 20)} "
                            f"|B b{rng.integers(0, 15)}\n" for _ in range(10000)))
    argv = ["-l", "0.1", "-b", "18", "--adaptive", "--power_t", "0.0",
            "--interactions", "AB", "--keep", "A", "--keep", "B", "--fwt_vocab", "on"]
    (jmi, jvw), (pmi, pvw) = both_configs(
        (tmp_path / "vw_namespace_map.csv").read_text(), argv)
    jargs, pargs = cli_args(argv, data)
    monkeypatch.setenv("FWT_FUSED", "on")
    engaged = []
    real = ppacked.try_fused_emit

    def counting(*a, **k):
        res = real(*a, **k)
        engaged.append(res is not None)
        return res

    monkeypatch.setattr(ppacked, "try_fused_emit", counting)
    kw = dict(batch_size=2048, K=2, can_pack=True, count_keys={"lr": 0},
              cut_at=None, holdout_after=None)
    want, _ = produce(jproducer, jpacked, jargs, jmi, jvw, **kw)
    got, _ = produce(pproducer, ppacked, pargs, pmi, pvw, **kw)
    assert any(engaged)
    assert_same_items(got, want)


def test_pack_cache_records_and_replays(tmp_path, caplog):
    """--fwt_pack_cache on: the first run records <input>.fwpack, the same
    file the JAX CLI records; the second run replays it, with byte-identical
    predictions and model file."""
    csv, argv, _ = eat_rate_stream(tmp_path, 1200)
    data = tmp_path / "train_1200.vw"
    fwpack = tmp_path / "train_1200.vw.fwpack"
    base = argv + ["--data", str(data), "--fwt_batch_size", "128",
                   "--fwt_superbatch", "3", "--fwt_vocab", "on",
                   "--fwt_pack_cache", "on", "--save_resume"]
    assert jax_main(base + ["-p", str(tmp_path / "j.preds")]) == 0
    jax_file = fwpack.read_bytes()
    fwpack.unlink()
    outs = []
    for run in ("record", "replay"):
        p, f = tmp_path / f"{run}.preds", tmp_path / f"{run}.fwt"
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert main(base + ["-p", str(p), "-f", str(f),
                                "--fwt_platform", "cpu"]) == 0
        replayed = any("using pack cache" in r.message for r in caplog.records)
        assert replayed == (run == "replay")
        if run == "record":
            assert fwpack.read_bytes() == jax_file
        outs.append((p.read_bytes(), f.read_bytes()))
    assert outs[0] == outs[1] and outs[0][0].count(b"\n") == 1200


def test_transferrer_on_the_cpu(tmp_path):
    """Packed buffers, snapshots and single batches pass through the
    transfer stage as plain copies (no event), with the stage's
    counters."""
    rng = np.random.default_rng(0)
    buf = rng.integers(0, 1 << 32, (3, 40), dtype=np.uint64).astype(np.uint32)
    snap = rng.integers(0, 1 << 25, (2, 128)).astype(np.int32)
    bd = {"label": np.array([0, 1, 1], np.uint8),
          "lr_ids": rng.integers(0, 1 << 20, (3, 5)).astype(np.int32),
          "ffm_vals": rng.normal(size=(3, 0)).astype(np.float32)}
    q, q2 = queue.Queue(), queue.Queue()
    for item in (("p", buf, "layout", 300), ("v", snap), ("s", bd, 3), None):
        q.put(item)
    ctr = fresh_ctr()
    pproducer.run_transferrer(q, q2, ctr, {"starve_s": 0.0, "xfer_s": 0.0,
                                           "put_s": 0.0, "bytes": 0}, "cpu")
    (_, dbuf, lay, gn, ev), (_, dsnap, ev2), (_, dbd, n, ev3) = (
        q2.get() for _ in range(3))
    assert q2.get() is None and ev is ev2 is ev3 is None
    assert (lay, gn, n) == ("layout", 300, 3)
    assert dbuf.dtype == torch.int32 and dbuf.numpy().tobytes() == buf.tobytes()
    assert dsnap.numpy().tobytes() == snap.tobytes()
    assert sorted(dbd) == sorted(bd)
    for k in bd:
        assert dbd[k].shape == bd[k].shape and dbd[k].numpy().tobytes() == bd[k].tobytes()
    buf[:] = 0  # the stage copied: the host buffer may be reused
    assert dbuf.numpy().any()
    assert ctr["xfer_puts"] == 3 and ctr["xfer_bytes"] == (
        buf.nbytes + snap.nbytes + sum(a.nbytes for a in bd.values()))
    assert "transfer" in ctr["cpu_s_by_thread"]


def test_transferrers_on_one_device_share_one_stream(monkeypatch):
    """Every Transferrer on one device copies on one stream, made once in
    the process (a stream per run came round PyTorch's pool of 32 to the
    graphs' capture stream); another device has its own. The stream is a
    stand-in that counts its constructions: there is no card here."""
    made = []

    class Stream:
        def __init__(self, device):
            made.append(device)

    monkeypatch.setattr(pproducer.torch.cuda, "Stream", Stream)
    monkeypatch.setattr(pproducer, "_STREAMS", {})
    a, b = pproducer.Transferrer("cuda:0"), pproducer.Transferrer(torch.device("cuda:0"))
    other = pproducer.Transferrer("cuda:1")
    assert a.stream is b.stream and isinstance(a.stream, Stream)
    assert other.stream is not a.stream
    assert made == [torch.device("cuda:0"), torch.device("cuda:1")]
    assert pproducer.Transferrer("cpu").stream is None and len(made) == 2
