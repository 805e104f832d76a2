"""The training path's transfer stage and packed step on the card
(fwumious_wabbit_tpu_torch/train/producer.py ``Transferrer``,
train/packed.py ``make_packed_train_step``): 64 superbatches of distinct
contents staged back to back through the ring of pinned buffers while the
copy stream is held back, each arriving byte-equal (a pinned buffer reused
before its copy completed would corrupt a batch without any error); the
same through the transfer thread's body; and K train steps from one packed
superbatch equal to K steps from the same batches sent one at a time,
within 1e-6. Skips without a card. This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_transfer_cuda.py
"""

import queue

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu_torch import synthetic
from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu_torch.models.model import FwModel
from fwumious_wabbit_tpu_torch.train import packed
from fwumious_wabbit_tpu_torch.train.producer import (
    SuperbatchProducer,
    Transferrer,
    arrived,
    run_transferrer,
)
from fwumious_wabbit_tpu_torch.train.step import make_train_step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the transfer stage's events and "
                    "pinned ring have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def superbatches(n=64, K=8, words=131072):
    """``n`` [K, words] u32 buffers (4 MiB each), every one distinct."""
    base = np.arange(K * words, dtype=np.uint32).reshape(K, words)
    return [base * np.uint32(2 * i + 1) + np.uint32(i) for i in range(n)]


@pytest.mark.cuda
def test_ring_reuses_a_buffer_only_after_its_copy(cuda):
    bufs = superbatches()
    tr = Transferrer(cuda)
    with torch.cuda.stream(tr.stream):
        torch.cuda._sleep(200_000_000)  # hold the copies back (~0.1 s)
    staged = [tr.stage([b]) for b in bufs]
    for (dev, ev), b in zip(staged, bufs):
        got = arrived(dev[0], ev)
        assert got.dtype == torch.int32 and got.device == cuda
        assert torch.equal(got.cpu(), torch.from_numpy(b.view(np.int32)))


@pytest.mark.cuda
def test_transfer_thread_body_delivers_every_item(cuda):
    bufs = superbatches(n=16)
    q, q2 = queue.Queue(), queue.Queue()
    snap = np.arange(256, dtype=np.int32).reshape(2, 128)
    bd = {"label": np.ones(64, np.uint8), "lr_ids": np.arange(64 * 5, dtype=np.int32)
          .reshape(64, 5), "ffm_ids": np.zeros((64, 0), np.int32)}
    for i, b in enumerate(bufs):
        q.put(("p", b, None, i))
        if i == 7:
            q.put(("v", snap))
            q.put(("s", bd, 64))
    q.put(None)
    ctr = {"xfer_starve_s": 0.0, "xfer_busy_s": 0.0, "xfer_stall_s": 0.0,
           "xfer_bytes": 0, "xfer_puts": 0}
    run_transferrer(q, q2, ctr, {"starve_s": 0.0, "xfer_s": 0.0, "put_s": 0.0,
                                 "bytes": 0}, cuda)
    seen = 0
    while (item := q2.get()) is not None:
        assert not isinstance(item, BaseException), item
        if item[0] == "p":
            _, dev, _, i, ev = item
            assert torch.equal(arrived(dev, ev).cpu(),
                               torch.from_numpy(bufs[i].view(np.int32)))
            seen += 1
        elif item[0] == "v":
            assert torch.equal(arrived(item[1], item[2]).cpu(), torch.from_numpy(snap))
        else:
            _, dbd, n, ev = item
            assert n == 64 and sorted(dbd) == sorted(bd)
            for k, v in dbd.items():
                assert torch.equal(arrived(v, ev).cpu(), torch.from_numpy(bd[k]))
    assert seen == 16 and ctr["xfer_puts"] == 18


def eat_rate(tmp_path, rows=4096):
    data = synthetic.ensure_dataset(tmp_path, rows)
    argv = synthetic.serving_argv()
    argv[argv.index("-b") + 1] = "18"
    argv[argv.index("--ffm_bit_precision") + 1] = "18"
    args = build_parser().parse_args(argv + ["--data", str(data)])
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    return args, ModelInstance.from_cmdline(args, vw), vw


def stream(args, mi, vw, K, B, count_keys):
    class Sink(list):
        put = list.append

    sink = Sink()
    state = packed.VocabTransferState()
    SuperbatchProducer(
        args, mi, vw, batch_size=B, K=K, can_pack=K > 1,
        count_keys=count_keys, cut_at=None, holdout_after=None,
        out_queue=sink, ctr={"producer_stall_s": 0.0},
        xfer_stats={"starve_s": 0.0, "xfer_s": 0.0, "put_s": 0.0, "bytes": 0},
        vocab_state=state).run()
    state.close()
    return sink


@pytest.mark.cuda
def test_packed_k_steps_equal_k_single_steps(cuda, tmp_path):
    args, mi, vw = eat_rate(tmp_path)
    K, B = 4, 256
    spec = FwModel(mi).ffm_spec
    keys = {"lr": 0, "ffm": (spec.align - 1).bit_length()}  # the loop's
    packed_items = [i for i in stream(args, mi, vw, K, B, keys) if i is not None]
    single = [i for i in stream(args, mi, vw, 1, B, keys) if i is not None]
    vocab, done = None, 0  # the snapshot in force; batches before the group
    for item in packed_items:
        if item[0] == "v":
            vocab = torch.from_numpy(item[1]).to(cuda)
        elif item[1].shape[0] == K:
            break
        else:
            done += item[1].shape[0]
    _, buf, lay, gn, *_ = item
    assert gn == K * B and lay.vocabs and lay.bitpacks and lay.bit_cols
    models = []
    for _ in range(2):
        m = FwModel(mi)
        m.load_params(m.init_params(cuda))
        models.append(m)
    step = packed.make_packed_train_step(models[0], lay, K)
    got = step(torch.from_numpy(buf.view(np.int32)).to(cuda), vocab)
    one = make_train_step(models[1], graph=False)
    want = torch.stack([one({k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
                             for k, v in bd.items()})
                        for _, bd, _n in single[done:done + K]])
    assert got.shape == want.shape == (K, B)
    assert (got - want).abs().max().item() <= 1e-6
    for key in ("lr_w", "lr_acc", "ffm_w", "ffm_acc"):
        a, b = getattr(models[0], key), getattr(models[1], key)
        assert (a - b).abs().max().item() <= 1e-6, key
    assert (models[0].ffm_w != FwModel(mi).init_params("cpu")["ffm_w"].to(cuda)).any()
