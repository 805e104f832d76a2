"""Juan et al.'s 39-field FFM at Criteo widths (F=39, k=4; the benchmark's
``criteo_ffm39`` configuration) through the port on the CPU, held to the
benchmark's plain reference (``portbench/reference_ffm.py``), which imports
nothing of the port.

Each slab is 156 floats at its id's 128-float row, so it spans two rows
and shares 28 floats with a slab at the next row: the port's generic FFM
path and its multi-row update (``tables.expand_grads`` + ``dedup_rows``,
and the batch-mean cap counted on the rows where it is on). The tables
are cut to 2^16 floats here; every width is the configuration's."""

import json

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu_torch.models.model import FwModel
from fwumious_wabbit_tpu_torch.train import step as step_mod
from fwumious_wabbit_tpu_torch.train.loop import run_train_loop
from portbench import cell as cellmod
from portbench import criteo, eatrate, features, reference, reference_ffm, spec

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

BITS = 16
TABLES = ("lr_w", "lr_acc", "ffm_w", "ffm_acc")
# the predictions: the -p file's six decimals (5e-7) and the same f32 sums
# in another order; the tables: f32 sums in another order (the port's
# float64 dedup and sorted update against the reference's scatter), as the
# port's other parity tests
PRED_ATOL = 1e-6
TABLE_RTOL, TABLE_ATOL = 1e-5, 1e-6


def config(name: str) -> dict:
    """A configuration of the benchmark with its tables cut to 2^16 floats
    (LR and FFM)."""
    cfg = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    argv = list(cfg["argv"])
    for flag in ("-b", "--ffm_bit_precision"):
        if flag in argv:
            argv[argv.index(flag) + 1] = str(BITS)
    cfg["argv"] = argv
    cfg["model"] = dict(cfg["model"], bit_precision=BITS, ffm_bit_precision=BITS)
    return cfg


class Program:
    """The port's model from the reference's initial weights, trained
    through ``run_train_loop`` (the CLI's training pass) over ``data``."""

    def __init__(self, cfg: dict, data, batch: int, K: int, seed: int, *extra: str):
        self.cfg, self.data = cfg, data
        self.flags = [*cfg["argv"], "--fwt_batch_size", str(batch), "--fwt_superbatch",
                      str(K), "--fwt_platform", "cpu", "--data", str(data), *extra]
        args = build_parser().parse_args(self.flags)
        self.vw = VwNamespaceMap.from_dataset_dir(str(data))
        self.mi = ModelInstance.from_cmdline(args, self.vw)
        self.model = FwModel(self.mi, batch_mean_mode=args.fwt_batch_mean or "auto")
        self.ref = reference_ffm
        st = reference_ffm.initial_weights(cfg["model"], seed, "cpu")
        self.model.load_params(cellmod.to_params(st, reference_ffm, cfg["model"]))

    def train(self, *extra: str) -> dict:
        args = build_parser().parse_args([*self.flags, *extra])
        return run_train_loop(args, self.mi, self.vw, self.model)

    def state(self) -> dict:
        return cellmod.snapshot(self.model, reference_ffm)


def reference_rows(cfg: dict, cols: dict, batch: int):
    ids = criteo.ids(cfg["model"], {})
    return reference_ffm.Rows(cfg["model"], ids.lr(cols), ids.ffm(cols), cols["label"],
                              batch, "cpu")


def assert_tables(got: dict, want: dict) -> None:
    for k in TABLES:
        torch.testing.assert_close(got[k], want[k], rtol=TABLE_RTOL, atol=TABLE_ATOL, msg=k)


@pytest.mark.parametrize("cap", [None, "on"])
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5])
def test_the_multipass_path_matches_the_reference(tmp_path, seed, cap):
    """Five batches of 64 and a partial one at K=2 (two superbatches, a
    tail and a per-batch step), recorded from the text and then replayed
    from the pack cache: each pass's predictions before each update and
    the tables after it, each pass from the port's own state before it.
    As configured (no batch-mean cap at power_t 0.5), and with the cap
    on, which the port counts on the card's rows for slabs across rows."""
    cfg, B = config("criteo_ffm39"), 64
    extra = ()
    if cap is not None:
        cfg["model"] = dict(cfg["model"], batch_mean=cap)
        extra = ("--fwt_batch_mean", cap)
    cols = criteo.columns({"lines": 5 * B + 17}, seed)
    criteo.write_text({}, cols, tmp_path / "train.vw")
    prog = Program(cfg, tmp_path / "train.vw", B, 2, seed, "--fwt_pack_cache", "on", *extra)
    rows = reference_rows(cfg, cols, B)
    start = prog.state()
    for tag in ("text", "replay"):
        preds = tmp_path / f"{tag}.txt"
        r = prog.train("-p", str(preds))
        assert r["examples"] == len(cols["label"])
        st = {k: v.clone() for k, v in start.items()}
        want = reference_ffm.run_pass(cfg["model"], st, rows).double().numpy()
        got = np.loadtxt(preds)
        np.testing.assert_allclose(got, want, rtol=0, atol=PRED_ATOL)
        start = prog.state()
        assert_tables(start, st)
        # the weights moved, the FFM's too
        assert not torch.equal(start["ffm_acc"], torch.zeros_like(start["ffm_acc"]))


@pytest.mark.parametrize("fault", [None, "half", "flip", "unchanged"])
def test_the_general_reference_is_the_eatrate_reference_at_two_fields(fault):
    """At F=2, k=8 (one 16-float slab a feature, keyed by its window) the
    reference of any width trains as reference.py's two-field reference
    does, bit for bit, faults included."""
    cell = spec.cell("lrffm_k8.multipass_b1024")
    m = cell.config["model"]
    cols = eatrate.draw(3 * 256 + 40, 11)
    ids = features.Ids(m, 1000, 10)
    lr, ffm = ids.lr(cols), ids.ffm(cols)
    out = []
    for ref in (reference, reference_ffm):
        rows = ref.Rows(m, lr, ffm, cols["label"], 256, "cpu")
        st = ref.initial_weights(m, 3, "cpu")
        out.append((ref.run_pass(m, st, rows, fault=fault), st))
    (p0, s0), (p1, s1) = out
    assert torch.equal(p0, p1)
    for k in TABLES:
        assert torch.equal(s0[k], s1[k]), k


def _pool(ns: str, model: dict, rng) -> tuple:
    """``(values, rows)``: random token values of namespace ``ns`` and the
    row (id >> 7) each one's slab starts at."""
    values = rng.integers(0, 1 << 32, 1 << 17, dtype=np.uint64)
    seed = int(features.murmur3_32([ns.encode()], 0)[0])
    h = features.murmur3_32([bytes(r) for r in criteo.hex_tokens(values)], seed)
    mask = ((1 << model["ffm_bit_precision"]) - 1) & ~3
    return values, ((h & np.uint32(0x7FFFFFFF)).astype(np.int64) & mask) >> 7


def edge_columns(case: str, n: int, model: dict, seed: int) -> dict:
    """Columns of ``n`` lines, each with a crafted pair of fields: ``I1``'s
    slab at row ``r`` and ``I2``'s at ``r + 1`` (the 28 floats they share;
    ``adjacent``), at the same row (``same_row``), or ``I1``'s at the
    table's last base row (``last_base``, its second row the padding)."""
    rng = np.random.default_rng(seed)
    cols = criteo.columns({"lines": n}, seed)
    last = (1 << model["ffm_bit_precision"]) // 128 - 1
    pools = [_pool(ns, model, rng) for ns in ("a", "b")]
    tok = [t.copy() for t in cols["tok"]]
    idx = cols["idx"]
    for i in range(n):
        r = last if case == "last_base" else int(rng.integers(0, last))
        want = [r] if case == "last_base" else [r, r + (case == "adjacent")]
        for f, row in enumerate(want):
            values, rows = pools[f]
            tok[f] = np.append(tok[f], np.uint32(rng.choice(values[rows == row])))
            idx[f, i] = len(tok[f]) - 1
    return dict(cols, tok=tok, idx=idx)


@pytest.mark.parametrize("case", ["adjacent", "same_row", "last_base"])
def test_slabs_that_share_rows_update_as_the_reference(tmp_path, case):
    """Slabs across two rows where an example's slabs overlap or reach
    the table's end: one pass of two batches of 32, predictions and
    tables against the reference."""
    cfg, B = config("criteo_ffm39"), 32
    m = cfg["model"]
    cols = edge_columns(case, 2 * B, m, 13)
    ids = criteo.ids(m, {}).ffm(cols)
    rows_a, rows_b = ids[:, 0] >> 7, ids[:, 1] >> 7
    if case == "adjacent":
        assert (rows_b == rows_a + 1).all()
    elif case == "same_row":
        assert (rows_b == rows_a).all()
    else:
        assert (rows_a == (1 << BITS) // 128 - 1).all()
    criteo.write_text({}, cols, tmp_path / "train.vw")
    prog = Program(cfg, tmp_path / "train.vw", B, 2, 13)
    st = prog.state()
    prog.train("-p", str(tmp_path / "p.txt"))
    want = reference_ffm.run_pass(m, st, reference_rows(cfg, cols, B)).double().numpy()
    np.testing.assert_allclose(np.loadtxt(tmp_path / "p.txt"), want, rtol=0, atol=PRED_ATOL)
    assert_tables(prog.state(), st)


@pytest.mark.parametrize("path", [[], ["--fwt_bitpack", "off"], ["--fwt_no_native"]],
                         ids=["native", "native_unpacked", "python"])
@pytest.mark.parametrize("name", ["criteo_ffm39", "lrffm_k8"])
def test_the_ffm_update_counter_counts_the_rows(tmp_path, monkeypatch, name, path):
    """``ffm_update_bytes`` over a call is Σ B·N·rows_per_slab·512 over its
    steps (B the step's rows, N its FFM entries an example, padding
    included): the bytes of the ``[K, 128]`` f32 rows each step's FFM scope
    handed the sparse update, as recorded here; ``ffm_update_examples`` is
    Σ B. 39·2·512 = 39,936 B an example at F=39, k=4 on the C++ ingest."""
    cfg, B = config(name), 64
    lines = 5 * B + 17
    if name == "criteo_ffm39":
        criteo.write_text({}, criteo.columns({"lines": lines}, 3), tmp_path / "train.vw")
    else:
        eatrate.write_dataset(tmp_path / "train.vw", lines, 3)
    handed = {"bytes": 0, "examples": 0}
    rows_of = step_mod.ffm_update_rows

    def recorded(model, bd, g_emb):
        rid, grows, pre = rows_of(model, bd, g_emb)
        assert grows.shape == (rid.shape[0], 128) and grows.dtype == torch.float32
        handed["bytes"] += grows.numel() * 4
        handed["examples"] += g_emb.shape[0]
        return rid, grows, pre

    monkeypatch.setattr(step_mod, "ffm_update_rows", recorded)
    prog = Program(cfg, tmp_path / "train.vw", B, 2, 3, *path)
    c = prog.train()["counters"]
    assert c["ffm_update_bytes"] == handed["bytes"] > 0
    assert c["ffm_update_examples"] == handed["examples"] >= lines
    if name == "criteo_ffm39" and "--fwt_no_native" not in path:
        n = c["ffm_update_examples"]
        assert c["ffm_update_bytes"] == n * 39 * 2 * 512
        assert step_mod.ffm_update_bytes(prog.model, n, 39) == c["ffm_update_bytes"]
