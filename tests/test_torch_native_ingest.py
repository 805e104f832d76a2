"""The port's C++ ingest bindings (fwumious_wabbit_tpu_torch/native:
``NativeIngest``, ``VocabEncoder``, ``bitpack_ids``, ``bitpack_mixed``,
``counts_table``) against the JAX package's, on the same inputs, bit for
bit: the hand-written streams of tests/test_torch_standalone.py (every
parser form, a ``--transform`` case) and the synthetic Eat-Rate stream;
batch fills, host counts, all-ones flags, widths, the carry of a block's
tail into the next, the end-of-stream offset, in-band commands and parse
errors. Each package builds its own library from its own sources."""

import numpy as np
import pytest

from fwumious_wabbit_tpu import native as jnative
from fwumious_wabbit_tpu.ingest import parser as jparser
from fwumious_wabbit_tpu_torch import native as pnative
from fwumious_wabbit_tpu_torch.ingest import parser as pparser

from test_torch_standalone import CSV, PIPELINES
from torch_parity import (  # noqa: F401 (jax_native_loaded: an autouse fixture)
    both_configs,
    eat_rate_stream,
    jax_native_loaded,
    require_jax_native,
)


def ingests(csv, argv, threads=3):
    """The JAX and the port ``NativeIngest`` of one configuration, with the
    configurations themselves."""
    (jmi, jvw), (pmi, pvw) = both_configs(csv, argv)
    return ((jnative.NativeIngest(jmi, jvw, threads), jmi),
            (pnative.NativeIngest(pmi, pvw, threads), pmi))


def assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def drive(ni, mi, text: bytes, B: int, chunk: int):
    """The stream's own loop, in small: translate ``chunk``-line blocks,
    emit full batches, carry each block's tail into the next, and all that
    is left at the end. Returns per batch the fill, the host counts, the
    all-ones flags, the widths and the end-of-stream offset."""
    lines = text.splitlines(keepends=True)
    blocks = [b"".join(lines[i:i + chunk]) for i in range(0, len(lines), chunk)]
    out, carried = [], False
    for i, block in enumerate(blocks + [b""]):
        if not block and not carried:
            break
        at_eof = i >= len(blocks) - 1
        n = ni.translate_block(block)
        L, N = ni.widths()
        L, N = max(L, 4), (max(N, 4) if mi.ffm_k > 0 else 0)
        s = 0
        while s < n:
            cap = min(B, n - s)
            if cap < B and not at_eof:
                break
            bd = ni.fill_range(s, cap, B, L, N)
            counts = {
                "lr": ni.batch_counts(bd["lr_ids"], bd["lr_combos"], 0),
                "lr_vals": ni.batch_counts(bd["lr_ids"], bd["lr_combos"], 0,
                                           vals=bd["lr_vals"]),
                "ffm": ni.batch_counts(bd["ffm_ids"], bd["ffm_fields"], 3),
            }
            out.append((bd, counts, ni.all_ones_flags(), (L, N),
                        ni.stop_offset()))
            s += cap
        carried = s < n
        if carried:
            ni.carry_tail(s)
    return out


def eat_rate(tmp_path):
    csv, argv, text = eat_rate_stream(tmp_path, 300)
    return csv, argv, text


STREAMS = {name: (argv, b"".join(lines * 9))
           for name, (argv, lines) in PIPELINES.items()}


@pytest.mark.parametrize("name", [*STREAMS, "eat_rate"])
@pytest.mark.parametrize("B,chunk", [(8, 5), (16, 200)], ids=["carry", "one_block"])
def test_stream_matches_jax(tmp_path, name, B, chunk):
    if name == "eat_rate":
        csv, argv, text = eat_rate(tmp_path)
    else:
        csv, (argv, text) = CSV, STREAMS[name]
    (jni, jmi), (pni, pmi) = ingests(csv, argv)
    want, got = drive(jni, jmi, text, B, chunk), drive(pni, pmi, text, B, chunk)
    assert len(got) == len(want) > 1
    for (gbd, gc, gf, gw, gs), (wbd, wc, wf, ww, ws) in zip(got, want):
        assert_same(gbd, wbd)
        assert_same(gc, wc)
        assert (gf, gw, gs) == (wf, ww, ws)
    assert sum(int((bd["label"] != 0).sum()) for bd, *_ in got) > 0


def test_end_of_stream_offset_matches_jax():
    argv, lines = PIPELINES["hand_lr_ffm"]
    text = b"".join(lines[:3]) + b"\n" + b"".join(lines[3:])
    (jni, _), (pni, _) = ingests(CSV, argv)
    assert pni.translate_block(text) == jni.translate_block(text) == 3
    assert pni.stop_offset() == jni.stop_offset() > 0


@pytest.mark.parametrize("line,exc", [
    (b"flush\n", "FlushCommand"), (b"hogwild_load /m.fwt\n", "HogwildLoadCommand"),
    (b"1 |Z nope\n", None), (b"x |A a\n", None)])
def test_in_band_commands_and_errors_match_jax(line, exc):
    argv, lines = PIPELINES["hand_lr_ffm"]
    text = b"".join(lines[:2]) + line + lines[2]
    (jni, _), (pni, _) = ingests(CSV, argv)
    raised = []
    for ni, mod in ((jni, jparser), (pni, pparser)):
        with pytest.raises(getattr(mod, exc) if exc else ValueError) as e:
            ni.translate_block(text)
        raised.append(str(e.value))
    assert raised[0] == raised[1]


def test_bitpackers_and_counts_table_match_jax():
    rng = np.random.default_rng(3)
    for bits, W, B in [(27, 13, 64), (22, 4, 32), (25, 5, 16), (31, 33, 8)]:
        a = rng.integers(0, 1 << bits, (B, W)).astype(np.int32)
        words = (W * bits + 31) // 32
        got = pnative.bitpack_ids(a, bits, words)
        assert got.tobytes() == jnative.bitpack_ids(a, bits, words).tobytes()
        if bits < 31:
            a[0, 0] = 1 << bits  # overflows: both refuse
            assert pnative.bitpack_ids(a, bits, words) is False
            assert jnative.bitpack_ids(a, bits, words) is False
    widths = np.array([6, 25, 4, 12, 14], np.int32)
    a = np.stack([rng.integers(0, 1 << w, 300) for w in widths], 1).astype(np.int32)
    words = (int(widths.sum()) + 31) // 32
    assert (pnative.bitpack_mixed(a, widths, words).tobytes()
            == jnative.bitpack_mixed(a, widths, words).tobytes())
    idx = rng.integers(0, 40, (256, 4)).astype(np.int32)
    codes = rng.integers(0, 200, (256, 5)).astype(np.uint8)[:, 1:]  # a view
    bases = [0, -1, 64, 128]
    assert (pnative.counts_table(idx, codes, bases, 256).tobytes()
            == jnative.counts_table(idx, codes, bases, 256).tobytes())


def test_vocab_encoder_matches_jax():
    """Dictionaries minted in first-seen order, a column that overflows
    its cap turning direct, the combo row of combo-packed ids, exports
    capped at a region, the dirty flag: equal in both packages."""
    rng = np.random.default_rng(11)
    encs = [pnative.VocabEncoder(4, 64), jnative.VocabEncoder(4, 64)]
    for step in range(3):
        ids = np.stack([rng.integers(0, 30, 128), rng.integers(0, 500, 128),
                        rng.integers(0, 1 << 25, 128),
                        np.full(128, 7)], 1).astype(np.int32)
        combos = np.broadcast_to(np.arange(4, dtype=np.int32), (128, 4))
        packed = ids | ((combos + 1) << 25)
        res = [e.encode2(packed[:, :3], 25, (1 << 25) - 1) for e in encs]
        for x, y in zip(*res):
            assert x.tobytes() == y.tobytes()
        for col in range(3):
            assert encs[0].col_size(col) == encs[1].col_size(col)
            assert encs[0].col_direct(col) == encs[1].col_direct(col)
            cap = 16
            assert (encs[0].export_col(col, cap).tobytes()
                    == encs[1].export_col(col, cap).tobytes())
        assert encs[0].dirty == encs[1].dirty
        for e in encs:
            e.clear_dirty()
    assert encs[0].col_direct(1) and encs[0].col_direct(2)
    bad = packed[:, :3].copy()
    bad[5, 0] = (bad[5, 0] & ((1 << 25) - 1)) | (3 << 25)  # a row of other combos
    assert encs[0].encode2(bad, 25, (1 << 25) - 1) is None
    assert encs[1].encode2(bad, 25, (1 << 25) - 1) is None
    for e in encs:
        e.close()


def test_jax_library_loads_after_a_failed_first_attempt(monkeypatch):
    """torch_parity.require_jax_native: a process whose first load of the
    JAX package's library failed (the module then keeps None) loads it on
    the locked retry instead of comparing against JAX's Python path."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_tried", True)
    assert jnative.load() is None
    lib = require_jax_native()
    assert lib is not None and jnative.load() is lib
