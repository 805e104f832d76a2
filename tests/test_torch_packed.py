"""The port's superbatch packing (fwumious_wabbit_tpu_torch/train/packed.py)
against the JAX package's: the host half (slimming, encoders,
``prepare_for_transfer``, ``layout_of``, ``pack``, ``try_fused_emit``) writes
the same bytes and layouts; the port's PyTorch ``unpack_row`` returns what
the JAX ``unpack_row`` returns from the same packed row, for every kind of
layout entry (raw fields of every dtype, appends, bit-packs with
word-crossing widths, row broadcasts, dictionary and direct vocab columns,
count tables, 1-bit columns), one row or a whole superbatch at once; and
the port's CLI trains byte-identically with ``--fwt_superbatch 1`` and 3."""

import numpy as np
import pytest
import torch

import jax

from fwumious_wabbit_tpu import native as jnative
from fwumious_wabbit_tpu.train import packed as jpacked
from fwumious_wabbit_tpu_torch import native as pnative
from fwumious_wabbit_tpu_torch.train import packed as ppacked
from fwumious_wabbit_tpu_torch.train.loop import main

from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (  # noqa: F401 (jax_native_loaded: an autouse fixture)
    both_configs,
    eat_rate_stream,
    jax_native_loaded,
)


class MI:
    """The fields of a model configuration the transfer slimming reads."""

    def __init__(self, bits=25, combos=13, ffm_k=0, ffm_bits=0):
        self.bit_precision = bits
        self.lr_hash_mask = (1 << bits) - 1
        self.num_combos = combos
        self.ffm_k = ffm_k
        self.ffm_bit_precision = ffm_bits


def assert_arrays_equal(got, want, key=""):
    got = np.ascontiguousarray(got)
    want = np.ascontiguousarray(want)
    assert got.shape == want.shape and got.dtype.itemsize == want.dtype.itemsize, key
    assert got.tobytes() == want.tobytes(), key


def assert_unpack_matches(bds: list, spec: tuple, vocab=None):
    """Layouts of both packages from the same slim dicts and spec, equal
    signatures and packed bytes; then the port's unpack_row of the whole
    superbatch and of each row against JAX's unpack_row of each row."""
    jlay = jpacked.layout_of(bds[0], *spec)
    play = ppacked.layout_of(bds[0], *spec)
    assert jlay is not None and play.signature == jlay.signature
    buf = jpacked.pack(jlay, bds)
    assert ppacked.pack(play, bds).tobytes() == buf.tobytes()
    tbuf = torch.from_numpy(buf.view(np.int32))
    tvocab = None if vocab is None else torch.from_numpy(vocab)
    whole = ppacked.unpack_row(tbuf, play, tvocab)
    unpack = jax.jit(lambda r, v: jpacked.unpack_row(r, jlay, v))
    for k in range(len(bds)):
        want = unpack(buf[k], vocab)
        one = ppacked.unpack_row(tbuf[k], play, tvocab)
        assert sorted(one) == sorted(whole) == sorted(want)
        for key in want:
            assert_arrays_equal(one[key].numpy(), np.asarray(want[key]), key)
            assert_arrays_equal(whole[key][k].numpy(), np.asarray(want[key]), key)
    return whole


def test_fields_of_every_dtype():
    rng = np.random.default_rng(0)
    bds = [{
        "label": rng.integers(0, 2, 64).astype(np.uint8),
        "lr_ids": rng.integers(0, 1 << 25, (64, 5)).astype(np.int32),
        "lr_vals": rng.normal(size=(64, 5)).astype(np.float32),
        "lr_combos": rng.integers(-1, 4, (64, 5)).astype(np.int8),
        "idx16": rng.integers(0, 1 << 16, (64, 2)).astype(np.uint16),
        "i16": rng.integers(-100, 100, (64, 2)).astype(np.int16),
        "u32": rng.integers(0, 1 << 32, (64, 3), dtype=np.uint64).astype(np.uint32),
    } for _ in range(3)]
    assert_unpack_matches(bds, ())
    assert ppacked.layout_of({"a": np.zeros(3, np.uint8)}) is None
    assert ppacked.layout_of({"a": np.zeros(4, np.float64)}) is None


def test_appends_of_the_constant_column():
    B, L = 64, 5
    rng = np.random.default_rng(1)
    const_id = (jpacked.CONSTANT_HASH & ((1 << 18) - 1)) | (3 << 18)
    bd = {"label": rng.integers(0, 2, B).astype(np.uint8),
          "lr_ids": np.concatenate(
              [rng.integers(0, 1 << 18, (B, L - 1)).astype(np.int32),
               np.full((B, 1), const_id, np.int32)], axis=1),
          "lr_counts": np.concatenate(
              [rng.integers(1, 5, (B, L - 1)).astype(np.uint8),
               np.full((B, 1), 64, np.uint8)], axis=1)}
    jslim, jap = jpacked.strip_constant_columns(bd, (1 << 18) - 1)
    pslim, pap = ppacked.strip_constant_columns(bd, (1 << 18) - 1)
    assert pap == jap == (("lr_ids", const_id), ("lr_counts", 64))
    for key in jslim:
        assert_arrays_equal(pslim[key], jslim[key], key)
    out = assert_unpack_matches([pslim], (pap,))
    assert_arrays_equal(out["lr_ids"][0].numpy(), bd["lr_ids"])


@pytest.mark.parametrize("bits,W,B", [(27, 13, 64), (22, 4, 32), (25, 5, 16),
                                      (31, 33, 8)])
def test_bitpacks_with_word_crossing_widths(bits, W, B):
    rng = np.random.default_rng(bits)
    bds, spec = [], None
    for _ in range(2):
        ids = rng.integers(0, 1 << bits, (B, W)).astype(np.int32)
        ids[rng.random((B, W)) < 0.2] = 0  # padding entries
        bd = {"lr_ids": ids, "label": rng.integers(0, 2, B).astype(np.uint8)}
        jbd, jbp = jpacked.bitpack_ids(bd, "lr_ids", bits)
        pbd, pbp = ppacked.bitpack_ids(bd, "lr_ids", bits)
        assert pbp == jbp == (("lr_ids", bits, W),)
        assert_arrays_equal(pbd["lr_ids"], jbd["lr_ids"])
        bds.append(pbd)
        spec = ((), pbp)
    out = assert_unpack_matches(bds, spec)
    assert out["lr_ids"].dtype == torch.int32


def test_row_broadcasts_and_bit_columns():
    rng = np.random.default_rng(3)
    B = 64
    fields = np.tile(np.array([0, 0, 1, 1, -1], np.int8), (B, 1))
    bd = {"ffm_fields": fields,
          "ffm_ids": rng.integers(0, 1 << 20, (B, 5)).astype(np.int32),
          "label": rng.integers(0, 2, B).astype(np.uint8)}
    pbd, prb = ppacked.strip_uniform_rows(bd, "ffm_fields")
    jbd, jrb = jpacked.strip_uniform_rows(bd, "ffm_fields")
    assert prb == jrb == (("ffm_fields", "|i1", (0, 0, 1, 1, -1), B),)
    pbd, pbc = ppacked.bitpack_labels(pbd)
    jbd, jbc = jpacked.bitpack_labels(jbd)
    assert pbc == jbc == (("label", B),)
    assert_arrays_equal(pbd["label"], jbd["label"])
    out = assert_unpack_matches([pbd], ((), (), prb, (), (), pbc))
    assert_arrays_equal(out["ffm_fields"][0].numpy(), fields)
    assert_arrays_equal(out["label"][0].numpy(), bd["label"])


def test_uniform_combos_leave_the_ids():
    mi = MI()
    B, W = 64, 14
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 1 << 25, (B, W)).astype(np.int32)
    combos = np.broadcast_to(np.arange(W, dtype=np.int32), (B, W))
    ids = (raw | ((combos + 1) << 25)).astype(np.int32)
    ids[:, -1] = (jpacked.CONSTANT_HASH & mi.lr_hash_mask) | (W << 25)
    bd = {"label": rng.integers(0, 2, B).astype(np.uint8), "lr_ids": ids,
          "lr_counts": np.full((B, W), 120, np.uint8)}
    jslim, *jspec = jpacked.prepare_for_transfer(dict(bd), mi)
    pslim, *pspec = ppacked.prepare_for_transfer(dict(bd), mi)
    assert pspec == jspec
    assert pspec[1] == (("lr_ids", 25, W - 1),)
    for key in jslim:
        assert_arrays_equal(pslim[key], jslim[key], key)
    out = assert_unpack_matches([pslim], tuple(pspec))
    assert_arrays_equal(out["lr_ids"][0].numpy(), ids & mi.lr_hash_mask)


def vocab_batches(seed, B=512, W=4):
    """Batches whose columns have 40 and 90 distinct ids, random ids and one
    id, combo-packed, with count codes a function of the id."""
    rng = np.random.default_rng(seed)
    va = rng.integers(0, 1 << 25, 40).astype(np.int32)
    vb = rng.integers(0, 1 << 25, 90).astype(np.int32)
    out = []
    for s in range(3):
        r = np.random.default_rng(seed + 100 + s)
        ids = np.stack([va[r.integers(0, 40, B)], vb[r.integers(0, 90, B)],
                        r.integers(0, 1 << 25, B).astype(np.int32),
                        np.full(B, 999, np.int32)], axis=1)
        combos = np.broadcast_to(np.arange(W, dtype=np.int32), (B, W))
        out.append({"label": r.integers(0, 2, B).astype(np.uint8),
                    "lr_ids": (ids | ((combos + 1) << 25)).astype(np.int32),
                    "lr_counts": ((ids % 200) + 1).astype(np.uint8)})
    return out


@pytest.mark.parametrize("with_counts", [False, True], ids=["vocabs", "count_tabs"])
def test_vocab_columns_and_count_tables(with_counts):
    """Dictionary columns (resolved against the snapshot) and direct ones
    (a column past the dictionary cap, random ids); with counts, the u8
    count table of the dictionary columns and the narrowed per-entry codes
    of the direct ones."""
    mi = MI(combos=3)
    states = (jpacked.VocabTransferState(max_cap=64),
              ppacked.VocabTransferState(max_cap=64))
    slims, spec = [], None
    for bd in vocab_batches(11):
        if not with_counts:
            del bd["lr_counts"]
        jslim, *jspec = jpacked.prepare_for_transfer(dict(bd), mi, vocab_state=states[0])
        pslim, *pspec = ppacked.prepare_for_transfer(dict(bd), mi, vocab_state=states[1])
        assert pspec == jspec
        for key in jslim:
            assert_arrays_equal(pslim[key], jslim[key], key)
        assert spec is None or tuple(pspec) == spec
        slims.append(pslim)
        spec = tuple(pspec)
    vocabs, count_tabs = spec[3], spec[4]
    _key, _widths, bases, _n_rows = vocabs[0]
    assert min(bases) < 0 <= max(bases)  # dictionary and direct columns
    assert bool(count_tabs) == with_counts
    snaps = [m.export_vocab(s.venc, vocabs[0]) for m, s in zip((jpacked, ppacked), states)]
    assert_arrays_equal(snaps[1], snaps[0])
    out = assert_unpack_matches(slims, spec, snaps[1])
    want = vocab_batches(11)[1]
    assert_arrays_equal(out["lr_ids"][1].numpy(), want["lr_ids"] & mi.lr_hash_mask)
    if with_counts:
        assert_arrays_equal(out["lr_counts"][1].numpy(), want["lr_counts"])
    for s in states:
        s.close()


def native_batches(mi, vw, module, text, B, n_batches, count_shift):
    """Full batches from a NativeIngest of ``module`` as the stream slims
    them (host counts, combos packed into the ids, all-ones arrays left
    out, u8 labels)."""
    ni = module.NativeIngest(mi, vw, 2)
    n = ni.translate_block(text)
    L, N = ni.widths()
    out = []
    for s in range(0, min(n, B * n_batches), B):
        bd = ni.fill_range(s, B, B, max(L, 4), max(N, 4))
        bd["lr_counts"] = ni.batch_counts(bd["lr_ids"], bd["lr_combos"], 0)
        bd["ffm_counts"] = ni.batch_counts(bd["ffm_ids"], bd["ffm_fields"], count_shift)
        c32 = (bd.pop("lr_combos").astype(np.int32) + 1) << mi.bit_precision
        bd["lr_ids"] |= c32
        del bd["lr_vals"], bd["ffm_vals"], bd["importance"]
        bd["label"] = bd["label"].astype(np.uint8)
        out.append(bd)
    return ni, out


@pytest.mark.parametrize("vocab", [False, True], ids=["bitpack", "vocab"])
def test_prepare_for_transfer_on_eat_rate_batches(tmp_path, vocab):
    csv, argv, text = eat_rate_stream(tmp_path, 1024)
    (jmi, jvw), (pmi, pvw) = both_configs(csv, argv)
    _, jb = native_batches(jmi, jvw, jnative, text, 256, 4, 3)
    _, pb = native_batches(pmi, pvw, pnative, text, 256, 4, 3)
    states = ((jpacked.VocabTransferState(), ppacked.VocabTransferState())
              if vocab else (None, None))
    slims, spec = [], None
    for jbd, pbd in zip(jb, pb):
        jslim, *jspec = jpacked.prepare_for_transfer(jbd, jmi, vocab_state=states[0])
        pslim, *pspec = ppacked.prepare_for_transfer(pbd, pmi, vocab_state=states[1])
        assert pspec == jspec
        assert (ppacked.layout_of(pslim, *pspec).signature
                == jpacked.layout_of(jslim, *jspec).signature)
        for key in jslim:
            assert_arrays_equal(pslim[key], jslim[key], key)
        if spec is None or tuple(pspec) == spec:
            slims.append(pslim)
            spec = tuple(pspec)
    assert bool(spec[3]) == vocab
    snap = ppacked.export_vocab(states[1].venc, spec[3][0]) if vocab else None
    assert_unpack_matches(slims, spec, snap)
    for s in states:
        if s is not None:
            s.close()


def test_try_fused_emit_matches_jax(tmp_path):
    """The fused wire emit of a full batch after a general batch minted
    the dictionaries: the same slim arrays and layout in both packages,
    and the same as the general chain for that batch."""
    (tmp_path / "vw_namespace_map.csv").write_text("A,animal\nB,food\n")
    rng = np.random.default_rng(11)
    text = "".join(f"{1 if rng.integers(0, 2) else -1} |A a{rng.integers(0, 20)} "
                   f"|B b{rng.integers(0, 15)}\n" for _ in range(4096)).encode()
    argv = ["-l", "0.1", "-b", "18", "--adaptive", "--power_t", "0.0",
            "--interactions", "AB", "--keep", "A", "--keep", "B"]
    csv = (tmp_path / "vw_namespace_map.csv").read_text()
    B = 2048
    results = []
    for (mi, vw), module, packed in zip(both_configs(csv, argv),
                                        (jnative, pnative), (jpacked, ppacked)):
        ni, bds = native_batches(mi, vw, module, text, B, 1, 0)
        state = packed.VocabTransferState()
        packed.prepare_for_transfer(bds[0], mi, vocab_state=state)
        L, _ = ni.widths()
        res = packed.try_fused_emit(ni, B, B, L, mi, state, with_counts=True)
        assert res is not None
        results.append(res)
        state.close()
    (jres, pres) = results
    assert pres.lay.signature == jres.lay.signature
    assert sorted(pres.slim) == sorted(jres.slim)
    for key in jres.slim:
        assert_arrays_equal(pres.slim[key], jres.slim[key], key)


def test_superbatch_1_and_3_train_byte_identically(tmp_path):
    """--fwt_superbatch 1 (every batch on its own) and 3 (packed groups,
    a holdout boundary inside the data) on the CPU: byte-identical -p and
    -f files."""
    csv, argv, text = eat_rate_stream(tmp_path, 1500)
    data = tmp_path / "train_1500.vw"
    base = argv + ["--data", str(data), "--fwt_batch_size", "128",
                   "--holdout_after", "1300", "--save_resume",
                   "--fwt_platform", "cpu"]
    outs = []
    for K in ("1", "3"):
        p, f = tmp_path / f"{K}.preds", tmp_path / f"{K}.fwt"
        assert main(base + ["-p", str(p), "-f", str(f), "--fwt_superbatch", K]) == 0
        outs.append((p.read_bytes(), f.read_bytes()))
    assert outs[0][0].count(b"\n") == 1500
    assert outs[0] == outs[1]
