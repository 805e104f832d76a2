"""The producer's adaptive settings in combination, through the port's CLI
(the counterpart of tests/test_auto_matrix.py, its seven ``CI_COMBOS``):
vocabulary encoding (with its forced mid-run flip), id bit-packing,
superbatching, the fetch ring, the batch-mean cap and the pack cache's
record and replay interact inside one producer. Each is a re-encoding of
the transfer or the dispatch, not of the arithmetic, so every combination's
``-p`` and ``-f`` must be byte-identical to the port's plain unpacked path,
and its ``-p`` within one unit of the sixth decimal of the JAX CLI's. The
JAX CLI's ``-p`` is run once, on its plain path: tests/test_auto_matrix.py
holds each of its combinations byte-identical to that file.

The ``pallas`` axis is a flag that only parses in the port: on a CUDA
tensor the sparse update kernel always runs, and on the CPU its plain
version does (the JAX CPU backend likewise only parses it)."""

import shutil

import numpy as np
import pytest

from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch.train.loop import main

from test_auto_matrix import AXES, CI_COMBOS, _argv
from test_end_to_end import FLAGS, gen_dataset
from torch_parity import jax_native_loaded, one_torch_thread  # noqa: F401 (autouse)

PRED_UNIT = 1e-6 * (1 + 1e-6)  # one unit of the %.6f file's last digit


def preds(path) -> np.ndarray:
    return np.array([float(x) for x in path.read_text().split()])


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """The plain unpacked path (no slimming, no superbatch, no ring, the
    batch-mean cap on: what auto resolves to at power_t 0) of the port and
    of the JAX CLI."""
    d = tmp_path_factory.mktemp("torch_auto_matrix")
    gen_dataset(d, n_train=6000, n_eval=10)
    argv = FLAGS + ["--data", str(d / "train.vw"), "--save_resume",
                    "--fwt_vocab", "off", "--fwt_bitpack", "off",
                    "--fwt_superbatch", "1", "--fwt_fetch_stack", "0",
                    "--fwt_pallas_update", "off", "--fwt_batch_mean", "on",
                    "--fwt_pack_cache", "off"]
    p, f = d / "plain.preds", d / "plain.fwt"
    assert main(argv + ["-p", str(p), "-f", str(f)]) == 0
    jp = d / "jax.preds"
    assert jax_main(argv + ["-p", str(jp), "-f", str(d / "jax.fwt")]) == 0
    return d, p.read_text(), f.read_bytes(), preds(jp)


@pytest.mark.parametrize(
    "combo", CI_COMBOS,
    ids=["-".join(f"{k[:2]}{v}" for k, v in c.items()) for c in CI_COMBOS])
def test_auto_mode_matrix(plain, combo, tmp_path, monkeypatch):
    assert set(combo) == set(AXES)
    d, base_preds, base_model, want = plain
    monkeypatch.setenv("FWT_VOCAB_FLIP", "force" if combo["vocab"] == "flip" else "off")
    data = d / "train.vw"
    if combo["pack_cache"] == "replay":  # the .fwpack sits beside the data
        data = tmp_path / "train.vw"
        shutil.copy(d / "train.vw", data)
        shutil.copy(d / "vw_namespace_map.csv", tmp_path / "vw_namespace_map.csv")
    passes = ["record", "replay"] if combo["pack_cache"] == "replay" else ["live"]
    for name in passes:
        p, f = tmp_path / f"{name}.preds", tmp_path / f"{name}.fwt"
        assert main(_argv(combo, data, p, f)) == 0
        assert p.read_text() == base_preds, f"{name} pass diverged"
        assert f.read_bytes() == base_model, f"{name} pass's model diverged"
        got = preds(p)
        assert got.shape == want.shape == (6000,)
        assert float(np.abs(got - want).max()) <= PRED_UNIT
