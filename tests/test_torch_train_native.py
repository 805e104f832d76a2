"""The port's training CLI on its default path — the C++ ingest, packed
superbatches and the transfer stage — on the CPU, against the JAX CLI's
default path (its native ingest) over the same data and flags: the ``-p``
files within 2e-6 (each side rounds to %.6f) and the ``-f --save_resume``
model files within rtol 1e-5 / atol 1e-6 in every table
(tests/test_torch_train_cli.py's bounds). The port's default path also
against its own ``--fwt_no_native`` path, and what it refuses."""

import logging

import numpy as np
import pytest

from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch import native
from fwumious_wabbit_tpu_torch.train.loop import main

from test_torch_train_cli import MODEL_ARGV, assert_same_model, data_file
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (  # noqa: F401 (jax_native_loaded: an autouse fixture)
    eat_rate_stream,
    jax_native_loaded,
)


def eat_rate_argv(tmp_path, rows=600):
    _, argv, _ = eat_rate_stream(tmp_path, rows)
    return argv + ["--data", str(tmp_path / f"train_{rows}.vw"),
                   "--fwt_batch_size", "64"]


def small_argv(tmp_path, n=120):
    return MODEL_ARGV + ["--data", str(data_file(tmp_path, n=n)),
                         "--fwt_batch_size", "16"]


def run(fn, argv, tmp_path, tag, extra=()):
    p, f = tmp_path / f"{tag}.out", tmp_path / f"{tag}.fwt"
    assert fn(argv + ["-p", str(p), "-f", str(f), "--save_resume", *extra]) == 0
    return np.array([float(x) for x in p.read_text().split()]), f


CASES = {
    "default": (small_argv, []),
    "power_t0": (small_argv, ["--power_t", "0"]),
    "holdout": (small_argv, ["--holdout_after", "50", "--predictions_after", "7"]),
    "bitpack_off": (small_argv, ["--fwt_bitpack", "off"]),
    "vocab_on": (eat_rate_argv, ["--fwt_vocab", "on"]),
    "fetch_stack": (small_argv, ["--fwt_superbatch", "2", "--fwt_fetch_stack", "4"]),
    "tail": (lambda t: eat_rate_argv(t, 555), ["--fwt_superbatch", "3"]),
    "exact": (lambda t: small_argv(t, 40), ["--fwt_exact"]),
    "delay": (small_argv, ["--prediction_model_delay", "40", "--power_t", "0"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_default_path_matches_jax(tmp_path, name):
    make_argv, flags = CASES[name]
    argv = make_argv(tmp_path) + flags
    jp, jf = run(jax_main, argv, tmp_path, "jax")
    pp, pf = run(main, argv, tmp_path, "port", ["--fwt_platform", "cpu"])
    assert pp.shape == jp.shape and pp.size >= 40
    np.testing.assert_allclose(pp, jp, rtol=0, atol=2e-6)
    assert np.abs(pp - 0.5).max() > 1e-3  # the model learned something
    assert_same_model(jf, pf)


@pytest.mark.parametrize("make_argv", [small_argv, eat_rate_argv],
                         ids=["variable_width", "eat_rate"])
def test_default_path_matches_the_python_path(tmp_path, make_argv):
    argv = make_argv(tmp_path) + ["--fwt_platform", "cpu"]
    pp, pf = run(main, argv, tmp_path, "native")
    qp, qf = run(main, argv, tmp_path, "python", ["--fwt_no_native"])
    np.testing.assert_allclose(pp, qp, rtol=0, atol=2e-6)
    assert_same_model(qf, pf)


def test_record_cache_is_refused(tmp_path, caplog):
    """A record cache the run cannot use — here one of another cache
    version — is refused with a warning and rebuilt from the text; the run
    trains as it does from the text."""
    argv = small_argv(tmp_path) + ["--fwt_platform", "cpu", "-c",
                                   "--fwt_pack_cache", "off"]
    cache = tmp_path / "d.vw.fwcache"
    first, _ = run(main, argv, tmp_path, "first")
    good = cache.read_bytes()
    cache.write_bytes(good[:4] + (10).to_bytes(4, "little") + good[8:])
    with caplog.at_level(logging.WARNING):
        again, _ = run(main, argv, tmp_path, "again")
    assert any("cache rejected (cache version 10 != 11)" in r.message
               for r in caplog.records)
    assert cache.read_bytes() == good
    np.testing.assert_array_equal(again, first)


def test_no_fallback_when_the_engine_cannot_be_built(tmp_path, monkeypatch):
    """The default path fails with the compiler's message and exits 1; it
    does not train through the Python ingest in its place. With
    --fwt_no_native the same run trains."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ["-include", "no_such.h"])
    out = tmp_path / "p.out"
    argv = small_argv(tmp_path) + ["--fwt_platform", "cpu", "-p", str(out)]
    assert main(argv) == 1
    assert "no_such.h" in native.load_error and not out.exists()
    assert main(argv + ["--fwt_no_native"]) == 0
    assert out.read_bytes().count(b"\n") == 120
