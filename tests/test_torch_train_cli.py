"""The port's training CLI (python -m fwumious_wabbit_tpu_torch, training mode)
on its Python-ingest path (``--fwt_no_native``), on the CPU, against the JAX
package's CLI on the same path, over the same data and flags: the ``-p`` files within
2e-6 (each side rounds to %.6f) and the ``-f --save_resume`` model files
equal in layout and header and within rtol 1e-5 / atol 1e-6 in every table
(the same sums in other orders)."""

from pathlib import Path

import numpy as np
import pytest

from fwumious_wabbit_tpu.persistence import model_file as jmf
from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch.train.loop import main

from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (  # noqa: F401 (jax_native_loaded: an autouse fixture)
    BASE_ARGV,
    FFM_ARGV,
    jax_native_loaded,
    make_vw,
    to_numpy,
    vw_lines,
)


MODEL_ARGV = [a for a in BASE_ARGV if a not in ("--data", "x")] + FFM_ARGV


def data_file(tmp_path, n=120, seed=5) -> Path:
    make_vw(tmp_path)
    data = tmp_path / "d.vw"
    data.write_bytes(b"".join(vw_lines(n, seed=seed)))
    return data


def run_both(tmp_path, argv):
    """Both CLIs with ``argv`` plus -p and -f; returns the two (preds, model
    path) pairs."""
    out = {}
    for side, fn, extra in (("jax", jax_main, ["--fwt_no_native"]),
                            ("port", main, ["--fwt_platform", "cpu",
                                            "--fwt_no_native"])):
        p, f = tmp_path / f"{side}.out", tmp_path / f"{side}.fwt"
        assert fn(argv + ["-p", str(p), "-f", str(f), "--save_resume", *extra]) == 0
        out[side] = (np.array([float(x) for x in p.read_text().split()]), f)
    return out["jax"], out["port"]


def assert_same_model(jax_path, port_path):
    assert jax_path.stat().st_size == port_path.stat().st_size
    jmi, jvw, _, jparams = jmf.load_model(jax_path)
    mi, vw, _, params = jmf.load_model(port_path)
    assert mi.to_json() == jmi.to_json()
    assert vw.to_source_json() == jvw.to_source_json()
    jparams, params = to_numpy(jparams), to_numpy(params)
    assert set(params) == set(jparams) == {"lr_w", "lr_acc", "ffm_w", "ffm_acc"}
    for key in params:
        np.testing.assert_allclose(params[key], jparams[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("flags", [
    [],
    ["--power_t", "0"],  # the batch-mean cap with host counts
    ["--fwt_exact"],
    ["--holdout_after", "50", "--predictions_after", "7"],
    ["--prediction_model_delay", "40", "--power_t", "0"],
], ids=["default", "power_t0", "exact", "holdout", "delay"])
def test_training_matches_jax(tmp_path, flags):
    n = 40 if "--fwt_exact" in flags else 120  # batch 1: a step per line
    data = data_file(tmp_path, n=n)
    argv = MODEL_ARGV + ["--data", str(data), "--fwt_batch_size", "16", *flags]
    (jp, jf), (pp, pf) = run_both(tmp_path, argv)
    skip = 7 if "--predictions_after" in flags else 0
    assert pp.shape == jp.shape == (n - skip,)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=2e-6)
    assert np.abs(pp - 0.5).max() > 1e-3  # the model learned something
    assert_same_model(jf, pf)


def test_resume_from_a_model_file(tmp_path):
    """-i: train on, from the optimizer state of a saved model."""
    data = data_file(tmp_path)
    argv = MODEL_ARGV + ["--data", str(data), "--fwt_batch_size", "16"]
    (_, jf), (_, pf) = run_both(tmp_path, argv)
    more = data_file(tmp_path, n=60, seed=6)
    jout, pout = tmp_path / "j2.out", tmp_path / "p2.out"
    assert jax_main(["-i", str(jf), "--data", str(more), "--fwt_batch_size",
                     "16", "-p", str(jout), "--fwt_no_native"]) == 0
    assert main(["-i", str(pf), "--data", str(more), "--fwt_batch_size", "16",
                 "-p", str(pout), "-f", str(tmp_path / "p2.fwt"),
                 "--save_resume", "--fwt_platform", "cpu",
                 "--fwt_no_native"]) == 0
    jp = np.array([float(x) for x in jout.read_text().split()])
    pp = np.array([float(x) for x in pout.read_text().split()])
    np.testing.assert_allclose(pp, jp, rtol=0, atol=2e-6)


def test_testonly_does_not_train(tmp_path):
    """-t without -i predicts from the fresh init and writes no update."""
    data = data_file(tmp_path)
    argv = MODEL_ARGV + ["--data", str(data), "-t", "--fwt_batch_size", "16"]
    (jp, jf), (pp, pf) = run_both(tmp_path, argv)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=2e-6)
    assert_same_model(jf, pf)


def test_final_regressor_needs_save_resume(tmp_path):
    data = data_file(tmp_path)
    assert main(MODEL_ARGV + ["--data", str(data), "-f", str(tmp_path / "m.fwt"),
                              "--fwt_platform", "cpu"]) == 1
    assert not (tmp_path / "m.fwt").exists()


@pytest.mark.parametrize("extra,mesh", [
    (["--nn_layers", "1", "--nn", "0:width:4"], ["--fwt_table_axis", "2"]),
    (["-c"], ["--fwt_data_axis", "2"])], ids=["nn", "cache"])
def test_unported_training_modes_are_refused(tmp_path, extra, mesh):
    """A tower and the record cache train in one process
    (tests/test_torch_tower_cli.py, test_torch_cache.py) and, where this
    test once found them refused, with a mesh and no process-group flags:
    one command starts the mesh's ranks (parallel/launch.py) and rank 0
    alone writes ``-p``, a line per example within 2e-6 of the run in one
    process, and the record cache, which the run in one process then
    reads."""
    data = data_file(tmp_path)
    common = MODEL_ARGV + ["--data", str(data), "--fwt_platform", "cpu", *extra]
    assert main(common + mesh + ["-p", str(tmp_path / "mesh.out")]) == 0
    assert (tmp_path / "d.vw.fwcache").exists() == ("-c" in extra)
    assert main(common + ["-p", str(tmp_path / "one.out")]) == 0
    got = np.loadtxt(tmp_path / "mesh.out")
    assert got.shape == (120,)
    np.testing.assert_allclose(got, np.loadtxt(tmp_path / "one.out"), rtol=0, atol=2e-6)


@pytest.mark.parametrize("path", [["--fwt_superbatch", "2"], ["--fwt_no_native"]],
                         ids=["native", "python"])
def test_profile_writes_a_trace(tmp_path, path):
    """--fwt_profile DIR: a torch.profiler trace of a window of the run's
    steps (the first left out) in DIR, in the Chrome trace format, with
    the FFM update rows' bytes and examples of the traced dispatches; the
    run's predictions as without it."""
    import json

    data = data_file(tmp_path)
    argv = MODEL_ARGV + ["--data", str(data), "--fwt_batch_size", "16",
                         "--fwt_platform", "cpu", *path]
    prof = tmp_path / "prof"
    assert main(argv + ["-p", str(tmp_path / "a.out"), "--fwt_profile", str(prof)]) == 0
    assert main(argv + ["-p", str(tmp_path / "b.out")]) == 0
    (trace,) = prof.iterdir()
    assert trace.name.startswith("fwt_trace_") and trace.suffix == ".json"
    window = json.loads(trace.read_text())["fwt_counters"]
    # 120 lines at B=16: seven full batches and a partial one of 8; with
    # K=2 the native path packs three superbatches of 2 and sends one full
    # and the partial batch alone, so dispatches 2..8 or 2..5 are traced
    assert window["dispatches"] == (7 if "--fwt_no_native" in path else 4)
    assert window["ffm_update_examples"] > 0
    assert window["ffm_update_bytes"] % (512 * window["ffm_update_examples"]) == 0
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert (tmp_path / "a.out").read_bytes() == (tmp_path / "b.out").read_bytes()
