"""The port's command line (python -m fwumious_wabbit_tpu_torch): ``-t -i``
predict on the CPU against the JAX package's ``-t -i --fwt_serve_engine
device``; no silent CPU fallback without a card; a process group without
its coordinator refused, the one-command tower mesh and convert."""

import subprocess
import sys
from pathlib import Path

import numpy as np

from fwumious_wabbit_tpu.models.model import FwModel as JaxModel
from fwumious_wabbit_tpu.persistence import model_file as jmf
from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch.train.loop import main

from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (  # noqa: F401 (jax_native_loaded: an autouse fixture)
    FFM_ARGV,
    jax_native_loaded,
    jax_params,
    make_mi,
    make_vw,
    vw_lines,
)


REPO = Path(__file__).resolve().parents[1]


def model_and_data(tmp_path):
    vw = make_vw(tmp_path)
    mi = make_mi(vw, FFM_ARGV)
    jmodel = JaxModel(mi)
    params = jax_params(jmodel, seed=21, train_lines=vw_lines(16, seed=22), vw=vw)
    path = tmp_path / "m.fwt"
    jmf.save_model(path, mi, vw, jmodel, params)
    data = tmp_path / "d.vw"
    data.write_bytes(b"".join(vw_lines(70, seed=23)))
    return path, data


def read_preds(path):
    return np.array([float(x) for x in Path(path).read_text().split()])


def test_predict_matches_jax_device_path(tmp_path):
    path, data = model_and_data(tmp_path)
    common = ["-t", "-i", str(path), "--data", str(data),
              "--fwt_batch_size", "32", "--predictions_after", "3"]
    assert jax_main(common + ["-p", str(tmp_path / "jax.out"),
                              "--fwt_serve_engine", "device"]) == 0
    assert main(common + ["-p", str(tmp_path / "port.out"),
                          "--fwt_platform", "cpu"]) == 0
    want, got = read_preds(tmp_path / "jax.out"), read_preds(tmp_path / "port.out")
    assert got.shape == want.shape == (70 - 3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def run_cli(args, tmp_path):
    # CUDA_VISIBLE_DEVICES="" hides any card, so the run is the same on a
    # machine with one
    return subprocess.run(
        [sys.executable, "-m", "fwumious_wabbit_tpu_torch", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
             "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)})


def test_no_card_without_cpu_flag_fails(tmp_path):
    path, data = model_and_data(tmp_path)
    r = run_cli(["-t", "-i", str(path), "--data", str(data),
                 "-p", str(tmp_path / "p.out")], tmp_path)
    assert r.returncode != 0
    assert "CUDA device" in r.stderr
    assert not (tmp_path / "p.out").exists()


def test_second_card_is_refused(tmp_path):
    path, data = model_and_data(tmp_path)
    assert main(["-t", "-i", str(path), "--data", str(data),
                 "-p", str(tmp_path / "p.out"), "--fwt_platform", "cuda:1"]) != 0
    assert not (tmp_path / "p.out").exists()


def test_coordinator_refusal_tower_mesh_and_convert(tmp_path):
    """A mesh with no process-group flags starts its own ranks, one per
    device
    (parallel/launch.py): the tower under ``--fwt_table_axis 2`` trains on
    two gloo ranks in one command, and rank 0 alone writes ``-p``, a
    prediction per line within 2e-6 of the same command in one process (a
    mesh's runs: tests/test_torch_mesh_cli.py, test_torch_launch.py). A
    process group without its coordinator still exits 1 naming the flag and
    writes nothing. Convert writes the inference file
    (tests/test_torch_convert.py)."""
    path, data = model_and_data(tmp_path)
    common = ["--data", str(data), "--keep", "A", "--fwt_platform", "cpu"]
    r = run_cli(common + ["-c", "--fwt_hosts", "2", "-p", str(tmp_path / "p.out")],
                tmp_path)
    assert r.returncode == 1
    assert "--fwt_coordinator" in r.stderr
    assert not (tmp_path / "p.out").exists()
    assert not (tmp_path / "d.vw.fwcache").exists()
    tower = ["--nn_layers", "1", "--nn", "0:width:4"]
    r = run_cli(common + tower + ["--fwt_table_axis", "2",
                                  "-p", str(tmp_path / "mesh.out")], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "[rank 1]" in r.stderr
    r = run_cli(common + tower + ["-p", str(tmp_path / "one.out")], tmp_path)
    assert r.returncode == 0, r.stderr
    got, want = read_preds(tmp_path / "mesh.out"), read_preds(tmp_path / "one.out")
    assert got.shape == want.shape == (70,)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    r = run_cli(["-i", str(path), "--convert_inference_regressor",
                 str(tmp_path / "inf.fwt"), "--fwt_platform", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "inf.fwt").exists()


def test_native_engine_testonly_writes_the_final_regressor(tmp_path, caplog):
    """-t -i -f --save_resume --fwt_serve_engine native: -f makes the run
    ineligible for the embedded engine (native_predict_eligible), so the
    device path writes the model file, byte-equal to the one the JAX CLI
    writes; without -f the embedded engine predicts."""
    import logging

    path, data = model_and_data(tmp_path)
    common = ["-t", "-i", str(path), "--data", str(data), "--save_resume",
              "--fwt_serve_engine", "native"]
    assert jax_main(common + ["-f", str(tmp_path / "jax.fwt"),
                              "-p", str(tmp_path / "jax.out")]) == 0
    with caplog.at_level(logging.INFO):
        assert main(common + ["-f", str(tmp_path / "port.fwt"),
                              "-p", str(tmp_path / "port.out"),
                              "--fwt_platform", "cpu"]) == 0
    assert not any("native predict engine" in r.message for r in caplog.records)
    assert (tmp_path / "port.fwt").read_bytes() == (tmp_path / "jax.fwt").read_bytes()
    np.testing.assert_allclose(read_preds(tmp_path / "port.out"),
                               read_preds(tmp_path / "jax.out"), rtol=0, atol=2e-6)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert main(common + ["-p", str(tmp_path / "native.out")]) == 0
    assert any("native predict engine" in r.message for r in caplog.records)
    np.testing.assert_allclose(read_preds(tmp_path / "native.out"),
                               read_preds(tmp_path / "jax.out"), rtol=0, atol=2e-6)
