"""The port's learning-quality gates (fwumious_wabbit_tpu_torch/gates.py) on
the CPU: the FFM dataset against examples/ffm/generate.py byte for byte;
the port's CLI against the JAX CLI, both with ``--fwt_platform cpu`` on
their default paths, at gate 3's exact flags (B=2048 over 20k/5k Eat-Rate
lines) and at the FFM gate's (k=10, SGD, ``--noconstant``, B=256, convert,
``-t`` from both files) over small data; the gates' arithmetic against the
scripts' formulas; and a failed bound failing the module. The gates at
their full sizes run on the card (chip_smoke.py phase 10; README)."""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fwumious_wabbit_tpu.persistence import model_file as jmf
from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch import gates, synthetic
from fwumious_wabbit_tpu_torch.train.loop import main

from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import jax_native_loaded, to_numpy  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
PRED_ATOL = 2e-6  # tests/test_torch_train_cli.py: each side rounds to %.6f


def test_ffm_dataset_is_the_script_s(tmp_path):
    """synthetic.generate_ffm_dataset writes what examples/ffm/generate.py
    writes for the same arguments, byte for byte."""
    script = tmp_path / "script"
    subprocess.run([sys.executable, str(REPO / "examples/ffm/generate.py"),
                    "--out", str(script), "--num_animals", "300",
                    "--num_foods", "200", "--num_train_examples", "2000",
                    "--num_test_examples", "500"], check=True,
                   capture_output=True)
    synthetic.generate_ffm_dataset(tmp_path / "port", 300, 200, 2000, 500)
    names = ["train.vw", "test-easy.vw", "test-hard.vw", "vw_namespace_map.csv"]
    assert sorted(p.name for p in script.iterdir()) == sorted(names)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (script / name).read_bytes(), name
    assert (script / "test-hard.vw").read_bytes().count(b"\n") == 500


def test_prepare_writes_each_gate_s_data_once(tmp_path, monkeypatch):
    """gates.prepare writes the Eat-Rate files in child processes, each the
    generator's bytes for its rows and seed, and the FFM gate's data in
    this process; a second call rewrites nothing."""
    monkeypatch.setitem(gates.ER_FILES, "er200k_train", (3000, 11))
    monkeypatch.setitem(gates.ER_FILES, "er200k_test", (1000, 12))
    gates.prepare(("ffm", "er200k"), tmp_path)
    for name, seed in (("er200k_train", 11), ("er200k_test", 12)):
        ref = tmp_path / f"{name}_ref.vw"
        synthetic.generate_dataset(ref, gates.ER_FILES[name][0], seed=seed)
        assert gates.data_path(name, tmp_path).read_bytes() == ref.read_bytes()
    ffm = gates.data_path("ffm", tmp_path)
    assert (ffm / "train.vw").read_bytes().count(b"\n") == 30000
    assert (tmp_path / "data" / "vw_namespace_map.csv").exists()
    stamps = {p: p.stat().st_mtime_ns for p in (tmp_path / "data").rglob("*.vw")}
    gates.prepare(("ffm", "er200k"), tmp_path)
    assert stamps == {p: p.stat().st_mtime_ns for p in (tmp_path / "data").rglob("*.vw")}


def both_clis(argv, out: Path, tag: str) -> dict:
    """``argv`` (paths with ``{side}``) through the JAX CLI and the port's,
    each with ``--fwt_platform cpu``."""
    for side, fn in (("jax", jax_main), ("port", main)):
        (out / side).mkdir(exist_ok=True)
        run = [a.format(side=out / side) for a in argv]
        assert fn(run + ["--fwt_platform", "cpu"]) == 0, (side, tag)


def test_gate3_flags_match_jax(tmp_path):
    """Gate 3's flags (the batch-mean cap on: AdaGrad at power_t 0) at
    B=2048 over 20,000 train and 5,000 test lines of its seeds: the test
    predictions within 2e-6 and the two loglosses within 1e-6."""
    synthetic.write_namespace_map(tmp_path)
    train, test = tmp_path / "train.vw", tmp_path / "test.vw"
    synthetic.generate_dataset(train, 20_000, seed=11)
    synthetic.generate_dataset(test, 5_000, seed=12)
    argv = gates.ER_ARGV + ["--fwt_batch_size", "2048"]
    both_clis(argv + ["--data", str(train), "-f", "{side}/m.fwt", "--save_resume"],
              tmp_path, "train")
    both_clis(argv + ["-i", "{side}/m.fwt", "-t", "--data", str(test),
                      "-p", "{side}/test.out"], tmp_path, "test")
    labels = gates.labels_of(test)
    jp, pp = (gates.read_preds(tmp_path / s / "test.out") for s in ("jax", "port"))
    assert pp.shape == jp.shape == (5_000,)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=PRED_ATOL)
    assert abs(gates.logloss(pp, labels) - gates.logloss(jp, labels)) <= 1e-6
    assert gates.logloss(pp, labels) < 0.75  # it learned


def test_ffm_gate_flags_match_jax(tmp_path):
    """The FFM gate's flags (LR + FFM k=10 on fields A and B, SGD,
    --noconstant, B=256) over 3,000 train lines and the hard test set:
    training and test predictions within 2e-6 of the JAX CLI's and the
    tables within rtol 1e-5 / atol 1e-6; the port's inference model predicts
    what its full model does on every line; the port's convert of the JAX
    CLI's full model is byte-equal to the JAX CLI's inference file. (The two
    full models differ in last bits: at k=10 the forward's sum over k runs
    in another order than XLA's dot, test_torch_ffm.py
    test_xla_sums_k10_in_another_order.)"""
    d = tmp_path / "data"
    synthetic.generate_ffm_dataset(d, 300, 200, 3000, 1000)
    argv = gates.FFM_ARGV
    both_clis(argv + ["--data", str(d / "train.vw"), "-p", "{side}/train.out",
                      "-f", "{side}/full.fwt", "--save_resume"], tmp_path, "train")
    both_clis(argv + ["-i", "{side}/full.fwt", "--convert_inference_regressor",
                      "{side}/inf.fwt"], tmp_path, "convert")
    for model in ("full", "inf"):
        both_clis(argv + ["-i", f"{{side}}/{model}.fwt", "--data",
                          str(d / "test-hard.vw"), "-p", f"{{side}}/{model}.out",
                          "-t"], tmp_path, model)
    read = lambda side, name: gates.read_preds(tmp_path / side / name)  # noqa: E731
    for name in ("train.out", "full.out"):
        np.testing.assert_allclose(read("port", name), read("jax", name),
                                   rtol=0, atol=PRED_ATOL, err_msg=name)
    assert read("port", "full.out").shape == (1000,)
    assert (np.abs(read("port", "inf.out") - read("port", "full.out")) < 1e-9).all()
    assert main(argv + ["-i", str(tmp_path / "jax/full.fwt"), "--fwt_platform", "cpu",
                        "--convert_inference_regressor", str(tmp_path / "jax_by_port.fwt")]) == 0
    assert (tmp_path / "jax_by_port.fwt").read_bytes() == (tmp_path / "jax/inf.fwt").read_bytes()
    _, _, _, jparams = jmf.load_model(tmp_path / "jax/full.fwt")
    _, _, _, params = jmf.load_model(tmp_path / "port/full.fwt")
    jparams, params = to_numpy(jparams), to_numpy(params)
    assert set(params) == set(jparams) == {"lr_w", "ffm_w"}
    for key in params:
        np.testing.assert_allclose(params[key], jparams[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def script_logloss(preds, labels) -> float:
    """scripts/basic_gate.sh gates 1–3."""
    return -sum(y * math.log(max(p, 1e-12)) + (1 - y) * math.log(max(1 - p, 1e-12))
                for p, y in zip(preds, labels)) / len(preds)


def script_balanced_accuracy(full, labels) -> float:
    """scripts/ffm_gate.sh."""
    tp = sum(1 for p, y in zip(full, labels) if y == 1 and p >= 0.5)
    tn = sum(1 for p, y in zip(full, labels) if y == 0 and p < 0.5)
    pos = sum(labels)
    neg = len(labels) - pos
    return 0.5 * (tp / max(pos, 1) + tn / max(neg, 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arithmetic_is_the_scripts(seed, tmp_path):
    """Logloss and balanced accuracy against the scripts' own formulas on
    fixed arrays, with 0, 1 and exactly 0.5 among the predictions; labels
    read by the scripts' rule (a first token of ``1``)."""
    rng = np.random.default_rng(seed)
    p = np.round(rng.random(400), 6)
    p[:6] = [0.0, 1.0, 0.5, 0.5, 1e-13, 1 - 1e-13]
    y = rng.integers(0, 2, 400)
    assert gates.logloss(p, y) == pytest.approx(script_logloss(p, y), rel=1e-12)
    assert gates.balanced_accuracy(p, y) == script_balanced_accuracy(p.tolist(), y.tolist())
    data = tmp_path / "d.vw"
    data.write_text("".join(("1" if v else "-1") + " |A a\n" for v in y))
    np.testing.assert_array_equal(gates.labels_of(data), y)


def test_a_failed_bound_exits_1(tmp_path, monkeypatch, capsys):
    """The FFM gate over 60 train lines misses its balanced-accuracy bound:
    the module exits 1 and writes the failed result over a passing one left
    by an earlier run, which it never reads."""
    monkeypatch.setattr(gates, "WORK", tmp_path)
    (tmp_path / "data").mkdir()
    synthetic.generate_ffm_dataset(tmp_path / "data" / "ffm", 300, 200, 60, 400)
    stale = tmp_path / "cpu" / "ffm.json"
    stale.parent.mkdir()
    stale.write_text(json.dumps({"gate": "ffm", "passed": True}))
    assert gates.main(["ffm", "--cpu"]) == 1
    res = json.loads(stale.read_text())
    assert res["passed"] is False and res["balanced_accuracy"] <= 0.80
    assert res["lines"] == 400 and res["device"] == "cpu"
    assert "gate ffm: FAILED" in capsys.readouterr().out


def test_a_failed_run_exits_1(tmp_path, monkeypatch, capsys):
    """A run that fails (here: its test file is missing) fails the gate,
    with its message."""
    monkeypatch.setattr(gates, "WORK", tmp_path)
    (tmp_path / "data").mkdir()
    d = tmp_path / "data" / "ffm"
    synthetic.generate_ffm_dataset(d, 300, 200, 60, 40)
    (d / "test-hard.vw").unlink()
    assert gates.main(["ffm", "--cpu"]) == 1
    assert "test-hard.vw" in capsys.readouterr().err
