"""Tower training (``--nn``) through the port's CLI on the CPU, against the
JAX CLI over the same data and flags, on both ingest paths (the Python
parser, ``--fwt_no_native``, and the default C++ ingest with packed
superbatches), and a ``-i`` resume of a saved tower model. Bounds of
tests/test_torch_train_cli.py and test_torch_train_native.py: the ``-p``
files within 2e-6 (each side rounds to %.6f) and the ``-f --save_resume``
model files of equal size and header, every table and tower ``w``, ``b``,
``w_acc``, ``b_acc`` within rtol 1e-5 / atol 1e-6."""

import numpy as np
import pytest

from fwumious_wabbit_tpu.persistence import model_file as jmf
from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch.persistence import model_file as pmf
from fwumious_wabbit_tpu_torch.train.loop import main

from test_torch_train_cli import MODEL_ARGV, data_file
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import jax_native_loaded, to_numpy  # noqa: F401 (autouse fixture)


# BASELINE config 3's tower (tests/test_baseline_flows.py:61-63)
BASELINE_TOWER = ["--nn_layers", "1", "--nn", "0:width:16", "--nn", "0:activation:relu",
                  "--nn_topology", "one", "--nn_learning_rate", "0.02",
                  "--nn_power_t", "0.5"]
TOWERS = {
    "baseline": BASELINE_TOWER,
    # the chip's configuration: power_t 0 in the sparse scopes, so the
    # batch-mean cap's host counts ride along
    "baseline_p0": BASELINE_TOWER + ["--power_t", "0"],
    "five_layernorm": ["--nn_layers", "2", "--nn_topology", "five",
                       "--nn", "0:width:8", "--nn", "0:activation:relu",
                       "--nn", "0:layernorm:after", "--nn", "1:width:4",
                       "--nn", "1:init:xavier", "--nn_learning_rate", "0.02",
                       "--nn_power_t", "0.5"],
}
PATHS = {"python": ["--fwt_no_native"], "native": ["--fwt_superbatch", "3"]}


def read_preds(path):
    return np.array([float(x) for x in path.read_text().split()])


def assert_same_tower_model(jax_path, port_path):
    """Equal size and header; the four tables and every tower tensor
    within rtol 1e-5 / atol 1e-6, read back by both packages' readers."""
    assert jax_path.stat().st_size == port_path.stat().st_size
    jmi, jvw, _, jparams = jmf.load_model(jax_path)
    mi, vw, _, params = jmf.load_model(port_path)
    assert mi.to_json() == jmi.to_json()
    assert vw.to_source_json() == jvw.to_source_json()
    jparams, params = to_numpy(jparams), to_numpy(params)
    assert set(params) == set(jparams) == {"lr_w", "lr_acc", "ffm_w", "ffm_acc",
                                           "nn", "final"}
    for key in ("lr_w", "lr_acc", "ffm_w", "ffm_acc"):
        np.testing.assert_allclose(params[key], jparams[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    layers = [*params["nn"], params["final"]]
    jlayers = [*jparams["nn"], jparams["final"]]
    assert len(layers) == len(jlayers)
    for i, (layer, jlayer) in enumerate(zip(layers, jlayers)):
        assert set(layer) == set(jlayer) == {"w", "b", "w_acc", "b_acc"}
        for name in layer:
            np.testing.assert_allclose(layer[name], jlayer[name], rtol=1e-5,
                                       atol=1e-6, err_msg=f"layer {i} {name}")
    # the port's own reader takes the file back with its tower
    _, _, model = pmf.load_model(port_path, device="cpu")
    assert model.has_nn and len(model.layers) == len(jparams["nn"])


def train_both(tmp_path, argv, tag=""):
    out = {}
    for side, fn, extra in (("jax", jax_main, []),
                            ("port", main, ["--fwt_platform", "cpu"])):
        p, f = tmp_path / f"{side}{tag}.out", tmp_path / f"{side}{tag}.fwt"
        assert fn(argv + ["-p", str(p), "-f", str(f), "--save_resume", *extra]) == 0
        out[side] = (read_preds(p), f)
    return out["jax"], out["port"]


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("tower", list(TOWERS))
def test_tower_training_matches_jax(tmp_path, tower, path):
    data = data_file(tmp_path, n=200)
    argv = MODEL_ARGV + TOWERS[tower] + ["--data", str(data),
                                         "--fwt_batch_size", "16", *PATHS[path]]
    (jp, jf), (pp, pf) = train_both(tmp_path, argv)
    assert pp.shape == jp.shape == (200,)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=2e-6)
    assert np.abs(pp - 0.5).max() > 1e-3  # the model learned something
    assert_same_tower_model(jf, pf)


def test_tower_paths_agree(tmp_path):
    """The default path and --fwt_no_native train the same tower."""
    data = data_file(tmp_path, n=200)
    argv = MODEL_ARGV + BASELINE_TOWER + ["--data", str(data), "--fwt_batch_size",
                                          "16", "--fwt_platform", "cpu"]
    outs = []
    for tag, extra in (("native", []), ("python", ["--fwt_no_native"])):
        p, f = tmp_path / f"{tag}.out", tmp_path / f"{tag}.fwt"
        assert main(argv + ["-p", str(p), "-f", str(f), "--save_resume", *extra]) == 0
        outs.append((read_preds(p), f))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=0, atol=2e-6)
    assert_same_tower_model(outs[1][1], outs[0][1])


@pytest.mark.parametrize("path", list(PATHS))
def test_tower_resume_from_a_model_file(tmp_path, path):
    """-i of a tower model saved with --save_resume: save → load → train
    on, from its optimizer state, on both CLIs."""
    data = data_file(tmp_path, n=120)
    argv = MODEL_ARGV + BASELINE_TOWER + ["--data", str(data),
                                          "--fwt_batch_size", "16", *PATHS[path]]
    (_, jf), (_, pf) = train_both(tmp_path, argv)
    more = data_file(tmp_path, n=80, seed=6)
    resume = ["--data", str(more), "--fwt_batch_size", "16", *PATHS[path]]
    (jp, jf2), (pp, pf2) = train_both(tmp_path, ["-i", str(jf), *resume], "2")
    np.testing.assert_allclose(pp, jp, rtol=0, atol=2e-6)
    assert_same_tower_model(jf2, pf2)
    # and the port resumes from its own file as from JAX's
    p3 = tmp_path / "own.out"
    assert main(["-i", str(pf), *resume, "-p", str(p3), "--fwt_platform", "cpu"]) == 0
    np.testing.assert_allclose(read_preds(p3), jp, rtol=0, atol=2e-6)


def test_tower_predict_matches_jax(tmp_path):
    """-t -i of a trained tower model on the device engine, against JAX's."""
    data = data_file(tmp_path, n=120)
    argv = MODEL_ARGV + BASELINE_TOWER + ["--data", str(data), "--fwt_batch_size", "16"]
    (_, jf), _ = train_both(tmp_path, argv)
    test = data_file(tmp_path, n=70, seed=9)
    common = ["-t", "-i", str(jf), "--data", str(test), "--fwt_batch_size", "32"]
    assert jax_main(common + ["-p", str(tmp_path / "jt.out"),
                              "--fwt_serve_engine", "device"]) == 0
    assert main(common + ["-p", str(tmp_path / "pt.out"), "--fwt_platform", "cpu"]) == 0
    want, got = read_preds(tmp_path / "jt.out"), read_preds(tmp_path / "pt.out")
    assert got.shape == want.shape == (70,)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
