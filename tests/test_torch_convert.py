"""``--convert_inference_regressor`` on the port's CLI against the JAX CLI's:
from one model file the JAX CLI trained (with optimizer state, LR+FFM, with
and without a dense tower), both CLIs write the inference file, quantized
(``--weight_quantization``) and not, and the two files are equal byte for
byte. The converted files load in the port's device engine (``-t -i``) and
in its embedded C++ engine (``--fwt_serve_engine native``): the plain
conversion predicts within 2e-6 of the unconverted model (the -p files'
rounding), the quantized one within 5e-3, the bound of the JAX package's
quantization tests (tests/test_ffi.py::test_ffi_quantized_model,
tests/test_inputs_and_config.py::test_quantized_convert_cli_roundtrip), and
both engines within 2e-6 of each other on every file."""

from pathlib import Path

import numpy as np
import pytest

from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch.persistence.model_file import load_model
from fwumious_wabbit_tpu_torch.train.loop import main

from torch_parity import (  # noqa: F401 (jax_native_loaded: an autouse fixture)
    BASE_ARGV,
    FFM_ARGV,
    jax_native_loaded,
    make_vw,
    vw_lines,
)

MODEL_ARGV = [a for a in BASE_ARGV if a not in ("--data", "x")] + FFM_ARGV
TOWER_ARGV = ["--nn_layers", "1", "--nn", "0:width:6", "--nn",
              "0:activation:relu"]
PRED_ATOL = 2e-6
QUANT_ATOL = 5e-3  # tests/test_ffi.py:121, tests/test_inputs_and_config.py:113


@pytest.fixture(scope="module", params=["lr_ffm", "tower"])
def trained(request, tmp_path_factory):
    """A model file the JAX CLI trained, with optimizer state."""
    d = tmp_path_factory.mktemp(f"convert_{request.param}")
    make_vw(d)
    data = d / "d.vw"
    data.write_bytes(b"".join(vw_lines(160, seed=7)))
    argv = MODEL_ARGV + (TOWER_ARGV if request.param == "tower" else [])
    assert jax_main(argv + ["--data", str(data), "--fwt_platform", "cpu",
                            "-f", str(d / "m.fwt"), "--save_resume"]) == 0
    return d, data, request.param


def convert_both(d: Path, quantize: bool) -> tuple[Path, Path]:
    q = ["--weight_quantization"] if quantize else []
    tag = "q" if quantize else "f"
    out = (d / f"jax_{tag}.fwt", d / f"port_{tag}.fwt")
    assert jax_main(["--convert_inference_regressor", str(out[0]), "-i",
                     str(d / "m.fwt"), "--fwt_platform", "cpu", *q]) == 0
    assert main(["--convert_inference_regressor", str(out[1]), "-i",
                 str(d / "m.fwt"), "--fwt_platform", "cpu", *q]) == 0
    return out


def predict(path: Path, data: Path, out: Path, engine: str) -> np.ndarray:
    assert main(["-t", "-i", str(path), "--data", str(data), "-p", str(out),
                 "--fwt_platform", "cpu", "--fwt_serve_engine", engine]) == 0
    return np.array([float(x) for x in out.read_text().split()])


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quantized"])
def test_convert_is_byte_equal_to_the_jax_cli(trained, quantize):
    d, _, kind = trained
    jax_f, port_f = convert_both(d, quantize)
    assert port_f.read_bytes() == jax_f.read_bytes()
    assert port_f.stat().st_size < (d / "m.fwt").stat().st_size  # no state
    mi, _, model = load_model(port_f, device="cpu")
    assert mi.optimizer.name == "SGD" and not model.has_state
    assert bool(mi.dequantize_weights) == quantize
    assert model.has_nn == (kind == "tower")


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quantized"])
def test_converted_file_serves_in_both_engines(trained, quantize):
    d, data, _ = trained
    _, port_f = convert_both(d, quantize)
    tag = "q" if quantize else "f"
    want = predict(d / "m.fwt", data, d / "full.out", "device")
    device = predict(port_f, data, d / f"{tag}_device.out", "device")
    native = predict(port_f, data, d / f"{tag}_native.out", "native")
    assert len(device) == 160
    np.testing.assert_allclose(native, device, rtol=0, atol=PRED_ATOL)
    np.testing.assert_allclose(device, want, rtol=0,
                               atol=QUANT_ATOL if quantize else PRED_ATOL)
    if not quantize:
        assert (d / f"{tag}_device.out").read_bytes() == (d / "full.out").read_bytes()


def test_convert_needs_an_initial_regressor(tmp_path):
    assert main(["--convert_inference_regressor", str(tmp_path / "o.fwt"),
                 "--fwt_platform", "cpu"]) == 1
    assert not (tmp_path / "o.fwt").exists()
