"""FWRE model files across packages: a file the JAX package writes loads into
the port with equal arrays, and a file the port writes loads into the JAX
package with equal arrays (and is byte-identical to the JAX package's) — for
the with-optimizer-state layout, the immutable (inference) layout and
f16-quantized FFM weights."""

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu.config.model_instance import Optimizer
from fwumious_wabbit_tpu.models.model import FwModel as JaxModel
from fwumious_wabbit_tpu.persistence import model_file as jmf
from fwumious_wabbit_tpu_torch.persistence import model_file as pmf

from torch_parity import (
    FFM_ARGV,
    config_fields,
    jax_params,
    make_mi,
    make_vw,
    port_config,
    port_model,
    vw_lines,
)

MODES = ["with_state", "immutable", "f16"]


def make_case(tmp_path, mode):
    """``(vw, mi, params, pvw, pmi)``: the JAX package's configuration and
    parameters, and the port's own configuration of the same argv."""
    vw = make_vw(tmp_path)
    argv = FFM_ARGV + ["--nn_layers", "1", "--nn", "0:width:5",
                       "--nn", "0:activation:relu"]
    mi = make_mi(vw, argv)
    params = jax_params(JaxModel(mi), seed=7, train_lines=vw_lines(16, seed=8),
                        vw=vw)
    overrides = {}
    if mode != "with_state":  # the inference layout: weights only, SGD
        mi.optimizer = Optimizer.SGD
        overrides["optimizer"] = "SGD"
        params = {k: v for k, v in params.items() if not k.endswith("_acc")}
        params["nn"] = [{k: v for k, v in l.items() if not k.endswith("_acc")}
                        for l in params["nn"]]
        params["final"] = {k: v for k, v in params["final"].items()
                           if not k.endswith("_acc")}
    if mode == "f16":
        mi.dequantize_weights = overrides["dequantize_weights"] = True
    pvw, pmi = port_config(tmp_path, argv, **overrides)
    assert config_fields(pmi) == config_fields(mi)
    return vw, mi, params, pvw, pmi


def flat_params(params) -> dict:
    """{name: numpy array} of a params dict from either package."""
    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    out = {k: host(v) for k, v in params.items() if k not in ("nn", "final")}
    for i, layer in enumerate(params.get("nn", [])):
        out.update({f"nn{i}.{k}": host(v) for k, v in layer.items()})
    if "final" in params:
        out.update({f"final.{k}": host(v) for k, v in params["final"].items()})
    return out


def assert_same(a: dict, b: dict):
    fa, fb = flat_params(a), flat_params(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_jax_file_loads_into_port(tmp_path, mode):
    vw, mi, params, _, _ = make_case(tmp_path, mode)
    path = tmp_path / "jax.fwt"
    jmf.save_model(path, mi, vw, JaxModel(mi), params,
                   quantize_weights=mode == "f16")
    immutable = mode != "with_state"
    _, _, _, want = jmf.load_model(path, immutable=immutable)
    pmi, pvw, model = pmf.load_model(path, immutable=immutable, device="cpu")
    assert pmi.to_json() == jmf.load_model(path, immutable=immutable)[0].to_json()
    assert pvw.to_source_json() == vw.to_source_json()
    assert_same(model.params(), want)


@pytest.mark.parametrize("mode", MODES)
def test_port_file_loads_into_jax(tmp_path, mode):
    vw, mi, params, pvw, pmi = make_case(tmp_path, mode)
    quantize = mode == "f16"
    jpath, ppath = tmp_path / "jax.fwt", tmp_path / "port.fwt"
    jmf.save_model(jpath, mi, vw, JaxModel(mi), params, quantize_weights=quantize)
    pmf.save_model(ppath, pmi, pvw, port_model(pmi, params),
                   quantize_weights=quantize)
    assert ppath.read_bytes() == jpath.read_bytes()
    immutable = mode != "with_state"
    _, _, _, got = jmf.load_model(ppath, immutable=immutable)
    _, _, _, want = jmf.load_model(jpath, immutable=immutable)
    assert_same(got, want)
