"""The port's predict path (fwumious_wabbit_tpu_torch/models/model.py) against
the JAX model on the same parameters (carried across with
convert.params_from_numpy) and the same batches: LR only, LR+FFM after JAX
train steps, and LR+FFM with an NN tower in every topology and layer norm
placement. Tolerance: 2e-6 on probabilities."""

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu.models.model import FwModel as JaxModel
from fwumious_wabbit_tpu.train.loop import _batch_dict
from fwumious_wabbit_tpu.train.step import make_predict_step as jax_predict_step
from fwumious_wabbit_tpu_torch.models import model as pm
from fwumious_wabbit_tpu_torch.train.step import batch_dict, make_predict_step

from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (
    FFM_ARGV,
    batches,
    jax_params,
    make_mi,
    make_vw,
    port_config,
    port_model,
    vw_lines,
)


def assert_predictions_match(vw, mi, pmi, params, lines=None):
    """``mi`` the JAX package's configuration, ``pmi`` the port's of the
    same argv; the batches are the JAX pipeline's numpy arrays."""
    jmodel = JaxModel(mi)
    jstep = jax_predict_step(jmodel)
    step = make_predict_step(port_model(pmi, params))
    n = 0
    for b in batches(vw, mi, lines or vw_lines(40, seed=5)):
        want = np.asarray(jstep(params, _batch_dict(b)))
        got = step(batch_dict(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        n += int(np.sum(np.abs(want - 0.5) > 1e-3))
    assert n > 0, "predictions are all 0.5: the comparison shows nothing"


def test_lr_only(tmp_path):
    vw = make_vw(tmp_path)
    mi = make_mi(vw)
    _, pmi = port_config(tmp_path)
    assert_predictions_match(vw, mi, pmi, jax_params(JaxModel(mi), seed=1))


def test_lr_ffm_after_train_steps(tmp_path):
    vw = make_vw(tmp_path)
    mi = make_mi(vw, FFM_ARGV)
    params = jax_params(JaxModel(mi), seed=2, train_lines=vw_lines(24, seed=9),
                        vw=vw)
    assert_predictions_match(vw, mi, port_config(tmp_path, FFM_ARGV)[1], params)


@pytest.mark.parametrize("layernorm", ["before", "after"])
@pytest.mark.parametrize("topology", ["one", "two", "four", "five"])
def test_lr_ffm_nn(tmp_path, topology, layernorm):
    vw = make_vw(tmp_path)
    argv = FFM_ARGV + [
        "--nn_layers", "2", "--nn_topology", topology,
        "--nn", "0:width:6", "--nn", "0:activation:relu",
        "--nn", f"0:layernorm:{layernorm}",
        "--nn", "1:width:4", "--nn", "1:init:xavier"]
    mi = make_mi(vw, argv)
    params = jax_params(JaxModel(mi), seed=3, train_lines=vw_lines(16, seed=4),
                        vw=vw)
    assert_predictions_match(vw, mi, port_config(tmp_path, argv)[1], params)


def test_predict_prob_clamps_and_maps_nan():
    x = torch.tensor([float("nan"), 100.0, -100.0, 0.0])
    p = pm.predict_prob(x)
    assert p[0] == 0.5 and p[3] == 0.5
    assert p[1] == torch.sigmoid(torch.tensor(50.0))
    assert p[2] == torch.sigmoid(torch.tensor(-50.0))
