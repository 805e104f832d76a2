"""The port's train step with a dense tower (fwumious_wabbit_tpu_torch/train/
step.py: the manual tower backward, train-mode normalization, the dense
AdaGrad update and max-norm) against the JAX package's, on the CPU:
5-step trajectories at B=64 from the same initial parameters (each
package's own init, bit-equal) on the same batches, for every topology ×
layer norm under AdagradLUT and one case each under AdagradFlex and SGD;
the max-norm case of tests/test_nn_maxnorm.py; and a tower without FFM.

Tolerances: every step's predictions within 2e-6; the four tables and
every tower ``w``, ``b``, ``w_acc`` and ``b_acc`` within rtol 1e-5 / atol
1e-6 at the end (the same f32 sums in other orders, and the port's
correctly rounded pow against XLA's)."""

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu.config.model_instance import Optimizer
from fwumious_wabbit_tpu.models.model import FwModel as JaxModel
from fwumious_wabbit_tpu.train.loop import _batch_dict
from fwumious_wabbit_tpu.train.step import apply_maxnorm as jax_maxnorm
from fwumious_wabbit_tpu.train.step import make_train_step as jax_train_step
from fwumious_wabbit_tpu_torch.convert import params_from_numpy
from fwumious_wabbit_tpu_torch.models.model import FwModel
from fwumious_wabbit_tpu_torch.train.step import apply_maxnorm, make_train_step

from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (
    FFM_ARGV,
    batches,
    config_fields,
    make_mi,
    make_vw,
    port_config,
    to_numpy,
    vw_lines,
)

PRED_ATOL = 2e-6


def tower_argv(topology="one", layernorm="none", maxnorm=None):
    """Two layers: 5 relu neurons (Hu init, ``layernorm``, ``maxnorm``),
    then 3 linear ones (Xavier init)."""
    argv = ["--nn_layers", "2", "--nn_topology", topology,
            "--nn", "0:width:5", "--nn", "0:activation:relu",
            "--nn", f"0:layernorm:{layernorm}",
            "--nn", "1:width:3", "--nn", "1:init:xavier",
            "--nn_learning_rate", "0.05", "--nn_power_t", "0.5"]
    if maxnorm is not None:
        argv += ["--nn", f"0:maxnorm:{maxnorm}"]
    return argv


CASES = {f"lut_{topo}_{ln}": (FFM_ARGV + tower_argv(topo, ln), None)
         for topo in ("one", "two", "four", "five")
         for ln in ("none", "before", "after")}
CASES["flex_one_after"] = (FFM_ARGV + tower_argv("one", "after"), Optimizer.ADAGRAD_FLEX)
CASES["sgd_four_before"] = (FFM_ARGV + tower_argv("four", "before"), Optimizer.SGD)
CASES["no_ffm_five_none"] = (tower_argv("five", "none"), None)
CASES["maxnorm_one_none"] = (FFM_ARGV + tower_argv("one", "none", 0.3), None)


def build(tmp_path, extra, optimizer=None):
    vw = make_vw(tmp_path)
    mi = make_mi(vw, extra)
    if optimizer is not None:
        mi.optimizer = optimizer
    _, pmi = port_config(tmp_path, extra, optimizer=mi.optimizer.name)
    assert config_fields(pmi) == config_fields(mi)
    return vw, mi, pmi


def assert_params_close(params: dict, jparams: dict) -> None:
    """Every table and tower tensor within rtol 1e-5 / atol 1e-6."""
    assert set(params) == set(jparams)
    for key in params:
        if key in ("nn", "final"):
            layers = params[key] if key == "nn" else [params[key]]
            jlayers = jparams[key] if key == "nn" else [jparams[key]]
            assert len(layers) == len(jlayers)
            for i, (layer, jlayer) in enumerate(zip(layers, jlayers)):
                assert set(layer) == set(jlayer)
                for name, t in layer.items():
                    np.testing.assert_allclose(t.numpy(), jlayer[name], rtol=1e-5,
                                               atol=1e-6, err_msg=f"{key}[{i}].{name}")
        else:
            np.testing.assert_allclose(params[key].numpy(), jparams[key],
                                       rtol=1e-5, atol=1e-6, err_msg=key)


def trajectory(tmp_path, extra, optimizer, steps=5, batch_size=64, seed=3):
    """Both packages' steps over the same batches from their own inits;
    returns ``(port model, JAX params)`` at the end."""
    vw, mi, pmi = build(tmp_path, extra, optimizer)
    jmodel = JaxModel(mi)
    jparams = jmodel.init_params()
    model = FwModel(pmi)
    model.load_params(model.init_params("cpu"))
    jstep, step = jax_train_step(jmodel), make_train_step(model)
    moved = 0.0
    for batch in batches(vw, mi, vw_lines(steps * batch_size, seed=seed), batch_size):
        bd = _batch_dict(batch)
        jparams, jp = jstep(jparams, dict(bd))
        p = step(bd)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=PRED_ATOL)
        moved = max(moved, float(np.abs(p.numpy() - 0.5).max()))
    assert moved > 1e-3  # the tower moved the predictions off 0.5
    return model, to_numpy(jparams)


@pytest.mark.parametrize("name", list(CASES))
def test_tower_trajectory_matches_jax(tmp_path, name):
    extra, optimizer = CASES[name]
    model, jparams = trajectory(tmp_path, extra, optimizer)
    params = model.params()
    if optimizer == Optimizer.SGD:
        assert "w_acc" not in params["nn"][0]
    assert_params_close(params, jparams)
    if name.startswith("maxnorm"):
        norms = np.linalg.norm(params["nn"][0]["w"].numpy(), axis=0)
        assert (norms <= 0.3 + 1e-4).all(), norms


def test_train_step_enforces_maxnorm():
    """tests/test_nn_maxnorm.py's case: a huge flex rate would blow the
    norms up; five steps later every column is within 0.5 and the tower
    equals JAX's."""
    from fwumious_wabbit_tpu.config.model_instance import ModelInstance as JaxMI
    from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance

    def configure(mi, optimizer):
        mi.optimizer = optimizer
        mi.learning_rate = mi.nn_learning_rate = 5.0
        mi.power_t = mi.nn_power_t = 0.0
        mi.bit_precision = 12
        mi.ffm_k = 0
        mi.init_acc_gradient = mi.nn_init_acc_gradient = 0.0
        mi.nn_config.layers = [{"width": "4", "activation": "relu", "maxnorm": "0.5"}]
        mi.nn_config.topology = "one"
        return mi

    from fwumious_wabbit_tpu_torch.config.model_instance import Optimizer as POpt

    jmodel = JaxModel(configure(JaxMI(), Optimizer.ADAGRAD_FLEX))
    model = FwModel(configure(ModelInstance(), POpt.ADAGRAD_FLEX))
    jparams = jmodel.init_params()
    model.load_params(params_from_numpy(to_numpy(jparams), model, "cpu"))
    batch = {
        "label": np.ones(8, np.float32), "importance": np.ones(8, np.float32),
        "lr_ids": np.arange(16, dtype=np.int32).reshape(8, 2),
        "lr_vals": np.ones((8, 2), np.float32),
        "lr_combos": np.zeros((8, 2), np.int32),
        "ffm_ids": np.zeros((8, 0), np.int32), "ffm_vals": np.zeros((8, 0), np.float32),
        "ffm_fields": np.zeros((8, 0), np.int32)}
    jstep, step = jax_train_step(jmodel), make_train_step(model)
    for _ in range(5):
        jparams, jp = jstep(jparams, dict(batch))
        p = step(dict(batch))
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=PRED_ATOL)
    norms = np.linalg.norm(model.layers[0].w.numpy(), axis=0)
    assert np.all(norms <= 0.5 + 1e-4), norms
    assert_params_close(model.params(), to_numpy(jparams))


def test_apply_maxnorm_matches_jax():
    """Only the columns above the bound scale, in place, as JAX's does."""
    w = np.array([[3.0, 0.1, -2.0], [4.0, 0.1, 0.5]], np.float32)
    t = torch.from_numpy(w.copy())
    out = apply_maxnorm(t, 1.0)
    assert out is t
    np.testing.assert_allclose(t.numpy(), np.asarray(jax_maxnorm(w, 1.0)),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(t.numpy()[:, 1], w[:, 1])


def test_dense_weights_update_in_place(tmp_path):
    """The step writes the tower's buffers in place (the packed step's K
    steps see each other's updates) and none of them requires grad."""
    vw, mi, pmi = build(tmp_path, FFM_ARGV + tower_argv("four", "after"))
    model = FwModel(pmi)
    model.load_params(model.init_params("cpu"))
    tensors = [t for layer in [*model.layers, model.final] for t in layer.buffers()]
    before = [t.clone() for t in tensors]
    (batch,) = batches(vw, mi, vw_lines(16, seed=2), 16)
    make_train_step(model)(_batch_dict(batch))
    after = [t for layer in [*model.layers, model.final] for t in layer.buffers()]
    assert all(a is b for a, b in zip(after, tensors))
    assert all(not t.requires_grad for t in after)
    assert sum(not torch.equal(a, b) for a, b in zip(after, before)) >= 6
