"""The port's train step (fwumious_wabbit_tpu_torch/train/step.py) against the
JAX package's (fwumious_wabbit_tpu/train/step.py): 5-step trajectories from
the same initial parameters on the same batches, comparing every step's
predictions and, at the end, all four tables. Tolerance rtol 1e-5, atol
1e-6: the same sums in other orders, and the port's f32 pow against XLA's."""

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu.config.model_instance import Optimizer
from fwumious_wabbit_tpu.models.model import FwModel as JaxModel
from fwumious_wabbit_tpu.train.loop import _batch_dict
from fwumious_wabbit_tpu.train.step import make_train_step as jax_train_step
from fwumious_wabbit_tpu_torch.convert import params_from_numpy
from fwumious_wabbit_tpu_torch.models.model import FwModel
from fwumious_wabbit_tpu_torch.train.loop import np_counts
from fwumious_wabbit_tpu_torch.train.step import make_train_step

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

TABLES = ("lr_w", "lr_acc", "ffm_w", "ffm_acc")

# name → (extra flags, optimizer override, host batch-mean counts?)
CONFIGS = {
    "lut_p0_counts": (["--power_t", "0"], None, True),
    "lut_p0_device_counts": (["--power_t", "0"], None, False),
    "lut_p05": (["--power_t", "0.5"], None, False),
    "flex": (["--power_t", "0.5"], Optimizer.ADAGRAD_FLEX, False),
    "sgd": ([], Optimizer.SGD, False),
}


def build(tmp_path, name):
    """``(vw, mi, pmi, counts)``: the JAX package's configuration and the
    port's own, from the same argv and optimizer."""
    extra, optimizer, counts = CONFIGS[name]
    vw = make_vw(tmp_path)
    mi = make_mi(vw, FFM_ARGV + extra)
    if optimizer is not None:
        mi.optimizer = optimizer
    _, pmi = port_config(tmp_path, FFM_ARGV + extra, optimizer=mi.optimizer.name)
    assert config_fields(pmi) == config_fields(mi)
    return vw, mi, pmi, counts


def with_counts(bd, batch, model):
    """The loop's host multiplicity counts for the batch-mean scopes."""
    if model.opt_lr.batch_mean:
        bd["lr_counts"] = np_counts(batch.lr_ids, batch.lr_vals, 0)
    if model.opt_ffm.batch_mean:
        bd["ffm_counts"] = np_counts(batch.ffm_ids, batch.ffm_vals,
                                     (model.ffm_spec.align - 1).bit_length())
    return bd


@pytest.mark.parametrize("batch_size", [1, 32])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_trajectory_matches_jax(tmp_path, name, batch_size):
    vw, mi, pmi, counts = build(tmp_path, name)
    jmodel = JaxModel(mi)
    jparams = jmodel.init_params()
    model = FwModel(pmi)
    model.load_params(params_from_numpy(to_numpy(jparams), model, "cpu"))
    assert model.opt_lr.batch_mean == jmodel.opt_lr.batch_mean
    assert model.opt_ffm.batch_mean == jmodel.opt_ffm.batch_mean
    jstep, step = jax_train_step(jmodel), make_train_step(model)
    lines = vw_lines(5 * batch_size, seed=batch_size + len(name))
    for batch in batches(vw, mi, lines, batch_size):
        bd = _batch_dict(batch)
        if counts:
            bd = with_counts(bd, batch, model)
        jparams, jp = jstep(jparams, dict(bd))
        p = step(bd)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
    jparams = to_numpy(jparams)
    params = model.params()
    assert set(params) == set(jparams) == (
        {"lr_w", "ffm_w"} if name == "sgd" else set(TABLES))
    for key in params:
        np.testing.assert_allclose(params[key].numpy(), jparams[key],
                                   rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", ["lut_p0_counts", "flex", "sgd"])
def test_init_params_match_jax(tmp_path, name):
    _, mi, pmi, _ = build(tmp_path, name)
    want = to_numpy(JaxModel(mi).init_params())
    got = FwModel(pmi).init_params("cpu")
    assert set(got) == set(want)
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)


def test_step_updates_in_place_and_tables_never_require_grad(tmp_path):
    vw, mi, pmi, _ = build(tmp_path, "lut_p05")
    model = FwModel(pmi)
    model.load_params(model.init_params("cpu"))
    tables = {k: getattr(model, k) for k in TABLES}
    before = {k: t.clone() for k, t in tables.items()}
    step = make_train_step(model)
    (batch,) = batches(vw, mi, vw_lines(8, seed=1), 8)
    p = step(_batch_dict(batch))
    assert p.shape == (8,) and not p.requires_grad
    for k, t in tables.items():
        assert getattr(model, k) is t and not t.requires_grad
        assert not torch.equal(t, before[k]), k


def test_tower_training_is_refused(tmp_path):
    """Only the tower the reference refuses is refused (dropout, disabled
    there too: src/block_neural.rs:82-84); a plain tower initializes and
    trains (tests/test_torch_tower_step.py holds it to JAX)."""
    make_vw(tmp_path)
    _, pmi = port_config(tmp_path, FFM_ARGV + ["--nn_layers", "1", "--nn",
                                               "0:width:4", "--nn", "0:dropout:0.5"])
    with pytest.raises(ValueError, match="Dropout is not supported"):
        FwModel(pmi)
    _, pmi = port_config(tmp_path, FFM_ARGV + ["--nn_layers", "1", "--nn", "0:width:4"])
    model = FwModel(pmi)
    model.load_params(model.init_params("cpu"))
    vw, mi, _, _ = build(tmp_path, "lut_p05")
    (batch,) = batches(vw, mi, vw_lines(8, seed=1), 8)
    assert make_train_step(model)(_batch_dict(batch)).shape == (8,)
