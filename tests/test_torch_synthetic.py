"""The port's synthetic dataset and serving configuration
(fwumious_wabbit_tpu_torch/synthetic.py) against bench.py's: the same lines
for the same rows and seed, and the same model instance as bench.py's LR+FFM
k=8 flags (the port's own configuration object, equal field by field)."""

import pytest

import bench
from fwumious_wabbit_tpu.config.cmdline import build_parser
from fwumious_wabbit_tpu.config.model_instance import ModelInstance, Optimizer
from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu_torch import synthetic

from torch_parity import config_fields


@pytest.mark.parametrize("rows,seed", [(1, 1), (300, 1), (257, 5)])
def test_dataset_matches_bench(tmp_path, rows, seed):
    want, got = tmp_path / "bench.vw", tmp_path / "port.vw"
    bench.generate_dataset(want, rows, seed=seed)
    synthetic.generate_dataset(got, rows, seed=seed)
    assert got.read_bytes() == want.read_bytes()
    assert len(got.read_bytes().splitlines()) == rows


def test_serving_config_matches_bench(tmp_path):
    data = synthetic.ensure_dataset(tmp_path, 50)
    assert (tmp_path / synthetic.NAMESPACE_MAP).is_file()
    assert len(data.read_bytes().splitlines()) == 50
    mi, vw = synthetic.serving_config(data)
    argv = bench._base_argv(data) + ["--ffm_k", "8", "--ffm_bit_precision", "25",
                                     "--ffm_field", "A", "--ffm_field", "B"]
    want = ModelInstance.from_cmdline(build_parser().parse_args(argv),
                                      VwNamespaceMap.from_dataset_dir(str(data)))
    want.optimizer = Optimizer.SGD
    assert type(mi).__module__ == "fwumious_wabbit_tpu_torch.config.model_instance"
    assert config_fields(mi) == config_fields(want)
    assert (mi.bit_precision, mi.ffm_bit_precision, mi.ffm_k) == (25, 25, 8)
    assert (mi.num_ffm_fields, mi.num_combos) == (2, 14)


def test_tower_config_matches_the_baseline_tower(tmp_path):
    """synthetic.tower_training_config: the full-width LR+FFM k=8 tables
    (training_config) with BASELINE config 3's tower, the flags of
    tests/test_baseline_flows.py — equal to the JAX package's
    configuration of the same flags, field by field."""
    from fwumious_wabbit_tpu.models.model import FwModel as JaxModel

    data = synthetic.ensure_dataset(tmp_path, 50)
    mi, _ = synthetic.tower_training_config(data)
    argv = (bench._base_argv(data) + ["--ffm_k", "8", "--ffm_bit_precision", "25",
                                      "--ffm_field", "A", "--ffm_field", "B"]
            + ["--nn_layers", "1", "--nn", "0:width:16", "--nn", "0:activation:relu",
               "--nn_topology", "one", "--nn_learning_rate", "0.02",
               "--nn_power_t", "0.5"])
    want = ModelInstance.from_cmdline(build_parser().parse_args(argv),
                                      VwNamespaceMap.from_dataset_dir(str(data)))
    assert config_fields(mi) == config_fields(want)
    assert want.optimizer == Optimizer.ADAGRAD_LUT
    assert (mi.power_t, mi.ffm_power_t, mi.nn_power_t) == (0.0, 0.0, 0.5)
    jmodel = JaxModel(want)
    assert [s.width for s in jmodel.nn_layers] == [16] and jmodel.topology == "one"
    assert jmodel.joined_width == 14 + 3
