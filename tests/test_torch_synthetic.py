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
