"""The port's daemon under concurrent load and live hot swaps on the card
(the soak of fwumious_wabbit_tpu_torch/deployment.py at a small width): 2
request/response and 2 pipelined clients while a swapper alternates
``hogwild_load`` of two models 10 times; every reply within 2e-6 of the
CPU's plain prediction of its line under one of the two models, the FFM
forward launched, and the card's allocated memory after swap 10 within
one model's table bytes of its reading after swap 2 (``SharedPredictor``
reads it as the next swap starts, and here once the soak has ended). Skips without a card.
This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py
"""

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu_torch import deployment, synthetic
from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance, Optimizer
from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu_torch.convert import params_from_numpy
from fwumious_wabbit_tpu_torch.models.model import FwModel
from fwumious_wabbit_tpu_torch.ops import ffm
from fwumious_wabbit_tpu_torch.persistence import model_file
from fwumious_wabbit_tpu_torch.serve.server import Serving

SWAPS = 10


def small_argv() -> list:
    argv = synthetic.serving_argv()
    argv[argv.index("-b") + 1] = "18"
    argv[argv.index("--ffm_bit_precision") + 1] = "18"
    return argv


def write_model(path, data, seed):
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    mi = ModelInstance.from_cmdline(build_parser().parse_args(small_argv()), vw)
    mi.optimizer = Optimizer.SGD
    model = FwModel(mi)
    rng = np.random.default_rng(seed)
    params = {"lr_w": rng.standard_normal(model.lr_size, np.float32) * 0.2,
              "ffm_w": rng.standard_normal(model.ffm_size, np.float32) * 0.1}
    model.load_params(params_from_numpy(params, model, "cpu"))
    model_file.save_model(path, mi, vw, model)


@pytest.mark.cuda
def test_soak_under_hot_swap_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    data = synthetic.ensure_dataset(tmp_path, 3000)
    m1, m2 = tmp_path / "m1.fwt", tmp_path / "m2.fwt"
    write_model(m1, data, 1)
    write_model(m2, data, 2)
    pool = deployment.probe_pool(data, (m1, m2), tmp_path, 3000)
    args = build_parser().parse_args(["--daemon", "--port", "0",
                                      "--num_children", "8"])
    mi, vw, model = model_file.load_model(m1, immutable=True)
    srv = Serving(args, mi, vw, model)
    del model
    table_bytes = deployment.model_table_bytes(small_argv())
    srv.serve_in_background()
    ffm.LAUNCHES = 0
    try:
        out = deployment.soak(srv.port, pool, (m1, m2), rr_clients=2,
                              burst_clients=2, n_swaps=SWAPS)
    finally:
        srv.shutdown()
    srv.predictor.note_resident()
    memory = srv.predictor.resident_bytes
    assert out["swaps"] == SWAPS and out["max_err_to_either_model"] <= 2e-6
    assert out["replies_v1q_only"] > 0 and out["replies_v2q_only"] > 0
    assert ffm.LAUNCHES > 0
    assert abs(memory[SWAPS] - memory[2]) <= table_bytes, memory
