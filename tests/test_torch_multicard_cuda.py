"""The sharded train step across four cards: four NCCL ranks, one per card,
run ``make_sharded_train_step`` at 4×1 psum, 1×4 a2a, 2×2 psum, 2×2 a2a
and 2×2 a2a with a tower, three steps each, and each is held against
``train/step.make_train_step`` on one card over the same global batches:
predictions within 1e-6, every table and tower tensor within
1e-5·(1+max|·|) (chip_smoke.py phase 7g's bounds), and no a2a drop.
Every scope's power_t is 0, so the AdaGrad LUT rate is the constant lr:
the tower's partial sums meet in an all_reduce, in another order than one
card's matmul, and at power_t 0.5 a last-bit difference that lands on a
LUT bucket edge moves a weight by a bucket's rate step (on four gloo
ranks, 0.0038 in an FFM weight within three steps of this model).

Skips, in its fixture, on a host with fewer than four cards: the NCCL
group needs a card per rank. This file imports no jax, so it runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_multicard_cuda.py

Run as a script, it is one rank:
``python tests/test_torch_multicard_cuda.py OUT_DIR RANK COORDINATOR``."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
CARDS = 4
STEPS = 3
B = 64
# name → (n_data, n_table, exchange, tower)
CASES = {"4x1_psum": (4, 1, "psum", False), "1x4_a2a": (1, 4, "a2a", False),
         "2x2_psum": (2, 2, "psum", False), "2x2_a2a": (2, 2, "a2a", False),
         "2x2_a2a_tower": (2, 2, "a2a", True)}
TABLES = ("lr_w", "lr_acc", "ffm_w", "ffm_acc")
RANK_TIMEOUT_S = 600


def model_config(tower: bool):
    """The LR+FFM k=8 model of tests/test_torch_sharded_cuda.py at power_t
    0 (the batch-mean cap, from the rows), with one ReLU layer of 8 when
    ``tower``."""
    from fwumious_wabbit_tpu_torch.config.model_instance import (
        FeatureComboDesc, ModelInstance, Optimizer)
    from fwumious_wabbit_tpu_torch.config.vwmap import NamespaceDescriptor

    mi = ModelInstance()
    mi.optimizer = Optimizer.ADAGRAD_LUT
    mi.learning_rate = mi.ffm_learning_rate = mi.nn_learning_rate = 0.1
    mi.power_t = mi.ffm_power_t = mi.nn_power_t = 0.0
    mi.bit_precision = mi.ffm_bit_precision = 16
    mi.ffm_k = 8
    descs = [NamespaceDescriptor(j) for j in range(3)]
    mi.feature_combo_descs = [FeatureComboDesc(namespace_descriptors=[d]) for d in descs]
    mi.ffm_fields = [[d] for d in descs]
    if tower:
        mi.nn_config.layers = [{"width": "8", "activation": "relu"}]
        mi.nn_config.topology = "one"
    return mi


def batches(mi) -> list:
    """STEPS global batches of B examples, from a numpy seed."""
    import torch

    rng = np.random.default_rng(4)
    L = N = 6
    out = []
    for _ in range(STEPS):
        out.append({
            "label": torch.from_numpy(rng.integers(0, 2, B).astype(np.float32)),
            "importance": torch.ones(B),
            "lr_ids": torch.from_numpy((rng.integers(0, 1 << 30, (B, L))
                                        & mi.lr_hash_mask).astype(np.int32)),
            "lr_vals": torch.ones(B, L),
            "lr_combos": torch.from_numpy(rng.integers(0, 3, (B, L)).astype(np.int32)),
            "ffm_ids": torch.from_numpy((rng.integers(0, 1 << 30, (B, N))
                                         & mi.ffm_hash_mask).astype(np.int32)),
            "ffm_vals": torch.ones(B, N),
            "ffm_fields": torch.from_numpy(rng.integers(0, 3, (B, N)).astype(np.int32)),
        })
    return out


def tensors(model, params: dict) -> dict:
    """The four tables of ``params`` and the tower's tensors of ``model``,
    as numpy arrays."""
    out = {k: params[k].cpu().numpy() for k in TABLES}
    if model.has_nn:
        for i, layer in enumerate([*model.layers, model.final]):
            for k, v in layer.tensors().items():
                out[f"nn{i}.{k}"] = v.cpu().numpy()
    return out


def _rank_main(out_dir: str, rank: int, coordinator: str) -> None:
    """One rank: every case in one order, rank 0 writing the gathered
    predictions, the drops and the gathered tables of each."""
    import torch

    from fwumious_wabbit_tpu_torch.models.model import FwModel
    from fwumious_wabbit_tpu_torch.parallel import distributed, sharded
    from fwumious_wabbit_tpu_torch.parallel import mesh as pmesh

    device = distributed.initialize(coordinator, CARDS, rank, None)
    try:
        for name, (n_d, n_t, exchange, tower) in CASES.items():
            mi = model_config(tower)
            mesh = pmesh.Mesh(n_d, n_t)
            model = FwModel(mi)
            model.load_params(model.init_params(device))
            pmesh.shard_model(model, mesh)
            step = sharded.make_sharded_train_step(model, mesh, exchange,
                                                   with_stats=True)
            both = exchange == "a2a"
            preds, dropped = [], 0
            for b in batches(mi):
                p, stats = step(pmesh.shard_batch(b, mesh, both))
                preds.append(pmesh.gather_batch(p, mesh, both))
                dropped += int(stats["a2a_dropped"])
            params = pmesh.gather_tables(model.params(), mesh, pmesh.table_rows(model))
            torch.cuda.synchronize()
            if rank == 0:
                np.savez(Path(out_dir) / f"{name}.npz",
                         preds=torch.stack(preds).cpu().numpy(),
                         **tensors(model, params))
                (Path(out_dir) / f"{name}.json").write_text(json.dumps(
                    {"dropped": dropped, "device": str(device)}))
    finally:
        distributed.shutdown()


@pytest.fixture(scope="module")
def four_cards(tmp_path_factory):
    """The four ranks, started once; skips with fewer than four cards."""
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < CARDS:
        pytest.skip(f"needs {CARDS} CUDA cards for an NCCL group of {CARDS} "
                    f"ranks, one per card; this host has {count}")
    from fwumious_wabbit_tpu_torch.parallel import launch

    out = tmp_path_factory.mktemp("multicard")
    coordinator = f"127.0.0.1:{launch.free_port()}"
    cmds = [([sys.executable, __file__, str(out), str(r), coordinator],
             launch.rank_env(r)) for r in range(CARDS)]
    assert launch.supervise(cmds) == 0
    return out


def one_card(tower: bool) -> dict:
    """``make_train_step`` on cuda:0 over the same global batches."""
    import torch

    from fwumious_wabbit_tpu_torch.models.model import FwModel
    from fwumious_wabbit_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = FwModel(model_config(tower))
    model.load_params(model.init_params(torch.device("cuda:0")))
    step = make_train_step(model)
    preds = torch.stack([step(b) for b in batches(model.mi)]).cpu().numpy()
    return {"preds": preds, **tensors(model, model.params())}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_on_four_cards_matches_one_card(name, four_cards):
    got = np.load(four_cards / f"{name}.npz")
    stats = json.loads((four_cards / f"{name}.json").read_text())
    assert stats["dropped"] == 0
    assert stats["device"] == "cuda:0"
    want = one_card(CASES[name][3])
    assert set(got.files) == set(want)
    pred_err = np.abs(got["preds"] - want["preds"]).max()
    assert pred_err <= 1e-6, pred_err
    for key, w in want.items():
        if key == "preds":
            continue
        err = np.abs(got[key] - w).max()
        assert err <= 1e-5 * (1 + np.abs(w).max()), (key, err)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
