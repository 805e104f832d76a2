"""The sharded step's pieces on the card: the fused FFM kernels
(csrc/ffm_triangle.cu, unchanged) reading slabs from rows an exchange
delivered (parallel/sharded.exchanged_slabs), forward and backward,
against their plain versions on the original table, at one-row and at
three-row slabs; and the sharded step on an NCCL group of one rank (mesh
1×1), psum and a2a, against train/step.make_train_step on the card.
Skips without a card: a CUDA kernel has no CPU mode. This file imports no
jax, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_sharded_cuda.py
"""

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu_torch.ops import ffm
from fwumious_wabbit_tpu_torch.parallel import sharded

from ffm_cases import SHAPES, ffm_case


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def within(got, ref) -> bool:
    return (got - ref).abs().max().item() <= 1e-5 * (1 + ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("F,k,N,B", SHAPES)
def test_fused_kernels_read_exchanged_rows(cuda, F, k, N, B):
    table, ids, vals, fields, spec = ffm_case(F, k, N, B, "both", seed=2)
    t, i, v, f = (torch.from_numpy(a).to(cuda) for a in (table, ids, vals, fields))
    buf, local_ids, row_spec = sharded.exchanged_slabs(
        t[sharded.slab_rows(i, spec).long()], i, spec)
    before = (ffm.LAUNCHES, ffm.BWD_LAUNCHES)
    got = ffm.ffm_fused(buf, local_ids, v, f, F, k, row_spec)
    g_out = torch.randn(got.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    d_emb = ffm.ffm_fused_bwd(g_out, buf, local_ids, v, f, F, k, row_spec)
    torch.cuda.synchronize()
    assert (ffm.LAUNCHES, ffm.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert within(got, ffm.ffm_fused_reference(t, i, v, f, F, k, spec))
    assert within(d_emb, ffm.ffm_fused_bwd_reference(g_out, t, i, v, f, F, k, spec))


@pytest.mark.cuda
def test_sharded_step_on_an_nccl_group_of_one(cuda):
    from fwumious_wabbit_tpu_torch.config.model_instance import (
        FeatureComboDesc, ModelInstance, Optimizer)
    from fwumious_wabbit_tpu_torch.config.vwmap import NamespaceDescriptor
    from fwumious_wabbit_tpu_torch.models.model import FwModel
    from fwumious_wabbit_tpu_torch.ops import sparse_update
    from fwumious_wabbit_tpu_torch.parallel import distributed, launch
    from fwumious_wabbit_tpu_torch.parallel import mesh as pmesh
    from fwumious_wabbit_tpu_torch.train.step import make_train_step

    mi = ModelInstance()
    mi.optimizer = Optimizer.ADAGRAD_LUT
    mi.learning_rate = mi.ffm_learning_rate = 0.1
    mi.power_t = mi.ffm_power_t = 0.5
    mi.bit_precision = mi.ffm_bit_precision = 16
    mi.ffm_k = 8
    descs = [NamespaceDescriptor(j) for j in range(3)]
    mi.feature_combo_descs = [FeatureComboDesc(namespace_descriptors=[d]) for d in descs]
    mi.ffm_fields = [[d] for d in descs]
    rng = np.random.default_rng(4)
    B, L, N = 64, 6, 6
    batches = [{
        "label": torch.from_numpy(rng.integers(0, 2, B).astype(np.float32)),
        "importance": torch.ones(B),
        "lr_ids": torch.from_numpy((rng.integers(0, 1 << 30, (B, L)) & mi.lr_hash_mask).astype(np.int32)),
        "lr_vals": torch.ones(B, L),
        "lr_combos": torch.from_numpy(rng.integers(0, 3, (B, L)).astype(np.int32)),
        "ffm_ids": torch.from_numpy((rng.integers(0, 1 << 30, (B, N)) & mi.ffm_hash_mask).astype(np.int32)),
        "ffm_vals": torch.ones(B, N),
        "ffm_fields": torch.from_numpy(rng.integers(0, 3, (B, N)).astype(np.int32)),
    } for _ in range(3)]
    ref = FwModel(mi)
    ref.load_params(ref.init_params(cuda))
    step = make_train_step(ref, graph=False)
    want = torch.stack([step(b) for b in batches])
    distributed.initialize(f"127.0.0.1:{launch.free_port()}", 1, 0, None)
    try:
        mesh = pmesh.Mesh(1, 1)
        for exchange in ("psum", "a2a"):
            model = FwModel(mi)
            model.load_params(model.init_params(cuda))
            pmesh.shard_model(model, mesh)
            before = (ffm.LAUNCHES, ffm.BWD_LAUNCHES, sparse_update.LAUNCHES)
            sstep = sharded.make_sharded_train_step(model, mesh, exchange)
            got = torch.stack([sstep(b) for b in batches])
            torch.cuda.synchronize()
            after = (ffm.LAUNCHES, ffm.BWD_LAUNCHES, sparse_update.LAUNCHES)
            assert [a - b for a, b in zip(after, before)] == [3, 3, 6], exchange
            assert (got - want).abs().max().item() <= 1e-6, exchange
            for key in ("lr_w", "lr_acc", "ffm_w", "ffm_acc"):
                assert within(getattr(model, key), getattr(ref, key)), (exchange, key)
    finally:
        distributed.shutdown()
