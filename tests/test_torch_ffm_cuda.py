"""The fused CUDA FFM kernels (fwumious_wabbit_tpu_torch/csrc/ffm_triangle.cu),
forward and backward, against their plain PyTorch versions (tables.gather,
then the triangle and its autograd), on the card: every shape of
tests/ffm_cases.py (one-row and three-row slabs), both padding forms,
duplicate ids, the warp path with 16-byte and with 4-byte loads and the
shared-memory path; reruns bit-identical. Skips without a card: a CUDA
kernel has no CPU mode. This file imports no jax, so it also runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_ffm_cuda.py
"""

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu_torch.ops import ffm
from fwumious_wabbit_tpu_torch.ops.kernels import build

from ffm_cases import SHAPES, ffm_case, padded


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def inputs(F, k, N, B, device, aligned=True):
    """The case on the card; ``aligned=False`` puts the table 4 bytes off a
    16-byte boundary, so the kernels take 4-byte loads."""
    table, ids, vals, fields, spec = ffm_case(F, k, N, B, "both", seed=1)
    t = torch.from_numpy(table).to(device)
    if not aligned:
        buf = torch.empty(t.numel() + 1, device=device)
        buf[1:] = t.reshape(-1)
        t = buf[1:].view(t.shape)
        assert t.is_contiguous() and t.data_ptr() % 16 == 4
    rest = tuple(torch.from_numpy(a).to(device) for a in (ids, vals, fields))
    return (t, *rest), spec


def within(got, ref) -> bool:
    return (got - ref).abs().max().item() <= 1e-5 * (1 + ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["vec16", "vec4"])
@pytest.mark.parametrize("F,k,N,B", SHAPES)
def test_kernel_matches_plain(cuda, F, k, N, B, aligned):
    args, spec = inputs(F, k, N, B, cuda, aligned)
    before = ffm.LAUNCHES
    got = ffm.ffm_fused(*args, F, k, spec)
    torch.cuda.synchronize()
    assert ffm.LAUNCHES == before + 1
    ref = ffm.ffm_fused_reference(*args, F, k, spec)
    assert got.shape == ref.shape == (B, F * (F + 1) // 2)
    assert bool(torch.isfinite(got).all()) and within(got, ref)


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda):
    for shape in ((16, 8, 12, 16), (2, 8, 8, 256), (40, 8, 48, 8)):
        args, spec = inputs(*shape, cuda)
        a = ffm.ffm_fused(*args, *shape[:2], spec)
        b = ffm.ffm_fused(*args, *shape[:2], spec)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    (table, ids, vals, fields), spec = inputs(2, 8, 8, 4, cuda)
    with pytest.raises(TypeError):
        ffm.ffm_fused(table, ids.long(), vals, fields, 2, 8, spec)
    with pytest.raises(TypeError):
        ffm.ffm_fused(table, ids, vals, fields.long(), 2, 8, spec)
    with pytest.raises(ValueError):
        ffm.ffm_fused(table, ids.t(), vals, fields, 2, 8, spec)
    with pytest.raises(ValueError):
        ffm.ffm_fused(table[:-1], ids, vals, fields, 2, 8, spec)
    with pytest.raises(ValueError, match="slab"):
        ffm.ffm_fused(table, ids, vals, fields, 2, 4, spec)
    big = ffm.tables.make_spec(1 << 12, 64 * 64)
    bt = torch.zeros((big.num_rows, 128), device=cuda)
    one = (ids[:1, :1].contiguous(), vals[:1, :1].contiguous(),
           fields[:1, :1].contiguous())
    with pytest.raises(ValueError, match="227 KB"):
        ffm.ffm_fused(bt, *one, 64, 64, big)
    with pytest.raises(ValueError, match="227 KB"):
        ffm.ffm_fused_bwd(torch.zeros((1, 64 * 65 // 2), device=cuda), bt, *one,
                          64, 64, big)
    g = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):
        ffm.ffm_fused_bwd(g[:, :2], table, ids, vals, fields, 2, 8, spec)
    with pytest.raises(ValueError):
        ffm.ffm_fused_bwd(g.t().contiguous().t(), table, ids, vals, fields, 2, 8, spec)


def upstream(F, B, device):
    rng = np.random.default_rng(F * 7 + B)
    g = rng.normal(size=(B, F * (F + 1) // 2)).astype(np.float32)
    return torch.from_numpy(g).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["vec16", "vec4"])
@pytest.mark.parametrize("F,k,N,B", SHAPES)
def test_backward_kernel_matches_plain(cuda, F, k, N, B, aligned):
    args, spec = inputs(F, k, N, B, cuda, aligned)
    g = upstream(F, B, cuda)
    before = ffm.BWD_LAUNCHES
    got = ffm.ffm_fused_bwd(g, *args, F, k, spec)
    torch.cuda.synchronize()
    assert ffm.BWD_LAUNCHES == before + 1
    ref = ffm.ffm_fused_bwd_reference(g, *args, F, k, spec)
    assert got.shape == ref.shape == (B, N, F * k)
    assert bool(torch.isfinite(got).all()) and within(got, ref)
    pad = torch.from_numpy(padded(args[2].cpu().numpy(), args[3].cpu().numpy(), F))
    assert torch.count_nonzero(got[pad.to(cuda)]) == 0


@pytest.mark.cuda
def test_backward_kernel_is_deterministic(cuda):
    for shape in ((16, 8, 12, 16), (2, 8, 8, 1024), (40, 8, 48, 8)):
        args, spec = inputs(*shape, cuda)
        g = upstream(shape[0], shape[3], cuda)
        a = ffm.ffm_fused_bwd(g, *args, *shape[:2], spec)
        b = ffm.ffm_fused_bwd(g, *args, *shape[:2], spec)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_function_runs_both_kernels(cuda):
    args, spec = inputs(2, 8, 8, 256, cuda)
    g = upstream(2, 256, cuda)
    leaf = ffm.slab_leaf(args[1], 2, 8)
    fwd, bwd = ffm.LAUNCHES, ffm.BWD_LAUNCHES
    out = ffm.FfmFused.apply(leaf, *args, 2, 8, spec)
    (d,) = torch.autograd.grad(out, leaf, g)
    assert (ffm.LAUNCHES, ffm.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    assert within(d, ffm.ffm_fused_bwd_reference(g, *args, 2, 8, spec))


@pytest.mark.cuda
def test_each_shape_takes_its_path(cuda):
    """The warp path for the small contra tensors (16-byte loads where the
    table allows), the shared-memory path for F=16 and F=40."""
    lanes = build.load("ffm_triangle").fwt_ffm_fused_warp_lanes
    assert [lanes(F, k, 1) for F, k, _, _ in SHAPES] == [16, 0, 32, 8, 0]
    assert [lanes(F, k, 0) for F, k, _, _ in SHAPES] == [0, 0, 32, 32, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["vec16", "vec4"])
def test_ffm_gate_shape(cuda, aligned):
    """The FFM gate's F=2, k=10 (N=2, B=256): F·F·k = 40 floats per example
    take the shared-memory path, with 4-byte loads however the table is
    aligned (k % 4 ≠ 0); forward and backward against plain."""
    F, k, N, B = 2, 10, 2, 256
    lanes = build.load("ffm_triangle").fwt_ffm_fused_warp_lanes
    assert lanes(F, k, 1) == lanes(F, k, 0) == 0
    args, spec = inputs(F, k, N, B, cuda, aligned)
    got = ffm.ffm_fused(*args, F, k, spec)
    assert within(got, ffm.ffm_fused_reference(*args, F, k, spec))
    g = upstream(F, B, cuda)
    got = ffm.ffm_fused_bwd(g, *args, F, k, spec)
    assert within(got, ffm.ffm_fused_bwd_reference(g, *args, F, k, spec))
    pad = torch.from_numpy(padded(args[2].cpu().numpy(), args[3].cpu().numpy(), F))
    assert torch.count_nonzero(got[pad.to(cuda)]) == 0
