"""The CUDA FFM triangle kernels (fwumious_wabbit_tpu_torch/csrc/ffm_triangle.cu),
forward and backward, against their plain PyTorch versions, on the card. Skips without one: a CUDA
kernel has no CPU mode. This file imports no jax, so it also runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_ffm_cuda.py
"""

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu_torch.ops import ffm

# (F, k, N, B): the serving shape + tests/test_pallas_ffm.py's grid + a
# model whose contra tensor needs more than 48 KB of shared memory
SHAPES = [(2, 8, 8, 256), (4, 4, 6, 8), (16, 8, 12, 16), (3, 2, 5, 4),
          (40, 8, 48, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def inputs(F, k, N, B, device):
    rng = np.random.default_rng(F * 1000 + k * 100 + N)
    emb = rng.normal(scale=0.1, size=(B, N, F * k)).astype(np.float32)
    vals = rng.uniform(0.5, 2, (B, N)).astype(np.float32)
    fields = rng.integers(0, F, (B, N)).astype(np.int32)
    pad = rng.random((B, N))
    fields[pad < 0.15] = -1  # the kernel's padding
    fields[(pad >= 0.15) & (pad < 0.3)] = 0  # Batcher's: field 0, value 0
    vals[(pad >= 0.15) & (pad < 0.3)] = 0.0
    return tuple(torch.from_numpy(a).to(device) for a in (emb, vals, fields))


@pytest.mark.cuda
@pytest.mark.parametrize("F,k,N,B", SHAPES)
def test_kernel_matches_plain(cuda, F, k, N, B):
    emb, vals, fields = inputs(F, k, N, B, cuda)
    before = ffm.LAUNCHES
    got = ffm.ffm_triangle(emb, vals, fields, F, k)
    torch.cuda.synchronize()
    assert ffm.LAUNCHES == before + 1
    ref = ffm.ffm_triangle_reference(emb, vals, fields, F, k)
    assert got.shape == ref.shape == (B, F * (F + 1) // 2)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * (1 + ref.abs().max().item())


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda):
    emb, vals, fields = inputs(16, 8, 12, 16, cuda)
    a = ffm.ffm_triangle(emb, vals, fields, 16, 8)
    b = ffm.ffm_triangle(emb, vals, fields, 16, 8)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    emb, vals, fields = inputs(2, 8, 8, 4, cuda)
    with pytest.raises(TypeError):
        ffm.ffm_triangle(emb, vals, fields.long(), 2, 8)
    with pytest.raises(ValueError):
        ffm.ffm_triangle(emb.transpose(0, 1), vals, fields, 2, 8)
    big = torch.zeros((1, 1, 64 * 64), device=cuda)
    with pytest.raises(ValueError, match="227 KB"):
        ffm.ffm_triangle(big, vals[:1, :1].contiguous(),
                         fields[:1, :1].contiguous(), 64, 64)
    g = torch.zeros((1, 64 * 65 // 2), device=cuda)
    with pytest.raises(ValueError, match="227 KB"):
        ffm.ffm_triangle_bwd(g, big, vals[:1, :1].contiguous(),
                             fields[:1, :1].contiguous(), 64, 64)
    g = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):
        ffm.ffm_triangle_bwd(g[:, :2], emb, vals, fields, 2, 8)
    with pytest.raises(ValueError):
        ffm.ffm_triangle_bwd(g.t().contiguous().t(), emb, vals, fields, 2, 8)


def upstream(F, B, device):
    rng = np.random.default_rng(F * 7 + B)
    g = rng.normal(size=(B, F * (F + 1) // 2)).astype(np.float32)
    return torch.from_numpy(g).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("F,k,N,B", SHAPES)
def test_backward_kernel_matches_plain(cuda, F, k, N, B):
    emb, vals, fields = inputs(F, k, N, B, cuda)
    g = upstream(F, B, cuda)
    before = ffm.BWD_LAUNCHES
    got = ffm.ffm_triangle_bwd(g, emb, vals, fields, F, k)
    torch.cuda.synchronize()
    assert ffm.BWD_LAUNCHES == before + 1
    ref = ffm.ffm_triangle_bwd_reference(g, emb, vals, fields, F, k)
    assert got.shape == ref.shape == emb.shape
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * (1 + ref.abs().max().item())
    pad = ((fields < 0) | (fields >= F) | (vals == 0))
    assert torch.count_nonzero(got[pad]) == 0


@pytest.mark.cuda
def test_backward_kernel_is_deterministic(cuda):
    emb, vals, fields = inputs(16, 8, 12, 16, cuda)
    g = upstream(16, 16, cuda)
    a = ffm.ffm_triangle_bwd(g, emb, vals, fields, 16, 8)
    b = ffm.ffm_triangle_bwd(g, emb, vals, fields, 16, 8)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_function_runs_both_kernels(cuda):
    emb, vals, fields = inputs(2, 8, 8, 256, cuda)
    g = upstream(2, 256, cuda)
    e = emb.clone().requires_grad_(True)
    fwd, bwd = ffm.LAUNCHES, ffm.BWD_LAUNCHES
    out = ffm.FfmTriangle.apply(e, vals, fields, 2, 8)
    (d,) = torch.autograd.grad(out, e, g)
    assert (ffm.LAUNCHES, ffm.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    ref = ffm.ffm_triangle_bwd_reference(g, emb, vals, fields, 2, 8)
    assert (d - ref).abs().max().item() <= 1e-5 * (1 + ref.abs().max().item())
