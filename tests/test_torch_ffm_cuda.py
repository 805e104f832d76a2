"""The fused CUDA FFM kernels (fwumious_wabbit_tpu_torch/csrc/ffm_triangle.cu),
forward and backward, against their plain PyTorch versions (tables.gather,
then the triangle and its autograd), on the card: every shape of
tests/ffm_cases.py (one-row and three-row slabs, one example streamed in
chunks at F=40), both padding forms, duplicate ids, 16-, 8- and 4-byte slab
copies, B=32,768, a contra tensor too large for the ring (slabs read from
global memory); the launch geometry; reruns bit-identical, and an example's
outputs the same bits alone, in its batch or in a permuted batch, with full
and ragged tiles.
Skips without a card: a CUDA kernel has no CPU mode. This file imports no
jax, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_ffm_cuda.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu_torch.ops import ffm
from fwumious_wabbit_tpu_torch.ops.kernels import build

from ffm_cases import SHAPES, ffm_case, padded

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def inputs(F, k, N, B, device, aligned=True, seed=1):
    """The case on the card; ``aligned=False`` puts the table 4 bytes off a
    16-byte boundary, so the kernels take 4-byte copies, ``aligned=8`` 8
    bytes off, for 8-byte copies where F·k is even."""
    table, ids, vals, fields, spec = ffm_case(F, k, N, B, "both", seed=seed)
    t = torch.from_numpy(table).to(device)
    if aligned is not True:
        off = 2 if aligned == 8 else 1
        buf = torch.empty(t.numel() + off, device=device)
        buf[off:] = t.reshape(-1)
        t = buf[off:].view(t.shape)
        assert t.is_contiguous() and t.data_ptr() % 16 == 4 * off
    rest = tuple(torch.from_numpy(a).to(device) for a in (ids, vals, fields))
    return (t, *rest), spec


def within(got, ref) -> bool:
    return (got - ref).abs().max().item() <= 1e-5 * (1 + ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, 8, False], ids=["vec16", "vec8", "vec4"])
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
@pytest.mark.parametrize("aligned", [True, 8, False], ids=["vec16", "vec8", "vec4"])
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
    """One kernel per direction at every shape, launched at the geometry
    ops/ffm.geometry states for the batch and the card's SMs: the kernel's
    own layout takes the bytes it says, slabs staged; a small batch
    spreads its tiles (one block each) over the SMs, and B=32,768 takes
    tiles of ffm.MAX_TILE examples."""
    lib = build.load("ffm_triangle")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    table = torch.zeros((8, 128), device=cuda)
    tiles = []
    for F, k, N, B in SHAPES + [(2, 8, 4, 1024), (2, 8, 4, 32768)]:
        for backward in (False, True):
            geo = ffm.launch_geometry(table, B, N, F, k, backward)
            assert geo == ffm.geometry(F, k, N, backward, 16, B, sms) and geo.staged
            assert lib.fwt_ffm_smem_bytes(int(backward), F, k, geo.tile, geo.chunk,
                                          1) == geo.smem
            assert geo.tile <= -(-B // sms)
        tiles.append(geo.tile)
    assert tiles == [1, 1, 1, 2, 1, 8, ffm.MAX_TILE]


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["vec16", "vec4"])
def test_ffm_gate_shape(cuda, aligned):
    """The FFM gate's F=2, k=10 (N=2, B=256): up to 25 examples per tile
    (2 at B=256, to spread over the SMs), each 80-byte slab in five
    16-byte copies on an aligned table (4-byte copies 4 bytes off); forward
    and backward against plain."""
    F, k, N, B = 2, 10, 2, 256
    args, spec = inputs(F, k, N, B, cuda, aligned)
    geo = ffm.geometry(F, k, N, False, ffm.table_alignment(args[0]))
    assert (geo.tile, geo.chunk, geo.vec) == (25, 50, 4 if aligned else 1)
    geo = ffm.launch_geometry(args[0], B, N, F, k, False)
    assert geo.tile == -(-B // torch.cuda.get_device_properties(cuda).multi_processor_count)
    got = ffm.ffm_fused(*args, F, k, spec)
    assert within(got, ffm.ffm_fused_reference(*args, F, k, spec))
    g = upstream(F, B, cuda)
    got = ffm.ffm_fused_bwd(g, *args, F, k, spec)
    assert within(got, ffm.ffm_fused_bwd_reference(g, *args, F, k, spec))
    pad = torch.from_numpy(padded(args[2].cpu().numpy(), args[3].cpu().numpy(), F))
    assert torch.count_nonzero(got[pad.to(cuda)]) == 0


@pytest.mark.cuda
def test_batch_of_32768(cuda):
    """BASELINE config 4's batch, B=32,768 at the main path's F=2, k=8, N=4:
    both kernels against plain, padded gradient positions exactly 0."""
    F, k, N, B = 2, 8, 4, 32768
    args, spec = inputs(F, k, N, B, cuda)
    got = ffm.ffm_fused(*args, F, k, spec)
    assert within(got, ffm.ffm_fused_reference(*args, F, k, spec))
    g = upstream(F, B, cuda)
    got = ffm.ffm_fused_bwd(g, *args, F, k, spec)
    assert within(got, ffm.ffm_fused_bwd_reference(g, *args, F, k, spec))
    pad = torch.from_numpy(padded(args[2].cpu().numpy(), args[3].cpu().numpy(), F))
    assert torch.count_nonzero(got[pad.to(cuda)]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full_tile", "ragged_tile", "ffm_gate", "chunked"])
def test_outputs_do_not_depend_on_the_batch(cuda, case):
    """Each example's triangle and gradient are the same bits alone (a
    batch of one), in the batch, and in a permuted batch: the kernels' sums
    run in an order of the example's own. The cases are chip_smoke.py's
    (invariance_shapes) at the card's SM count: tiles of ffm.MAX_TILE
    examples all full, the same with a last tile of 17, the FFM gate's
    tiles of 25 with a last tile of 7, and F=40's example streamed in
    chunks; each case's tiles are checked first."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    F, k, N, B = SMOKE.invariance_shapes(sms)[case]
    args, spec = inputs(F, k, N, B, cuda)
    geo = ffm.launch_geometry(args[0], B, N, F, k, False)
    assert {"full_tile": (geo.tile, B % geo.tile) == (ffm.MAX_TILE, 0),
            "ragged_tile": (geo.tile, B % geo.tile) == (ffm.MAX_TILE, 17),
            "ffm_gate": (geo.tile, B % geo.tile) == (25, 7),
            "chunked": geo.chunk < geo.tile * N}[case]
    g = upstream(F, B, cuda)
    fwd = ffm.ffm_fused(*args, F, k, spec)
    bwd = ffm.ffm_fused_bwd(g, *args, F, k, spec)
    perm = torch.from_numpy(np.random.default_rng(B).permutation(B)).to(cuda)
    table, rest = args[0], args[1:]
    p_rest = [a[perm].contiguous() for a in rest]
    assert torch.equal(ffm.ffm_fused(table, *p_rest, F, k, spec), fwd[perm])
    assert torch.equal(ffm.ffm_fused_bwd(g[perm].contiguous(), table, *p_rest, F, k,
                                         spec), bwd[perm])
    for b in (0, 1, B // 2, B - 9, B - 1):
        one = [a[b:b + 1].contiguous() for a in rest]
        assert torch.equal(ffm.ffm_fused(table, *one, F, k, spec), fwd[b:b + 1])
        assert torch.equal(ffm.ffm_fused_bwd(g[b:b + 1].contiguous(), table, *one,
                                             F, k, spec), bwd[b:b + 1])


@pytest.mark.cuda
def test_contra_tensor_too_large_for_the_ring(cuda):
    """F=30, k=63: C takes 226,800 of a block's 232,448 bytes, so no ring
    fits beside it and both kernels read slabs (and g_out) from global
    memory; against plain, reruns bit-identical."""
    F, k, N, B = 30, 63, 5, 3
    for backward in (False, True):
        assert not ffm.geometry(F, k, N, backward).staged
    args, spec = inputs(F, k, N, B, cuda)
    got = ffm.ffm_fused(*args, F, k, spec)
    assert within(got, ffm.ffm_fused_reference(*args, F, k, spec))
    assert torch.equal(got, ffm.ffm_fused(*args, F, k, spec))
    g = upstream(F, B, cuda)
    got = ffm.ffm_fused_bwd(g, *args, F, k, spec)
    assert within(got, ffm.ffm_fused_bwd_reference(g, *args, F, k, spec))
    assert torch.equal(got, ffm.ffm_fused_bwd(g, *args, F, k, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("F,k,N,B", [(2, 8, 300, 3), (2, 10, 900, 2)])
def test_main_shape_example_in_chunks(cuda, F, k, N, B):
    """The main path's F and k with an example whose slabs outgrow a ring
    stage: a tile is one example streamed in chunks through C in shared
    memory (the backward in two sweeps), not the one-chunk register path;
    both kernels against plain, padded gradient positions exactly 0."""
    for backward in (False, True):
        geo = ffm.geometry(F, k, N, backward)
        assert geo.tile == 1 and geo.chunk < N
    args, spec = inputs(F, k, N, B, cuda)
    got = ffm.ffm_fused(*args, F, k, spec)
    assert within(got, ffm.ffm_fused_reference(*args, F, k, spec))
    g = upstream(F, B, cuda)
    got = ffm.ffm_fused_bwd(g, *args, F, k, spec)
    assert within(got, ffm.ffm_fused_bwd_reference(g, *args, F, k, spec))
    pad = torch.from_numpy(padded(args[2].cpu().numpy(), args[3].cpu().numpy(), F))
    assert torch.count_nonzero(got[pad.to(cuda)]) == 0
