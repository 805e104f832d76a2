"""The CUDA sparse AdaGrad update kernel
(fwumious_wabbit_tpu_torch/csrc/sparse_update.cu) against its plain PyTorch
version (ops/adagrad.apply_rows_plain), on the card. Skips without one: a
CUDA kernel has no CPU mode. This file imports no jax, so it also runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_sparse_update_cuda.py

Tolerance on w and acc: rtol 1e-5, atol 1e-6 (the bound of
tests/test_pallas_sparse_update.py): the kernel sums each row's gradients
tile by tile in sorted order and rates the sum once, the plain version adds
rate·g per row with index_add_, and the flex rate's rsqrtf/powf differ from
torch's pow in the last bits. Where every id occurs once, the LUT and SGD
updates equal the plain version bit for bit: one term needs no sum, the LUT
rate is the table's entry, and each product and difference is rounded on its
own on both sides.

The kernel's schedule (csrc/sparse_update.cu) cuts the sorted ids into
tiles of sparse_update.TILE positions and sums a run that crosses a tile
edge in a second pass; the schedule tests put runs at every offset of a
tile.
"""

import numpy as np
import pytest
import torch

from fwumious_wabbit_tpu_torch.ops import adagrad, sparse_update

KINDS = [adagrad.OPT_ADAGRAD_LUT, adagrad.OPT_ADAGRAD_FLEX, adagrad.OPT_SGD]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda:0")


def case(R, K, seed, dup_heavy=False, pad=0, device="cpu"):
    rng = np.random.default_rng(seed)
    hi = 8 if dup_heavy else R
    rid = rng.integers(0, hi, K).astype(np.int32)
    rid[:pad] = R  # padding ids
    g = (rng.normal(size=(K, 128)) * 0.1).astype(np.float32)
    w = rng.normal(size=(R, 128)).astype(np.float32)
    acc = rng.uniform(0, 2, size=(R, 128)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (w, acc, rid, g))


def both(w, acc, rid, g, kind, power_t, iag=0.0):
    """(kernel result, plain result) on copies of the same tables."""
    has_acc = kind != adagrad.OPT_SGD
    w1, a1 = w.clone(), acc.clone() if has_acc else None
    before = sparse_update.LAUNCHES
    sparse_update.sparse_adagrad_update(w1, a1, rid, g, 0.1, power_t, iag, kind)
    torch.cuda.synchronize()
    assert sparse_update.LAUNCHES == before + 1
    w2, a2 = w.clone(), acc.clone() if has_acc else None
    adagrad.apply_rows_plain(w2, a2, rid, g, kind, 0.1, power_t, iag)
    return (w1, a1), (w2, a2)


def assert_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def check_ids(rid, device, kind=adagrad.OPT_ADAGRAD_FLEX, power_t=0.5, R=None,
              seed=0):
    """The kernel against plain on random tables for the ids ``rid``, handed
    over in a shuffled order (the kernel sorts them); returns the kernel's w
    and the w it started from. The flex rate by default: the LUT rate steps
    at each bucket edge, and a sum in another order lands acc one ulp across
    an edge about once in 10^6 weights; these tests are of the sums."""
    rng = np.random.default_rng(seed)
    rid = rng.permutation(np.asarray(rid, np.int32))
    R = R or int(rid.max()) + 2
    _, _, _, g = case(1, len(rid), seed, device=device)
    w, acc, _, _ = case(R, 1, seed + 1, device=device)
    (w1, a1), (w2, a2) = both(w, acc, torch.from_numpy(rid).to(device), g,
                              kind, power_t, iag=0.5)
    assert_close(w1, w2)
    if a1 is not None:
        assert_close(a1, a2)
    return w1, w


@pytest.mark.cuda
@pytest.mark.parametrize("length", ["T-1", "T", "T+1", "2T", "2T+1"])
def test_runs_across_tile_edges(cuda, length):
    """A run of T−1, T, T+1, 2T or 2T+1 positions starting at every offset
    of a tile: ``off`` distinct ids sort before it, T + 3 after it."""
    tile = sparse_update.TILE
    L = {"T-1": tile - 1, "T": tile, "T+1": tile + 1, "2T": 2 * tile,
         "2T+1": 2 * tile + 1}[length]
    for off in range(tile):
        rid = np.concatenate([np.arange(off), np.full(L, 500),
                              np.arange(1000, 1000 + tile + 3)])
        check_ids(rid, cuda, seed=off)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 5, 31, 2048, 20000])
def test_one_run_covers_all_of_k(cuda, K):
    """K = 1, K < T, and one run over all K positions; at K = 20,000 the
    second pass counts the run's 312 tiles in three rounds of 128."""
    check_ids(np.full(K, 3), cuda, R=16)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 7, 700])
def test_every_id_padding(cuda, K):
    """Ids ≥ R change nothing, as in the plain version; nor do ids < 0,
    which the kernel also takes as padding (the plain version does not)."""
    w1, w = check_ids(64 + np.arange(K) % 3 * 1000, cuda, R=64)
    assert torch.equal(w1, w)
    w, acc, _, g = case(64, K, 3, device=cuda)
    w1, a1 = w.clone(), acc.clone()
    rid = torch.full((K,), -3, dtype=torch.int32, device=cuda)
    rid[::2] = 64
    sparse_update.sparse_adagrad_update(w1, a1, rid, g, 0.1, 0.5, 0.5,
                                        adagrad.OPT_ADAGRAD_LUT)
    assert torch.equal(w1, w) and torch.equal(a1, acc)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_ffm_step_pattern(cuda, kind):
    """The FFM step's pattern: ~75% of positions on row 0 with zero
    gradients (the padding slots), the rest scattered over the table."""
    K, R = 8192, 32768
    rng = np.random.default_rng(11)
    rid = rng.integers(1, R, K).astype(np.int32)
    pad = rng.random(K) < 0.75
    rid[pad] = 0
    w, acc, _, g = case(R, K, 12, device=cuda)
    g[torch.from_numpy(pad).to(cuda)] = 0.0
    (w1, a1), (w2, a2) = both(w, acc, torch.from_numpy(rid).to(cuda), g, kind,
                              0.0)
    assert_close(w1, w2)
    if a1 is not None:
        assert_close(a1, a2)
        assert torch.equal(a1[0], acc[0])  # zero gradients leave row 0 as it was
    assert torch.equal(w1[0], w[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,power_t", [
    (adagrad.OPT_ADAGRAD_LUT, 0.0), (adagrad.OPT_ADAGRAD_LUT, 0.5),
    (adagrad.OPT_ADAGRAD_LUT, 0.25), (adagrad.OPT_SGD, 0.0)])
def test_distinct_ids_bit_for_bit(cuda, kind, power_t):
    """Every id once: the kernel equals the plain version bit for bit."""
    R, K = 40000, 16384
    rng = np.random.default_rng(13)
    rid = rng.permutation(R)[:K].astype(np.int32)
    w, acc, _, g = case(R, K, 14, device=cuda)
    (w1, a1), (w2, a2) = both(w, acc, torch.from_numpy(rid).to(cuda), g, kind,
                              power_t, iag=0.5)
    assert torch.equal(w1.view(torch.int32), w2.view(torch.int32))
    if a1 is not None:
        assert torch.equal(a1.view(torch.int32), a2.view(torch.int32))


@pytest.mark.cuda
def test_reruns_bit_identical_at_the_ffm_step_shape(cuda):
    """K = 8,192 with a run of 6,144 positions: two runs of the kernel give
    the same bits."""
    K, R = 8192, 32768
    rng = np.random.default_rng(15)
    rid = rng.integers(1, R, K).astype(np.int32)
    rid[rng.permutation(K)[:6144]] = 0
    w, acc, _, g = case(R, K, 16, device=cuda)
    rid_t = torch.from_numpy(rid).to(cuda)
    outs = []
    for _ in range(2):
        w1, a1 = w.clone(), acc.clone()
        sparse_update.sparse_adagrad_update(w1, a1, rid_t, g, 0.1, 0.5, 0.5,
                                            adagrad.OPT_ADAGRAD_LUT)
        outs.append((w1.view(torch.int32), a1.view(torch.int32)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    (w1, a1), (w2, a2) = both(w, acc, rid_t, g, adagrad.OPT_ADAGRAD_LUT, 0.5, 0.5)
    assert_close(w1, w2)
    assert_close(a1, a2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dup_heavy", [False, True])
@pytest.mark.parametrize("power_t", [0.0, 0.5, 0.25])
def test_kernel_matches_plain(cuda, kind, dup_heavy, power_t):
    w, acc, rid, g = case(512, 300, 7, dup_heavy=dup_heavy, pad=5, device=cuda)
    (w1, a1), (w2, a2) = both(w, acc, rid, g, kind, power_t, iag=0.5)
    assert_close(w1, w2)
    if a1 is not None:
        assert_close(a1, a2)


@pytest.mark.cuda
def test_untouched_rows_stay_bit_identical(cuda):
    """Runs far apart with empty stretches between them: rows no id names
    come back exactly as they were."""
    R = 4096
    rid = torch.tensor([0] * 333 + [3 * 1024 + 5] * 77 + [R] * 3,
                       dtype=torch.int32, device=cuda)
    _, _, _, g = case(1, len(rid), 9, device=cuda)
    w, acc, _, _ = case(R, 1, 9, device=cuda)
    (w1, a1), (w2, a2) = both(w, acc, rid, g, adagrad.OPT_ADAGRAD_LUT, 0.5)
    assert_close(w1, w2)
    assert_close(a1, a2)
    untouched = torch.ones(R, dtype=torch.bool, device=cuda)
    untouched[[0, 3 * 1024 + 5]] = False
    assert torch.equal(w1[untouched], w[untouched])
    assert torch.equal(a1[untouched], acc[untouched])


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda):
    w, acc, rid, g = case(64, 4096, 3, dup_heavy=True, device=cuda)
    outs = []
    for _ in range(2):
        w1, a1 = w.clone(), acc.clone()
        sparse_update.sparse_adagrad_update(w1, a1, rid, g, 0.1, 0.5, 0.0,
                                            adagrad.OPT_ADAGRAD_LUT)
        outs.append((w1, a1))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    w, acc, rid, g = case(64, 32, 4, device=cuda)
    lut = adagrad.OPT_ADAGRAD_LUT
    with pytest.raises(TypeError):
        sparse_update.sparse_adagrad_update(w, acc, rid.long(), g, 0.1, 0.5, 0.0, lut)
    with pytest.raises(TypeError):
        sparse_update.sparse_adagrad_update(w, acc, rid, g.double(), 0.1, 0.5, 0.0, lut)
    with pytest.raises(ValueError):
        sparse_update.sparse_adagrad_update(w, None, rid, g, 0.1, 0.5, 0.0, lut)
    with pytest.raises(ValueError):
        sparse_update.sparse_adagrad_update(w, acc, rid, g[:, :64], 0.1, 0.5, 0.0, lut)
    with pytest.raises(ValueError):
        sparse_update.sparse_adagrad_update(w, acc, rid, g.t().contiguous().t(),
                                            0.1, 0.5, 0.0, lut)
    with pytest.raises(ValueError):
        sparse_update.sparse_adagrad_update(w, acc, rid.cpu(), g, 0.1, 0.5, 0.0, lut)
    unaligned = torch.empty(g.numel() + 1, device=cuda)[1:].view(g.shape)
    with pytest.raises(ValueError):
        sparse_update.sparse_adagrad_update(w, acc, rid, unaligned, 0.1, 0.5, 0.0, lut)


@pytest.mark.cuda
def test_kernel_refuses_a_scratch_sized_for_another_tile(cuda, monkeypatch):
    """The wrapper sizes the scratch for sparse_update.TILE positions per
    tile; the kernel launches only when that is its own tile size."""
    w, acc, rid, g = case(64, 300, 5, device=cuda)
    monkeypatch.setattr(sparse_update, "TILE", sparse_update.TILE * 2)
    with pytest.raises(RuntimeError):
        sparse_update.sparse_adagrad_update(w, acc, rid, g, 0.1, 0.5, 0.0,
                                            adagrad.OPT_ADAGRAD_LUT)
