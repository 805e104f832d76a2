"""The CUDA sparse AdaGrad update kernel
(fwumious_wabbit_tpu_torch/csrc/sparse_update.cu) against its plain PyTorch
version (ops/adagrad.apply_rows_plain), on the card. Skips without one: a
CUDA kernel has no CPU mode. This file imports no jax, so it also runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_sparse_update_cuda.py

Tolerance on w and acc: rtol 1e-5, atol 1e-6 (the bound of
tests/test_pallas_sparse_update.py): the kernel sums each row's gradients in
sorted order and rates the sum once, the plain version adds rate·g per row
with index_add_, and the card's rsqrtf/powf differ from the CPU's pow in the
last bits.
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
