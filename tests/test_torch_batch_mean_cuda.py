"""The batch-mean cap counted from the update rows themselves
(fwumious_wabbit_tpu_torch/ops/adagrad.py ``batch_mean_grads``) on the
card, at the rows of one step of the 39-field FFM at Criteo widths: B =
32,768 examples of 39 slabs of two rows, K = 2,555,904 rows of 128 floats
(the benchmark's ``criteo_ffm39`` configuration, where slabs that span rows
get no host counts). Skips without a card. This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_batch_mean_cuda.py
"""

import pytest
import torch

from fwumious_wabbit_tpu_torch.ops import adagrad

K = 32768 * 39 * 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this measures the card")
    return torch.device("cuda:0")


def rows(n: int, device, seed: int = 0):
    """``n`` update rows: ids of 2^20 rows with a heavy head (a few rows in
    most examples), and each odd row zero past its 28th lane, as a slab's
    second row is."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand(n, generator=gen, dtype=torch.float64)
    rid = torch.minimum((2.0 ** 20) ** u - 1.0, torch.tensor(2.0 ** 20 - 1)).long()
    g = torch.randn(n, 128, generator=gen)
    g[1::2, 28:] = 0.0
    return rid.to(device), g.to(device)


@pytest.mark.cuda
def test_the_card_counts_as_the_cpu_does(cuda):
    rid, g = rows(1 << 16, "cpu", 1)
    want = adagrad.batch_mean_grads(rid, g, 8.0)
    got = adagrad.batch_mean_grads(rid.to(cuda), g.to(cuda), 8.0).cpu()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_a_criteo_step_takes_milliseconds(cuda):
    """A running sum down the K rows of ``[K, 128]`` took ~0.92 s a call
    here (an H100 80GB HBM3 at 700 W, the benchmark's traced pass); the
    counts summed per run of equal ids take milliseconds. The bound leaves
    room for a slower card, far under the old time."""
    rid, g = rows(K, cuda)
    adagrad.batch_mean_grads(rid, g, 8.0)
    torch.cuda.synchronize(cuda)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        adagrad.batch_mean_grads(rid, g, 8.0)
    end.record()
    torch.cuda.synchronize(cuda)
    ms = start.elapsed_time(end) / 5
    print(f"batch_mean_grads at K={K}: {ms:.2f} ms a call on {torch.cuda.get_device_name(cuda)}")
    assert ms < 100.0
