"""The port's optimizer arithmetic (fwumious_wabbit_tpu_torch/ops/adagrad.py)
against the JAX package's (fwumious_wabbit_tpu/ops/adagrad.py) and the
reference's table: the LUT rate bit for bit over all 2048 buckets, the flex
update, the count codes, the batch-mean factors and caps, and what a
denormal accumulator does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fwumious_wabbit_tpu.ops import adagrad as ja
from fwumious_wabbit_tpu_torch.ops import adagrad as ta

SHIFT = 31 - ta.FASTMATH_LR_LUT_BITS


def bucket_accs() -> np.ndarray:
    """Each bucket's lower edge and a mid-bucket bit pattern, as f32."""
    keys = np.arange(ta.FASTMATH_LR_LUT_SIZE, dtype=np.uint32)
    edge = (keys << SHIFT).view(np.float32)
    mid = ((keys << SHIFT) | np.uint32(1 << (SHIFT - 1))).view(np.float32)
    return np.concatenate([edge, mid])


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


LUT_GRID = [
    (0.1, 0.0, 0.0), (1.0, 0.0, 1.0), (0.1, 0.5, 0.0), (0.1, 0.5, 1.0),
    (0.15, 0.5, 0.1), (0.1, 0.3, 0.0), (0.5, 0.3, 0.5), (0.1, 0.3, 1.0)]


@pytest.mark.parametrize("lr,power_t,iag", LUT_GRID)
def test_lut_rate_compute_is_the_table_bit_for_bit(lr, power_t, iag):
    """The arithmetic LUT rate equals the port's build_lut lookup and the
    JAX lut_rate_compute bit for bit, and the port's table is the JAX one."""
    accs = bucket_accs()
    lut = ta.build_lut(lr, power_t, iag)
    np.testing.assert_array_equal(bits(lut), bits(ja.build_lut(lr, power_t, iag)))
    want = lut[accs.view(np.uint32) >> SHIFT]
    got = ta.lut_rate_compute(torch.from_numpy(accs), lr, power_t, iag).numpy()
    jax_got = np.asarray(ja.lut_rate_compute(jnp.asarray(accs), lr, power_t, iag))
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(got), bits(jax_got))


@pytest.mark.parametrize("lr,power_t,iag", LUT_GRID)
def test_device_lut_is_the_jax_table_bit_for_bit(lr, power_t, iag):
    """The table the sparse update wrapper hands the CUDA kernel equals the
    JAX package's build_lut bit for bit, and reading it as the kernel does,
    at the top 11 bits of acc, gives the port's lut_rate_compute over all
    2048 buckets."""
    table = ta.device_lut(lr, power_t, iag, torch.device("cpu"))
    assert table.dtype == torch.float32 and table.shape == (ta.FASTMATH_LR_LUT_SIZE,)
    np.testing.assert_array_equal(bits(table.numpy()),
                                  bits(ja.build_lut(lr, power_t, iag)))
    accs = torch.from_numpy(bucket_accs())
    looked_up = table[(accs.view(torch.int32) >> SHIFT) & (ta.FASTMATH_LR_LUT_SIZE - 1)]
    np.testing.assert_array_equal(
        bits(looked_up.numpy()),
        bits(ta.lut_rate_compute(accs, lr, power_t, iag).numpy()))


def test_device_lut_is_built_once_per_key():
    cpu = torch.device("cpu")
    a = ta.device_lut(0.1, 0.5, 0.0, cpu)
    assert ta.device_lut(0.1, 0.5, 0.0, cpu) is a
    b = ta.device_lut(0.1, 0.5, 1.0, cpu)
    assert b is not a and ta.device_lut(0.1, 0.5, 1.0, cpu) is b
    assert not torch.equal(a, b)


def test_flex_update_matches_jax():
    rng = np.random.default_rng(1)
    g = rng.normal(size=500).astype(np.float32)
    acc = rng.uniform(0, 3, 500).astype(np.float32)
    acc[:4] = 0.0  # 0^-p = inf: NaN/inf updates become 0
    g[:2] = 0.0
    for power_t in (0.0, 0.5, 0.4):
        got = ta.flex_update(torch.from_numpy(g), torch.from_numpy(acc), 0.15,
                             power_t).numpy()
        want = np.asarray(ja.flex_update(jnp.asarray(g), jnp.asarray(acc), 0.15,
                                         power_t))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert np.isfinite(got).all()
    # the reference's unit golden (src/optimizer.rs:180-226)
    upd = ta.flex_update(torch.tensor(0.1), torch.tensor(0.91), 0.15, 0.4)
    assert abs(float(upd) - 0.015576674) < 1e-6


def test_encode_counts_matches_jax():
    c = np.arange(100_001)
    np.testing.assert_array_equal(ta.encode_counts(c), ja.encode_counts(c))


def test_decode_counts_and_count_factor_match_jax():
    codes = np.arange(256, dtype=np.uint8)
    got = ta.decode_counts(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ja.decode_counts(jnp.asarray(codes))))
    plain = np.array([0, 1, 2, 7, 8, 9, 100, 5000], np.int32)
    for cap in (8.0, 1.0, 3.0):
        t = ta.ScopedOptimizer(ta.OPT_ADAGRAD_LUT, 0.1, 0.0, 0.0, True, cap)
        j = ja.ScopedOptimizer(ja.OPT_ADAGRAD_LUT, 0.1, 0.0, 0.0, True, cap)
        for counts in (codes, plain):
            np.testing.assert_array_equal(
                t.count_factor(torch.from_numpy(counts)).numpy(),
                np.asarray(j.count_factor(jnp.asarray(counts))))


@pytest.mark.parametrize("dup_heavy", [False, True])
def test_batch_mean_grads_match_jax(dup_heavy):
    rng = np.random.default_rng(4)
    K = 300
    rid = rng.integers(0, 6 if dup_heavy else 200, K).astype(np.int32)
    g = (rng.normal(size=(K, 128)) * 0.1).astype(np.float32)
    g[rng.random((K, 128)) < 0.7] = 0.0  # untouched lanes do not count
    for cap in (8.0, 2.0):
        got = ta.batch_mean_grads(torch.from_numpy(rid), torch.from_numpy(g), cap)
        want = ja.batch_mean_grads(512, jnp.asarray(rid), jnp.asarray(g), cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0)


def test_initial_acc_and_state_match_jax():
    for kind in (ta.OPT_SGD, ta.OPT_ADAGRAD_FLEX, ta.OPT_ADAGRAD_LUT):
        t = ta.ScopedOptimizer(kind, 0.1, 0.5, 0.25)
        j = ja.ScopedOptimizer(kind, 0.1, 0.5, 0.25)
        assert (t.has_state, t.initial_acc()) == (j.has_state, j.initial_acc())


def test_denormal_accumulator():
    """A denormal acc: its LUT rate is the JAX package's (both flush
    denormal bucket edges: bucket 0's rate is lr). The port keeps a
    denormal acc where XLA on the CPU flushes it to 0, and its flex update
    is the IEEE value — the reference's, which does not flush."""
    acc = np.float32(1e-40)
    assert 0.0 < abs(acc) < np.finfo(np.float32).tiny  # denormal
    for power_t in (0.0, 0.5, 0.3):
        got = ta.lut_rate_compute(torch.tensor([acc]), 0.1, power_t, 0.0).numpy()
        want = np.asarray(ja.lut_rate_compute(jnp.asarray([acc]), 0.1, power_t, 0.0))
        np.testing.assert_array_equal(bits(got), bits(want))
        assert got[0] == np.float32(0.1)
    g2 = np.float32(1e-39)
    bumped = (torch.tensor([acc]) + torch.tensor([g2])).numpy()
    assert bumped[0] == acc + g2 != 0.0
    assert float(np.asarray(jnp.float32(acc) + jnp.float32(g2))) == 0.0
    upd = ta.flex_update(torch.tensor([0.1]), torch.tensor([acc]), 0.1, 0.5)
    want = np.float32(0.1) * np.float32(0.1) * np.float32(np.float64(acc) ** -0.5)
    np.testing.assert_allclose(upd.numpy(), [want], rtol=1e-6)
