"""The port's FFM initialization (fwumious_wabbit_tpu_torch/ops/init.py)
against the reference's merand48 (fwumious_wabbit_tpu/hashing.py) and the
JAX package's device init (fwumious_wabbit_tpu/ops/init.py), element for
element."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fwumious_wabbit_tpu import hashing
from fwumious_wabbit_tpu.ops import init as ji
from fwumious_wabbit_tpu_torch.ops import init as ti


def test_merand48_matches_hashing():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.arange(5000), rng.integers(0, 1 << 32, 5000),
                        [0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]])
    got = ti.merand48(torch.from_numpy(x.astype(np.int64))).numpy()
    want = hashing.merand48_array(x.astype(np.uint64))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    jax_got = np.asarray(ji.merand48(jnp.asarray(x.astype(np.uint32))))
    np.testing.assert_array_equal(got.view(np.uint32), jax_got.view(np.uint32))


@pytest.mark.parametrize("n,k,padded", [(4096 + 16, 4, 4224), (1000, 8, 1000),
                                        ((1 << 32) - 100, 8, 300)])
def test_ffm_init_default_matches_jax(n, k, padded, monkeypatch):
    monkeypatch.setattr(ti, "_BLOCK", 256)  # several blocks at a small size
    got = ti.ffm_init_default(n, k, padded).numpy()
    want = np.asarray(ji.ffm_init_default(n, k, padded))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.shape == (padded,)


@pytest.mark.parametrize("width,zero_band,center", [(0.1, 0.0, 0.0),
                                                    (0.2, 0.5, 0.01)])
def test_ffm_init_band_matches_reference_order(width, zero_band, center,
                                               monkeypatch):
    """Element for element against the reference's f32 arithmetic
    (src/block_ffm.rs:807-822, each operation rounded); within one f32 ulp
    of the band width of the JAX package's values, whose XLA code fuses
    some of those operations (near 0, m·bw − bw/2 cancels, so the bound is
    absolute)."""
    monkeypatch.setattr(ti, "_BLOCK", 256)
    n, padded = 4096 + 16, 4224
    got = ti.ffm_init_band(n, padded, width, zero_band, center).numpy()
    f32 = np.float32
    bw, zhb = f32(width * (1.0 - zero_band)), f32(width * zero_band * 0.5)
    w = hashing.merand48_array(np.arange(n, dtype=np.uint64)) * bw - bw * f32(0.5)
    want = np.where(w > 0, w + zhb, w - zhb) + f32(center)
    np.testing.assert_array_equal(got[:n].view(np.uint32), want.view(np.uint32))
    assert not got[n:].any()
    jax_w = np.asarray(ji.ffm_init_band(n, padded, width, zero_band, center))
    np.testing.assert_allclose(got, jax_w, rtol=0, atol=np.spacing(f32(width)))
