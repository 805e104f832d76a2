"""The port's FFM triangle (fwumious_wabbit_tpu_torch/ops/ffm.py) against the
JAX package: the Pallas kernel in interpret mode and the XLA path
(FwModel.triangle ∘ ffm_outputs), on the Pallas test grid plus the serving
shape, with both padding forms (field −1, and field 0 with value 0). The
CUDA kernel itself is checked against the plain version on the card, in
tests/test_torch_ffm_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fwumious_wabbit_tpu.config.model_instance import ModelInstance, Optimizer
from fwumious_wabbit_tpu.models.model import FwModel
from fwumious_wabbit_tpu.ops.pallas.ffm import ffm_triangle as jax_ffm_triangle
from fwumious_wabbit_tpu_torch.ops import ffm

# (F, k, N, B): tests/test_pallas_ffm.py's grid + the serving shape
SHAPES = [(4, 4, 6, 8), (16, 8, 12, 16), (3, 2, 5, 4), (2, 8, 8, 256)]


def make_inputs(F, k, N, B, padding):
    rng = np.random.default_rng(F * 100 + k + (7 if padding == "val0" else 0))
    # embedding weights at a trained model's scale (the FFM init draws
    # (U-0.5)/sqrt(k)/50); at unit scale the diagonal's cancellation leaves
    # f32 noise of ~1e-5 in JAX and the port alike, against a float64 truth
    emb = rng.normal(scale=0.1, size=(B, N, F * k)).astype(np.float32)
    vals = rng.uniform(0.5, 2, (B, N)).astype(np.float32)
    fields = rng.integers(0, F, (B, N)).astype(np.int32)
    pad = rng.random((B, N)) < 0.3
    if padding == "minus1":
        fields[pad] = -1
    else:  # what Batcher emits: field 0, value 0.0
        fields[pad] = 0
        vals[pad] = 0.0
    return emb, vals, fields


def jax_model(F, k):
    mi = ModelInstance()
    mi.ffm_k = k
    mi.ffm_bit_precision = 12
    mi.ffm_fields = [[] for _ in range(F)]
    mi.optimizer = Optimizer.ADAGRAD_FLEX
    mi.add_constant_feature = False
    return FwModel(mi)


@pytest.mark.parametrize("padding", ["minus1", "val0"])
@pytest.mark.parametrize("F,k,N,B", SHAPES)
def test_plain_matches_jax(F, k, N, B, padding):
    emb, vals, fields = make_inputs(F, k, N, B, padding)
    model = jax_model(F, k)
    batch = {"ffm_vals": jnp.asarray(vals), "ffm_fields": jnp.asarray(fields)}
    xla = np.asarray(model.triangle(model.ffm_outputs(jnp.asarray(emb), batch)))
    pallas = np.asarray(jax_ffm_triangle(
        jnp.asarray(emb), jnp.asarray(vals), jnp.asarray(fields),
        F=F, k=k, tile=min(B, 256), interpret=True))
    got = ffm.ffm_triangle(torch.from_numpy(emb), torch.from_numpy(vals),
                           torch.from_numpy(fields), F, k)
    assert got.shape == (B, F * (F + 1) // 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), xla, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_do_not_launch():
    emb, vals, fields = make_inputs(2, 8, 8, 4, "minus1")
    before = ffm.LAUNCHES
    ffm.ffm_triangle(torch.from_numpy(emb), torch.from_numpy(vals),
                     torch.from_numpy(fields), 2, 8)
    assert ffm.LAUNCHES == before


# -- the gradient ------------------------------------------------------------------


def jax_grad(emb, vals, fields, g, F, k):
    """jax.vjp of the JAX model's triangle(ffm_outputs(emb)) at ``g``."""
    import jax

    model = jax_model(F, k)
    batch = {"ffm_vals": jnp.asarray(vals), "ffm_fields": jnp.asarray(fields)}
    _, vjp = jax.vjp(lambda e: model.triangle(model.ffm_outputs(e, batch)),
                     jnp.asarray(emb))
    return np.asarray(vjp(jnp.asarray(g))[0])


def port_grad(emb, vals, fields, g, F, k):
    e = torch.from_numpy(emb).requires_grad_(True)
    out = ffm.FfmTriangle.apply(e, torch.from_numpy(vals),
                                torch.from_numpy(fields), F, k)
    (d,) = torch.autograd.grad(out, e, torch.from_numpy(g))
    return d.numpy()


@pytest.mark.parametrize("padding", ["minus1", "val0"])
@pytest.mark.parametrize("F,k,N,B", SHAPES)
def test_gradient_matches_jax_vjp(F, k, N, B, padding):
    """rtol 1e-5, atol 1e-6: the same sums in other orders; padded
    positions get exactly 0."""
    emb, vals, fields = make_inputs(F, k, N, B, padding)
    g = np.random.default_rng(B + N).normal(
        size=(B, F * (F + 1) // 2)).astype(np.float32)
    got = port_grad(emb, vals, fields, g, F, k)
    np.testing.assert_allclose(got, jax_grad(emb, vals, fields, g, F, k),
                               rtol=1e-5, atol=1e-6)
    pad = (fields < 0) | (vals == 0.0)
    assert not got[pad].any()


def test_gradient_with_a_missing_field():
    """No position of field 2: the slab every position keeps for field 2
    gets 0 (it meets no partner there), the other slabs their gradient."""
    F, k, N, B = 4, 4, 6, 8
    emb, vals, fields = make_inputs(F, k, N, B, "minus1")
    fields[fields == 2] = 1
    g = np.random.default_rng(3).normal(size=(B, F * (F + 1) // 2)).astype(np.float32)
    got = port_grad(emb, vals, fields, g, F, k)
    np.testing.assert_allclose(got, jax_grad(emb, vals, fields, g, F, k),
                               rtol=1e-5, atol=1e-6)
    per_slab = got.reshape(B, N, F, k)
    assert not per_slab[:, :, 2].any()
    assert per_slab[:, :, [0, 1, 3]][fields >= 0].any()


def test_cpu_gradient_does_not_launch():
    emb, vals, fields = make_inputs(2, 8, 8, 4, "minus1")
    g = np.ones((4, 3), np.float32)
    before = ffm.BWD_LAUNCHES
    port_grad(emb, vals, fields, g, 2, 8)
    assert ffm.BWD_LAUNCHES == before


def test_shared_memory_size_check():
    """The kernels take up to 227 KB of shared memory per example: F=40,
    k=8 (51,360 bytes, over the old 48 KB) fits, F=64, k=64 does not."""
    assert ffm.shared_memory_bytes(40, 8) == (40 * 40 * 8 + 40) * 4
    assert ffm.shared_memory_bytes(40, 8, backward=True) == (40 * 40 * 8 + 1600) * 4
    with pytest.raises(ValueError, match="227 KB"):
        ffm.shared_memory_bytes(64, 64)
    with pytest.raises(ValueError, match="227 KB"):
        ffm.shared_memory_bytes(64, 64, backward=True)
