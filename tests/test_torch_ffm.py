"""The port's fused FFM entry (fwumious_wabbit_tpu_torch/ops/ffm.py: the slab
gather and the triangle, and their gradient) against the JAX package on the
same tables: the JAX gather (ops/tables.py) followed by the Pallas kernel
in interpret mode and by the XLA path (FwModel.triangle ∘ ffm_outputs), and
jax.vjp of the latter. Both slab layouts (one row, three rows), both
padding forms (field −1, and field 0 with value 0), duplicate ids. On the
CPU the entry runs its plain version; the CUDA kernels are checked against
it on the card, in tests/test_torch_ffm_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fwumious_wabbit_tpu.config.model_instance import ModelInstance, Optimizer
from fwumious_wabbit_tpu.models.model import FwModel
from fwumious_wabbit_tpu.ops import tables as jt
from fwumious_wabbit_tpu.ops.pallas.ffm import ffm_triangle as jax_ffm_triangle
from fwumious_wabbit_tpu_torch.ops import ffm

from ffm_cases import PADDINGS, SHAPES, ffm_case, padded

PALLAS_SHAPES = SHAPES[:4]  # the interpreter is slow at F=40


def jax_model(F, k):
    mi = ModelInstance()
    mi.ffm_k = k
    mi.ffm_bit_precision = 12
    mi.ffm_fields = [[] for _ in range(F)]
    mi.optimizer = Optimizer.ADAGRAD_FLEX
    mi.add_constant_feature = False
    return FwModel(mi)


def jax_slabs(table, ids, spec):
    """The JAX package's gather of the same ids from the same table."""
    jspec = jt.make_spec(spec.logical_size, spec.slab)
    assert (jspec.align, jspec.rows_per_slab, jspec.padded_size) == (
        spec.align, spec.rows_per_slab, spec.padded_size)
    return jt.gather(jnp.asarray(table), jnp.asarray(ids), jspec)[0]


def port_inputs(table, ids, vals, fields):
    return tuple(torch.from_numpy(a) for a in (table, ids, vals, fields))


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("F,k,N,B", SHAPES)
def test_plain_matches_jax(F, k, N, B, padding):
    table, ids, vals, fields, spec = ffm_case(F, k, N, B, padding)
    emb = jax_slabs(table, ids, spec)
    model = jax_model(F, k)
    batch = {"ffm_vals": jnp.asarray(vals), "ffm_fields": jnp.asarray(fields)}
    xla = np.asarray(model.triangle(model.ffm_outputs(emb, batch)))
    got = ffm.ffm_fused(*port_inputs(table, ids, vals, fields), F, k, spec)
    assert got.shape == (B, F * (F + 1) // 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), xla, rtol=1e-5, atol=1e-6)
    if (F, k, N, B) in PALLAS_SHAPES:
        pallas = np.asarray(jax_ffm_triangle(
            emb, jnp.asarray(vals), jnp.asarray(fields),
            F=F, k=k, tile=min(B, 256), interpret=True))
        np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_do_not_launch():
    table, ids, vals, fields, spec = ffm_case(2, 8, 8, 4)
    before = ffm.LAUNCHES
    ffm.ffm_fused(*port_inputs(table, ids, vals, fields), 2, 8, spec)
    assert ffm.LAUNCHES == before


# -- the gradient ------------------------------------------------------------------


def jax_grad(table, ids, vals, fields, spec, g, F, k):
    """jax.vjp of the JAX model's triangle(ffm_outputs(emb)) at ``g``, emb
    the JAX gather of the ids."""
    model = jax_model(F, k)
    batch = {"ffm_vals": jnp.asarray(vals), "ffm_fields": jnp.asarray(fields)}
    _, vjp = jax.vjp(lambda e: model.triangle(model.ffm_outputs(e, batch)),
                     jax_slabs(table, ids, spec))
    return np.asarray(vjp(jnp.asarray(g))[0])


def port_grad(table, ids, vals, fields, spec, g, F, k):
    """``d emb`` through FfmFused: the gradient its stride-0 leaf gets."""
    t, i, v, f = port_inputs(table, ids, vals, fields)
    leaf = ffm.slab_leaf(i, F, k)
    assert leaf.stride() == (0, 0, 0) and leaf.requires_grad
    out = ffm.FfmFused.apply(leaf, t, i, v, f, F, k, spec)
    (d,) = torch.autograd.grad(out, leaf, torch.from_numpy(g))
    assert d.shape == (ids.shape[0], ids.shape[1], F * k)
    return d.numpy()


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("F,k,N,B", SHAPES)
def test_gradient_matches_jax_vjp(F, k, N, B, padding):
    """rtol 1e-5, atol 1e-6: the same sums in other orders; padded
    positions get exactly 0."""
    table, ids, vals, fields, spec = ffm_case(F, k, N, B, padding)
    g = np.random.default_rng(B + N).normal(
        size=(B, F * (F + 1) // 2)).astype(np.float32)
    got = port_grad(table, ids, vals, fields, spec, g, F, k)
    np.testing.assert_allclose(
        got, jax_grad(table, ids, vals, fields, spec, g, F, k),
        rtol=1e-5, atol=1e-6)
    assert not got[padded(vals, fields, F)].any()


def test_gradient_with_a_missing_field():
    """No position of field 2: the slab every position keeps for field 2
    gets 0 (it meets no partner there), the other slabs their gradient."""
    F, k, N, B = 4, 4, 6, 8
    table, ids, vals, fields, spec = ffm_case(F, k, N, B, "minus1")
    fields[fields == 2] = 1
    g = np.random.default_rng(3).normal(size=(B, F * (F + 1) // 2)).astype(np.float32)
    got = port_grad(table, ids, vals, fields, spec, g, F, k)
    np.testing.assert_allclose(
        got, jax_grad(table, ids, vals, fields, spec, g, F, k),
        rtol=1e-5, atol=1e-6)
    per_slab = got.reshape(B, N, F, k)
    assert not per_slab[:, :, 2].any()
    assert per_slab[:, :, [0, 1, 3]][fields >= 0].any()


def test_cpu_gradient_does_not_launch():
    table, ids, vals, fields, spec = ffm_case(2, 8, 8, 4)
    g = np.ones((4, 3), np.float32)
    before = ffm.BWD_LAUNCHES
    port_grad(table, ids, vals, fields, spec, g, 2, 8)
    assert ffm.BWD_LAUNCHES == before


def test_shared_memory_size_check():
    """The kernels' shared-memory path takes up to 227 KB per example:
    F=40, k=8 (51,360 bytes, over the old 48 KB) fits, F=64, k=64 does
    not."""
    assert ffm.shared_memory_bytes(40, 8) == (40 * 40 * 8 + 40) * 4
    assert ffm.shared_memory_bytes(40, 8, backward=True) == (40 * 40 * 8 + 1600) * 4
    with pytest.raises(ValueError, match="227 KB"):
        ffm.shared_memory_bytes(64, 64)
    with pytest.raises(ValueError, match="227 KB"):
        ffm.shared_memory_bytes(64, 64, backward=True)


@pytest.mark.parametrize("F,k", [(2, 8), (40, 8), (16, 8)])
def test_slab_mask_is_the_gather_rule(F, k):
    """``id & slab_mask`` is the first flat float tables.gather reads, in
    both layouts."""
    table, ids, vals, fields, spec = ffm_case(F, k, 6, 4)
    flat = table.reshape(-1)
    base = ids.astype(np.int64) & ffm.slab_mask(spec)
    want = np.stack([flat[b:b + F * k] for b in base.reshape(-1)])
    got = ffm.tables.gather(torch.from_numpy(table), torch.from_numpy(ids), spec)
    np.testing.assert_array_equal(got.numpy().reshape(-1, F * k), want)
    assert (spec.rows_per_slab > 1) == (F * k > 128)


@pytest.mark.parametrize("F,k", [(2, 10), (3, 4), (4, 4)])
def test_field_sums_add_in_xla_order(F, k):
    """``C = einsum("bnf,bntk->btfk", onehot, weighted)`` of the plain
    triangle, bit for bit against the JAX model's einsum on XLA's CPU
    backend at every N up to 19 and at 32 and 48, every feature in one field
    (the longest sums). ``torch.einsum`` adds in feature order and differs
    from N = 4 on; a last-bit difference in C reached an AdaGrad LUT weight
    through a bucket edge (ROADMAP §3)."""
    rng = np.random.default_rng(F * 100 + k)
    xla = jax.jit(lambda a, b: jnp.einsum("bnf,bntk->btfk", a, b,
                                          precision="highest"))
    for N in [*range(1, 20), 32, 48]:
        onehot = np.zeros((16, N, F), np.float32)
        onehot[:, :, 1] = 1.0
        weighted = rng.normal(size=(16, N, F, k)).astype(np.float32)
        got = ffm.field_sums(torch.from_numpy(onehot), torch.from_numpy(weighted))
        np.testing.assert_array_equal(got.numpy(), np.asarray(xla(onehot, weighted)),
                                      err_msg=str(N))
    assert not torch.equal(
        got, torch.einsum("bnf,bntk->btfk", torch.from_numpy(onehot),
                          torch.from_numpy(weighted)))


@pytest.mark.parametrize("F,k,N,B", [(4, 4, 6, 8), (2, 8, 8, 256), (2, 10, 2, 256)])
def test_gradient_is_bit_equal_to_jax_vjp(F, k, N, B):
    """``d emb`` of the plain version equals ``jax.vjp``'s bit for bit
    where the sums of C follow XLA's order (test_field_sums_add_in_xla_order),
    the FFM gate's F=2, k=10, N=2 among them."""
    table, ids, vals, fields, spec = ffm_case(F, k, N, B, "minus1")
    g = np.random.default_rng(B + N).normal(
        size=(B, F * (F + 1) // 2)).astype(np.float32)
    np.testing.assert_array_equal(
        port_grad(table, ids, vals, fields, spec, g, F, k),
        jax_grad(table, ids, vals, fields, spec, g, F, k))


def test_xla_sums_k10_in_another_order():
    """Once the remnant of the port's float order against XLA's (ROADMAP
    §3): at the FFM gate's F=2, k=10 (N=2, B=256) the plain triangle's
    ``½Σ_k C[t,f,k]·C[f,t,k]`` and its self term's ``Σ_k own²`` added in
    another order than the JAX model's ``einsum("btfk,bftk->btf")`` and
    ``jnp.sum`` on XLA's CPU backend (196 of 768 elements differed, by up
    to 1.2e-7). They now add in XLA's orders (ops/ffm.k_dot: the first
    eight products in order, the rest fused on; the self term in order):
    the triangle is XLA's bit for bit at the gate's shape, with random
    values, as at k=8."""
    for F, k, N in ((2, 10, 2), (2, 8, 4)):
        table, ids, vals, fields, spec = ffm_case(F, k, N, 256, "minus1")
        batch = {"ffm_vals": jnp.asarray(vals), "ffm_fields": jnp.asarray(fields)}
        model = jax_model(F, k)
        np.testing.assert_array_equal(
            ffm.ffm_fused(*port_inputs(table, ids, vals, fields), F, k, spec).numpy(),
            np.asarray(model.triangle(model.ffm_outputs(jax_slabs(table, ids, spec),
                                                        batch))), err_msg=str(k))


@pytest.mark.parametrize("k", range(1, 18))
def test_k_dot_adds_in_xla_order(k):
    """ops/ffm.k_dot against the JAX model's ``einsum("btfk,bftk->btf")``
    on XLA's CPU backend, bit for bit at every k up to 17;
    ``torch.einsum`` differs at k = 2 and from k = 9 on."""
    C = np.random.default_rng(k).normal(size=(64, 3, 3, k)).astype(np.float32)
    want = np.asarray(jax.jit(lambda c: jnp.einsum("btfk,bftk->btf", c, c,
                                                   precision="highest"))(C))
    t = torch.from_numpy(C)
    np.testing.assert_array_equal(ffm.k_dot(t, t.transpose(1, 2)).numpy(), want)
