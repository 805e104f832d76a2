"""Port table geometry and gathers (fwumious_wabbit_tpu_torch/ops/tables.py)
against the JAX package's: the geometry defines the model file's layout, so
it must be identical, and the gathers must return exactly the same floats."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fwumious_wabbit_tpu.ops import tables as jt
from fwumious_wabbit_tpu_torch.ops import tables as tt

# (logical size, slab): scalar LR tables, FFM slabs below/at/above 128 lanes
# (incl. non-power-of-two and multi-row slabs), and sizes past 2048 rows
# where the row count is padded to the 2048-row chunk
GEOMETRY = [
    (1 << 12, 1), (1 << 18, 1), (1 << 20, 1), (3000, 1),
    ((1 << 12) + 16, 16), ((1 << 18) + 16, 16), ((1 << 18) + 24, 12),
    ((1 << 14) + 6, 6), ((1 << 12) + 128, 128), ((1 << 18) + 160, 160),
    ((1 << 12) + 384, 384), ((1 << 19) + 300, 300), (100, 3),
]


@pytest.mark.parametrize("size,slab", GEOMETRY)
def test_make_spec_matches_jax(size, slab):
    a = jt.make_spec(size, slab)
    b = tt.make_spec(size, slab)
    assert (b.logical_size, b.slab, b.align, b.rows_per_slab, b.padded_size) == \
        (a.logical_size, a.slab, a.align, a.rows_per_slab, a.padded_size)
    assert (b.num_rows, b.positions) == (a.num_rows, a.positions)


@pytest.mark.parametrize("size,slab", [
    ((1 << 12) + 16, 16), ((1 << 12) + 24, 12), ((1 << 12) + 6, 6),
    ((1 << 12) + 128, 128), ((1 << 12) + 160, 160), ((1 << 12) + 384, 384),
    ((1 << 14) + 32, 32),
])
def test_gather_matches_jax(size, slab):
    spec = tt.make_spec(size, slab)
    rng = np.random.default_rng(size + slab)
    flat = rng.normal(size=size).astype(np.float32)
    rows_j = jt.to_rows(jnp.asarray(flat), jt.make_spec(size, slab))
    rows_t = tt.to_rows(torch.from_numpy(flat), spec)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    # hashes as the translator masks them: below 2^bits, any low bits
    ids = rng.integers(0, size - slab, (5, 7)).astype(np.int32)
    want = np.asarray(jt.gather(rows_j, jnp.asarray(ids), jt.make_spec(size, slab))[0])
    got = tt.gather(rows_t, torch.from_numpy(ids), spec).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tt.to_flat(rows_t, spec).numpy(), flat)


def test_gather_scalars_matches_jax():
    size = 1 << 12
    spec = tt.make_spec(size, 1)
    rng = np.random.default_rng(3)
    flat = rng.normal(size=size).astype(np.float32)
    rows = tt.to_rows(torch.from_numpy(flat), spec)
    ids = rng.integers(0, size, (6, 9)).astype(np.int32)
    want = np.asarray(jt.gather_scalars(jnp.asarray(rows.numpy()), jnp.asarray(ids))[0])
    got = tt.gather_scalars(rows, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


# -- backward: expand and per-example dedup ---------------------------------------
#
# The JAX package dedups pairwise (order kept) for narrow inputs and by sort
# (entries reordered) for wide ones (fwumious_wabbit_tpu/ops/tables.py:245-252);
# the port keeps entries in place with one sort path. Where JAX keeps the order
# the results are compared entry for entry; everywhere they are also compared
# by what the update consumes: Σg and Σg² per table row. Tolerance rtol 1e-5,
# atol 1e-6: the run sums are taken in other orders, and JAX's sort path takes
# them as differences of an f32 cumulative sum, whose error grows with the
# sum of the |g| before a run; cotangents are drawn at 0.1 scale, as in
# tests/test_pallas_sparse_update.py.

# (batch, W): JAX's pairwise side, then its sort side (W > 128)
DEDUP_SHAPES = [(6, 9), (3, 130)]


def effect(rid, grows, rows):
    rid = np.asarray(rid).astype(np.int64)
    g = np.asarray(grows, np.float64)
    s = np.zeros((rows, tt.LANE))
    q = np.zeros((rows, tt.LANE))
    np.add.at(s, rid, g)
    np.add.at(q, rid, g * g)
    return s, q


def assert_same_update(got, want, rows):
    for a, b in zip(effect(*got, rows), effect(*want, rows)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def dup_ids(batch, W, vocab, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, W)).astype(np.int32)


@pytest.mark.parametrize("batch,W", DEDUP_SHAPES)
def test_expand_scalar_grads_dedup_matches_jax(batch, W):
    size = 1 << 12
    ids = dup_ids(batch, W, 40, W) * 97 % size  # repeats within an example
    g = (np.random.default_rng(1).normal(size=(batch, W)) * 0.1).astype(np.float32)
    got = tt.expand_scalar_grads_dedup(torch.from_numpy(ids), torch.from_numpy(g))
    want = jt.expand_scalar_grads_dedup(jnp.asarray(ids), jnp.asarray(g))
    rows = size // tt.LANE
    assert_same_update(got, want, rows)
    if jt.dedup_preserves_order(batch, W):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=1e-6)
    # and the plain expansion, without dedup, entry for entry
    table = jnp.zeros((rows, tt.LANE), jnp.float32)
    _, aux = jt.gather_scalars(table, jnp.asarray(ids))
    want = jt.expand_scalar_grads(aux, jnp.asarray(g))
    got = tt.expand_scalar_grads(torch.from_numpy(ids), torch.from_numpy(g))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("batch,W", DEDUP_SHAPES)
@pytest.mark.parametrize("slab", [16, 6, 128])
def test_expand_grads_dedup_matches_jax(batch, W, slab):
    size = (1 << 12) + slab
    spec = tt.make_spec(size, slab)
    ids = dup_ids(batch, W, 30, slab) * 131 % (size - slab)
    g = (np.random.default_rng(2).normal(size=(batch, W, slab)) * 0.1).astype(np.float32)
    got = tt.expand_grads_dedup(torch.from_numpy(ids), torch.from_numpy(g), spec)
    want = jt.expand_grads_dedup(jnp.asarray(ids), jnp.asarray(g),
                                 jt.make_spec(size, slab))
    assert_same_update(got, want, spec.num_rows)
    if jt.dedup_preserves_order(batch, W):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batch,W", DEDUP_SHAPES)
@pytest.mark.parametrize("slab", [16, 12, 160, 384])
def test_expand_grads_and_dedup_rows_match_jax(batch, W, slab):
    """The row-level path: expand every occurrence, then dedup keyed by the
    window id (single-row slabs) or the row (multi-row slabs)."""
    size = (1 << 12) + slab
    spec, jspec = tt.make_spec(size, slab), jt.make_spec(size, slab)
    ids = dup_ids(batch, W, 30, slab + 1) * 131 % (size - slab)
    g = (np.random.default_rng(3).normal(size=(batch, W, slab)) * 0.1).astype(np.float32)
    table = jnp.zeros((jspec.num_rows, tt.LANE), jnp.float32)
    _, aux = jt.gather(table, jnp.asarray(ids), jspec)
    want = jt.expand_grads(aux, jnp.asarray(g), jspec)
    got = tt.expand_grads(torch.from_numpy(ids), torch.from_numpy(g), spec)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    keys = None
    if spec.rows_per_slab == 1:
        keys = ids >> (spec.align - 1).bit_length()
    got = tt.dedup_rows(*got, batch,
                        keys=None if keys is None else torch.from_numpy(keys))
    want = jt.dedup_rows(*want, batch,
                         keys=None if keys is None else jnp.asarray(keys))
    assert_same_update(got, want, spec.num_rows)
    if jt.dedup_preserves_order(batch, got[0].shape[0] // batch):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=1e-6)


def test_dedup_sums_onto_the_first_occurrence():
    keys = torch.tensor([[5, 3, 5, 5, 3, 7]])
    payload = torch.arange(6, dtype=torch.float32).reshape(1, 6, 1) + 1
    _, out = tt._dedup_runs(keys, payload)
    assert out[0, :, 0].tolist() == [1 + 3 + 4, 2 + 5, 0, 0, 0, 6]
