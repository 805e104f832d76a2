"""The port's sparse row update on the CPU — ops/sparse_update.py's plain
version, ops/adagrad.apply_rows_plain — against the JAX package's
``apply_rows`` (the XLA scatter path) and its Pallas kernel
``sparse_adagrad_update`` run in interpret mode, as
tests/test_pallas_sparse_update.py runs it. The CUDA kernel is held against
the same plain version on the card (tests/test_torch_sparse_update_cuda.py).

Tolerance on w and acc: rtol 1e-5, atol 1e-6 (tests/test_pallas_sparse_update.py:51-55):
the three sum each weight's gradients in different orders."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fwumious_wabbit_tpu.ops import adagrad as ja
from fwumious_wabbit_tpu.ops.pallas import sparse_update as jsu
from fwumious_wabbit_tpu_torch.ops import adagrad as ta
from fwumious_wabbit_tpu_torch.ops import sparse_update as tsu

KINDS = [ta.OPT_ADAGRAD_LUT, ta.OPT_ADAGRAD_FLEX, ta.OPT_SGD]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jsu, "_INTERPRET", True)


def case(R=512, K=300, seed=0, dup_heavy=False, pad=0):
    rng = np.random.default_rng(seed)
    rid = rng.integers(0, 8 if dup_heavy else R, K).astype(np.int32)
    rid[K - pad:] = R  # padding ids
    g = (rng.normal(size=(K, 128)) * 0.1).astype(np.float32)
    w = rng.normal(size=(R, 128)).astype(np.float32)
    acc = rng.uniform(0, 2, size=(R, 128)).astype(np.float32)
    return rid, g, w, acc


def port(rid, g, w, acc, kind, lr, power_t, iag):
    w_t = torch.from_numpy(w.copy())
    a_t = torch.from_numpy(acc.copy()) if kind != ta.OPT_SGD else None
    w2, a2 = tsu.sparse_adagrad_update(w_t, a_t, torch.from_numpy(rid),
                                       torch.from_numpy(g), lr, power_t, iag, kind)
    assert w2 is w_t and a2 is a_t  # in place
    return w2.numpy(), None if a2 is None else a2.numpy()


def jax_both(rid, g, w, acc, kind, lr, power_t, iag):
    """(apply_rows, Pallas interpret) results of the JAX package."""
    opt = ja.ScopedOptimizer(kind, lr, power_t, iag, pallas_mode="off")
    xla = opt.apply_rows(jnp.asarray(w), jnp.asarray(acc), jnp.asarray(rid),
                         jnp.asarray(g))
    pallas = jsu.sparse_adagrad_update(
        jnp.array(w), jnp.array(acc) if kind != ta.OPT_SGD else None,
        jnp.asarray(rid), jnp.asarray(g), lr, power_t, iag, kind=kind)
    return xla, pallas


def assert_matches(got, refs, kind):
    for ref in refs:
        np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=1e-5, atol=1e-6)
        if kind != ta.OPT_SGD:
            np.testing.assert_allclose(got[1], np.asarray(ref[1]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dup_heavy", [False, True])
def test_matches_jax(kind, dup_heavy):
    rid, g, w, acc = case(dup_heavy=dup_heavy)
    got = port(rid, g, w, acc, kind, 0.1, 0.5, 0.0)
    assert_matches(got, jax_both(rid, g, w, acc, kind, 0.1, 0.5, 0.0), kind)


@pytest.mark.parametrize("power_t,iag", [(0.0, 0.0), (0.5, 0.5), (0.25, 1.0),
                                         (0.35, 0.5)])
@pytest.mark.parametrize("kind", [ta.OPT_ADAGRAD_LUT, ta.OPT_ADAGRAD_FLEX])
def test_power_t_variants(kind, power_t, iag):
    rid, g, w, acc = case(seed=3)
    got = port(rid, g, w, acc, kind, 0.1, power_t, iag)
    assert_matches(got, jax_both(rid, g, w, acc, kind, 0.1, power_t, iag), kind)


def test_empty_chunks_between_occupied_ones():
    """A long run in chunk 0, nothing in chunks 1-2, updates in chunk 3
    (the pattern that hung the TPU kernel): rows no id names come back
    bit-identical."""
    R = 4 * 1024
    rid = np.concatenate([np.zeros(333, np.int32),
                          np.full(77, 3 * 1024 + 5, np.int32)])
    rng = np.random.default_rng(9)
    g = (rng.normal(size=(len(rid), 128)) * 0.1).astype(np.float32)
    w = rng.normal(size=(R, 128)).astype(np.float32)
    acc = rng.uniform(0, 2, size=(R, 128)).astype(np.float32)
    kind = ta.OPT_ADAGRAD_LUT
    got = port(rid, g, w, acc, kind, 0.1, 0.5, 0.0)
    assert_matches(got, jax_both(rid, g, w, acc, kind, 0.1, 0.5, 0.0), kind)
    assert np.array_equal(got[0][1:3 * 1024 + 5], w[1:3 * 1024 + 5])
    assert np.array_equal(got[1][3 * 1024 + 6:], acc[3 * 1024 + 6:])


@pytest.mark.parametrize("kind", KINDS)
def test_pad_ids_are_dropped(kind):
    rid, g, w, acc = case(seed=5, pad=40)
    got = port(rid, g, w, acc, kind, 0.1, 0.5, 0.0)
    assert_matches(got, jax_both(rid, g, w, acc, kind, 0.1, 0.5, 0.0), kind)


def test_apply_rows_goes_through_the_wrapper():
    """ScopedOptimizer.apply_rows updates the tables in place and does not
    count a kernel launch on the CPU."""
    rid, g, w, acc = case(seed=6)
    w_t, a_t = torch.from_numpy(w.copy()), torch.from_numpy(acc.copy())
    before = tsu.LAUNCHES
    opt = ta.ScopedOptimizer(ta.OPT_ADAGRAD_FLEX, 0.1, 0.5, 0.0)
    w2, a2 = opt.apply_rows(w_t, a_t, torch.from_numpy(rid), torch.from_numpy(g))
    assert w2 is w_t and a2 is a_t and tsu.LAUNCHES == before
    assert_matches((w2.numpy(), a2.numpy()),
                   [jax_both(rid, g, w, acc, ta.OPT_ADAGRAD_FLEX, 0.1, 0.5, 0.0)[0]],
                   ta.OPT_ADAGRAD_FLEX)
