"""The least-time arithmetic against counts by hand."""

import numpy as np
import pytest

from portbench import reference, reference_lr, roofline, spec

MODEL = spec.cell("lrffm_k8.multipass_b1024").config["model"]
HB, FL = roofline.PEAKS["hbm_bytes_s"], roofline.PEAKS["f32_flops"]


def rows(lr, ffm, batch):
    lr, ffm = np.asarray(lr, np.int64), np.asarray(ffm, np.int64)
    return reference.Rows(MODEL, lr, ffm, np.ones(len(lr), np.int64), batch, "cpu")


def test_bound_takes_the_larger():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e9, 67e12) == pytest.approx(1.0)


def test_one_batch_of_two_rows_by_hand():
    # two rows, 14 LR ids each; their 32 B sectors (id >> 3): 0, 1 | 0, 25, 26
    lr = [list(range(14)), [0] + list(range(200, 213))]
    # FFM windows (id >> 4): 1, 2 | 1, 300 → 3 slabs of 64 B
    ffm = [[16, 32], [16, 4800]]
    got = roofline.least_per_pass(rows(lr, ffm, 1024), MODEL, reference)
    E, F, k, T, b = 4, 2, 8, 3, 2
    fwd_bytes = E * 12 + 3 * 64 + b * T * 4
    fwd_ops = E * 2 * F * k + b * T * 2 * k
    assert got["ffm_fwd"] == pytest.approx(max(fwd_bytes / HB, (fwd_ops + E * 3 * k) / FL))
    assert got["ffm_bwd"] == pytest.approx(max((fwd_bytes + E * F * k * 4) / HB,
                                               (fwd_ops + E * F * k * 3) / FL))
    # LR: 28 entries of an id and one float; 4 sectors of w and acc, each
    # read and written
    lr_t = max((28 * 8 + 4 * 32 * 4) / HB, 28 * 4 / FL)
    # FFM: 4 entries of an id and a 16-float slab; 3 slabs, 4 touches each
    ffm_t = max((4 * (4 + 64) + 3 * 64 * 4) / HB, 4 * 16 * 4 / FL)
    assert got["sparse_update"] == pytest.approx(lr_t + ffm_t)
    step_bytes = 4 * 32 * 4 + 3 * 64 * 4 + b * (14 + 2 + 1) * 4
    assert got["step"] == pytest.approx(step_bytes / HB)
    assert got["steps"] == 1


def test_batches_are_counted_apart():
    # four rows in two batches of two: each batch its own distinct sectors
    # (id 1: sector 0; id 129: sector 16) and slabs
    lr = [[1] * 14, [1] * 14, [1] * 14, [129] * 14]
    ffm = [[16, 16], [16, 16], [16, 16], [16, 16]]
    got = roofline.least_per_pass(rows(lr, ffm, 2), MODEL, reference)
    lr_t = (28 * 8 + 1 * 32 * 4) / HB + (28 * 8 + 2 * 32 * 4) / HB
    ffm_t = 2 * (4 * (4 + 64) + 64 * 4) / HB
    assert got["sparse_update"] == pytest.approx(lr_t + ffm_t)
    assert got["steps"] == 2


def test_a_model_without_ffm_counts_its_lr_alone():
    # the LR reference names no FFM pieces: no FFM work, the LR update and
    # the step's LR sectors alone (ids 0..13: sectors 0, 1)
    model = spec.cell("eatrate_lr.multipass_b32k").config["model"]
    lr = np.asarray([list(range(14))], np.int64)
    r = reference_lr.Rows(model, lr, np.zeros((1, 0), np.int64), np.ones(1, np.int64),
                          1024, "cpu")
    got = roofline.least_per_pass(r, model, reference_lr)
    assert got["ffm_fwd"] == got["ffm_bwd"] == 0.0
    assert got["sparse_update"] == pytest.approx((14 * 8 + 2 * 32 * 4) / HB)
    assert got["step"] == pytest.approx((2 * 32 * 4 + (14 + 1) * 4) / HB)
