"""The plain reference of a logistic-regression model with no FFM and no
tower: its training step, written out in plain PyTorch from the model's
equations, and driven over a pass of the traffic's rows in the order the
program trains them (spec.py's reference contract).

It imports nothing of the program and takes nothing the program made but
the state it is told to start from. It shares reference.py's arithmetic
of the count rounding, the per-example dedup and the AdaGrad lookup
table.

The model (fwumious_wabbit ``src/block_lr.rs``, ``src/optimizer.rs``), for a
schema in which every namespace holds one feature of value 1:

* one weight per combo, ``x_c = w[id_c]``; the logit is ``Σ x``;
* ``p = sigmoid(clamp(logit, ±50))``, ``g = p − label`` inside the clamp;
* each key's multiplicity per batch is capped at ``cap``
  (``g·min(1, cap/c)``, ``c`` the key's count over the batch rounded up to
  four significant bits above 15), each example's entries of one key are
  summed, then ``acc += Σ_e (Σ g)²`` and ``w −= rate(acc)·Σ g``; ``rate``
  is the AdaGrad lookup table of the accumulator's top 11 bits.

The table is flat: weight ``h`` at ``h``; a snapshot's ``[rows, 128]``
table is the same floats.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import (LANE, _dedup_square, batch_counts, first_of_key, lut, rate,
                        rounded_counts, table_rows, to_dtype)

__all__ = ["LANE", "TABLES", "FFM_PIECES", "tower_shapes", "initial_weights",
           "weight_leaves", "Rows", "step", "run_pass", "to_dtype"]

TABLES = ("lr_w", "lr_acc")
FFM_PIECES = None  # no FFM


def tower_shapes(model: dict) -> list:
    return []


def initial_weights(model: dict, seed: int, device) -> dict:
    """The weights and the accumulators, all 0 (nothing is drawn from
    ``seed``)."""
    rows = table_rows(1 << model["bit_precision"], 1)
    return {k: torch.zeros(rows * LANE, device=device) for k in TABLES}


def weight_leaves(model: dict) -> list:
    return [TABLES]


class Rows:
    """One pass's inputs on ``device``: each row's LR ids, label, count
    factors and dedup map, in the order the rows are trained
    (``ffm_ids`` is ``[n, 0]`` and unused)."""

    def __init__(self, model: dict, lr_ids: np.ndarray, ffm_ids: np.ndarray,
                 labels: np.ndarray, batch: int, device):
        self.batch = batch
        self.n = len(labels)
        self.lr = torch.from_numpy(lr_ids).to(device)
        self.label = torch.from_numpy((labels > 0).astype(np.float32)).to(device)
        c = rounded_counts(batch_counts(self.lr, batch)).float()
        self.lr_factor = torch.clamp(float(model["batch_cap"]) / c.clamp(min=1.0), max=1.0)
        self.lr_first = first_of_key(self.lr)

    def steps(self):
        for lo in range(0, self.n, self.batch):
            yield slice(lo, min(lo + self.batch, self.n))


def step(st: dict, rows: Rows, sl: slice, table: torch.Tensor,
         fault: str | None = None) -> torch.Tensor:
    """One batch, in place on ``st``; returns the probabilities before the
    update. ``fault`` as reference.step's: ``"half"`` leaves out the
    batch's second half and doubles the rest's gradient, ``"flip"`` turns
    the step's first probability ``p`` into ``1 − p`` where it is
    produced, ``"unchanged"`` leaves the state as it was."""
    dt = st["lr_w"].dtype
    ids = rows.lr[sl]
    y = rows.label[sl].to(dt)
    b = ids.shape[0]
    logit = st["lr_w"][ids].sum(-1)
    p = torch.sigmoid(torch.clamp(logit, -50.0, 50.0))
    if fault == "flip":
        p = torch.cat([1.0 - p[:1], p[1:]])
    inside = (logit >= -50.0) & (logit <= 50.0)
    g = torch.where(inside, p - y, torch.zeros_like(p))
    if fault == "half":
        g = torch.cat([2.0 * g[:b // 2], torch.zeros_like(g[b // 2:])])
    if fault == "unchanged":
        return p
    g_lr = g[:, None] * rows.lr_factor[sl].to(dt)
    flat = ids.reshape(-1)
    st["lr_acc"].index_add_(0, flat, _dedup_square(g_lr[..., None], rows.lr_first[sl]).reshape(-1))
    st["lr_w"].index_add_(0, flat, (-g_lr.reshape(-1)) * rate(table, st["lr_acc"][flat]))
    return p


def run_pass(model: dict, st: dict, rows: Rows, fault: str | None = None) -> torch.Tensor:
    """Train ``st`` over ``rows`` in place; returns every row's
    probability before its step's update, as f32."""
    table = torch.from_numpy(lut(model["learning_rate"], model["power_t"],
                                 model["init_acc_gradient"])).to(rows.lr.device)
    preds = torch.empty(rows.n, device=rows.lr.device)
    for sl in rows.steps():
        preds[sl] = step(st, rows, sl, table, fault).float()
    return preds
