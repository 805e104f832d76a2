"""The numbers that decide ``correct``: what the program's pass produced,
against the plain reference's pass from the same start over the same
rows.

* ``loss_gap``: each step's logloss, from the program's predictions (the
  ``-p`` file, six decimals) and from the reference's probabilities
  rounded the same way, both clipped at 1e-6; the worst step's gap, in
  nats.
* ``grad_gap``: per leaf (a weight table or tower tensor), the norm of the
  gradients the optimizer took over the pass, ``√Σ(acc_after −
  acc_before)`` (the accumulator adds each (Σ g)²); the gap between the
  program's and the reference's norms over the reference's norm of that
  leaf or of the median leaf, whichever is larger; the worst leaf.
* ``change_gap``: the same for the weights' change, ``‖w_after −
  w_before‖``, over the leaves whose reference gradient norm is at least a
  thousandth of the median leaf's.
* ``grad_gap_median``, ``change_gap_median``: the median leaf's gap in
  place of the worst's.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

CLIP = 1e-6
MOVED = 1e-3  # a leaf's gradient norm, against the median leaf's, below
# which its change is round-off and is not compared


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_norms(leaves: list, before: dict, after: dict, device) -> dict:
    """``{weight: (‖Δw‖, √ΣΔacc)}``."""
    out = {}
    for w, acc in leaves:
        dw = after[w].to(device).double() - before[w].to(device).double()
        da = after[acc].to(device).double() - before[acc].to(device).double()
        out[w] = (_norm(dw), float(torch.sqrt(da.sum().clamp(min=0.0))))
    return out


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """``{"grad_gap", "change_gap", "leaves"}`` from :func:`leaf_norms` of
    the program and of the reference."""
    med_g = statistics.median(g for _, g in ref.values())
    moved = {w for w, (_, g) in ref.items() if g >= MOVED * med_g}
    med_c = statistics.median(ref[w][0] for w in moved)
    grad = {w: abs(prog[w][1] - g) / max(g, med_g, 1e-30) for w, (_, g) in ref.items()}
    change = {w: abs(prog[w][0] - ref[w][0]) / max(ref[w][0], med_c, 1e-30)
              for w in moved}
    return {"grad_gap": max(grad.values()), "change_gap": max(change.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap_median": statistics.median(change.values()),
            "leaves": {w: {"ref": ref[w], "prog": prog[w]} for w in ref},
            "left_out": sorted(set(ref) - moved)}


def step_losses(preds: np.ndarray, labels: np.ndarray, batch: int) -> np.ndarray:
    """Each step's mean logloss of six-decimal predictions."""
    p = np.clip(np.round(preds.astype(np.float64), 6), CLIP, 1.0 - CLIP)
    y = labels > 0
    loss = -np.where(y, np.log(p), np.log1p(-p))
    n = len(loss)
    steps = -(-n // batch)
    sums = np.add.reduceat(loss, np.arange(0, n, batch))
    counts = np.minimum(batch, n - np.arange(steps) * batch)
    return sums / counts


def loss_gaps(prog_preds: np.ndarray, ref_preds: np.ndarray, labels: np.ndarray,
              batch: int) -> np.ndarray:
    """Each step's gap of logloss; infinite when the program's
    predictions are not one per row."""
    if len(prog_preds) != len(ref_preds):
        return np.full(1, np.inf)
    return np.abs(step_losses(prog_preds, labels, batch)
                  - step_losses(ref_preds, labels, batch))


def read_predictions(path) -> np.ndarray:
    with open(path, "rb") as f:
        return np.array(f.read().split(), dtype=np.float64)
