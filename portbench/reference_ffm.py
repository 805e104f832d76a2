"""The plain reference of LR + a field-aware FM of any width, with no
tower: its training step, written out in plain PyTorch from the model's
equations, and driven over a pass of the traffic's rows in the order the
program trains them (spec.py's reference contract).

It imports nothing of the program and takes nothing the program made but
the state it is told to start from. It shares reference.py's initial
weights, table geometry, count rounding and AdaGrad lookup table, and
works out the rest from the equations for any number of fields ``F`` and
factor width ``k``, for a schema in which every FFM field holds exactly
one feature of value 1 (field ``f``'s feature is entry ``f``).

The model (Juan et al., "Field-aware Factorization Machines for CTR
Prediction", RecSys 2016; fwumious_wabbit ``src/block_ffm.rs``,
``src/block_lr.rs``, ``src/optimizer.rs``):

* LR: one weight per combo, ``x_c = w[id_c]``.
* FFM: feature ``n`` (of field ``f_n``) owns a slab of ``F·k`` floats,
  ``e[n→t] = slab_n[t·k : (t+1)·k]`` its vector toward field ``t``. A
  slab lies at ``base = id & ~(align − 1)`` where ``F·k ≤ 128`` (``align``
  the next power of two), and at ``base = id & ~127`` otherwise, spanning
  ``G = ⌈F·k/128⌉`` rows of 128 floats, so that neighbouring slabs share
  floats. With ``C[t][f] = Σ_{n: f_n = f} v_n·e[n→t]``, the triangle is
  ``out(i, j) = ⟨C[i][j], C[j][i]⟩`` below the diagonal (``j < i``) and
  ``½‖C[t][t]‖² − ½Σ_{n: f_n = t} v_n²‖e[n→t]‖²`` on it (0 here).
* ``x = [x_lr (combos), triangle (F(F+1)/2, row-major)]``; the logit is
  ``Σ x``; ``p = sigmoid(clamp(logit, ±50))``, ``g = p − label`` inside
  the clamp.
* The FFM gradient: ``d e[n→t] = v_n·G[t][f_n]·C[f_n][t] − [t = f_n]·
  G[t][t]·v_n²·e[n→t]``, ``G[i][j] = G[j][i]`` the gradient of entry
  ``(max, min)`` (``g`` for every entry here).
* The batch-mean cap (the program's ``--fwt_batch_mean``, the model's
  ``batch_mean``: ``on``, or ``auto``, the default, for the scopes whose
  ``power_t`` is 0) caps each weight's multiplicity per batch at ``cap``:
  ``g·min(1, cap/c)``. For LR and for slabs within a row, ``c`` is the
  key's (id's, window's) count over the batch's entries, rounded up to
  four significant bits above 15 (the host's counts), applied before the
  dedup; for slabs across rows, ``c`` is, per float, the count of the
  batch's deduplicated pieces (below) whose sum there is not 0, exact,
  applied after the dedup (the program's count on the card).
* Per example, the gradients of each float are summed (LR: entries of one
  id; FFM: the slab pieces of one window, or of one row for slabs that
  span rows, so that floats shared by two slabs sum), then ``acc +=
  Σ_e (Σ g)²`` and ``w −= rate(acc)·Σ g``; ``rate`` is the AdaGrad lookup
  table of the accumulator's top 11 bits.

Departures from libffm, all the program's: an LR block beside the FFM,
no L2 term, no per-instance normalisation, the rate from a table of the
accumulator's top bits (libffm: an exact ``1/√G``), slabs at 128-float
bases that overlap.

Tables are flat: LR weight ``h`` at ``h``, a slab at ``base``; a
snapshot's ``[rows, 128]`` tables are the same floats. A step runs its
forward and backward in blocks of :data:`BLOCK` examples, all from the
state before the step, then updates once.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import (LANE, TABLES, _dedup_square, batch_counts, first_of_key,
                        initial_weights, lut, rate, rounded_counts, to_dtype,
                        weight_leaves)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["LANE", "TABLES", "FFM_PIECES", "tower_shapes", "initial_weights",
           "weight_leaves", "slab_unit", "Rows", "step", "run_pass", "to_dtype"]

# the Rows attribute of each FFM entry's slab key (the roofline's pieces)
FFM_PIECES = "ffm_slab"
BLOCK = 8192  # examples a block of a step's forward and backward


def tower_shapes(model: dict) -> list:
    if model.get("nn"):
        raise ValueError("reference_ffm models no tower")
    return []


def slab_unit(model: dict) -> tuple:
    """``(unit, G)``: the floats of one piece the dedup keys (the slab's
    aligned window where it fits a row, else a row) and the pieces of one
    slab."""
    Fk = len(model["ffm_fields"]) * model["ffm_k"]
    if Fk <= LANE:
        unit = 1
        while unit < Fk:
            unit <<= 1
        return unit, 1
    return LANE, -(-Fk // LANE)


class Rows:
    """One pass's inputs on ``device``: each row's LR ids, FFM slab bases,
    label and count factors, in the order the rows are trained."""

    def __init__(self, model: dict, lr_ids: np.ndarray, ffm_ids: np.ndarray,
                 labels: np.ndarray, batch: int, device):
        self.batch = batch
        self.n = len(labels)
        self.lr = torch.from_numpy(lr_ids).to(device)
        unit, G = slab_unit(model)
        self.unit_bits = unit.bit_length() - 1
        self.pieces = G
        # a slab's key (its window, or its first row) and its first float
        self.ffm_slab = torch.from_numpy(ffm_ids).to(device) >> self.unit_bits
        self.ffm_base = self.ffm_slab << self.unit_bits
        self.label = torch.from_numpy((labels > 0).astype(np.float32)).to(device)
        cap = float(model["batch_cap"])
        mode = model.get("batch_mean", "auto")

        def capped(power_t):
            return mode == "on" or (mode == "auto" and power_t == 0.0)

        def factor(keys):
            c = rounded_counts(batch_counts(keys, batch)).float()
            return torch.clamp(cap / c.clamp(min=1.0), max=1.0)

        self.lr_factor = factor(self.lr) if capped(model["power_t"]) else None
        ffm_capped = capped(model["ffm_power_t"])
        # a slab in one row: counted per window over the batch's entries,
        # rounded (the host's counts); a slab across rows: per float, over
        # the batch's deduplicated pieces whose gradient there is not 0
        self.ffm_factor = factor(self.ffm_slab) if ffm_capped and G == 1 else None
        self.row_cap = cap if ffm_capped and G > 1 else None

    def steps(self):
        for lo in range(0, self.n, self.batch):
            yield slice(lo, min(lo + self.batch, self.n))


def forward_backward(model: dict, st: dict, rows: Rows, sl: slice, flip: bool = False):
    """One block's probabilities, its logit gradients ``[b]`` (every LR
    entry's) and its FFM slab gradients ``[b, F, F·k]``, uncapped, from
    ``st``; ``flip`` turns the block's first probability ``p`` into
    ``1 − p`` before the gradients are taken."""
    F, k = len(model["ffm_fields"]), model["ffm_k"]
    lr_ids, base = rows.lr[sl], rows.ffm_base[sl]
    y = rows.label[sl].to(st["lr_w"].dtype)
    b = lr_ids.shape[0]
    x_lr = st["lr_w"][lr_ids]  # [b, C]
    slabs = st["ffm_w"][base[..., None] + torch.arange(F * k, device=base.device)]
    e = slabs.view(b, F, F, k)  # e[b, n, t] = e[n→t]; entry n is field n's feature
    C = e.transpose(1, 2)  # C[b, t, f] = e[f→t], the field sums (v = 1)
    ti, tj = torch.tril_indices(F, F, device=base.device)
    tri = (C[:, ti, tj] * C[:, tj, ti]).sum(-1)  # ⟨C[i][j], C[j][i]⟩
    diag = ti == tj
    self_sq = (e[:, ti, ti] * e[:, ti, ti]).sum(-1)  # ‖e[n→n]‖² at a diagonal entry
    tri = torch.where(diag, 0.5 * tri - 0.5 * self_sq, tri)
    logit = torch.cat([x_lr, tri], dim=1).sum(-1)
    p = torch.sigmoid(torch.clamp(logit, -50.0, 50.0))
    if flip:
        p = torch.cat([1.0 - p[:1], p[1:]])
    inside = (logit >= -50.0) & (logit <= 50.0)
    g = torch.where(inside, p - y, torch.zeros_like(p))
    # d e[n→t] = G[t][n]·C[n][t] − [t = n]·G[t][t]·e[n→t]; G = g on every entry
    d_e = g[:, None, None, None] * C
    eye = torch.eye(F, dtype=torch.bool, device=base.device)[None, :, :, None]
    d_e = torch.where(eye, g[:, None, None, None] * (C - e), d_e)
    return p, g, d_e.reshape(b, F, F * k)


def _pieces(rows: Rows, sl: slice, g_slab: torch.Tensor, F: int, k: int):
    """The FFM gradient as dedup pieces: keys ``[b, F·G]`` (window or row
    numbers) and payloads ``[b, F·G, unit]``, a slab's floats padded to
    ``G·unit``."""
    unit, G = 1 << rows.unit_bits, rows.pieces
    b = g_slab.shape[0]
    pad = G * unit - F * k
    if pad:
        g_slab = torch.cat([g_slab, g_slab.new_zeros(b, F, pad)], dim=-1)
    keys = rows.ffm_slab[sl][..., None] + torch.arange(G, device=g_slab.device)
    return keys.reshape(b, F * G), g_slab.reshape(b, F * G, unit)


def step(model: dict, st: dict, rows: Rows, sl: slice, luts: dict,
         fault: str | None = None) -> torch.Tensor:
    """One batch, in place on ``st``; returns the probabilities before the
    update. ``fault`` plants one of the faults the check must catch:
    ``"half"`` leaves out the batch's second half and doubles the rest's
    gradient, ``"flip"`` turns the step's first probability ``p`` into
    ``1 − p`` where it is produced, ``"unchanged"`` returns the
    probabilities and leaves the state as it was."""
    F, k = len(model["ffm_fields"]), model["ffm_k"]
    dt = st["lr_w"].dtype
    n0, n1 = sl.start, sl.stop
    ps, lr_parts, ffm_parts = [], [], []
    for lo in range(n0, n1, BLOCK):
        blk = slice(lo, min(lo + BLOCK, n1))
        p, g, d_e = forward_backward(model, st, rows, blk, fault == "flip" and lo == n0)
        ps.append(p)
        lr_parts.append(g)
        ffm_parts.append(d_e)
    p = torch.cat(ps)
    g = torch.cat(lr_parts)
    d_e = torch.cat(ffm_parts)
    b = g.shape[0]
    if fault == "half":
        keep = torch.arange(b, device=g.device) < b // 2
        g = torch.where(keep, 2.0 * g, torch.zeros_like(g))
        d_e = torch.where(keep[:, None, None], 2.0 * d_e, torch.zeros_like(d_e))
    if fault == "unchanged":
        return p
    lr_ids = rows.lr[sl]
    g_lr = g[:, None].expand_as(lr_ids).to(dt)
    if rows.lr_factor is not None:
        g_lr = g_lr * rows.lr_factor[sl].to(dt)
    if rows.ffm_factor is not None:
        d_e = d_e * rows.ffm_factor[sl].to(dt)[..., None]
    keys, pieces = _pieces(rows, sl, d_e, F, k)
    # updates: every gradient above read the old weights
    lr_flat = lr_ids.reshape(-1)
    st["lr_acc"].index_add_(0, lr_flat, _dedup_square(g_lr[..., None], first_of_key(lr_ids)).reshape(-1))
    st["lr_w"].index_add_(0, lr_flat, (-g_lr.reshape(-1)) * rate(luts["lr"], st["lr_acc"][lr_flat]))
    unit = pieces.shape[-1]
    acc, w = st["ffm_acc"].view(-1, unit), st["ffm_w"].view(-1, unit)
    flat_keys = keys.reshape(-1)
    if rows.row_cap is None:
        acc.index_add_(0, flat_keys, _dedup_square(pieces, first_of_key(keys)).reshape(-1, unit))
        flat = pieces.reshape(-1, unit)
    else:
        # each float's total per example on its first piece, capped by the
        # count of the batch's pieces whose total there is not 0
        d = torch.zeros_like(pieces).scatter_add_(
            1, first_of_key(keys)[..., None].expand_as(pieces), pieces).reshape(-1, unit)
        uniq, inv = torch.unique(flat_keys, return_inverse=True)
        c = torch.zeros(len(uniq), unit, dtype=d.dtype, device=d.device).index_add_(
            0, inv, (d != 0).to(d.dtype))[inv]
        cap = torch.full((), rows.row_cap, dtype=d.dtype, device=d.device)
        flat = d * torch.clamp(cap / c.clamp(min=1.0), max=1.0)
        acc.index_add_(0, flat_keys, flat * flat)
    w.index_add_(0, flat_keys, (-flat) * rate(luts["ffm"], acc[flat_keys]))
    return p


def run_pass(model: dict, st: dict, rows: Rows, fault: str | None = None) -> torch.Tensor:
    """Train ``st`` over ``rows`` in place; returns every row's
    probability before its step's update, as f32."""
    dev = rows.lr.device
    luts = {"lr": torch.from_numpy(lut(model["learning_rate"], model["power_t"],
                                       model["init_acc_gradient"])).to(dev),
            "ffm": torch.from_numpy(lut(model["ffm_learning_rate"], model["ffm_power_t"],
                                        model["ffm_init_acc_gradient"])).to(dev)}
    preds = torch.empty(rows.n, device=dev)
    for sl in rows.steps():
        preds[sl] = step(model, st, rows, sl, luts, fault).float()
    return preds
