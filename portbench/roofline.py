"""The least time the card could take for the work of one pass: the
published peaks of the card, and the bytes and operations that the pass's
inputs need, from each batch's own ids.

``bound`` and the FFM kernels' counts are a frozen copy of
``chip_smoke.py`` ``bound``/``ffm_work``, counted over the entries these
inputs need (each example's real FFM and LR entries; the program's
padding is its own cost):

* FFM forward, per call: ids, values and fields read once (12 B an
  entry); each distinct slab (F·k floats) read once; the triangle written
  once. Operations: the contra sums (2·F·k an entry), the self terms
  (3·k an entry) and the triangle's dot products (2·k an output).
* FFM backward: the same, plus ``d emb`` written once (F·k floats an
  entry) and 3·F·k operations an entry in place of the self terms.
* The sparse update, per call (LR, then FFM): each entry's id (4 B) and
  gradient (one float an LR entry, an F·k-float slab an FFM entry) read
  once, and of the weights and the accumulators each distinct piece the
  entries touch read once and written once: a 32 B sector (the card's
  access granularity) of the LR tables, a slab (F·k floats, 64 B) of the
  FFM tables. The program's 128-float rows are its own layout, not the
  work. Operations: 4 an updated float.
* The whole step: the same distinct LR sectors and FFM slabs, which it
  gathers and updates, weights and accumulators each read and written
  once, the tower's tensors likewise, and its inputs once (an id per
  entry and a label); its f32 operations are the forward, backward and
  update of every entry and of the tower.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM, data sheet, dense, at 700 W
PEAKS = {"hbm_bytes_s": 3.35e12, "f32_flops": 67e12}
F32 = 4
SECTOR = 32  # bytes: the least the card's memory reads or writes


def bound_s(nbytes: float, ops: float) -> float:
    """The larger of bytes over the memory rate and f32 operations over
    the f32 peak, in seconds."""
    return max(nbytes / PEAKS["hbm_bytes_s"], ops / PEAKS["f32_flops"])


def _distinct_per_batch(keys: torch.Tensor, batch: int) -> torch.Tensor:
    """``[steps]``: distinct keys of each batch's entries."""
    n, W = keys.shape
    steps = -(-n // batch)
    bidx = (torch.arange(n, device=keys.device) // batch)[:, None].expand(n, W)
    uniq = torch.unique((bidx.reshape(-1) << 40) | keys.reshape(-1))
    return torch.bincount(uniq >> 40, minlength=steps).double()


def least_per_pass(rows, model: dict, ref) -> dict:
    """Seconds of least time, summed over the pass's steps, for each
    kernel and for the whole step; ``rows`` is the ``Rows`` of ``ref``, the
    configuration's reference, which names the FFM pieces
    (``ref.FFM_PIECES``) and the tower (``ref.tower_shapes``)."""
    B = rows.batch
    n = rows.n
    steps = -(-n // B)
    b = torch.full((steps,), float(B), dtype=torch.float64, device=rows.lr.device)
    b[-1] = n - (steps - 1) * B
    C = rows.lr.shape[1]
    F, k = len(model["ffm_fields"]), model["ffm_k"]
    T = F * (F + 1) // 2
    E = b * F  # FFM entries
    slabs = (_distinct_per_batch(getattr(rows, ref.FFM_PIECES), B) if ref.FFM_PIECES
             else torch.zeros_like(b))
    lr_sectors = _distinct_per_batch(rows.lr >> 3, B)  # 8 floats a sector
    slab = F * k * F32
    hb, fl = PEAKS["hbm_bytes_s"], PEAKS["f32_flops"]

    def total(nbytes, ops):
        return float(torch.maximum(nbytes / hb, ops / fl).sum())

    fwd_bytes = E * 12 + slabs * slab + b * T * 4
    fwd_ops = E * 2 * F * k + b * T * 2 * k
    out = {"ffm_fwd": total(fwd_bytes, fwd_ops + E * 3 * k),
           "ffm_bwd": total(fwd_bytes + E * F * k * 4, fwd_ops + E * F * k * 3)}
    K_lr, K_ffm = b * C, E
    # weights and accumulators, each read and written: 4 touches a piece
    lr_tables, ffm_tables = lr_sectors * SECTOR * 4, slabs * slab * 4
    out["sparse_update"] = (
        total(K_lr * (4 + F32) + lr_tables, K_lr * 4)
        + total(K_ffm * (4 + slab) + ffm_tables, K_ffm * F * k * 4))
    tower = sum(fi * fo + fo for _, fi, fo in ref.tower_shapes(model))
    step_bytes = lr_tables + ffm_tables + tower * 4 * 4 + b * (C + F + 1) * 4
    step_ops = (b * C * 6 + E * F * k * 12 + b * T * 2 * k
                + b * tower * 6 + tower * 4)
    out["step"] = total(step_bytes, step_ops)
    out["steps"] = steps
    return out
