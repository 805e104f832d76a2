"""The plain reference: the configuration's training step, written out in
plain PyTorch from the model's equations, and driven over a pass of the
traffic's rows in the order the program trains them.

It imports nothing of the program and takes nothing the program made
but the state it is told to start from (a snapshot of the program's
tables, or the benchmark's own initial weights). Everything the program
derives it works out again: the feature ids (features.py), each
batch's multiplicity counts and their 8-bit rounding, the per-example
dedup, the LR and FFM forward, the dense tower's forward and backward,
the logistic gradient, and the AdaGrad lookup-table rule.

The model (fwumious_wabbit ``src/block_lr.rs``, ``src/block_ffm.rs``,
``src/block_neural.rs``, ``src/optimizer.rs``), for the Eat-Rate schema, in
which every namespace holds one feature of value 1:

* LR: one weight per combo, ``x_c = w[id_c]``;
* FFM, fields A (0) and B (1), one feature each: a 16-float slab per
  window ``id >> 4``, ``e_n→t = slab_n[8t : 8t+8]``; the triangle's
  off-diagonal output is ``⟨e_A→1, e_B→0⟩``, its diagonal outputs (pairs
  within one field) are 0;
* ``x = [x_lr (combos), triangle (3)]``; the logit is ``Σ x``, or with a
  tower ``[relu(x·W + b), x]·W_f + b_f`` (topology one);
* ``p = sigmoid(clamp(logit, ±50))``, ``g = p − label`` inside the clamp;
* the LR and FFM scopes cap each key's multiplicity per batch at ``cap``
  (``g·min(1, cap/c)``, ``c`` the key's count over the batch rounded up to
  four significant bits above 15), sum each example's entries of one key,
  then ``acc += Σ_e (Σ g)²`` and ``w −= rate(acc)·Σ g``; the tower's
  tensors ``acc += Σ g²``, ``w −= rate(acc)·Σ g``; ``rate`` is the AdaGrad
  lookup table of the accumulator's top 11 bits.

Tables are flat: LR weight ``h`` at ``h``, an FFM window ``v`` at
``16·v``; a snapshot's ``[rows, 128]`` tables are the same floats.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LANE = 128
LUT_BITS = 11
CAP_CODE_EXACT = 15
# the flat tables of the state, the program's params and the snapshots
TABLES = ("lr_w", "lr_acc", "ffm_w", "ffm_acc")
# the Rows attribute of each FFM entry's slab key (the roofline's pieces)
FFM_PIECES = "ffm_win"


def table_rows(logical: int, slab: int) -> int:
    """Rows of 128 floats that hold a table of ``logical`` floats in
    slabs of ``slab`` (the model file's padded arena)."""
    align = 1
    while align < slab:
        align <<= 1
    rows_per_slab = 1
    if slab > LANE:
        align = -(-slab // LANE) * LANE
        rows_per_slab = align // LANE
    unit = LANE * rows_per_slab
    padded = -(-max(logical, align) // unit) * unit
    if padded // LANE > 2048:
        unit = LANE * math.lcm(rows_per_slab, 2048)
        padded = -(-padded // unit) * unit
    return padded // LANE


def geometry(model: dict) -> dict:
    """Each table's ``(addressable floats, rows)``."""
    F, k = len(model["ffm_fields"]), model["ffm_k"]
    lr = 1 << model["bit_precision"]
    ffm = (1 << model["ffm_bit_precision"]) + F * k
    return {"lr": (lr, table_rows(lr, 1)), "ffm": (ffm, table_rows(ffm, F * k))}


def tower_shapes(model: dict) -> list:
    """``[(name, fan_in, fan_out)]`` of the tower's layers and readout."""
    nn = model.get("nn")
    if not nn:
        return []
    joined = len(model["lr_combos"]) + int(model["constant"]) + 3
    shapes, d = [], joined
    for i, layer in enumerate(nn["layers"]):
        shapes.append((f"nn.{i}", d, layer["width"]))
        d = layer["width"]
    shapes.append(("final", d + joined, 1))
    return shapes


def initial_weights(model: dict, seed: int, device) -> dict:
    """The run's initial weights, made on ``device`` from ``seed``: LR 0,
    FFM uniform in ±0.5/√k/50 (the reference engine's range), the
    tower's layers normal with σ = √(2/fan_in), its readout 1, biases and
    every accumulator 0: flat tensors, keyed as :func:`weight_leaves` names
    them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    geo = geometry(model)
    (lr_n, lr_rows), (ffm_n, ffm_rows) = geo["lr"], geo["ffm"]
    st = {"lr_w": torch.zeros(lr_rows * LANE, device=device),
          "lr_acc": torch.zeros(lr_rows * LANE, device=device),
          "ffm_w": torch.zeros(ffm_rows * LANE, device=device),
          "ffm_acc": torch.zeros(ffm_rows * LANE, device=device)}
    scale = 1.0 / math.sqrt(model["ffm_k"]) / 50.0
    st["ffm_w"][:ffm_n] = (torch.rand(ffm_n, generator=gen, device=device) - 0.5) * scale
    for name, fan_in, fan_out in tower_shapes(model):
        if name == "final":
            w = torch.ones(fan_in, fan_out, device=device)
        else:
            w = torch.randn(fan_in, fan_out, generator=gen, device=device) * math.sqrt(2.0 / fan_in)
        st[name + ".w"] = w
        st[name + ".b"] = torch.zeros(fan_out, device=device)
        st[name + ".w_acc"] = torch.zeros(fan_in, fan_out, device=device)
        st[name + ".b_acc"] = torch.zeros(fan_out, device=device)
    return st


def weight_leaves(model: dict) -> list:
    """``[(weight, accumulator)]`` keys of the state."""
    out = [("lr_w", "lr_acc"), ("ffm_w", "ffm_acc")]
    for name, _, _ in tower_shapes(model):
        out += [(name + ".w", name + ".w_acc"), (name + ".b", name + ".b_acc")]
    return out


def lut(learning_rate: float, power_t: float, initial_acc_gradient: float) -> np.ndarray:
    """The 2^11-entry AdaGrad rate table: entry ``x`` averages
    ``lr·e^(−power_t)`` at the two edges of bucket ``x``, the f32 values
    whose bits are ``x << 20`` and ``(x+1) << 20`` (a denormal edge taken
    as 0) plus the initial gradient; ``lr`` where that is not finite."""
    x = np.arange(1 << LUT_BITS, dtype=np.uint64)

    def edge(v):
        f = ((v << np.uint64(31 - LUT_BITS)) & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.float32)
        f = np.where(np.abs(f) < np.float32(2.0 ** -126), np.float32(0.0), f)
        return (f + np.float32(initial_acc_gradient)).astype(np.float32)

    with np.errstate(all="ignore"):
        mp = np.float32(-power_t)
        val = (np.float32(learning_rate) * (edge(x) ** mp + edge(x + np.uint64(1)) ** mp)
               * np.float32(0.5)).astype(np.float32)
    return np.where(np.isfinite(val), val, np.float32(learning_rate)).astype(np.float32)


def rate(table: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The table's rate for each accumulator (read as f32 bits)."""
    key = (acc.float().contiguous().view(torch.int32) >> (31 - LUT_BITS)) & ((1 << LUT_BITS) - 1)
    return table[key.long()].to(acc.dtype)


def rounded_counts(c: torch.Tensor) -> torch.Tensor:
    """A multiplicity as the batch-mean cap reads it: exact to 15, above
    that rounded up to four significant bits."""
    c = c.long()
    e = torch.floor(torch.log2(c.clamp(min=1).double())).long()
    sh = (e - 3).clamp(min=0)
    m = (c + (1 << sh) - 1) >> sh
    up = m == 16
    m = torch.where(up, torch.full_like(m, 8), m)
    sh = torch.where(up, sh + 1, sh)
    return torch.where(c <= CAP_CODE_EXACT, c, m << sh)


def batch_counts(keys: torch.Tensor, batch: int) -> torch.Tensor:
    """``[n, W]``: each entry's key's count over its batch's entries (rows
    ``[i·batch, (i+1)·batch)``)."""
    n, W = keys.shape
    bidx = (torch.arange(n, device=keys.device) // batch)[:, None].expand(n, W)
    comb = (bidx.reshape(-1) << 40) | keys.reshape(-1)
    _, inv, cnt = torch.unique(comb, return_inverse=True, return_counts=True)
    return cnt[inv].reshape(n, W)


def first_of_key(keys: torch.Tensor) -> torch.Tensor:
    """``[n, W]``: the position of each entry's key's first entry in its
    row."""
    n, W = keys.shape
    out = torch.empty_like(keys)
    for lo in range(0, n, 1 << 18):
        k = keys[lo:lo + (1 << 18)]
        eq = k[:, :, None] == k[:, None, :]  # [b, j, i]
        out[lo:lo + (1 << 18)] = eq.to(torch.int8).argmax(dim=2)
    return out


class Rows:
    """One pass's inputs on ``device``: the ids, labels, count factors and
    dedup maps of every row, in the order the rows are trained."""

    def __init__(self, model: dict, lr_ids: np.ndarray, ffm_ids: np.ndarray,
                 labels: np.ndarray, batch: int, device):
        self.batch = batch
        self.n = len(labels)
        self.lr = torch.from_numpy(lr_ids).to(device)
        self.ffm_win = torch.from_numpy(ffm_ids).to(device) >> 4
        self.label = torch.from_numpy((labels > 0).astype(np.float32)).to(device)
        cap = float(model["batch_cap"])

        def factor(keys):
            c = rounded_counts(batch_counts(keys, batch)).float()
            return torch.clamp(cap / c.clamp(min=1.0), max=1.0)

        self.lr_factor = factor(self.lr)
        self.ffm_factor = factor(self.ffm_win)
        self.lr_first = first_of_key(self.lr)
        self.ffm_first = first_of_key(self.ffm_win)

    def steps(self):
        for lo in range(0, self.n, self.batch):
            yield slice(lo, min(lo + self.batch, self.n))


def _dedup_square(g: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Per row, each key's entries summed onto its first entry, squared;
    the other entries 0. ``g [b, W, P]``, ``first [b, W]``."""
    d = torch.zeros_like(g).scatter_add_(1, first[..., None].expand_as(g), g)
    return d * d


def step(model: dict, st: dict, rows: Rows, sl: slice, luts: dict,
         fault: str | None = None) -> torch.Tensor:
    """One batch, in place on ``st``; returns the probabilities before the
    update. ``fault`` plants one of the faults the check must catch:
    ``"half"`` leaves out the batch's second half and doubles the rest's
    gradient (the mean over the rest), ``"flip"`` turns the step's first
    probability ``p`` into ``1 − p`` where it is produced, ``"unchanged"``
    returns the probabilities and leaves the state as it was."""
    dt = st["lr_w"].dtype
    lr_ids, win = rows.lr[sl], rows.ffm_win[sl]
    y = rows.label[sl].to(dt)
    b = lr_ids.shape[0]
    # forward
    x_lr = st["lr_w"][lr_ids]  # [b, C]
    offs = torch.arange(16, device=win.device)
    slabs = st["ffm_w"][(win[..., None] << 4) + offs]  # [b, 2, 16]
    eA1, eB0 = slabs[:, 0, 8:], slabs[:, 1, :8]
    off = (eA1 * eB0).sum(-1)
    zero = torch.zeros_like(off)
    x = torch.cat([x_lr, torch.stack([zero, off, zero], dim=1)], dim=1)
    tower = tower_shapes(model)
    if tower:
        h_pre = x @ st["nn.0.w"] + st["nn.0.b"]
        mask = h_pre > 0
        h = torch.where(mask, h_pre, torch.zeros_like(h_pre))
        fin = torch.cat([h, x], dim=1)
        logit = (fin @ st["final.w"] + st["final.b"])[:, 0]
    else:
        logit = x.sum(-1)
    p = torch.sigmoid(torch.clamp(logit, -50.0, 50.0))
    if fault == "flip":
        p = torch.cat([1.0 - p[:1], p[1:]])
    inside = (logit >= -50.0) & (logit <= 50.0)
    g = torch.where(inside, p - y, torch.zeros_like(p))
    if fault == "half":
        g = torch.cat([2.0 * g[:b // 2], torch.zeros_like(g[b // 2:])])
    # backward
    dense = {}
    if tower:
        width = h.shape[1]
        wf = st["final.w"][:, 0]
        g_fin = g[:, None] * wf[None, :]
        dense["final.w"] = (fin.T @ g[:, None], (fin * fin).T @ (g * g)[:, None])
        dense["final.b"] = (g.sum(0, keepdim=True), (g * g).sum(0, keepdim=True))
        g_h = torch.where(mask, g_fin[:, :width], torch.zeros_like(h))
        dense["nn.0.w"] = (x.T @ g_h, (x * x).T @ (g_h * g_h))
        dense["nn.0.b"] = (g_h.sum(0), (g_h * g_h).sum(0))
        g_x = g_h @ st["nn.0.w"].T + g_fin[:, width:]
    else:
        g_x = g[:, None].expand_as(x)
    g_lr = g_x[:, :x_lr.shape[1]] * rows.lr_factor[sl].to(dt)
    g_off = g_x[:, x_lr.shape[1] + 1]
    g_slab = torch.zeros_like(slabs)
    g_slab[:, 0, 8:] = g_off[:, None] * eB0
    g_slab[:, 1, :8] = g_off[:, None] * eA1
    g_slab = g_slab * rows.ffm_factor[sl].to(dt)[..., None]
    if fault == "unchanged":
        return p
    # updates: every gradient above read the old weights
    for name, (gsum, gsq) in dense.items():
        acc = st[name + "_acc"]
        acc.add_(gsq)
        st[name].sub_(gsum * rate(luts["nn"], acc))
    lr_flat = lr_ids.reshape(-1)
    st["lr_acc"].index_add_(0, lr_flat, _dedup_square(g_lr[..., None], rows.lr_first[sl]).reshape(-1))
    st["lr_w"].index_add_(0, lr_flat, (-g_lr.reshape(-1)) * rate(luts["lr"], st["lr_acc"][lr_flat]))
    fidx = ((win[..., None] << 4) + offs).reshape(-1)
    st["ffm_acc"].index_add_(0, fidx, _dedup_square(g_slab, rows.ffm_first[sl]).reshape(-1))
    st["ffm_w"].index_add_(0, fidx, (-g_slab.reshape(-1)) * rate(luts["ffm"], st["ffm_acc"][fidx]))
    return p


def luts_for(model: dict, device) -> dict:
    out = {"lr": lut(model["learning_rate"], model["power_t"], model["init_acc_gradient"]),
           "ffm": lut(model["ffm_learning_rate"], model["ffm_power_t"],
                      model["ffm_init_acc_gradient"])}
    nn = model.get("nn")
    if nn:
        out["nn"] = lut(nn["learning_rate"], nn["power_t"], nn["init_acc_gradient"])
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def run_pass(model: dict, st: dict, rows: Rows, fault: str | None = None) -> torch.Tensor:
    """Train ``st`` over ``rows`` in place; returns every row's
    probability before its step's update, as f32."""
    luts = luts_for(model, rows.lr.device)
    preds = torch.empty(rows.n, device=rows.lr.device)
    for sl in rows.steps():
        preds[sl] = step(model, st, rows, sl, luts, fault).float()
    return preds


def to_dtype(st: dict, dtype) -> dict:
    """A copy of ``st`` in ``dtype`` (the control's lower precision)."""
    return {k: v.to(dtype).clone() for k, v in st.items()}
