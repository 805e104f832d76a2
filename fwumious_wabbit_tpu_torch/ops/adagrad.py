"""Optimizers: SGD, AdaGrad with a flexible power_t, and the AdaGrad
lookup-table rule — the counterpart of fwumious_wabbit_tpu/ops/adagrad.py,
with the same update rules (reference: src/optimizer.rs):

* SGD: ``update = g · lr``;
* AdagradFlex: ``acc += g²; update = g · lr · acc^(−power_t)``, a NaN or
  infinite update set to 0;
* AdagradLUT: a 2^11-entry table indexed by the top 11 bits of acc's f32 bit
  pattern; each entry averages ``lr · x^(−power_t)`` at the bucket's two
  edges, ``initial_acc_gradient`` folded in.

Batch semantics are the JAX package's: each example's contributions to a
weight are summed first (ops/tables.py dedup), so per weight
``acc += Σ_examples g_e²`` and ``w −= rate(acc_new) · Σ_examples g_e``.

The JAX module imports jax at its top, so :func:`build_lut` and
:func:`encode_counts` (numpy) are copied here rather than imported.
:meth:`ScopedOptimizer.apply_rows` updates its tables in place: on a CUDA
tensor through the hand-written kernel (ops/sparse_update.py), on a CPU
tensor through the plain ``index_add_`` version below.
:meth:`ScopedOptimizer.apply_dense` updates a tower tensor in place.

Denormal accumulators: XLA on a TPU (and on the CPU) flushes them to zero;
PyTorch on the CPU and the CUDA kernel (built without fast math) keep them,
as the reference does. The LUT rate of a denormal accumulator is the same
either way, because both flush denormal bucket *edges* to zero.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

FASTMATH_LR_LUT_BITS = 11
FASTMATH_LR_LUT_SIZE = 1 << FASTMATH_LR_LUT_BITS
_LUT_SHIFT = 31 - FASTMATH_LR_LUT_BITS

# smallest normal f32: denormal bucket edges are flushed to zero in both the
# table and its arithmetic form (fwumious_wabbit_tpu/ops/adagrad.py:41-49)
_FLT_MIN = np.float32(2.0 ** -126)

# optimizer kinds (values match the reference's enum for file compat)
OPT_SGD = 100
OPT_ADAGRAD_FLEX = 200
OPT_ADAGRAD_LUT = 300


def build_lut(learning_rate: float, power_t: float,
              initial_acc_gradient: float) -> np.ndarray:
    """The 2048-entry learning-rate table (reference: src/optimizer.rs:121-144);
    a copy of the JAX package's numpy function."""
    lut = np.zeros(FASTMATH_LR_LUT_SIZE, dtype=np.float32)
    minus_power_t = -power_t

    def edge(x):
        v = np.uint32(x << (31 - FASTMATH_LR_LUT_BITS)).view(np.float32)
        if abs(v) < _FLT_MIN:  # flush denormal edges (see _FLT_MIN note)
            v = np.float32(0.0)
        return v + np.float32(initial_acc_gradient)

    with np.errstate(all="ignore"):
        for x in range(FASTMATH_LR_LUT_SIZE):
            fx = edge(x)
            fx1 = edge(x + 1)
            val = (
                np.float32(learning_rate)
                * (np.float32(fx) ** np.float32(minus_power_t)
                   + np.float32(fx1) ** np.float32(minus_power_t))
                * np.float32(0.5)
            )
            if not np.isfinite(val):
                val = np.float32(learning_rate)
            lut[x] = val
    return lut


@functools.lru_cache(maxsize=None)
def device_lut(learning_rate: float, power_t: float,
               initial_acc_gradient: float,
               device: torch.device) -> torch.Tensor:
    """:func:`build_lut`'s table as a ``[2048]`` f32 tensor on ``device``:
    the table the CUDA update kernel reads the LUT rate from, at
    ``bits(acc) >> 20``. Built once per ``(lr, power_t, iag, device)``, not
    once per step; callers share the tensor and must not write to it."""
    return torch.from_numpy(
        build_lut(learning_rate, power_t, initial_acc_gradient)).to(device)


def _edge(key: torch.Tensor, initial_acc_gradient: float) -> torch.Tensor:
    """The f32 value whose bits are ``key << 20`` (key in 0..2048, as int64),
    a denormal flushed to 0, plus the initial gradient."""
    bits = (key << _LUT_SHIFT) & 0xFFFFFFFF
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)  # as signed
    v = bits.to(torch.int32).view(torch.float32)
    v = torch.where(v.abs() < float(_FLT_MIN), torch.zeros_like(v), v)
    return v + initial_acc_gradient


def lut_rate_compute(acc: torch.Tensor, learning_rate: float, power_t: float,
                     initial_acc_gradient: float) -> torch.Tensor:
    """The LUT entry for ``acc``, computed rather than looked up: the 11-bit
    bucket of acc's bit pattern, ``lr·½(e0^−p + e1^−p)`` at its two edges,
    ``lr`` where that is not finite.

    ``x^−p`` is taken as a correctly rounded f32 function (evaluated in
    float64 and rounded once), which is what the table's ``powf`` gives, so
    the result equals :func:`build_lut`'s entry bit for bit (tested over all
    2048 buckets). The int32 view is shifted arithmetically and masked to
    11 bits: torch has no logical shift for int32."""
    key = ((acc.contiguous().view(torch.int32) >> _LUT_SHIFT)
           & (FASTMATH_LR_LUT_SIZE - 1)).long()
    mpt = float(np.float32(-power_t))

    def powm(e):
        return e.double().pow(mpt).float()

    e0 = powm(_edge(key, initial_acc_gradient))
    e1 = powm(_edge(key + 1, initial_acc_gradient))
    val = (learning_rate * (e0 + e1)) * 0.5
    return torch.where(torch.isfinite(val), val,
                       torch.full_like(val, learning_rate))


def flex_update(gsum: torch.Tensor, acc_new: torch.Tensor,
                learning_rate: float, power_t: float) -> torch.Tensor:
    """AdagradFlex update given the already-bumped accumulator; NaN/Inf → 0
    (reference: src/optimizer.rs:76-89)."""
    upd = gsum * learning_rate * torch.pow(acc_new, -power_t)
    return torch.nan_to_num(upd, nan=0.0, posinf=0.0, neginf=0.0)


def encode_counts(c: np.ndarray) -> np.ndarray:
    """The native engine's 8-bit count code (fw_native.cpp encode_count):
    0–15 exact, ``e<<3 | (m−8)`` with c rounded up above; a copy of the
    JAX package's numpy function."""
    c = np.asarray(c, np.int64)
    out = c.astype(np.uint8)
    big = c > 15
    if big.any():
        cb = c[big]
        e = np.floor(np.log2(cb)).astype(np.int64)
        m = -(-cb // (1 << np.maximum(e - 3, 0)))  # ceil divide
        bump = m == 16
        e[bump] += 1
        m[bump] = 8
        out[big] = ((e << 3) | (m - 8)).astype(np.uint8)
    return out


def decode_counts(code: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_counts`: 0–15 exact; above that
    ``(8 + (code & 7)) << ((code >> 3) − 3)``, as f32."""
    code = code.to(torch.int32)
    e = code >> 3  # codes are 0..255: the arithmetic shift is logical here
    m = code & 7
    big = (8 + m) << torch.clamp(e - 3, min=0)
    return torch.where(code < 16, code, big).to(torch.float32)


def batch_mean_grads(rid: torch.Tensor, grows: torch.Tensor,
                     cap: float = 8.0) -> torch.Tensor:
    """Cap each weight's effective per-batch multiplicity at ``cap``:
    ``g_eff = Σ_e g_e · min(1, cap/c)``, c the number of update rows that
    touch the weight (lane-wise; a row with an exact 0.0 gradient in a lane
    does not count). Runs after dedup, on ``[K, 128]`` rows; the counts come
    from a stable sort of the row ids, never from a table-sized buffer
    (fwumious_wabbit_tpu/ops/adagrad.py:303-365): each sorted row's run
    (the place of its id among the distinct ids) indexes one ``[K, 128]``
    sum of the touched lanes. The counts are whole numbers, exact in f32
    below 2^24, so the order of the adds (atomic on the card) moves none.
    Not a running sum down the K rows: on the card that adds each lane's K
    values in one thread (~0.92 s a call at the 39-field FFM's K = 2.56M)."""
    K = rid.shape[0]
    if K <= 1:
        return grows
    touched = (grows != 0.0).to(grows.dtype)
    rs, order = torch.sort(rid, stable=True)
    run = torch.cat([torch.zeros(1, dtype=torch.long, device=rid.device),
                     torch.cumsum(rs[1:] != rs[:-1], dim=0)])
    counts = torch.zeros_like(grows).index_add_(0, run, touched[order])
    c = torch.clamp(counts[run], min=1.0)
    # tensor / tensor: a Python scalar / tensor is reciprocal() * scalar;
    # the cap is filled on the device (new_tensor would copy it from the
    # host, which a CUDA graph's capture refuses)
    cap_t = torch.full((), cap, dtype=c.dtype, device=c.device)
    scaled = grows[order] * torch.clamp(cap_t / c, max=1.0)
    out = torch.empty_like(grows)
    out[order] = scaled
    return out


class ScopedOptimizer:
    """One optimizer per scope (LR, FFM, NN), as in the reference
    (src/block_ffm.rs:50-60). ``batch_mean``: cap each weight's per-batch
    multiplicity at ``batch_cap`` (see :func:`batch_mean_grads`)."""

    def __init__(self, kind: int, learning_rate: float, power_t: float,
                 initial_acc_gradient: float, batch_mean: bool = False,
                 batch_cap: float = 8.0):
        self.kind = kind
        self.learning_rate = float(learning_rate)
        self.power_t = float(power_t)
        self.initial_acc_gradient = float(initial_acc_gradient)
        self.batch_mean = bool(batch_mean)
        self.batch_cap = float(batch_cap)

    @property
    def has_state(self) -> bool:
        return self.kind != OPT_SGD

    def initial_acc(self) -> float:
        """Initial accumulator. For LUT the initial gradient is folded into
        the table instead (reference: src/optimizer.rs:158-161)."""
        if self.kind == OPT_ADAGRAD_FLEX:
            return self.initial_acc_gradient
        return 0.0

    def count_factor(self, counts: torch.Tensor) -> torch.Tensor:
        """Batch-mean cap factor ``min(1, cap/c)`` per entry from host
        multiplicity counts (u8 codes or plain integers). The train step
        scales the scalar/slab gradients with it before dedup."""
        c = decode_counts(counts) if counts.dtype == torch.uint8 else counts
        c = torch.clamp(c.to(torch.float32), min=1.0)
        # filled on the device, as in batch_mean_grads
        cap = torch.full((), self.batch_cap, dtype=c.dtype, device=c.device)
        return torch.clamp(cap / c, max=1.0)

    def apply_dense(self, w: torch.Tensor, acc: torch.Tensor | None,
                    gsum: torch.Tensor, gsq: torch.Tensor):
        """Dense update of a tower tensor, **in place**: ``w``, ``acc``,
        ``gsum`` (Σ_examples g) and ``gsq`` (Σ_examples g²) of one shape.
        ``acc += gsq`` then ``w −= rate(acc_new)·gsum``; ``w −= lr·gsum`` for
        SGD, whose ``acc`` is None (fwumious_wabbit_tpu/ops/adagrad.py:191-202).
        Returns ``(w, acc)``."""
        if self.kind == OPT_SGD:
            w.sub_(gsum * self.learning_rate)
            return w, acc
        acc.add_(gsq)
        if self.kind == OPT_ADAGRAD_LUT:
            upd = gsum * lut_rate_compute(acc, self.learning_rate, self.power_t,
                                          self.initial_acc_gradient)
        else:
            upd = flex_update(gsum, acc, self.learning_rate, self.power_t)
        w.sub_(upd)
        return w, acc

    def apply_rows(self, w: torch.Tensor, acc: torch.Tensor | None,
                   rid: torch.Tensor, grows: torch.Tensor,
                   pre_scaled: bool = False):
        """Sparse update of a ``[R, 128]`` row table, **in place**:
        ``rid [K]`` row ids (repeats allowed, ids ≥ R are padding and
        dropped), ``grows [K, 128]`` gradient rows. Per weight
        ``acc += Σg²`` then ``w −= rate(acc_new)·Σg``; ``w −= lr·Σg`` for
        SGD, whose ``acc`` is None. Returns ``(w, acc)``.

        An example's duplicate ids must be pre-summed (ops/tables.py dedup)
        so that acc receives ``(Σg)²`` per example and weight. With the
        batch-mean cap on and ``pre_scaled`` false (no host counts), the cap
        is taken from the rows themselves (:func:`batch_mean_grads`)."""
        if self.batch_mean and not pre_scaled:
            grows = batch_mean_grads(rid, grows, self.batch_cap)
        from .sparse_update import sparse_adagrad_update

        return sparse_adagrad_update(
            w, acc if self.has_state else None, rid.to(torch.int32),
            grows.contiguous(), self.learning_rate, self.power_t,
            self.initial_acc_gradient, self.kind)


def apply_rows_plain(w: torch.Tensor, acc: torch.Tensor | None,
                     rid: torch.Tensor, grows: torch.Tensor, kind: int,
                     learning_rate: float, power_t: float,
                     initial_acc_gradient: float):
    """The plain version of the sparse row update, in place: ``index_add_``
    of g² into acc, gather the bumped rows, rate them, ``index_add_`` of
    −rate·g into w (fwumious_wabbit_tpu/ops/adagrad.py:258-268). Ids ≥ R
    are padding and dropped, as XLA's scatter drops them."""
    rid = rid.long()
    keep = rid < w.shape[0]
    if not bool(keep.all()):
        rid, grows = rid[keep], grows[keep]
    if kind == OPT_SGD:
        # the product rounded before the add, as JAX's w.at[rid].add(−lr·g)
        w.index_add_(0, rid, grows * -learning_rate)
        return w, acc
    acc.index_add_(0, rid, grows * grows)
    acc_rows = acc[rid]
    if kind == OPT_ADAGRAD_LUT:
        upd = grows * lut_rate_compute(acc_rows, learning_rate, power_t,
                                       initial_acc_gradient)
    else:
        upd = flex_update(grows, acc_rows, learning_rate, power_t)
    w.index_add_(0, rid, upd, alpha=-1.0)
    return w, acc
