"""Row-structured hashed weight tables — the counterpart of
fwumious_wabbit_tpu/ops/tables.py.

The geometry (:class:`TableSpec`, :func:`make_spec`) is copied exactly: it
defines the model file's layout and the FFM addressing. Every table is
stored as ``[num_rows, 128]`` f32 holding the bytes of the reference's flat
arena, so a lookup indexes the flat view directly:

* **LR** (slab = 1 float): hash ``h`` owns flat float ``h``.
* **FFM** (slab = F·k floats): hash ``h`` owns the aligned flat window
  ``[h & ~(align−1), …) + F·k`` (``align`` = F·k rounded up to a power of
  two ≤ 128, or to a multiple of 128 above that; multi-row slabs start at
  the row of ``h``).

The JAX package selects lanes with one-hot contractions because scalar
gathers are slow on a TPU; on a GPU an indexed load of the flat view is the
natural form and returns the same values.

The backward helpers turn per-occurrence cotangents into ``(rid [K],
grows [K, 128])`` update rows for ops/adagrad.apply_rows, keyed by the ids
(the port's gathers keep no ``aux``), with the JAX package's per-example
dedup: each example's contributions to one key are summed onto the key's
first occurrence and the other entries zeroed, so the accumulator receives
``(Σg)²`` per example and weight (reference: src/block_ffm.rs:265-288). The
JAX package has a pairwise path for narrow inputs and a sort path for wide
ones; one stable-sort path that keeps the entries in place does both here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

LANE = 128
LANE_BITS = 7


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class TableSpec:
    """Static geometry of one row table."""

    logical_size: int  # addressable flat floats (2^bits)
    slab: int  # floats returned per lookup
    align: int  # slab address granularity (pow2 or multiple of 128)
    rows_per_slab: int  # consecutive rows gathered per lookup
    padded_size: int  # physical flat floats (row multiple)

    @property
    def num_rows(self) -> int:
        return self.padded_size // LANE

    @property
    def positions(self) -> int:
        """Slab positions per row (align < 128 case)."""
        return LANE // self.align if self.align <= LANE else 1


def make_spec(logical_size: int, slab: int) -> TableSpec:
    if slab <= LANE:
        align = _next_pow2(slab)
        rows_per_slab = 1
    else:
        align = round_up(slab, LANE)
        rows_per_slab = align // LANE
    padded = round_up(max(logical_size, align), LANE * rows_per_slab)
    if padded // LANE > 2048:
        # the JAX package pads large tables to a multiple of its sparse-update
        # kernel's 2048-row sweep chunk; the same padding keeps the row
        # count, and so the in-memory layout, identical between packages
        unit = LANE * math.lcm(rows_per_slab, 2048)
        padded = round_up(padded, unit)
    return TableSpec(logical_size, slab, align, rows_per_slab, padded)


def to_rows(flat: torch.Tensor, spec: TableSpec) -> torch.Tensor:
    """Flat ``[n]`` → ``[num_rows, 128]``, zero-padding the tail."""
    n = flat.shape[0]
    if n < spec.padded_size:
        flat = torch.cat([flat, flat.new_zeros(spec.padded_size - n)])
    return flat.reshape(spec.num_rows, LANE)


def to_flat(rows: torch.Tensor, spec: TableSpec) -> torch.Tensor:
    """``[num_rows, 128]`` → flat ``[logical_size]`` (a view)."""
    return rows.reshape(-1)[: spec.logical_size]


def gather(table: torch.Tensor, ids: torch.Tensor, spec: TableSpec) -> torch.Tensor:
    """Slabs ``[..., slab]`` for ``ids`` (any leading shape) from a
    ``[num_rows, 128]`` table."""
    ids = ids.long()
    if spec.rows_per_slab == 1:
        base = ids & ~(spec.align - 1)  # align is a power of two ≤ 128
    else:
        base = ids & ~(LANE - 1)  # whole consecutive rows from h's row
    offs = torch.arange(spec.slab, device=ids.device)
    return table.reshape(-1)[base.unsqueeze(-1) + offs]


def gather_scalars(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Scalar weights ``w[h]`` for ``ids`` (any leading shape)."""
    return table.reshape(-1)[ids.long()]


# -- backward: cotangents → update rows ------------------------------------------


def _pos_bits(spec: TableSpec) -> int:
    return (spec.align - 1).bit_length()  # log2(align)


def expand_scalar_grads(ids: torch.Tensor, g: torch.Tensor):
    """Scalar cotangents ``g [...]`` of the weights ``ids [...]`` →
    ``(rid [K], grows [K, 128])``: one row per occurrence, g in its lane."""
    ids = ids.long()
    oh = torch.nn.functional.one_hot(ids & (LANE - 1), LANE).to(g.dtype)
    grows = oh * g[..., None]
    return (ids >> LANE_BITS).reshape(-1), grows.reshape(-1, LANE)


def _pad_slab(g: torch.Tensor, width: int) -> torch.Tensor:
    pad = width - g.shape[-1]
    if pad:
        g = torch.cat([g, g.new_zeros((*g.shape[:-1], pad))], dim=-1)
    return g


def _place_windows(wid: torch.Tensor, g: torch.Tensor, spec: TableSpec):
    """Window ids and ``[..., align]`` slabs (align ≤ 128) → row ids and
    ``[K, 128]`` rows with each slab at its window's lanes."""
    pos_bits = _pos_bits(spec)
    rid = wid >> (LANE_BITS - pos_bits)
    P = spec.positions
    if P == 1:
        grows = g
    else:
        oh = torch.nn.functional.one_hot(wid & (P - 1), P).to(g.dtype)
        grows = (oh[..., :, None] * g[..., None, :]).reshape(*g.shape[:-1], LANE)
    return rid.reshape(-1), grows.reshape(-1, LANE)


def expand_grads(ids: torch.Tensor, g: torch.Tensor, spec: TableSpec):
    """Slab cotangents ``g [..., slab]`` of the slabs of ``ids [...]`` →
    ``(rid [K], grows [K, 128])``; a multi-row slab gives its rows in order."""
    ids = ids.long()
    if spec.rows_per_slab == 1:
        return _place_windows(ids >> _pos_bits(spec), _pad_slab(g, spec.align),
                              spec)
    G = spec.rows_per_slab
    rid = (ids >> LANE_BITS)[..., None] + torch.arange(G, device=ids.device)
    grows = _pad_slab(g, G * LANE).reshape(*g.shape[:-1], G, LANE)
    return rid.reshape(-1), grows.reshape(-1, LANE)


def _dedup_runs(keys: torch.Tensor, payload: torch.Tensor):
    """Per example, sum each key's payloads onto its first occurrence and
    zero its other entries; entries stay where they are.

    ``keys [B, W]``, ``payload [B, W, P]`` → ``(keys, payload_dedup)``. A
    stable sort along W puts each key's entries together in their original
    order; the run sums are differences of one cumulative sum, taken at the
    run's last and before its first entry (the JAX sort path,
    fwumious_wabbit_tpu/ops/tables.py:286-310); the totals are then put
    back in place. The cumulative sum is taken in float64, so a difference
    does not cancel away the f32 precision of a small run after large ones."""
    B, W = keys.shape
    if W <= 1:
        return keys, payload
    P = payload.shape[-1]
    ks, order = torch.sort(keys, dim=1, stable=True)
    order3 = order[..., None].expand(B, W, P)
    ps = torch.gather(payload, 1, order3).double()
    step = ks[:, 1:] != ks[:, :-1]
    one = torch.ones((B, 1), dtype=torch.bool, device=keys.device)
    is_first = torch.cat([one, step], dim=1)
    is_last = torch.cat([step, one], dim=1)
    csum = torch.cumsum(ps, dim=1)
    idx = torch.arange(W, device=keys.device).expand(B, W)
    run_first = torch.cummax(torch.where(is_first, idx, 0), dim=1).values
    run_last = torch.flip(torch.cummin(torch.flip(
        torch.where(is_last, idx, W - 1), [1]), dim=1).values, [1])
    totals = torch.gather(csum, 1, run_last[..., None].expand(B, W, P))
    base = torch.gather(csum, 1, torch.clamp(run_first - 1, min=0)[..., None]
                        .expand(B, W, P))
    totals = totals - torch.where((run_first > 0)[..., None], base,
                                  torch.zeros((), dtype=base.dtype,
                                              device=payload.device))
    sorted_d = torch.where(is_first[..., None], totals,
                           torch.zeros((), dtype=totals.dtype,
                                       device=payload.device)).to(payload.dtype)
    return keys, torch.empty_like(payload).scatter_(1, order3, sorted_d)


def dedup_rows(rid: torch.Tensor, grows: torch.Tensor, batch: int,
               keys: torch.Tensor | None = None):
    """Per-example dedup of expanded rows ``rid [K]``, ``grows [K, 128]``
    (``K = batch·W``), keyed by ``keys [batch, W]`` (default: the row id).
    Returns ``(rid, grows)`` with each key's total on its first entry."""
    W = rid.shape[0] // batch
    k2 = rid.reshape(batch, W) if keys is None else keys.reshape(batch, W)
    _, g = _dedup_runs(k2, grows.reshape(batch, W, LANE))
    return rid, g.reshape(-1, LANE)


def expand_scalar_grads_dedup(ids: torch.Tensor, g: torch.Tensor):
    """LR cotangents with per-example dedup before lane expansion: ``ids
    [B, W]`` feature ids, ``g [B, W]`` scalars, deduped keyed by the id (an
    id is one (row, lane)), then expanded as :func:`expand_scalar_grads`."""
    _, g = _dedup_runs(ids, g[..., None])
    return expand_scalar_grads(ids, g[..., 0])


def expand_grads_dedup(ids: torch.Tensor, g: torch.Tensor, spec: TableSpec):
    """FFM slab cotangents with per-example dedup before row expansion,
    keyed by the window id ``ids >> log2(align)``: equal windows overlap
    fully and merge; distinct windows of one row use disjoint lanes. Only
    for single-row slabs (F·k ≤ 128): wider ones use :func:`expand_grads`
    and :func:`dedup_rows`."""
    if spec.rows_per_slab != 1:
        raise ValueError("multi-row slabs: use expand_grads + dedup_rows")
    g = _pad_slab(g, spec.align)
    wid = ids.long() >> _pos_bits(spec)
    _, g = _dedup_runs(wid, g)
    return _place_windows(wid, g, spec)
