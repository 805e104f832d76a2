"""The explicit-collectives train step on row-sharded tables — the
counterpart of fwumious_wabbit_tpu/parallel/sharded.py, on
``torch.distributed`` (NCCL on the card, gloo on the CPU), one process per
device (parallel/distributed.py, parallel/mesh.py).

Two exchanges, as in the JAX package:

**psum** (batch cut over ``data``, the same slice on every rank of a table
group):

* lookup: each rank takes the rows it owns (a masked local take), and one
  ``all_reduce(SUM)`` over the table group assembles whole rows everywhere;
* update: the occurrences' ids and gradient rows are ``all_gather``-ed over
  the data group, so every rank replays the whole batch on its own block.

**a2a** (batch cut over both axes: every rank owns distinct examples):

* lookup: ids are bucketed by owner, ``all_to_all_single`` carries each
  owner the ids it serves, the owner takes its rows, a second
  ``all_to_all_single`` carries them back;
* update: ids and gradient rows travel to their owner the same way, then one
  ``all_gather`` over the data group merges the other data replicas'
  owner-bucketed rows before the local update;
* the sends have a static capacity of ``slack·K/n_table`` slots per owner
  (equal splits, which NCCL and gloo both take); an overflowed occurrence
  reads zero rows and drops its update for that step, and the step counts
  such drops over the whole mesh. Only occurrences that matter take a slot:
  in the lookup those with a value and a combo or field (padding, id 0,
  would all go to owner 0 and push real rows out of its bucket: at B=1024
  on a 1×4 mesh the C++ ingest's two padded FFM positions per example
  fill half of every owner's slots), in the update the rows with a
  gradient. The others read zero rows and send nothing, which changes
  nothing: their contributions and gradients are 0. The JAX sharded step
  buckets every occurrence.

The owner-local tail is ``opt.apply_rows`` on the rank's own block: the
batch-mean cap over the gathered global batch (ops/adagrad.batch_mean_grads),
then ops/sparse_update.sparse_adagrad_update, the CUDA kernel on the card.

The FFM forward and backward run through the fused kernels of ops/ffm.py,
unchanged: the exchange delivers whole 128-lane rows per occurrence,
``[B, N·rows_per_slab, 128]``, and that buffer is their table, addressed by
ids ``(position·rows_per_slab) << 7 | (id & 127 & slab_mask)``, so the
kernel's ``base = id & mask`` finds each slab's window in its own received
row. The tower's dense gradients and Σg² meet in one ``all_reduce`` over the
dense axes (data; data and table for a2a) before the tower's update: every
gradient of the step is complete before any weight is written.

The batch-mean cap takes the host's multiplicity counts
(``lr_counts``/``ffm_counts``) when the batch carries them, as the
single-device step does: the host counted them over the global batch, so
each rank's slice scales its gradients by the same factors before dedup,
and the mesh trains what one device trains (the CLI's batches carry them).
Without them the cap is taken from the gathered rows themselves, as in the
JAX sharded step, which never reads the counts: the two differ where the
host's 8-bit count code rounds a count up (above 15, not of the form
m·2^e with m < 16; a partial last batch's constant feature, say).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..models.model import FwModel, predict_prob
from ..ops import ffm, tables
from ..train import step as st
from .mesh import DATA_AXIS, TABLE_AXIS, Mesh, all_gather

# bytes of the collectives' outputs on this rank: a per-rank proxy of the
# exchange's traffic (the JAX tests read the same off the compiled HLO)
COLLECTIVE_BYTES = 0


def _count(t: torch.Tensor) -> torch.Tensor:
    global COLLECTIVE_BYTES
    COLLECTIVE_BYTES += t.numel() * t.element_size()
    return t


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    return _count(x)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return _count(out)


def _all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    return _count(all_gather(x, group, size))


# -- the psum exchange -------------------------------------------------------------------


def _sharded_take(mesh: Mesh, local: torch.Tensor, rid: torch.Tensor) -> torch.Tensor:
    """Rows ``rid [...]`` of a table row-sharded over the table axis: a
    masked local take, then ``all_reduce(SUM)`` over the table group."""
    rl = local.shape[0]
    lrid = rid.long() - mesh.table_index * rl
    ok = (lrid >= 0) & (lrid < rl)
    rows = local[lrid.clamp(0, rl - 1)]
    rows = torch.where(ok[..., None], rows, torch.zeros((), device=rows.device))
    return _all_reduce(rows, mesh.table_group)


def _owner_rows(mesh: Mesh, rl: int, ids: torch.Tensor, g: torch.Tensor):
    """Global row ids and gradient rows → this rank's local ids (``rl``, the
    update's padding id, where another rank owns the row) and rows (zero
    there)."""
    lrid = ids.long() - mesh.table_index * rl
    ok = (lrid >= 0) & (lrid < rl)
    g = torch.where(ok[:, None], g, torch.zeros((), device=g.device))
    return torch.where(ok, lrid, rl), g


def _sharded_row_update(mesh: Mesh, opt, w, acc, rid, grows, pre: bool) -> None:
    """The owner-side update of a row-sharded table (psum exchange): this
    data shard's occurrences gathered over the data group, so each rank
    applies the whole batch to its block."""
    n_d = mesh.shape[DATA_AXIS]
    rid_all = _all_gather(rid.to(torch.int32), mesh.data_group, n_d)
    grows_all = _all_gather(grows, mesh.data_group, n_d)
    lrid, g = _owner_rows(mesh, w.shape[0], rid_all, grows_all)
    opt.apply_rows(w, acc, lrid, g, pre_scaled=pre)


# -- the all-to-all exchange ---------------------------------------------------------------


def _bucket_slots(owner: torch.Tensor, n_t: int, capacity: int,
                  keep: torch.Tensor):
    """``(slot, valid)``: each kept occurrence's place in its owner's send
    bucket (the number of earlier kept occurrences with the same owner, an
    exclusive one-hot cumsum) and whether it fits the capacity. An
    overflowed or unkept one gets ``slot == capacity``."""
    oh = ((owner[:, None] == torch.arange(n_t, device=owner.device))
          & keep[:, None]).to(torch.int32)
    rank = ((torch.cumsum(oh, 0) - oh) * oh).sum(1)
    valid = keep & (rank < capacity)
    return torch.where(valid, rank, capacity), valid


def _sends(owner, slot, valid, capacity: int, n_t: int, values: list) -> list:
    """Each of ``values`` (per occurrence) scattered into an ``[n_t·cap,
    ...]`` send buffer at its owner's bucket; overflowed ones are left out
    and unfilled slots stay 0."""
    at = (owner * capacity + slot)[valid]
    out = []
    for v in values:
        buf = v.new_zeros((n_t * capacity, *v.shape[1:]))
        buf[at] = v[valid]
        out.append(buf)
    return out


def _a2a_take(mesh: Mesh, local: torch.Tensor, rid: torch.Tensor,
              keep: torch.Tensor, capacity: int) -> torch.Tensor:
    """Rows ``rid [...]`` of a row-sharded table by the all-to-all id
    exchange: bucket the ``keep`` occurrences by owner, send the ids, the
    owners take their rows, send the rows back. An overflowed or unkept
    occurrence reads a zero row."""
    n_t = mesh.shape[TABLE_AXIS]
    rl, lane = local.shape
    shape = rid.shape
    rid = rid.reshape(-1).long()
    owner = rid // rl  # tables are padded to n_t equal blocks
    slot, valid = _bucket_slots(owner, n_t, capacity, keep.reshape(-1))
    (send_ids,) = _sends(owner, slot, valid, capacity, n_t, [rid.to(torch.int32)])
    recv_ids = _all_to_all(send_ids, mesh.table_group)  # requests to me
    lrid = (recv_ids.long() - mesh.table_index * rl).clamp(0, rl - 1)
    recv_rows = _all_to_all(local[lrid], mesh.table_group)  # replies to me
    rows = recv_rows[torch.where(valid, owner * capacity + slot, 0)]
    rows = torch.where(valid[:, None], rows, torch.zeros((), device=rows.device))
    return rows.reshape(*shape, lane)


def _a2a_row_update(mesh: Mesh, opt, w, acc, rid, grows, pre: bool,
                    capacity: int) -> torch.Tensor:
    """The owner-side update by all-to-all: ids and gradient rows travel to
    their owner over the table group, then one ``all_gather`` over the data
    group merges the other data replicas' buckets. Returns the number of
    occurrences with a gradient that overflowed (padding rows, all zero,
    are not counted: losing them loses nothing)."""
    n_t, n_d = mesh.shape[TABLE_AXIS], mesh.shape[DATA_AXIS]
    rid = rid.reshape(-1).long()
    owner = rid // w.shape[0]
    real = (grows != 0.0).any(1)
    slot, valid = _bucket_slots(owner, n_t, capacity, real)
    send_ids, send_g = _sends(owner, slot, valid, capacity, n_t,
                              [rid.to(torch.int32), grows])
    recv_ids = _all_to_all(send_ids, mesh.table_group)
    recv_g = _all_to_all(send_g, mesh.table_group)
    all_ids = _all_gather(recv_ids, mesh.data_group, n_d)
    all_g = _all_gather(recv_g, mesh.data_group, n_d)
    # unfilled send slots carry id 0 and a zero row: inert
    lrid, g = _owner_rows(mesh, w.shape[0], all_ids, all_g)
    opt.apply_rows(w, acc, lrid, g, pre_scaled=pre)
    return ((~valid) & real).sum().to(torch.int32)


def a2a_capacity(n_occurrences: int, n_t: int, capacity_factor: float) -> int:
    """Static per-destination all-to-all capacity: ``slack·K/n_t`` slots."""
    return max(1, math.ceil(capacity_factor * n_occurrences / n_t))


def estimate_comm_bytes(batch_global: int, width: int, mesh_shape: tuple[int, int],
                        exchange: str, capacity_factor: float = 2.0) -> int:
    """Per-device collective traffic (bytes received) per table per step,
    the JAX package's analytical model (its parallel/sharded.py:217-242).

    psum: the lookup reduces full ``[K_loc, 128]`` rows over the table axis
    (a ring receives about the array's size) and the update gathers every
    occurrence row over the data axis, O(B·width·516) per shard whatever
    n_table is. a2a: ids and rows travel owner-bucketed, so the data-axis
    gather carries about 1/n_table of the rows: per-shard traffic shrinks
    as the table axis grows."""
    n_d, n_t = mesh_shape
    row_b = tables.LANE * 4
    id_b = 4
    if exchange == "psum":
        k_loc = (batch_global // n_d) * width
        lookup = k_loc * row_b * (n_t - 1) // max(n_t, 1)  # ring psum recv
        update = (n_d - 1) * k_loc * (row_b + id_b)  # data all_gather
        return lookup + update
    k_dev = (batch_global // (n_d * n_t)) * width
    cap = a2a_capacity(k_dev, n_t, capacity_factor)
    a2a = 2 * (n_t - 1) * cap * (row_b + id_b)  # fwd + bwd exchanges
    gather = (n_d - 1) * n_t * cap * (row_b + id_b)  # owner-bucketed rows
    return a2a + gather


# -- the step --------------------------------------------------------------------------


def resolve_exchange(exchange: str, mesh: Mesh) -> str:
    """``auto`` → a2a when the table axis is > 1, else psum."""
    if exchange == "auto":
        exchange = "a2a" if mesh.shape[TABLE_AXIS] > 1 else "psum"
    if exchange not in ("psum", "a2a"):
        raise ValueError(f"unknown exchange: {exchange!r}")
    return exchange


def slab_rows(ids: torch.Tensor, spec: tables.TableSpec) -> torch.Tensor:
    """The table rows each FFM id's slab spans: ``[B, N]`` (one-row slabs)
    or ``[B, N, rows_per_slab]``."""
    rid = ids >> tables.LANE_BITS
    G = spec.rows_per_slab
    if G > 1:
        rid = rid[..., None] + torch.arange(G, dtype=rid.dtype, device=rid.device)
    return rid


def exchanged_slabs(rows: torch.Tensor, ids: torch.Tensor,
                    spec: tables.TableSpec) -> tuple:
    """``(table, ids, spec)`` that address the slabs of ``ids [B, N]`` (i32)
    in ``rows``, the rows :func:`slab_rows` names as an exchange delivered
    them: the buffer ``[B·N·rows_per_slab, 128]``, the ids
    ``(position·rows_per_slab) << 7 | (id & 127 & slab_mask)`` and the
    FFM spec with the buffer's row count. The fused kernels' ``base = id &
    mask`` then finds each slab in its own rows."""
    B, N = ids.shape
    G = spec.rows_per_slab
    buf = rows.reshape(B * N * G, tables.LANE).contiguous()
    pos = torch.arange(B * N, dtype=torch.int32, device=ids.device).reshape(B, N)
    local_ids = ((pos * G) << tables.LANE_BITS) | (ids & (tables.LANE - 1)
                                                   & ffm.slab_mask(spec))
    return (buf, local_ids.contiguous(),
            dataclasses.replace(spec, padded_size=buf.shape[0] * tables.LANE))


def _occupied(vals, slots: torch.Tensor, n: int) -> torch.Tensor:
    """The occurrences that contribute: a combo or field in ``[0, n)`` and,
    where the batch carries values, a value other than 0."""
    keep = (slots >= 0) & (slots < n)
    return keep if vals is None else keep & (vals != 0.0)


def _gather(model: FwModel, bd: dict, take) -> tuple:
    """``(leaves, ffm_rows)``: the leaves of train/step.gather — the LR
    weights picked from their exchanged rows, and the FFM slab leaf — and
    the FFM slabs' exchanged rows as a table with its ids and spec
    (:func:`exchanged_slabs`, FwModel.ffm_outputs ``rows``)."""
    lr_ids, combos = model.lr_ids_combos(bd)
    keep = _occupied(bd.get("lr_vals"), combos, model.num_combos)
    rows = take(model.lr_w, lr_ids >> tables.LANE_BITS, keep)  # [B, L, 128]
    lane = (lr_ids & (tables.LANE - 1)).long()
    lr_wg = rows.gather(-1, lane[..., None])[..., 0]
    leaves = [lr_wg.detach().requires_grad_(True)]
    if not model.has_ffm:
        return leaves, None
    ids = bd["ffm_ids"].to(torch.int32)
    rid = slab_rows(ids, model.ffm_spec)
    keep = _occupied(bd.get("ffm_vals"), bd["ffm_fields"], model.num_fields)
    rows = take(model.ffm_w, rid, keep[..., None].expand(rid.shape)
                if rid.dim() > keep.dim() else keep)
    leaves.append(ffm.slab_leaf(ids, model.num_fields, model.ffm_k))
    return leaves, exchanged_slabs(rows, ids, model.ffm_spec)


def _reduce_dense(dense: tuple, group) -> tuple:
    """The tower's ``(grads, gsqs)`` summed over ``group`` in one
    ``all_reduce`` of their concatenation."""
    flat = [t for tree in dense for part in [*tree["nn"], tree["final"]]
            for t in (part["w"], part["b"])]
    joined = _all_reduce(torch.cat([t.reshape(-1) for t in flat]), group)
    out, at = [], 0
    for t in flat:
        out.append(joined[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    it = iter(out)

    def rebuild(tree):
        return {"nn": [{"w": next(it), "b": next(it)} for _ in tree["nn"]],
                "final": {"w": next(it), "b": next(it)}}

    return tuple(rebuild(tree) for tree in dense)


def make_sharded_train_step(model: FwModel, mesh: Mesh, exchange: str = "auto",
                            capacity_factor: float = 2.0,
                            with_stats: bool = False):
    """``step(batch) -> p`` (``(p, {"a2a_dropped": n})`` with
    ``with_stats``): the train step of train/step.make_train_step on a
    model whose tables are this rank's row blocks (mesh.shard_model), with
    explicit collectives; ``batch`` is this rank's slice
    (mesh.shard_batch) and ``p`` its predictions. The model's weights are
    updated in place. ``exchange`` is ``psum``, ``a2a`` or ``auto`` (a2a
    when the table axis is > 1); ``n`` is a tensor on the device, the
    overflowed occurrences of the whole mesh in this step (0 for psum)."""
    exchange = resolve_exchange(exchange, mesh)
    a2a = exchange == "a2a"
    dense_group = mesh.world_group if a2a else mesh.data_group
    device = model.lr_w.device
    n_t = mesh.shape[TABLE_AXIS]

    def take(local, rid, keep):
        if a2a:
            return _a2a_take(mesh, local, rid, keep,
                             a2a_capacity(rid.numel(), n_t, capacity_factor))
        return _sharded_take(mesh, local, rid)

    def row_update(opt, w, acc, rows):
        rid, grows, pre = rows
        if a2a:
            cap = a2a_capacity(rid.numel(), n_t, capacity_factor)
            return _a2a_row_update(mesh, opt, w, acc, rid, grows, pre, cap)
        _sharded_row_update(mesh, opt, w, acc, rid, grows, pre)
        return None

    def train_step(batch: dict):
        bd = st.to_device(batch, st.TRAIN_KEYS, device)
        leaves, ffm_rows = _gather(model, bd, take)
        x, p, dlogit, residuals = st.forward(model, bd, leaves, ffm_rows)
        grads, dense = st.backward(model, x, leaves, dlogit, residuals)
        if dense is not None:
            st.tower_update(model, *_reduce_dense(dense, dense_group))
        drops = [row_update(model.opt_lr, model.lr_w, getattr(model, "lr_acc", None),
                            st.lr_update_rows(model, bd, grads[0]))]
        if model.has_ffm:
            drops.append(row_update(model.opt_ffm, model.ffm_w,
                                    getattr(model, "ffm_acc", None),
                                    st.ffm_update_rows(model, bd, grads[1])))
        if not with_stats:
            return p
        if a2a:
            dropped = _all_reduce(sum(drops), mesh.world_group)
        else:
            dropped = torch.zeros((), dtype=torch.int32, device=device)
        return p, {"a2a_dropped": dropped}

    return train_step


def make_sharded_predict_step(model: FwModel, mesh: Mesh, exchange: str = "auto"):
    """``step(batch) -> p``: the forward of :func:`make_sharded_train_step`
    on this rank's slice, through the same take. Its a2a capacity is every
    occurrence (one owner may serve them all), so no lookup overflows and
    the predictions are exact, as the JAX package's GSPMD predict is."""
    exchange = resolve_exchange(exchange, mesh)
    device = model.lr_w.device

    def take(local, rid, keep):
        if exchange == "a2a":
            return _a2a_take(mesh, local, rid, keep, max(1, rid.numel()))
        return _sharded_take(mesh, local, rid)

    def predict_step(batch: dict) -> torch.Tensor:
        bd = st.to_device(batch, st.INPUT_KEYS, device)
        with torch.no_grad():
            leaves, ffm_rows = _gather(model, bd, take)
            parts = [model.lr_outputs(leaves[0], bd)]
            if model.has_ffm:
                parts.append(model.ffm_outputs(bd, None, ffm_rows))
            x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
            logit = model.tower(x) if model.has_nn else x.sum(-1)
            return predict_prob(logit)

    return predict_step
