"""The ('data', 'table') grid of ranks — the counterpart of
fwumious_wabbit_tpu/parallel/mesh.py.

* **data axis**: synchronous data parallelism. The batch is cut over
  ``data``; the tower's dense gradients meet in an ``all_reduce`` over the
  data group (parallel/sharded.py).
* **table axis**: the hashed row tables (``lr_w``, ``ffm_w`` and their
  accumulators) are row-sharded over ``table``: each rank keeps one block of
  rows, ``P(table, None)``, the same block on every rank of a table column.

One process per device (parallel/distributed.py): rank ``r`` of an
``n_data × n_table`` mesh sits at ``(r // n_table, r % n_table)``, the
row-major order of the JAX mesh's device grid. Its table group holds the
ranks of its row of the grid (one data index, every table index), its data
group the ranks of its column. Tables are padded to a multiple of the table
axis so the blocks are equal.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

DATA_AXIS = "data"
TABLE_AXIS = "table"
TABLE_KEYS = ("lr_w", "lr_acc", "ffm_w", "ffm_acc")


def all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' ``x`` stacked along axis 0, in group-rank order."""
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


class Mesh:
    """An ``n_data × n_table`` grid of the ranks of the process group, with
    this rank's coordinates and its groups: ``table_group`` (its row of the
    grid), ``data_group`` (its column) and ``world_group`` (every rank).
    Every rank must build the same meshes in the same order: making a
    subgroup is a collective of the whole group."""

    def __init__(self, n_data: int, n_table: int):
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs a process group "
                               "(parallel/distributed.initialize)")
        world = dist.get_world_size()
        if n_data * n_table != world:
            raise ValueError(f"mesh {n_data}x{n_table} does not cover the "
                             f"{world} ranks of the process group")
        self.shape = {DATA_AXIS: n_data, TABLE_AXIS: n_table}
        self.rank = dist.get_rank()
        self.data_index, self.table_index = divmod(self.rank, n_table)
        self.world_group = dist.group.WORLD
        if world == 1:
            self.table_group = self.data_group = self.world_group
            return
        for d in range(n_data):
            g = dist.new_group([d * n_table + t for t in range(n_table)])
            if d == self.data_index:
                self.table_group = g
        for t in range(n_table):
            g = dist.new_group([d * n_table + t for d in range(n_data)])
            if t == self.table_index:
                self.data_group = g

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[TABLE_AXIS]

    def shards(self, both_axes: bool) -> tuple[int, int]:
        """``(count, index)`` of the batch shards: over ``data`` (psum
        exchange), or over both axes, data-major (a2a exchange: every rank
        owns distinct examples)."""
        if both_axes:
            return self.size, self.rank
        return self.shape[DATA_AXIS], self.data_index


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_rows(rows: int, n_table: int) -> int:
    """A table's rows padded to the mesh (fwumious_wabbit_tpu/parallel/
    mesh.py:81-104): a multiple of the table axis, and of ``n_table · 2048``
    for large tables, so each block is a multiple of the JAX sparse-update
    kernel's 2048-row sweep. Rows past the hash range are never addressed."""
    if n_table == 1:
        return rows
    unit = n_table * 2048 if rows >= n_table * 2048 else n_table
    return round_up(rows, unit)


def pad_params_for_mesh(params: dict, mesh: Mesh) -> dict:
    """``params`` with each table's rows zero-padded to :func:`padded_rows`."""
    n_table = mesh.shape[TABLE_AXIS]
    out = dict(params)
    for key in TABLE_KEYS:
        if key in out:
            t = out[key]
            target = padded_rows(t.shape[0], n_table)
            if target != t.shape[0]:
                out[key] = torch.cat([t, t.new_zeros((target - t.shape[0],
                                                      t.shape[1]))])
    return out


def shard_params(params: dict, mesh: Mesh) -> dict:
    """This rank's share of padded ``params``: its own row block of every
    table, ``P(table, None)``, copied into memory of its own (the update
    writes it in place); the tower's tensors whole."""
    n_table, t = mesh.shape[TABLE_AXIS], mesh.table_index
    out = dict(params)
    for key in TABLE_KEYS:
        if key in out:
            rl = out[key].shape[0] // n_table
            out[key] = out[key][t * rl:(t + 1) * rl].clone()
    return out


def shard_model(model, mesh: Mesh) -> None:
    """Give ``model`` this rank's row blocks of its tables (padded, then
    :func:`shard_params`) in place of the whole tables, and the mesh as
    ``model.mesh``: the sharded steps (parallel/sharded.py) update the
    blocks, and persistence/model_file.save_model gathers them back."""
    params = {k: getattr(model, k) for k in TABLE_KEYS if k in model._buffers}
    for key, block in shard_params(pad_params_for_mesh(params, mesh), mesh).items():
        model.register_buffer(key, block)
    model.mesh = mesh


def gather_tables(params: dict, mesh: Mesh, rows: dict) -> dict:
    """``params`` with each table's row blocks gathered over the table group
    to every rank and the mesh padding cut off: ``rows[key]`` rows, the
    unsharded table (fwumious_wabbit_tpu/persistence/model_file.py:94-112,
    ``_fetch_global``). A collective: every rank of the mesh calls it."""
    n_table = mesh.shape[TABLE_AXIS]
    out = dict(params)
    for key in TABLE_KEYS:
        if key in out:
            whole = all_gather(out[key], mesh.table_group, n_table)
            out[key] = whole[:rows[key]]
    return out


def shard_batch(batch: dict, mesh: Mesh, both_axes: bool = False) -> dict:
    """This rank's slice of a global batch: axis 0 of every array cut over
    ``data``, or over both axes (:meth:`Mesh.shards`). Host arrays and
    tensors alike; the batch must divide evenly."""
    count, index = mesh.shards(both_axes)
    out = {}
    for key, v in batch.items():
        n = v.shape[0]
        if n % count:
            raise ValueError(f"batch of {n} does not split into {count} shards")
        m = n // count
        out[key] = v[index * m:(index + 1) * m]
    return out


def gather_batch(x: torch.Tensor, mesh: Mesh, both_axes: bool = False) -> torch.Tensor:
    """The global batch of a per-rank result ``x [B_local]``, in the order
    :func:`shard_batch` cut it: gathered over every rank (a2a exchange), or
    over the rank's data group (psum exchange, where a table group's ranks
    hold the same slice)."""
    if both_axes:
        return all_gather(x, mesh.world_group, mesh.size)
    return all_gather(x, mesh.data_group, mesh.shape[DATA_AXIS])


def table_rows(model) -> dict:
    """The unsharded row count of each of ``model``'s tables."""
    rows = {"lr_w": model.lr_spec.num_rows, "lr_acc": model.lr_spec.num_rows}
    if model.has_ffm:
        rows["ffm_w"] = rows["ffm_acc"] = model.ffm_spec.num_rows
    return rows

