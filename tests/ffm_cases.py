"""Inputs of the fused FFM kernels (fwumious_wabbit_tpu_torch/ops/ffm.py) for
the tests, from a numpy seed: a table of either slab layout, ids with
duplicates, values and fields with the padding forms. Imports no jax, so
the card's tests use it too."""

from __future__ import annotations

import numpy as np

from fwumious_wabbit_tpu_torch.ops import tables

# (F, k, N, B): tests/test_pallas_ffm.py's grid, the serving shape (one-row
# slabs), and a model whose slabs span three rows and whose contra tensor
# needs more than 48 KB of shared memory
SHAPES = [(4, 4, 6, 8), (16, 8, 12, 16), (3, 2, 5, 4), (2, 8, 8, 256),
          (40, 8, 48, 8)]
PADDINGS = ["minus1", "val0"]


def ffm_case(F, k, N, B, padding="both", seed=0, bits=12):
    """``(table [R, 128], ids [B, N] i32, vals [B, N] f32, fields [B, N]
    i32, spec)``, numpy arrays and the table's spec. ``padding``:
    ``"minus1"`` (field −1), ``"val0"`` (what Batcher emits: field 0, value
    0.0) or ``"both"``. Each example repeats its first id at its second
    position, and every other example starts with example 0's first id."""
    rng = np.random.default_rng(seed + F * 1000 + k * 100 + N)
    spec = tables.make_spec(1 << bits, F * k)
    # weights at a trained model's scale (the FFM init draws
    # (U-0.5)/sqrt(k)/50); at unit scale the diagonal's cancellation leaves
    # f32 noise of ~1e-5 in JAX and the port alike, against a float64 truth
    table = rng.normal(scale=0.1, size=(spec.num_rows, tables.LANE)).astype(np.float32)
    # every id's slab lies inside the table (tables.gather's rule)
    top = (spec.padded_size if spec.rows_per_slab == 1
           else (spec.num_rows - spec.rows_per_slab + 1) * tables.LANE)
    ids = rng.integers(0, top, (B, N)).astype(np.int32)
    if N > 1:
        ids[:, 1] = ids[:, 0]
    ids[1::2, 0] = ids[0, 0]
    vals = rng.uniform(0.5, 2.0, (B, N)).astype(np.float32)
    fields = rng.integers(0, F, (B, N)).astype(np.int32)
    pad = rng.random((B, N))
    if padding in ("minus1", "both"):
        fields[pad < 0.15] = -1
    if padding in ("val0", "both"):
        sel = (pad >= 0.15) & (pad < 0.3)
        fields[sel] = 0
        vals[sel] = 0.0
    return table, ids, vals, fields, spec


def padded(vals: np.ndarray, fields: np.ndarray, F: int) -> np.ndarray:
    """The positions both padding forms mark: their gradient is exactly 0."""
    return (fields < 0) | (fields >= F) | (vals == 0.0)
