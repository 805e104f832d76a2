"""Record → model-input translation and fixed-shape batching.

The per-example translation reproduces the reference's
``FeatureBufferTranslator::translate`` (reference:
src/feature_buffer.rs:137-338):

* LR path: for each feature combo, the cartesian product of its namespaces'
  features with VW-compatible chained hashing
  ``h_next = h_from ^ (h_acc * FNV_PRIME)``, masked to ``2^bit_precision``,
  values multiplied, tagged with the combo index; optional constant feature
  ``CONSTANT_HASH`` as its own output (reference: src/feature_buffer.rs:194-276).
* FFM path: one entry per (feature, field) with the hash masked so the low
  ``ceil(log2 k)`` bits are free for the embedding lanes (reference:
  src/feature_buffer.rs:279-336). We store the plain field index (the
  reference stores ``field_idx * ffm_k``).

Unlike the reference's one-example-at-a-time design, the TPU framework feeds
the device **fixed-shape padded batches**; :class:`Batcher` pads the
variable-length feature lists into bucketed dense arrays. Padding entries use
id 0 / value 0.0, which contribute exactly zero to forward outputs and
gradients, so they are mathematically inert.

The port's own copy of fwumious_wabbit_tpu/ingest/translator.py, the same in
behaviour; it imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config.model_instance import ModelInstance
from ..config.vwmap import NamespaceDescriptor, NamespaceFormat, NamespaceType
from ..hashing import CONSTANT_HASH, MASK32, VOWPAL_FNV_PRIME
from .parser import (
    EXAMPLE_IMPORTANCE_OFFSET,
    HEADER_LEN,
    IS_NOT_SINGLE_MASK,
    LABEL_OFFSET,
)


@dataclass
class TranslatedExample:
    label: float
    importance: float
    lr_hashes: list
    lr_values: list
    lr_combos: list
    ffm_hashes: list
    ffm_values: list
    ffm_fields: list


def read_namespace_features(
    record: np.ndarray,
    desc: NamespaceDescriptor,
    transform_executors=None,
):
    """Yield (hash, value) for a namespace in a packed record — the
    ``feature_reader!`` macro (reference: src/feature_buffer.rs:47-108)."""
    if desc.namespace_type == NamespaceType.TRANSFORMED:
        if transform_executors is None:
            raise ValueError("record references a transformed namespace but no executors given")
        yield from transform_executors.execute(desc.namespace_index, record)
        return
    first_token = int(record[HEADER_LEN + desc.namespace_index])
    if (first_token & IS_NOT_SINGLE_MASK) == 0:
        yield first_token, 1.0
        return
    start = (first_token >> 16) & 0x3FFF
    end = first_token & 0xFFFF
    if desc.namespace_format != NamespaceFormat.F32:
        for off in range(start, end, 2):
            yield int(record[off]), float(np.uint32(record[off + 1]).view(np.float32))
    else:
        for off in range(start, end, 2):
            yield int(record[off]), 1.0


class FeatureTranslator:
    def __init__(self, mi: ModelInstance):
        self.mi = mi
        self.lr_hash_mask = mi.lr_hash_mask
        self.ffm_hash_mask = mi.ffm_hash_mask
        if mi.transform_namespaces is not None:
            from .transforms import TransformExecutors

            self.transform_executors = TransformExecutors(mi.transform_namespaces)
        else:
            self.transform_executors = None

    def translate(self, record: np.ndarray) -> TranslatedExample:
        label = float(record[LABEL_OFFSET])
        importance = float(np.uint32(record[EXAMPLE_IMPORTANCE_OFFSET]).view(np.float32))
        te = TranslatedExample(label, importance, [], [], [], [], [], [])

        mi = self.mi
        for combo_index, combo in enumerate(mi.feature_combo_descs):
            descs = combo.namespace_descriptors
            current = list(
                read_namespace_features(record, descs[0], self.transform_executors)
            )
            for desc in descs[1:]:
                nxt = []
                for h_acc, v_acc in current:
                    half = (h_acc * VOWPAL_FNV_PRIME) & MASK32
                    for h, v in read_namespace_features(
                        record, desc, self.transform_executors
                    ):
                        nxt.append((h ^ half, v_acc * v))
                current = nxt
            for h, v in current:
                te.lr_hashes.append(h & self.lr_hash_mask)
                te.lr_values.append(v * combo.weight)
                te.lr_combos.append(combo_index)

        if mi.add_constant_feature:
            te.lr_hashes.append(CONSTANT_HASH & self.lr_hash_mask)
            te.lr_values.append(1.0)
            te.lr_combos.append(len(mi.feature_combo_descs))

        if mi.ffm_k > 0:
            for field_index, ffm_field in enumerate(mi.ffm_fields):
                for desc in ffm_field:
                    for h, v in read_namespace_features(
                        record, desc, self.transform_executors
                    ):
                        te.ffm_hashes.append(h & self.ffm_hash_mask)
                        te.ffm_values.append(v)
                        te.ffm_fields.append(field_index)
        return te


def _bucket(n: int, minimum: int) -> int:
    """Round up to the next power of two (static shapes with few recompiles)."""
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b


@dataclass
class Batch:
    """Fixed-shape device batch. All arrays are dense and padded."""

    label: np.ndarray  # [B] f32
    importance: np.ndarray  # [B] f32
    lr_ids: np.ndarray  # [B, L] i32
    lr_vals: np.ndarray  # [B, L] f32
    lr_combos: np.ndarray  # [B, L] i32
    ffm_ids: np.ndarray  # [B, N] i32
    ffm_vals: np.ndarray  # [B, N] f32
    ffm_fields: np.ndarray  # [B, N] i32
    num_examples: int = 0  # actual (non-padding) examples

    def shape_key(self):
        return (self.label.shape[0], self.lr_ids.shape[1], self.ffm_ids.shape[1])


class Batcher:
    """Packs translated examples into padded batches.

    ``lr_width_min`` / ``ffm_width_min`` set the smallest padded width;
    per-batch widths are bucketed to powers of two so the jitted train step
    compiles for only a handful of shapes.
    """

    def __init__(self, batch_size: int, lr_width_min: int = 8, ffm_width_min: int = 8):
        self.batch_size = batch_size
        self.lr_width_min = lr_width_min
        self.ffm_width_min = ffm_width_min

    def make_batch(self, examples: list[TranslatedExample], pad_to_batch: bool = True) -> Batch:
        n = len(examples)
        bsz = self.batch_size if pad_to_batch else n
        lmax = _bucket(max((len(e.lr_hashes) for e in examples), default=0), self.lr_width_min)
        has_ffm = any(e.ffm_hashes for e in examples)
        nmax = (
            _bucket(max((len(e.ffm_hashes) for e in examples), default=0), self.ffm_width_min)
            if has_ffm
            else 0
        )

        label = np.zeros(bsz, np.float32)
        importance = np.zeros(bsz, np.float32)  # 0 importance => padding has no grad
        lr_ids = np.zeros((bsz, lmax), np.int32)
        lr_vals = np.zeros((bsz, lmax), np.float32)
        lr_combos = np.zeros((bsz, lmax), np.int32)
        ffm_ids = np.zeros((bsz, nmax), np.int32)
        ffm_vals = np.zeros((bsz, nmax), np.float32)
        ffm_fields = np.zeros((bsz, nmax), np.int32)

        for i, e in enumerate(examples):
            label[i] = e.label
            importance[i] = e.importance
            k = len(e.lr_hashes)
            lr_ids[i, :k] = e.lr_hashes
            lr_vals[i, :k] = e.lr_values
            lr_combos[i, :k] = e.lr_combos
            k = len(e.ffm_hashes)
            if k:
                ffm_ids[i, :k] = e.ffm_hashes
                ffm_vals[i, :k] = e.ffm_values
                ffm_fields[i, :k] = e.ffm_fields

        return Batch(
            label=label,
            importance=importance,
            lr_ids=lr_ids,
            lr_vals=lr_vals,
            lr_combos=lr_combos,
            ffm_ids=ffm_ids,
            ffm_vals=ffm_vals,
            ffm_fields=ffm_fields,
            num_examples=n,
        )
