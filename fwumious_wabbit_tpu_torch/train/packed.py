"""Superbatch packing: K train batches → ONE contiguous u32 buffer → ONE
host→device copy → K train steps on the card → ONE prediction fetch.

The port's own copy of fwumious_wabbit_tpu/train/packed.py. The host half
(:class:`PackedLayout`, :func:`layout_of`, the slimming and encoders,
:func:`prepare_for_transfer`, :func:`try_fused_emit`, :func:`pack`) is the
same code and writes the same bytes (tests/test_torch_packed.py). The
device half is PyTorch: :func:`unpack_row` restores the batch dicts of all
K rows at once, vectorised over the columns, with index tensors built once
per layout (:class:`_Plan`); :func:`make_packed_train_step` runs the K train
steps one after the other (the JAX version's ``lax.scan``), so the
trajectory is that of K separate steps, and on the card replays them as one
CUDA graph per (layout, K) (the JAX version's jit). On the card the packed buffer
arrives through the pinned transfer stage (train/producer.py
``Transferrer``): one copy per superbatch instead of one per array per
batch.

The reference has no analogue (its device is the CPU it runs on); this is
plumbing for the reference's single-stream train loop (reference:
src/main.rs:213-270).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.spans import span
from .step import (  # noqa: F401 (GraphError: raised through here)
    CudaGraphCapturer,
    GraphError,
    _GraphedStep,
    train_step_fn,
)

# numpy dtype of a packed field → the torch dtype unpack_row views it as.
# u32 fields are held as their int32 bit pattern: torch's unsigned 32-bit
# type has few CUDA kernels, and every shift of the unpack widens to int64
_DTYPES = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.int32,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int16): torch.int16,
}



@dataclass(frozen=True)
class _Field:
    key: str
    dtype: str  # numpy dtype str
    shape: tuple
    word_off: int
    word_len: int


@dataclass(frozen=True)
class PackedLayout:
    """Static byte layout of one packed batch (a row of the superbatch).

    ``appends``: constant columns elided from the transfer, re-synthesized
    on device by :func:`unpack_row` — tuple of (key, scalar). The constant
    feature is the canonical case: on a fixed-width schema its id (and its
    multiplicity code) are identical in every example of a full batch, so
    shipping the column is 5 B/example of pure redundancy (~8% of the
    Eat-Rate payload).

    ``bitpacks``: id columns shipped bit-packed — tuple of (key, bits, W):
    the batch dict carries ``[B, ceil(W·bits/32)]`` u32 words and
    :func:`unpack_row` restores ``[B, W]`` i32 with shifts and masks
    vectorised over the columns. Hash ids only occupy
    ``bit_precision`` (+ packed-combo) bits — 27 on the b=25 benchmark
    schema — so shipping i32 wastes ~16% of the dominant column.

    ``row_broadcasts``: columns whose every example row is identical
    (fixed-width schemas: the FFM field indices and — when not packed into
    the ids — the combo indices are the same in each example), elided from
    the transfer and re-broadcast device-side — tuple of
    (key, dtype_str, row_values, B).

    ``vocabs``: id columns shipped as per-column dictionary indices —
    tuple of (key, widths, bases, n_rows): column j ships ``widths[j]``
    bits (mixed-width row-major bit-pack); on device, a column with
    ``bases[j] >= 0`` resolves ``id = vocab_flat[bases[j] + index]``
    against the device-resident [n_rows, 128] i32 vocabulary snapshot
    (one indexed load), while ``bases[j] == -1`` columns carry raw ids
    (high-cardinality
    columns, e.g. LR interaction combos, degrade to direct). See
    :func:`encode_vocab_ids`.

    ``count_tabs``: multiplicity-count columns shipped as a u8 SHADOW of
    the vocab regions — tuple of (counts_key, ids_key): within a batch a
    given id has one global multiplicity, so for dictionary columns the
    per-entry code column is redundant with a per-(column, index) table
    (``counts_key + '_tab'``, one u8 per vocab slot ≈ 5 B/example vs 12
    on the Eat-Rate schema); direct columns keep per-entry codes in a
    narrowed ``counts_key`` array. See :func:`table_counts`.

    ``bit_cols``: binary per-example columns (the 0/1 label) shipped as
    ONE bit per example across the batch — tuple of (key, n): the batch
    dict carries ``[n/32]`` u32 words and :func:`unpack_row` restores
    ``[n]`` u8 with a broadcast shift/mask (1 vs 8 bits per example).
    See :func:`bitpack_labels`."""

    fields: tuple  # tuple[_Field]
    words: int
    appends: tuple = ()
    bitpacks: tuple = ()
    row_broadcasts: tuple = ()
    vocabs: tuple = ()
    count_tabs: tuple = ()
    bit_cols: tuple = ()

    @property
    def signature(self):
        return (tuple((f.key, f.dtype, f.shape) for f in self.fields),
                self.appends, self.bitpacks, self.row_broadcasts,
                self.vocabs, self.count_tabs, self.bit_cols)


def layout_of(bd: dict, appends: tuple = (), bitpacks: tuple = (),
              row_broadcasts: tuple = (), vocabs: tuple = (),
              count_tabs: tuple = (), bit_cols: tuple = ()) -> PackedLayout | None:
    """Build the layout for a batch dict, or None if it cannot pack
    (unknown dtype or a byte count not divisible by 4)."""
    fields = []
    off = 0
    for key in sorted(bd):
        a = bd[key]
        if not isinstance(a, np.ndarray) or a.dtype not in _DTYPES:
            return None
        nbytes = int(a.nbytes)
        if nbytes % 4:
            return None
        wl = nbytes // 4
        fields.append(_Field(key, a.dtype.str, tuple(a.shape), off, wl))
        off += wl
    return PackedLayout(tuple(fields), off, tuple(appends), tuple(bitpacks),
                        tuple(row_broadcasts), tuple(vocabs),
                        tuple(count_tabs), tuple(bit_cols))


CONSTANT_HASH = 11650396  # the VW constant feature (ingest/translator.py)


def strip_constant_columns(bd: dict, lr_hash_mask: int):
    """If the LAST lr column is the constant feature with a uniform packed
    id (and uniform count code), drop it from the transfer payload and
    return the append spec for :func:`unpack_row` to re-synthesize it.

    Fixed-width schemas (every example has the same feature count — e.g.
    the whole Eat-Rate benchmark family) qualify on every full batch; a
    variable-width schema fails the uniformity check and ships unchanged.
    Returns (bd, appends) — bd unchanged when not strippable."""
    ids = bd.get("lr_ids")
    if ids is None or ids.ndim != 2 or ids.shape[1] < 2:
        return bd, ()
    last = ids[:, -1]
    v = int(last[0])
    if (v & lr_hash_mask) != (CONSTANT_HASH & lr_hash_mask):
        return bd, ()
    if not (last == v).all():
        return bd, ()
    appends = [("lr_ids", v)]
    out = dict(bd)
    out["lr_ids"] = ids[:, :-1]
    counts = bd.get("lr_counts")
    if counts is not None:
        c = int(counts[0, -1])
        if not (counts[:, -1] == c).all():
            return bd, ()  # mixed multiplicities: ship unchanged
        # contiguous: pack()'s flat memcpy of a strided view is slower
        # per byte
        out["lr_counts"] = np.ascontiguousarray(counts[:, :-1])
        appends.append(("lr_counts", c))
    return out, tuple(appends)


def bitpack_ids(bd: dict, key: str, bits: int):
    """Bit-pack the non-negative id column ``bd[key]`` ([B, W] i32) into
    ``[B, ceil(W·bits/32)]`` u32 words. Returns (bd, bitpacks) — unchanged
    when packing would not shrink the column, ``bits`` exceeds 31, or any
    id overflows ``bits`` (checked; overflow ships unpacked instead of
    corrupting). Padding entries are 0 and round-trip as 0."""
    a = bd.get(key)
    if a is None or a.ndim != 2 or a.dtype != np.int32 or bits > 31:
        return bd, ()
    W = a.shape[1]
    words = (W * bits + 31) // 32
    if words >= W or W == 0 or a.size == 0:
        return bd, ()
    from .. import native as fw_native

    out = fw_native.bitpack_ids(a, bits, words)  # C row-major bit-writer
    if out is False:  # a value overflows `bits`: ship the column unpacked
        return bd, ()
    if out is None:  # no native lib: numpy fallback (strided, slow)
        if int(a.max()) >= (1 << bits) or int(a.min()) < 0:
            return bd, ()
        v = a.view(np.uint32)  # same buffer — values proven non-negative
        out = np.zeros((a.shape[0], words), np.uint32)
        for j in range(W):
            o = j * bits
            w0, s = o // 32, o % 32
            out[:, w0] |= v[:, j] << np.uint32(s)  # u32 shift truncates
            if s + bits > 32:
                out[:, w0 + 1] |= v[:, j] >> np.uint32(32 - s)
    nb = dict(bd)
    nb[key] = out
    return nb, ((key, bits, W),)


def bitpack_labels(bd: dict, key: str = "label"):
    """Ship a 0/1 u8 column as one bit per example (8× smaller): the label
    is 1 B/example of the Eat-Rate payload whose information content is one
    bit. Guards: u8 dtype, values ≤ 1 (the 255 NO_LABEL sentinel only occurs
    on predict paths, which never pack), and a 32-divisible batch so the
    words view is exact. Device inverse in :func:`unpack_row` is a single
    broadcast shift/mask (reference label layout: src/parser.rs packed
    records carry the label word; ours is already a u8 column)."""
    lab = bd.get(key)
    if (lab is None or not isinstance(lab, np.ndarray)
            or lab.dtype != np.uint8 or lab.ndim != 1
            or lab.size % 32 != 0 or (lab > 1).any()):
        return bd, ()
    words = np.packbits(lab, bitorder="little").view(np.uint32)
    out = dict(bd)
    out[key] = words
    return out, ((key, int(lab.size)),)


def strip_uniform_rows(bd: dict, key: str):
    """If every example row of ``bd[key]`` is identical (fixed-width
    schemas: FFM field indices, unpacked combo indices), drop the column
    from the transfer and return the row-broadcast spec for
    :func:`unpack_row` to re-synthesize it."""
    a = bd.get(key)
    if a is None or not isinstance(a, np.ndarray) or a.ndim != 2 \
            or a.shape[0] == 0 or a.shape[1] == 0:
        return bd, ()
    if not (a == a[0]).all():
        return bd, ()
    nb = dict(bd)
    del nb[key]
    return nb, ((key, a.dtype.str, tuple(int(x) for x in a[0]),
                 int(a.shape[0])),)


def unpack_uniform_combos(slim: dict, appends: tuple, mi):
    """When the host packed ``combo+1`` into the id bits above
    ``bit_precision`` (train/loop.py slim()) and every example's combo row
    is identical — true for any fixed-width schema — move the combos out of
    the ids into a zero-byte row-broadcast so the ids bit-pack at
    ``bit_precision`` instead of ``bit_precision + combo`` bits (13×25 vs
    13×29 bits on the b=25 Eat-Rate schema: 44 vs 48 B/example). Only
    engages when it saves whole u32
    words. Returns (slim, appends, row_broadcasts)."""
    shift_bits = (mi.num_combos + 1).bit_length()
    if mi.bit_precision + shift_bits > 31 or "lr_combos" in slim:
        return slim, appends, ()  # ids are not combo-packed
    ids = slim.get("lr_ids")
    if ids is None or ids.ndim != 2 or ids.shape[1] == 0 \
            or ids.dtype != np.int32 or ids.shape[0] == 0:
        return slim, appends, ()
    W = ids.shape[1]
    packed_bits = mi.bit_precision + shift_bits
    if (W * mi.bit_precision + 31) // 32 >= (W * packed_bits + 31) // 32:
        return slim, appends, ()  # no whole-word saving at this width
    high = ids >> np.int32(mi.bit_precision)  # combo+1 (0 at padding)
    row0 = high[0]
    if not (high == row0).all():
        return slim, appends, ()  # variable combo layout: keep packed
    combo_row = row0.astype(np.int32) - 1  # padding → −1 (zero one-hot)
    new_appends = []
    for key, v in appends:
        if key == "lr_ids":
            # the elided constant column's combo joins the broadcast row;
            # its re-appended id sheds the combo bits like the rest
            combo_row = np.append(combo_row,
                                  np.int32((v >> mi.bit_precision) - 1))
            v = int(v & mi.lr_hash_mask)
        new_appends.append((key, v))
    out = dict(slim)
    out["lr_ids"] = ids & np.int32(mi.lr_hash_mask)
    rb = (("lr_combos", np.dtype(np.int32).str,
           tuple(int(x) for x in combo_row), int(ids.shape[0])),)
    return out, tuple(new_appends), rb


class VocabTransferState:
    """Owns the persistent native VocabEncoder across a training stream
    (one per producer). Recreates the encoder with fresh dictionaries if
    the schema's high-water column count outgrows it (index assignments
    restart; the next group ships a new signature + full snapshot)."""

    def __init__(self, max_cap: int = 1 << 14):
        # 2^14 keeps every realistic categorical-namespace dictionary
        # (measured Eat-Rate: 2k/10k uniques) while making unbounded
        # columns (the AB interaction: 32k+ uniques in the FIRST batch)
        # overflow to direct DURING batch 0 — one stable layout signature
        # for the whole run instead of a mid-run re-signature
        self.venc = None
        self.max_cap = max_cap
        self._grow_to = 0  # deferred-recreation width (see encoder_for)
        # latched once encoding can never pay off (dictionary widths only
        # grow, so a no-saving verdict is permanent) — stops the per-batch
        # native sweep on schemas where vocab encoding never engages
        self.disabled = False

    def encoder_for(self, n_cols: int):
        if self.venc is not None and self.venc.n_cols < n_cols:
            # DEFER recreation (r4 review): a pending packed group may
            # still need the OLD dictionaries for its snapshot export —
            # recreating here would flush that group against re-minted,
            # differently-ordered entries (silent wrong-id resolution).
            # Returning None ships THIS batch plain; its signature
            # mismatch flushes the pending group (old snapshot exported
            # by the producer, synchronously) and the next call recreates
            # safely.
            if self._grow_to:
                # the flush already happened while processing the plain
                # batch above; recreate now at the grown width
                self.venc.close()
                self.venc = None
            else:
                self._grow_to = n_cols
                return None
        if self.venc is None:
            from .. import native as fw_native

            self.venc = fw_native.VocabEncoder(
                max(n_cols, self._grow_to, 16), self.max_cap)
            self._grow_to = 0
        return self.venc

    def close(self):
        if self.venc is not None:
            self.venc.close()
            self.venc = None


def _vocab_width(size: int) -> int:
    """Wire bits for a dictionary of ``size`` entries — exact width
    rounded up to EVEN, so a growing dictionary only re-signatures (a new
    layout) every 4× growth."""
    w = max(4, int(size - 1).bit_length() if size > 1 else 1)
    return w + (w & 1)


def encode_vocab_ids(slim: dict, appends: tuple, mi,
                     state: VocabTransferState):
    """Dictionary-encode ``slim['lr_ids']`` for the transfer.

    One fused native sweep (fwn_vocab_encode2) extracts/verifies the
    batch-uniform combo row from combo-packed ids, masks them, and maps
    each column to dense dictionary indices; each column then ships
    ``_vocab_width(dict_size)`` bits instead of ``bit_precision``
    (measured Eat-Rate schema: 2 columns at 12 bits + 10 at 14 + the
    unbounded AB interaction column direct at 25 → 38 vs 62 B/example);
    the device resolves indices against
    the vocabulary snapshot (see :class:`PackedLayout` and
    :func:`export_vocab`). Only engages when it saves whole u32 words
    over the plain uniform bit-pack. Returns
    (slim, appends, row_broadcasts, vocabs_spec, idx_sizes) — idx_sizes
    is (idx, sizes): the raw [B, W] i32 index matrix (dictionary indices
    for vocab columns, masked ids for direct ones) and the exact
    per-column dictionary sizes (-1 direct), reused by
    :func:`table_counts`; all unchanged/empty (idx_sizes None) when the
    encoding does not apply (variable combo layout, no native lib, no
    saving)."""
    ids = slim.get("lr_ids")
    if state.disabled or ids is None or ids.ndim != 2 \
            or ids.shape[1] == 0 or ids.dtype != np.int32 \
            or ids.shape[0] == 0:
        return slim, appends, (), (), None
    shift_bits = (mi.num_combos + 1).bit_length()
    combos_packed = ("lr_combos" not in slim
                     and mi.bit_precision + shift_bits <= 31)
    W = ids.shape[1]
    venc = state.encoder_for(W)
    if venc is None:  # deferred encoder recreation: ship plain this batch
        return slim, appends, (), (), None
    res = venc.encode2(ids, mi.bit_precision if combos_packed else 0,
                       mi.lr_hash_mask)
    if res is None:
        return slim, appends, (), (), None  # variable combos: plain path
        # (no latch: encode2 bails at the first mismatching row, and a
        # later batch may well be row-uniform again)
    idx, sizes, combo_row = res
    widths = tuple(
        mi.bit_precision if sizes[j] < 0 else _vocab_width(int(sizes[j]))
        for j in range(W))
    words = (sum(widths) + 31) // 32
    # the real alternative is the combo-broadcast plain pack at
    # bit_precision (combos are row-uniform here, or ship separately) —
    # NOT the wider combo-packed encoding
    if words >= (W * mi.bit_precision + 31) // 32:
        state.disabled = True  # widths only grow: permanent verdict
        return slim, appends, (), (), None
    from .. import native as fw_native

    packed = fw_native.bitpack_mixed(idx, np.array(widths, np.int32), words)
    if packed is None or packed is False:
        state.disabled = packed is None  # no native lib: permanent
        return slim, appends, (), (), None
    bases = []
    off = 0
    for j in range(W):
        if sizes[j] < 0:
            bases.append(-1)
        else:
            bases.append(off)
            off += 1 << widths[j]
    n_rows = (off + 127) // 128
    out = dict(slim)
    out["lr_ids"] = packed
    row_broadcasts = ()
    if combos_packed:
        crow = combo_row.astype(np.int32)
        new_appends = []
        for key, v in appends:
            if key == "lr_ids":
                # the elided constant column's combo joins the broadcast
                # row; its re-appended id sheds the combo bits
                crow = np.append(crow,
                                 np.int32((v >> mi.bit_precision) - 1))
                v = int(v & mi.lr_hash_mask)
            new_appends.append((key, v))
        appends = tuple(new_appends)
        row_broadcasts = (("lr_combos", np.dtype(np.int32).str,
                           tuple(int(x) for x in crow),
                           int(ids.shape[0])),)
    return out, appends, row_broadcasts, (
        ("lr_ids", widths, tuple(bases), n_rows),), (idx, tuple(
            int(s) for s in sizes[:W]))


def export_vocab(venc, spec) -> np.ndarray:
    """Assemble the [n_rows, 128] i32 device vocabulary snapshot for a
    layout's vocab spec (column dictionaries at their region bases)."""
    _key, widths, bases, n_rows = spec
    flat = np.zeros(n_rows * 128, np.int32)
    for j, (w, b) in enumerate(zip(widths, bases)):
        if b < 0:
            continue
        col = venc.export_col(j, 1 << w)
        flat[b:b + len(col)] = col
    return flat.reshape(n_rows, 128)


_TAB_GRAIN = 2048  # tab region rounding: trades re-signature cadence
# against shipped padding. Lifetime bound: a column re-signatures at most
# max_cap/2048 = 8 times before it either saturates or overflows to
# direct (fixed-cardinality schemas saturate in batch 1; steadily-growing
# ones pay <= 8 extra layouts per column)


def table_counts(slim: dict, vocabs: tuple, idx_sizes, row_broadcasts: tuple):
    """Re-encode ``lr_counts`` as a u8 shadow table of the dictionaries.

    Within one batch an id has ONE global multiplicity (the radix counts
    are keyed by the id alone), so for dictionary columns the per-entry
    code is a function of (column, index): ship it once per dictionary
    slot (``lr_counts_tab``) instead of once per example. The tab packs
    columns at their EXACT dictionary sizes rounded to ``_TAB_GRAIN``
    (its own base offsets, carried in the count_tabs spec) — NOT the
    power-of-2 vocab snapshot regions, which ship only on growth and can
    afford the padding; the tab ships EVERY batch (measured Eat-Rate
    schema: 104k real entries vs 172k power-of-2 slots → 3.25 vs 5.25
    B/example). Direct columns keep per-entry codes in a narrowed
    ``lr_counts``.

    Requires exact conditions (checked here; ship per-entry otherwise):
    the value column was elided as all-ones (a zero-valued entry's code
    is 0 regardless of its id, breaking the id→code function) and the
    batch has no padding entries (their code is 0 the same way) — i.e.
    the combo broadcast row is all non-negative."""
    counts = slim.get("lr_counts")
    if idx_sizes is None or not vocabs or counts is None \
            or "lr_vals" in slim or counts.ndim != 2:
        return slim, ()
    idx, sizes = idx_sizes
    if counts.shape != idx.shape or counts.dtype != np.uint8:
        return slim, ()
    for key, _dt, row_vals, _b in row_broadcasts:
        if key == "lr_combos" and any(v < 0 for v in row_vals):
            return slim, ()  # padded batch: codes are 0 at padding
    if "lr_combos" in slim:
        return slim, ()  # combo column shipped raw: padding unknown
    if (counts == counts[0]).all():
        return slim, ()  # row-uniform: broadcast elision is free, a tab
        # would ship the region bytes for nothing (strip_uniform_rows)
    _key, widths, bases, _n_rows = vocabs[0]
    B, W = counts.shape
    tab_bases = []
    off = 0
    for j, b in enumerate(bases):
        if b < 0:
            tab_bases.append(-1)
        else:
            tab_bases.append(off)
            # exact size rounded to the grain, but never beyond the
            # power-of-2 snapshot region (small vocabs stay tiny)
            off += min(1 << widths[j],
                       -(-max(int(sizes[j]), 1) // _TAB_GRAIN) * _TAB_GRAIN)
    off = -(-off // 128) * 128  # [.., 128] device reshape
    n_direct = sum(1 for b in bases if b < 0)
    if off + B * n_direct >= B * W:
        return slim, ()  # tab + direct columns outweigh per-entry codes
        # (large vocab relative to the batch)
    from .. import native as fw_native

    tab = fw_native.counts_table(idx, counts, tab_bases, off)
    if tab is None:
        return slim, ()
    direct = [j for j, b in enumerate(bases) if b < 0]
    out = dict(slim)
    out["lr_counts"] = np.ascontiguousarray(counts[:, direct])
    out["lr_counts_tab"] = tab
    return out, (("lr_counts", "lr_ids", tuple(tab_bases)),)


def prepare_for_transfer(bd: dict, mi, bitpack: bool = True,
                         vocab_state: VocabTransferState | None = None):
    """Production transfer slimming for one full batch: constant-feature
    column elision, combo un-packing to a row broadcast, vocabulary
    index encoding + shadow-table counts (when ``vocab_state`` is
    given), lr/ffm id bit-packing, uniform-row elision (field
    indices, combo indices, multiplicity counts), and 1-bit label
    packing. Returns (slim, appends, bitpacks, row_broadcasts, vocabs,
    count_tabs, bit_cols) — the layout_of inputs. Used by the train loop's producer and by bench.py's
    transfer probes so measurements ship the production payload."""
    slim, appends = strip_constant_columns(bd, mi.lr_hash_mask)
    bitpacks = ()
    row_broadcasts = ()
    vocabs = ()
    count_tabs = ()
    if bitpack:
        if vocab_state is not None:
            slim, appends, rb0, vocabs, idx_sizes = encode_vocab_ids(
                slim, appends, mi, vocab_state)
            row_broadcasts += rb0
            if vocabs:
                slim, count_tabs = table_counts(slim, vocabs, idx_sizes,
                                                row_broadcasts)
        if not vocabs:
            slim, appends, rb0 = unpack_uniform_combos(slim, appends, mi)
            row_broadcasts += rb0
            shift_bits = (mi.num_combos + 1).bit_length()
            combos_out = "lr_combos" in slim or any(
                r[0] == "lr_combos" for r in row_broadcasts)
            if not combos_out and mi.bit_precision + shift_bits <= 31:
                id_bits = mi.bit_precision + shift_bits
            else:
                id_bits = mi.bit_precision
            slim, bitpacks = bitpack_ids(slim, "lr_ids", id_bits)
        if getattr(mi, "ffm_k", 0) > 0 and "ffm_ids" in slim:
            # ffm ids are the raw hash masked to 2^ffm_bit_precision
            # (native/fw_core.h translate_record; padding entries are 0)
            slim, bp2 = bitpack_ids(slim, "ffm_ids", mi.ffm_bit_precision)
            bitpacks = bitpacks + bp2
    for key in ("ffm_fields", "lr_combos", "lr_counts", "ffm_counts"):
        if count_tabs and key == "lr_counts":
            continue  # narrowed direct-column array: unpack needs it
        slim, rb = strip_uniform_rows(slim, key)
        row_broadcasts = row_broadcasts + rb
    bit_cols = ()
    if bitpack:
        slim, bit_cols = bitpack_labels(slim)
    return (slim, appends, bitpacks, row_broadcasts, vocabs, count_tabs,
            bit_cols)


class PreparedBatch:
    """A full batch already in wire form (the fused C emit path): ``slim``
    is the transfer dict and ``lay`` its :class:`PackedLayout` — the
    producer appends it to the current group directly, skipping
    :func:`prepare_for_transfer`."""

    __slots__ = ("slim", "lay")

    def __init__(self, slim: dict, lay: PackedLayout):
        self.slim = slim
        self.lay = lay


def try_fused_emit(ni, start: int, B: int, W_all: int, mi,
                   state: VocabTransferState, with_counts: bool,
                   ffm_pad_width: int = 0, ffm_count_shift=None):
    """Steady-state fused emit of one FULL batch: translated SoA →
    final wire arrays in one native sweep (fwn_emit_fused), byte-identical
    to the prepare_for_transfer chain (asserted in tests/test_fused_emit).

    The layout (per-column wire widths, vocab snapshot regions, count-tab
    bases) is derived here from the PRE-batch dictionary state; the native
    sweep bails on anything that could change it (a mint, an overflow, a
    variable-width example, a non-uniform combo row, labels outside {0,1},
    row-uniform counts), in which case this returns None and the caller
    falls back to the general path — which re-encodes idempotently.

    Caller contract (checked by the producer's hook, not here): full
    batch, LR-only schema, lr values and importances proven all-ones,
    count key = raw id (shift 0). Returns (slim, layout) or None."""
    if state is None or state.disabled:
        return None
    shift_bits = (mi.num_combos + 1).bit_length()
    if mi.bit_precision + shift_bits > 31 or B % 32 or B <= 0:
        return None
    W = W_all - 1
    if W < 1:
        return None
    # read-only peek at the encoder: encoder_for() owns the deferred
    # grow/recreate protocol and must be called exactly ONCE per batch
    # (by the general path) — a second call in the same batch would
    # recreate the dictionaries while a pending group still needs the old
    # ones for its snapshot export. A missing or too-narrow encoder means
    # this batch belongs to the general path anyway.
    venc = state.venc
    if venc is None or venc.n_cols < W or state._grow_to:
        return None
    widths = np.empty(W, np.int32)
    bases = []
    sizes = []
    n_direct = 0
    off = 0
    for j in range(W):
        if venc.col_direct(j):
            widths[j] = mi.bit_precision
            bases.append(-1)
            sizes.append(-1)
            n_direct += 1
        else:
            s = venc.col_size(j)
            if s <= 0:
                return None  # unseen column: the first batch must mint
            widths[j] = _vocab_width(s)
            bases.append(off)
            off += 1 << int(widths[j])
            sizes.append(s)
    words = (int(widths.sum()) + 31) // 32
    if words >= (W * mi.bit_precision + 31) // 32:
        return None  # no whole-word saving: the general path latches off
    n_rows = (off + 127) // 128
    tab_bases = None
    tab_len = -1
    if with_counts:
        tab_bases = np.empty(W, np.int32)
        toff = 0
        for j in range(W):
            if bases[j] < 0:
                tab_bases[j] = -1
            else:
                tab_bases[j] = toff
                toff += min(1 << int(widths[j]),
                            -(-max(sizes[j], 1) // _TAB_GRAIN) * _TAB_GRAIN)
        toff = -(-toff // 128) * 128
        if toff + B * n_direct >= B * W:
            return None  # per-entry codes are smaller (table_counts)
        tab_len = toff
    # FFM columns: the wire shape is the stream's PADDED width; the ids
    # column ships bit-packed only when that saves a whole u32 word per
    # row (bitpack_ids' rule), else raw i32 — byte-identical either way
    n_ffm = int(ffm_pad_width)
    ffm_bits = fwords = 0
    ffm_packed = False
    out_ffm_ids = out_ffm_counts = ffm_field_row = None
    fshift = -1
    if n_ffm > 0:
        if getattr(mi, "ffm_k", 0) <= 0:
            return None
        fb = mi.ffm_bit_precision
        fwords = (n_ffm * fb + 31) // 32
        ffm_packed = fb <= 31 and fwords < n_ffm
        if ffm_packed:
            ffm_bits = fb
        else:
            fwords = n_ffm
        out_ffm_ids = np.empty(
            (B, fwords), np.uint32 if ffm_packed else np.int32)
        ffm_field_row = np.empty(n_ffm, np.int32)
        if ffm_count_shift is not None:
            fshift = int(ffm_count_shift)
            out_ffm_counts = np.empty((B, n_ffm), np.uint8)

    out_ids = np.empty((B, words), np.uint32)
    out_label = np.empty(B // 32, np.uint32)
    out_tab = np.empty(tab_len, np.uint8) if with_counts else None
    out_direct = np.empty((B, n_direct), np.uint8) if with_counts else None
    combo_row = np.empty(W_all, np.int32)
    const_code = np.zeros(1, np.int32)
    const_id = CONSTANT_HASH & mi.lr_hash_mask
    if not ni.emit_fused(venc, start, B, W_all, const_id, widths, tab_bases,
                         words, tab_len, n_direct, out_ids.reshape(-1),
                         out_tab,
                         None if out_direct is None
                         else out_direct.reshape(-1),
                         out_label, combo_row, const_code,
                         n_ffm_pad=n_ffm, ffm_bits=ffm_bits,
                         ffm_words=fwords, ffm_shift=fshift,
                         out_ffm_ids=None if out_ffm_ids is None
                         else out_ffm_ids.reshape(-1).view(np.uint32),
                         out_ffm_counts=None if out_ffm_counts is None
                         else out_ffm_counts.reshape(-1),
                         ffm_field_row=ffm_field_row):
        return None
    slim = {"label": out_label, "lr_ids": out_ids}
    bitpacks = ()
    if n_ffm > 0:
        slim["ffm_ids"] = out_ffm_ids
        if ffm_packed:
            bitpacks = (("ffm_ids", ffm_bits, n_ffm),)
        if out_ffm_counts is not None:
            slim["ffm_counts"] = out_ffm_counts
    else:
        # zero-byte FFM placeholders: fill_range always materializes them
        # for LR-only schemas and slim keeps them, so they are part of the
        # general path's layout signature — the fused layout must match it
        # exactly or fused and general batches would split superbatch
        # groups
        slim["ffm_fields"] = np.empty((B, 0), np.int8)
        slim["ffm_ids"] = np.empty((B, 0), np.int32)
        slim["ffm_vals"] = np.empty((B, 0), np.float32)
    appends = [("lr_ids", const_id)]
    if with_counts:
        slim["lr_counts"] = out_direct
        slim["lr_counts_tab"] = out_tab
        appends.append(("lr_counts", int(const_code[0])))
    row_broadcasts = (("lr_combos", np.dtype(np.int32).str,
                       tuple(int(x) for x in combo_row), B),)
    if n_ffm > 0:
        # same append order as prepare_for_transfer's strip_uniform_rows
        # loop: lr_combos (from the vocab encode) first, then ffm_fields
        row_broadcasts += (("ffm_fields", np.dtype(np.int8).str,
                            tuple(int(x) for x in ffm_field_row), B),)
    vocabs = (("lr_ids", tuple(int(x) for x in widths), tuple(bases),
               n_rows),)
    count_tabs = ((("lr_counts", "lr_ids",
                    tuple(int(x) for x in tab_bases)),)
                  if with_counts else ())
    lay = layout_of(slim, tuple(appends), bitpacks, row_broadcasts, vocabs,
                    count_tabs, (("label", B),))
    if lay is None:
        return None
    return PreparedBatch(slim, lay)


def pack(layout: PackedLayout, bds: list) -> np.ndarray:
    """K batch dicts → [K, words] u32 (one flat memcpy per array)."""
    buf = np.empty((len(bds), layout.words), np.uint32)
    for k, bd in enumerate(bds):
        row = buf[k]
        for f in layout.fields:
            row[f.word_off : f.word_off + f.word_len] = (
                bd[f.key].reshape(-1).view(np.uint32)
            )
    return buf


# -- the device half ------------------------------------------------------------


def _bit_fields(offsets, widths, n_words: int, device):
    """Index tensors that extract ``widths[j]``-bit fields starting at bit
    ``offsets[j]`` of a row of u32 words: the field's first word, the next
    one (itself for the last word; a field that does not cross into it
    masks its bits away), the shift and the mask, all int64 ``[W]``."""
    o = np.asarray(offsets, np.int64)
    w0 = o // 32
    w1 = np.minimum(w0 + 1, max(n_words - 1, 0))
    mask = (np.int64(1) << np.asarray(widths, np.int64)) - 1
    return tuple(torch.from_numpy(a).to(device) for a in (w0, w1, o % 32, mask))


def _extract(words: torch.Tensor, fields) -> torch.Tensor:
    """``[..., n_words]`` int32 words (the bit pattern of u32) → ``[..., W]``
    int64 fields. Each field is read from the 64-bit pair (its word, the
    next) by one shift: the shift is logical because the words are widened
    to int64 and masked to 32 bits first, and a field that crosses a word
    edge (``s + bits > 32``) takes its high bits from the second word."""
    w0, w1, s, mask = fields
    a = words.long() & 0xFFFFFFFF
    return ((a[..., w0] | (a[..., w1] << 32)) >> s) & mask


def _gather_last(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx[..., i, j]]`` per leading row: ``table [*lead, T]``,
    ``idx [*lead, B, W]`` → ``[*lead, B, W]``."""
    lead = table.shape[:-1]
    flat = idx.reshape(*lead, -1)
    return torch.gather(table, -1, flat).reshape(idx.shape)


class _Plan:
    """The index tensors :func:`unpack_row` needs for one layout on one
    device, built once: the bit fields of every ``bitpacks`` and ``vocabs``
    entry, the dictionary columns' bases, the count tables' slots and
    direct columns, the row broadcasts' rows."""

    def __init__(self, layout: PackedLayout, device):
        width = {f.key: f.shape[-1] if f.shape else 0 for f in layout.fields}
        self.bitpacks = {}
        for key, bits, W in layout.bitpacks:
            self.bitpacks[key] = _bit_fields([j * bits for j in range(W)],
                                             [bits] * W, width[key], device)
        self.vocabs = {}
        for key, widths, bases, _n_rows in layout.vocabs:
            offsets = np.cumsum([0, *widths[:-1]])
            is_dict = np.asarray(bases) >= 0
            self.vocabs[key] = (
                _bit_fields(offsets, widths, width[key], device),
                torch.from_numpy(is_dict).to(device),
                torch.from_numpy(np.maximum(bases, 0).astype(np.int64)).to(device),
                bool(is_dict.any()))
        self.count_tabs = []
        for spec in layout.count_tabs:
            ckey, idkey = spec[0], spec[1]
            vbases = [v[2] for v in layout.vocabs if v[0] == idkey][0]
            tab_bases = np.asarray(spec[2] if len(spec) > 2 else vbases)
            is_dict = tab_bases >= 0
            dcol = np.maximum(np.cumsum(~is_dict) - 1, 0)  # direct column j's index
            self.count_tabs.append((
                ckey, idkey, torch.from_numpy(is_dict).to(device),
                torch.from_numpy(np.maximum(tab_bases, 0).astype(np.int64)).to(device),
                torch.from_numpy(dcol.astype(np.int64)).to(device),
                int((~is_dict).sum())))
        self.shifts = torch.arange(32, dtype=torch.int64, device=device)
        self.rows = {
            key: torch.from_numpy(np.array(vals, np.dtype(dtstr))).to(
                _DTYPES[np.dtype(dtstr)]).to(device)
            for key, dtstr, vals, _B in layout.row_broadcasts}


def unpack_row(row: torch.Tensor, layout: PackedLayout,
               vocab: torch.Tensor | None = None,
               plan: _Plan | None = None) -> dict:
    """Inverse of :func:`pack` on the device: ``row`` is one packed row
    ``[words]`` or a whole superbatch ``[K, words]`` of int32 (the bit
    pattern of the u32 words); every array of the result gains the same
    leading dimensions. ``vocab`` is the ``[n_rows, 128]`` i32 dictionary
    snapshot, required when the layout carries a vocab spec.

    The values equal the JAX version's (fwumious_wabbit_tpu/train/packed.py
    ``unpack_row``): fields are views of the row; bit-packed and
    dictionary columns come out of :func:`_extract` for all columns at
    once; a dictionary column reads ``vocab.view(-1)[base + index]`` (the
    JAX version's row gather and lane select, a TPU workaround, is one
    indexed load here); count tables, 1-bit columns, row broadcasts
    (stride-0 views) and appended columns follow. A u32 field the layout
    does not decode stays int32. ``plan`` is the layout's :class:`_Plan`
    on ``row``'s device, built here when not given (the packed step keeps
    one)."""
    lead = tuple(row.shape[:-1])
    if plan is None:
        plan = _Plan(layout, row.device)
    bd = {}
    for f in layout.fields:
        seg = row[..., f.word_off:f.word_off + f.word_len]
        bd[f.key] = seg.view(_DTYPES[np.dtype(f.dtype)]).reshape(*lead, *f.shape)
    vocab_idx = {}
    for key, _widths, _bases, _n_rows in layout.vocabs:
        fields, is_dict, base, any_dict = plan.vocabs[key]
        v = _extract(bd[key], fields)
        vocab_idx[key] = v
        ids = v.to(torch.int32)
        if any_dict:
            looked = vocab.reshape(-1)[torch.where(is_dict, v + base, 0)]
            ids = torch.where(is_dict, looked, ids)
        bd[key] = ids
    for ckey, idkey, is_dict, base, dcol, n_direct in plan.count_tabs:
        tab = bd.pop(ckey + "_tab")
        codes = _gather_last(tab, torch.where(is_dict, vocab_idx[idkey] + base, 0))
        if n_direct:
            codes = torch.where(is_dict, codes, bd[ckey][..., dcol])
        bd[ckey] = codes
    for key, _bits, _W in layout.bitpacks:
        bd[key] = _extract(bd[key], plan.bitpacks[key]).to(torch.int32)
    for key, n in layout.bit_cols:
        bits = (bd[key].long()[..., :, None] >> plan.shifts) & 1
        bd[key] = bits.reshape(*lead, n).to(torch.uint8)
    for key, _dtstr, row_vals, B in layout.row_broadcasts:
        bd[key] = plan.rows[key].expand(*lead, B, len(row_vals))
    for key, value in layout.appends:
        a = bd[key]
        bd[key] = torch.cat([a, a.new_full((*a.shape[:-1], 1), value)], dim=-1)
    return bd


def _cached(model, key, build):
    cache = getattr(model, "_packed_steps", None)
    if cache is None:
        cache = model._packed_steps = {}
    if key not in cache:
        cache[key] = build()
    return cache[key]


def graph_counts(model) -> dict:
    """The model's packed superbatches so far: ``graph_captures`` (CUDA
    graphs captured, one per (layout, K) seen twice), ``graph_replays``
    (superbatches run as a replay, the capturing one included) and
    ``eager_superbatches`` (run step by step from Python: the first of each
    (layout, K), and every one on the CPU or with ``graph=False``); and the
    host seconds of each: ``capture_s`` (the captures alone), ``replay_s``
    (the input copies and replays) and ``eager_s``."""
    counts = getattr(model, "_graph_counts", None)
    if counts is None:
        counts = model._graph_counts = {
            "graph_captures": 0, "graph_replays": 0, "eager_superbatches": 0,
            "capture_s": 0.0, "replay_s": 0.0, "eager_s": 0.0}
    return counts


def release_counts(model) -> dict:
    """The model's packed-step graphs released so far (``graph_releases``:
    a capture beyond the graphs it keeps drops the least recently replayed
    one and returns its pool to the card) and the host seconds their
    releases took (``graph_release_s``)."""
    counts = getattr(model, "_release_counts", None)
    if counts is None:
        counts = model._release_counts = {"graph_releases": 0,
                                          "graph_release_s": 0.0}
    return counts


# the captured packed-step graphs a model keeps at once: a run's steady
# (layout, K) and the tail (K' < K) that recurs once per pass of a
# multi-pass run. A layout that a vocabulary re-signature replaced never
# comes back, and each graph holds its own memory pool, so the least
# recently replayed graph beyond these is released; should its (layout, K)
# come back, it is captured anew.
_LIVE_GRAPHS = 2


def _live_graphs(model) -> list:
    """The model's captured packed-step graphs, the least recently replayed
    first."""
    live = getattr(model, "_live_graphs", None)
    if live is None:
        live = model._live_graphs = []
    return live


class _PackedGraphedStep(_GraphedStep):
    """One (layout, K)'s packed step as train/step.py ``_GraphedStep`` (the
    JAX version's jitted ``lax.scan``), called as the step-by-step packed
    step is: its inputs are the ``[K, words]`` buffer and the vocabulary
    snapshot, its output the ``[K, B]`` predictions."""

    def __init__(self, model, layout: PackedLayout, K: int, eager, capturer):
        super().__init__(model, "the packed step", f"layout {layout.signature!r}, K={K}",
                         lambda inputs: eager(inputs["buf"], inputs.get("vocab")),
                         capturer, _live_graphs(model), release_counts(model),
                         _LIVE_GRAPHS, graph_counts(model), "eager_superbatches")

    def __call__(self, buf: torch.Tensor, vocab: torch.Tensor | None = None):
        inputs = {"buf": buf} if vocab is None else {"buf": buf, "vocab": vocab}
        return super().__call__(inputs)

    @property
    def buf(self):
        """The graph's own ``[K, words]`` input (None once released)."""
        return None if self.inputs is None else self.inputs["buf"]


def make_packed_train_step(model, layout: PackedLayout, K: int,
                           graph: bool = True, capturer=None):
    """``step(buf [K, words] int32[, vocab]) -> preds [K, B]``, cached by
    ``(layout.signature, K)`` as the JAX version caches its jit.

    Unpacks the superbatch once, then runs K train steps one after the
    other (train/step.py ``train_step_fn``, the step the per-batch path
    graphs on its own), each updating the model's tables in place; the result is
    the K steps' predictions. ``vocab`` is the [n_rows, 128] i32 snapshot,
    required when the layout carries a vocab spec.

    On the card the K steps run as one CUDA graph from the second
    superbatch of a (layout, K) on (:class:`_PackedGraphedStep`; the JAX
    version's jitted ``lax.scan``), and the result is the graph's output,
    overwritten by its next replay. On the CPU, and with ``graph=False``,
    they run step by step from Python. ``capturer`` stands in for
    :class:`CudaGraphCapturer` (tests)."""

    def build():
        step = train_step_fn(model)
        plan = _Plan(layout, model.lr_w.device)

        def packed_steps(buf: torch.Tensor, vocab: torch.Tensor | None = None):
            bd = unpack_row(buf, layout, vocab, plan)
            return torch.stack([step({k: v[i] for k, v in bd.items()})
                                for i in range(K)])

        if graph and (capturer is not None or model.lr_w.device.type == "cuda"):
            return _PackedGraphedStep(model, layout, K, packed_steps,
                                      capturer or CudaGraphCapturer())

        def eager_steps(buf: torch.Tensor, vocab: torch.Tensor | None = None):
            counts = graph_counts(model)
            counts["eager_superbatches"] += 1
            with span("fwt.graph.eager", counts, "eager_s"):
                return packed_steps(buf, vocab)

        return eager_steps

    return _cached(model, ("packed", layout.signature, K, graph, capturer),
                   build)


def make_packed_train_step_ring(model, layout: PackedLayout, K: int, M: int,
                                graph: bool = True):
    """``step(buf, ring [M, K, B], slot[, vocab]) -> ring``: the math of
    :func:`make_packed_train_step`, with the superbatch's predictions
    written into row ``slot`` of a device-resident ring that the caller
    fetches once per M superbatches (``--fwt_fetch_stack M``). The fetch,
    the copy into the ring and the later steps' writes are ordered by the
    stream they share; on the card the steps are the same graph."""

    def build():
        inner = make_packed_train_step(model, layout, K, graph)

        def packed_steps_ring(buf, ring, slot: int, vocab=None):
            ring[slot].copy_(inner(buf, vocab))
            return ring

        return packed_steps_ring

    return _cached(model, ("packed_ring", layout.signature, K, M, graph), build)
