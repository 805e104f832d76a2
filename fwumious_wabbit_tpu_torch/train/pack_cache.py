"""Packed-payload cache: record/replay of the superbatch producer stream.

The port's own copy of fwumious_wabbit_tpu/train/pack_cache.py: the same
file format, so a stream one package records the other replays
(tests/test_torch_producer.py).

The reference's ``-c`` cache stores parsed records — its most-digested
host-side form, so repeated passes skip text parsing (reference:
src/cache.rs:12-153). THIS engine's most-digested host form is the
producer's queue stream: packed superbatch buffers (train/packed.py),
vocabulary snapshots, and unpacked tail batches. On a training re-run over
the same input and config (multipass epochs — the reference delegates
multipass to exactly such re-reads — or a benchmark's repeated runs),
replaying that stream skips parse, translate, batch fill, multiplicity
counts, vocab encoding, and packing entirely: the host cost per example
drops to a file read, and the pipeline floor becomes
min(transfer, device step).

Trajectory identity is by construction — the replay enqueues the exact
bytes the first run enqueued.

File format (``<input>.fwpack``, little-endian):

  b"FWPK" | u32 version | u64 sig_len | sig (config-signature JSON)
  then tagged items, ending with the 8-byte trailer "eFWPKEND":
    'v' : array                     (vocab snapshot, i32 [rows, 128])
    'p' : u64 gn | json (layout) | array (u32 [K, words] superbatch)
    's' : u64 n | u32 nkeys | nkeys * (u16 klen | key | array)
    trailer (absent = truncated -> cache rejected before any replay)
  array := u8 dtype_len | dtype_str | u8 ndim | ndim*u64 dims | raw bytes

Written to ``.writing`` and atomically renamed on a clean end-of-stream —
an aborted run never publishes. The config signature covers everything
that shapes the stream (model instance, namespace map, batch size,
superbatch K, bitpack/vocab/count settings, holdout cut); a mismatch
silently falls back to the live producer, which re-records. With
``--fwt_pack_cache auto`` the cache engages only with ``-c``, which the
port does not run yet; ``--fwt_pack_cache on`` engages it.
"""
from __future__ import annotations

import json
import os
import struct
from pathlib import Path

import numpy as np

from ..utils.logging import get_logger
from .packed import PackedLayout, _Field

log = get_logger(__name__)

PACK_MAGIC = b"FWPK"
# Bump on any change to the production payload format so stale caches
# re-record with the current slimming (v2: 1-bit labels + size-packed
# count tabs — a v1 replay would silently ship the fatter stream)
PACK_VERSION = 2
# 8-byte trailer: a 1-byte marker would false-pass on ~1/256 of truncation
# points (array payload bytes are arbitrary); 'e' doubles as the item
# loop's stop tag
PACK_TRAILER = b"eFWPKEND"


def pack_cache_path_for(input_path: str | Path) -> str:
    return str(input_path) + ".fwpack"


def stream_signature(mi, vw, *, batch_size: int, K: int, bitpack_on: bool,
                     vocab_on: bool, count_keys, cut_at,
                     data_path=None) -> bytes:
    """Everything that shapes the producer's queue stream, as stable JSON.

    Includes the SOURCE file's identity (size + mtime): a regenerated
    dataset must invalidate the replay. (The record cache's identity —
    whether it exists — is deliberately NOT included: with unchanged
    source data, live-producing from text or from records yields the
    same stream, so deleting only the .fwcache keeps the replay valid.)"""
    src = None
    if data_path is not None:
        try:
            st = os.stat(data_path)
            src = [int(st.st_size), int(st.st_mtime_ns)]
        except OSError:
            src = "unstattable"
    sig = {
        "pack_version": PACK_VERSION,
        "mi": mi.to_json(),
        "vw": vw.to_source_json(),
        "source": src,
        "batch_size": int(batch_size),
        "K": int(K),
        "bitpack": bool(bitpack_on),
        "vocab": bool(vocab_on),
        "count_keys": sorted(count_keys.items()) if count_keys else None,
        "cut_at": None if cut_at is None else int(cut_at),
    }
    return json.dumps(sig, sort_keys=True).encode()


def _write_array(fh, a: np.ndarray) -> None:
    dt = a.dtype.str.encode()
    fh.write(struct.pack("<B", len(dt)))
    fh.write(dt)
    fh.write(struct.pack("<B", a.ndim))
    for d in a.shape:
        fh.write(struct.pack("<Q", d))
    fh.write(np.ascontiguousarray(a).tobytes())


def _read_exact(fh, n: int) -> bytes:
    b = fh.read(n)
    if len(b) != n:
        raise ValueError("truncated pack cache")
    return b


def _read_array(fh) -> np.ndarray:
    (dtl,) = struct.unpack("<B", _read_exact(fh, 1))
    dt = np.dtype(_read_exact(fh, dtl).decode())
    (ndim,) = struct.unpack("<B", _read_exact(fh, 1))
    shape = tuple(
        struct.unpack("<Q", _read_exact(fh, 8))[0] for _ in range(ndim))
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    raw = _read_exact(fh, n * dt.itemsize)
    return np.frombuffer(raw, dt).reshape(shape)


def _retuple(x):
    """JSON lists → nested tuples (layout signatures compare by tuple)."""
    if isinstance(x, list):
        return tuple(_retuple(v) for v in x)
    return x


def _layout_to_json(lay: PackedLayout) -> bytes:
    return json.dumps({
        "fields": [[f.key, f.dtype, list(f.shape), f.word_off, f.word_len]
                   for f in lay.fields],
        "words": lay.words,
        "appends": lay.appends,
        "bitpacks": lay.bitpacks,
        "row_broadcasts": lay.row_broadcasts,
        "vocabs": lay.vocabs,
        "count_tabs": lay.count_tabs,
        "bit_cols": lay.bit_cols,
    }).encode()


def _layout_from_json(raw: bytes) -> PackedLayout:
    d = json.loads(raw.decode())
    fields = tuple(
        _Field(f[0], f[1], tuple(f[2]), f[3], f[4]) for f in d["fields"])
    return PackedLayout(fields, d["words"], _retuple(d["appends"]),
                        _retuple(d["bitpacks"]), _retuple(d["row_broadcasts"]),
                        _retuple(d["vocabs"]), _retuple(d["count_tabs"]),
                        _retuple(d.get("bit_cols", ())))


class PackCacheWriter:
    """Records the producer stream; publishes atomically on a clean end."""

    def __init__(self, final_path: str, sig: bytes):
        self.final_path = final_path
        self.tmp_path = final_path + ".writing"
        self._fh = open(self.tmp_path, "wb", buffering=1 << 20)
        self._fh.write(PACK_MAGIC)
        self._fh.write(struct.pack("<IQ", PACK_VERSION, len(sig)))
        self._fh.write(sig)

    def put(self, item) -> None:
        fh = self._fh
        tag = item[0]
        if tag == "v":
            fh.write(b"v")
            _write_array(fh, item[1])
        elif tag == "p":
            _, buf, lay, gn = item
            fh.write(b"p")
            fh.write(struct.pack("<Q", gn))
            lj = _layout_to_json(lay)
            fh.write(struct.pack("<Q", len(lj)))
            fh.write(lj)
            _write_array(fh, buf)
        elif tag == "s":
            _, bd, n = item
            fh.write(b"s")
            fh.write(struct.pack("<QI", n, len(bd)))
            for k in sorted(bd):
                kb = k.encode()
                fh.write(struct.pack("<H", len(kb)))
                fh.write(kb)
                _write_array(fh, np.asarray(bd[k]))
        else:  # pragma: no cover — producer emits only v/p/s
            raise ValueError(f"unknown stream item tag {tag!r}")

    def finish(self) -> None:
        self._fh.write(PACK_TRAILER)
        self._fh.close()
        os.replace(self.tmp_path, self.final_path)
        self._fh = None

    def abort(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        try:
            os.unlink(self.tmp_path)
        except OSError:
            pass


class RecordingQueue:
    """Queue proxy: serializes every stream item as it is enqueued.

    ``None`` (clean end of stream) publishes the cache; an exception item
    (producer abort) discards it — the record cache's abort-never-publishes
    rule, one pipeline level up."""

    def __init__(self, q, writer: PackCacheWriter):
        self._q = q
        self._w = writer

    def put(self, item) -> None:
        if self._w is not None:
            try:
                if item is None:
                    self._w.finish()
                    self._w = None
                elif isinstance(item, BaseException):
                    self._w.abort()
                    self._w = None
                else:
                    self._w.put(item)
            except OSError as e:  # disk full etc: drop the cache, not the run
                log.warning("pack cache write failed (%s); disabled", e)
                self._w.abort()
                self._w = None
        self._q.put(item)


def open_pack_cache(path: str, sig: bytes):
    """Iterator over the recorded stream, or None (missing/stale/mismatch).

    Validates the trailing end marker BEFORE yielding anything — a
    truncated file must fall back to the live producer, not replay a
    partial run."""
    try:
        fh = open(path, "rb", buffering=1 << 20)
    except OSError:
        return None
    try:
        if _read_exact(fh, 4) != PACK_MAGIC:
            raise ValueError("bad magic")
        version, sig_len = struct.unpack("<IQ", _read_exact(fh, 12))
        if version != PACK_VERSION:
            raise ValueError(f"pack cache version {version}")
        if _read_exact(fh, sig_len) != sig:
            raise ValueError("config signature mismatch")
        body_start = fh.tell()
        fh.seek(-len(PACK_TRAILER), os.SEEK_END)
        if fh.read(len(PACK_TRAILER)) != PACK_TRAILER:
            raise ValueError("missing end trailer (truncated)")
        fh.seek(body_start)
    except (ValueError, OSError, struct.error) as e:
        log.warning("pack cache rejected (%s); using the live producer", e)
        fh.close()
        return None

    def items():
        with fh:
            while True:
                tag = fh.read(1)
                if tag == b"e" or tag == b"":
                    return
                if tag == b"v":
                    yield ("v", _read_array(fh))
                elif tag == b"p":
                    (gn,) = struct.unpack("<Q", _read_exact(fh, 8))
                    (lj_len,) = struct.unpack("<Q", _read_exact(fh, 8))
                    lay = _layout_from_json(_read_exact(fh, lj_len))
                    yield ("p", _read_array(fh), lay, gn)
                elif tag == b"s":
                    n, nkeys = struct.unpack("<QI", _read_exact(fh, 12))
                    bd = {}
                    for _ in range(nkeys):
                        (klen,) = struct.unpack("<H", _read_exact(fh, 2))
                        k = _read_exact(fh, klen).decode()
                        bd[k] = _read_array(fh)
                    yield ("s", bd, n)
                else:
                    raise ValueError(f"corrupt pack cache tag {tag!r}")

    return items()
