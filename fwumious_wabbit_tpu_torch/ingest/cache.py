"""Input record cache (.fwcache) — the port's own copy of
fwumious_wabbit_tpu/ingest/cache.py.

Same role and framing discipline as the reference's cache
(reference: src/cache.rs:12-232): parsed u32 records written verbatim with a
``FWCA`` magic + version + embedded namespace-map JSON header; the cache is
invalidated when the version or namespace map changes; writes go to a
``.writing`` temp file renamed into place on success.

The JAX package compresses with zstd (level 1) and imports ``zstandard`` at
its top. Here ``zstandard`` is imported where it is used: a cache is
written zstd where the package is installed and raw (``CODEC_RAW``) where
it is not, and the header records which. A zstd cache on a host without
``zstandard`` cannot be read there and counts as stale
(:class:`StaleCacheError`, naming the codec), so the caller rebuilds it: a
cache is a local artifact, never exchanged between hosts
(docs/MIGRATION.md). The codec changes only the file; the records, and so
the training run, are the same either way.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

from ..config.vwmap import VwNamespaceMap

CACHE_HEADER_MAGIC = b"FWCA"
CACHE_VERSION = 11  # tracks the reference's cache version (src/cache.rs:12)
CODEC_RAW = 0
CODEC_ZSTD = 2
CODEC_NAMES = {CODEC_RAW: "raw", CODEC_ZSTD: "zstd"}


def zstandard_module():
    """The ``zstandard`` package, or None where it is not installed."""
    try:
        import zstandard
    except ImportError:
        return None
    return zstandard


class RecordCacheWriter:
    """Writes u32 records to ``final_path`` through ``<final_path>.writing``.
    ``compress``: zstd (True) or raw (False); None takes zstd where
    ``zstandard`` is installed, raw where it is not."""

    def __init__(self, final_path: str | Path, vw: VwNamespaceMap,
                 compress: bool | None = None):
        zstd = zstandard_module()
        if compress is None:
            compress = zstd is not None
        if compress and zstd is None:
            raise RuntimeError("a zstd record cache needs the zstandard package")
        self.codec = CODEC_ZSTD if compress else CODEC_RAW
        self.final_path = str(final_path)
        self.tmp_path = self.final_path + ".writing"
        self._fh = open(self.tmp_path, "wb")
        vw_json = vw.to_source_json().encode()
        self._fh.write(CACHE_HEADER_MAGIC)
        self._fh.write(struct.pack("<IIQ", CACHE_VERSION, self.codec, len(vw_json)))
        self._fh.write(vw_json)
        if compress:
            self._zstd = zstd
            self._writer = zstd.ZstdCompressor(level=1).stream_writer(self._fh)
        else:
            self._writer = self._fh

    def push_record(self, record: np.ndarray) -> None:
        self._writer.write(np.asarray(record, dtype=np.uint32).tobytes())

    def write_finish(self) -> None:
        if self._writer is not self._fh:
            self._writer.flush(self._zstd.FLUSH_FRAME)
        self._fh.flush()
        self._fh.close()
        os.replace(self.tmp_path, self.final_path)

    def abort(self) -> None:
        try:
            self._fh.close()
        finally:
            if os.path.exists(self.tmp_path):
                os.unlink(self.tmp_path)


class RecordCacheReader:
    """Iterates u32 records out of a cache file."""

    CHUNK = 1 << 20

    def __init__(self, path: str | Path, vw: VwNamespaceMap | None = None):
        self._fh = open(path, "rb")
        try:
            self._open(vw)
        except BaseException:
            self._fh.close()
            raise
        self._buf = b""

    def _open(self, vw) -> None:
        magic = self._fh.read(4)
        if magic != CACHE_HEADER_MAGIC:
            raise ValueError("Not a valid .fwcache file (bad magic)")
        version, codec, vw_len = struct.unpack("<IIQ", self._fh.read(16))
        if version != CACHE_VERSION:
            raise StaleCacheError(f"cache version {version} != {CACHE_VERSION}")
        vw_json = self._fh.read(vw_len).decode()
        if vw is not None and vw.to_source_json() != vw_json:
            raise StaleCacheError("namespace map changed; cache is stale")
        self.codec = codec
        if codec == CODEC_ZSTD:
            zstd = zstandard_module()
            if zstd is None:
                raise StaleCacheError(
                    f"the cache is zstd-compressed (codec {CODEC_ZSTD}) and "
                    f"zstandard is not installed here")
            self._reader = zstd.ZstdDecompressor().stream_reader(self._fh)
        else:
            self._reader = self._fh

    def read_chunk(self, size: int = 64 << 20) -> bytes:
        """Raw decompressed bytes (bulk path for the native record
        translator); b"" at EOF."""
        return self._reader.read(size)

    def close(self) -> None:
        self._fh.close()

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        while len(self._buf) < 4:
            chunk = self._reader.read(self.CHUNK)
            if not chunk:
                if self._buf:
                    raise ValueError("truncated cache file")
                raise StopIteration
            self._buf += chunk
        reclen_words = int(np.frombuffer(self._buf[:4], np.uint32)[0])
        need = reclen_words * 4
        while len(self._buf) < need:
            chunk = self._reader.read(self.CHUNK)
            if not chunk:
                raise ValueError("truncated cache file")
            self._buf += chunk
        rec = np.frombuffer(self._buf[:need], np.uint32).copy()
        self._buf = self._buf[need:]
        return rec


class StaleCacheError(Exception):
    pass


def cache_path_for(input_path: str | Path) -> str:
    return str(input_path) + ".fwcache"
