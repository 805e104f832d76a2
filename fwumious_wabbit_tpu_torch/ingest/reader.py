"""Input opening by extension: .vw plain, .gz gzip, .zst zstandard
(reference: src/buffer_handler.rs:18-36).

The port's own copy of fwumious_wabbit_tpu/ingest/reader.py, the same in
behaviour; it imports nothing of that package.
"""

from __future__ import annotations

import gzip
import io
from pathlib import Path


def create_buffered_input(path: str | Path, buffer_size: int = 1 << 20):
    """Open an input file for binary line reading, decompressing by extension."""
    p = str(path)
    if p.endswith(".gz"):
        return io.BufferedReader(gzip.open(p, "rb"), buffer_size)
    if p.endswith(".zst"):
        import zstandard

        fh = open(p, "rb")
        return io.BufferedReader(zstandard.ZstdDecompressor().stream_reader(fh), buffer_size)
    return open(p, "rb", buffering=buffer_size)
