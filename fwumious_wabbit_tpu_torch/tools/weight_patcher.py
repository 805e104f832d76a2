"""weight_patcher — byte-level model-file diff/patch: the port's copy of
fwumious_wabbit_tpu/tools/weight_patcher.py.

The on-disk format is the reference's standalone patcher's (reference:
weight_patcher/src/main.rs:52-266): a gzip stream of (LEB128-varint index
delta, raw new byte) entries. The C++ tool (native/weight_patcher.cpp,
built by g++ with zlib on first use into ``fwumious_wabbit_tpu_torch/build/``,
native.weight_patcher) is the fast path; this module has the same
operations in Python, taken when the tool cannot be built, and then with
g++'s message logged. The CLI:

    python -m fwumious_wabbit_tpu_torch.tools.weight_patcher create_diff A B diff
    python -m fwumious_wabbit_tpu_torch.tools.weight_patcher recreate A diff out
"""

from __future__ import annotations

import gzip
import subprocess
import sys
from pathlib import Path

from ..utils.logging import get_logger

log = get_logger(__name__)


def _write_varint(out: bytearray, value: int) -> None:
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def create_diff_bytes(a: bytes, b: bytes) -> bytes:
    """Diff payload (uncompressed) between equal-length byte strings."""
    out = bytearray()
    prev = 0
    n = max(len(a), len(b))
    for i in range(n):
        av = a[i] if i < len(a) else None
        bv = b[i] if i < len(b) else None
        if av != bv:
            _write_varint(out, i - prev)
            out.append(bv if bv is not None else 0)
            prev = i
    return bytes(out)


def recreate_bytes(a: bytes, diff: bytes) -> bytes:
    """Apply an uncompressed diff payload to ``a``."""
    out = bytearray(a)
    pos = 0
    index = 0
    first = True
    while pos < len(diff):
        delta = 0
        shift = 0
        while True:
            byte = diff[pos]
            pos += 1
            delta |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        to = diff[pos]
        pos += 1
        index = delta if first else index + delta
        first = False
        if index < len(out):
            out[index] = to
    return bytes(out)


def native_tool() -> Path | None:
    """The C++ tool, built on first use; None, with g++'s message logged,
    when it cannot be built."""
    from .. import native

    try:
        return native.weight_patcher()
    except RuntimeError as e:
        log.warning("the C++ weight patcher could not be built; using the "
                    "Python path: %s", e)
        return None


def create_diff(a_path, b_path, diff_path, use_native: bool = True) -> None:
    tool = native_tool() if use_native else None
    if tool is not None:
        subprocess.run([str(tool), "create_diff", str(a_path), str(b_path),
                        str(diff_path)], check=True)
        return
    payload = create_diff_bytes(Path(a_path).read_bytes(), Path(b_path).read_bytes())
    Path(diff_path).write_bytes(gzip.compress(payload, compresslevel=6))


def recreate(a_path, diff_path, out_path, use_native: bool = True) -> None:
    tool = native_tool() if use_native else None
    if tool is not None:
        subprocess.run([str(tool), "recreate", str(a_path), str(diff_path),
                        str(out_path)], check=True)
        return
    payload = gzip.decompress(Path(diff_path).read_bytes())
    Path(out_path).write_bytes(recreate_bytes(Path(a_path).read_bytes(), payload))


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 4 or argv[0] not in ("create_diff", "recreate"):
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "create_diff":
        create_diff(argv[1], argv[2], argv[3])
    else:
        recreate(argv[1], argv[2], argv[3])
    return 0


if __name__ == "__main__":
    sys.exit(main())
