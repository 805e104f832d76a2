"""VW-text parser → packed u32 record buffer.

Produces records bit-identical to the reference's parser
(reference: src/parser.rs:57-74,214-461):

    [0] u32 total record length (in u32 words)
    [1] u32 label: 1 / 0 / NO_LABEL(0xff)
    [2] u32 bits of f32 example importance (default 1.0)
    [3..3+num_namespaces] one slot per declared namespace:
        - NO_FEATURES (== IS_NOT_SINGLE_MASK) if namespace absent
        - 31-bit feature hash if a single unweighted categorical feature
        - IS_NOT_SINGLE_MASK | (start<<16 | end) addressing the dynamic tail,
          which holds (hash, f32-bits) pairs
    [tail...]

Feature hashes are murmur3_32 seeded with murmur3_32 of the namespace name —
exact VW hash compatibility (verified against the reference's golden parser
tests, src/parser.rs:474-760).

This is the Python reference implementation; the C++ parser in
fwumious_wabbit_tpu/native implements the identical contract for the hot path
and is cross-checked against this one in tests.

The port's own copy of fwumious_wabbit_tpu/ingest/parser.py, the same in
behaviour; it imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config.vwmap import NamespaceFormat, VwNamespaceMap
from ..hashing import murmur3_32

HEADER_LEN = 3
LABEL_OFFSET = 1
EXAMPLE_IMPORTANCE_OFFSET = 2
IS_NOT_SINGLE_MASK = 1 << 31
MASK31 = IS_NOT_SINGLE_MASK - 1
NO_FEATURES = IS_NOT_SINGLE_MASK
NO_LABEL = 0xFF
FLOAT32_ONE = 1065353216  # 1.0f32.to_bits()


class FlushCommand(Exception):
    """In-band "flush" command (reference: src/parser.rs:233-241)."""

    def __str__(self) -> str:
        return 'Not really an error: a "flush" command from client'


@dataclass
class HogwildLoadCommand(Exception):
    """In-band "hogwild_load <file>" command (reference: src/parser.rs:242-253)."""

    filename: str

    def __str__(self) -> str:
        return ('Not really an error: a "hogwild_load" command from client'
                f" to load: {self.filename}")


class ParseError(ValueError):
    pass


def _f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.uint32))


def _parse_float(tok: bytes, error_str: str) -> float:
    if tok == b"NONE":
        return float("nan")
    try:
        return float(tok)
    except ValueError:
        raise ParseError(f"{error_str}: {tok.decode(errors='replace')}") from None


class VowpalParser:
    """Stream parser; call :meth:`parse_line` per input line."""

    def __init__(self, vw: VwNamespaceMap):
        self.vw = vw
        self.num_namespaces = vw.num_namespaces
        # bytes name -> (descriptor, seed)
        self._lookup = {
            name: (desc, vw.vwname_to_seed[name])
            for name, desc in vw.vwname_to_descriptor.items()
        }
        self._skip_prefix = vw.namespace_skip_prefix

    def parse_line(self, line: bytes) -> np.ndarray:
        """Parse one example line (no trailing newline required) into the
        packed u32 record. Raises FlushCommand / HogwildLoadCommand for the
        in-band commands, ParseError on malformed input."""
        if line.endswith(b"\n"):
            line = line[:-1]
        if not line:
            return np.zeros(0, dtype=np.uint32)

        out: list[int] = [0] * (HEADER_LEN + self.num_namespaces)
        for i in range(HEADER_LEN, len(out)):
            out[i] = NO_FEATURES

        first = line[0:1]
        if first == b"1":
            out[LABEL_OFFSET] = 1
        elif first == b"-":
            out[LABEL_OFFSET] = 0
        elif first == b"|":
            out[LABEL_OFFSET] = NO_LABEL
        elif line.startswith(b"flush"):
            raise FlushCommand()
        else:
            toks = line.split()
            if len(toks) == 2 and toks[0] == b"hogwild_load":
                raise HogwildLoadCommand(toks[1].decode())
            raise ParseError("Cannot parse an example")

        pos = 0
        n = len(line)
        if out[LABEL_OFFSET] == NO_LABEL:
            out[EXAMPLE_IMPORTANCE_OFFSET] = FLOAT32_ONE
        else:
            # skip the label token, then optional example importance
            while pos < n and line[pos] != 0x20:
                pos += 1
            while pos < n and line[pos] == 0x20:
                pos += 1
            if pos < n and line[pos] == 0x7C:  # '|'
                out[EXAMPLE_IMPORTANCE_OFFSET] = FLOAT32_ONE
            else:
                start = pos
                while pos < n and line[pos] != 0x20:
                    pos += 1
                imp = _parse_float(line[start:pos], "Failed parsing example importance")
                if imp < 0.0:
                    raise ParseError(f"Example importance cannot be negative: {imp}! ")
                out[EXAMPLE_IMPORTANCE_OFFSET] = _f32_bits(imp)

        # seek first namespace
        while pos < n and line[pos] != 0x7C:
            pos += 1

        cur_seed = 0
        cur_slot = HEADER_LEN
        cur_format = NamespaceFormat.CATEGORICAL
        cur_ns_weight = 1.0
        cur_num_features = 0
        ns_tail_start = 0

        while pos < n:
            while pos < n and line[pos] == 0x20:
                pos += 1
            start = pos
            while pos < n and line[pos] != 0x20 and line[pos] != 0x3A:  # ' ' ':'
                pos += 1
            end_first = pos
            while pos < n and line[pos] != 0x20:
                pos += 1
            end = pos
            if start >= n:
                break

            if line[start] == 0x7C:  # '|' namespace declaration
                name = line[start + 1 : end_first]
                if end_first != end:
                    cur_ns_weight = _parse_float(
                        line[end_first + 1 : end], "Failed parsing namespace weight"
                    )
                else:
                    cur_ns_weight = 1.0
                entry = self._lookup.get(name)
                if entry is None:
                    raise ParseError(
                        "Feature name was not predeclared in vw_namespace_map.csv: "
                        + name.decode(errors="replace")
                    )
                desc, cur_seed = entry
                cur_slot = HEADER_LEN + desc.namespace_index
                cur_format = desc.namespace_format
                cur_num_features = 0
                ns_tail_start = len(out)
            else:
                # a feature
                h = murmur3_32(line[start:end_first], cur_seed) & MASK31
                if end_first != end:
                    feat_weight = _parse_float(
                        line[end_first + 1 : end], "Failed parsing feature weight"
                    )
                else:
                    feat_weight = 1.0

                if (
                    cur_num_features == 0
                    and cur_format == NamespaceFormat.CATEGORICAL
                    and cur_ns_weight == 1.0
                    and feat_weight == 1.0
                ):
                    out[cur_slot] = h
                else:
                    slot_val = out[cur_slot]
                    if cur_num_features == 1 and (slot_val & IS_NOT_SINGLE_MASK) == 0:
                        # promote the in-place feature to the tail
                        out.append(slot_val)
                        out.append(FLOAT32_ONE)
                    out.append(h)
                    if cur_format == NamespaceFormat.F32:
                        fstart = start + self._skip_prefix
                        if end_first != fstart:
                            fval = _parse_float(
                                line[fstart:end_first],
                                "Failed parsing feature value to float (for float namespace)",
                            )
                        else:
                            fval = float("nan")
                        out.append(_f32_bits(fval))
                        if cur_ns_weight * feat_weight != 1.0:
                            raise ParseError(
                                "Namespaces that are f32 can not have weight attached neither"
                                " to namespace nor to a single feature (basically they can'"
                                " use :weight syntax"
                            )
                    else:
                        out.append(_f32_bits(cur_ns_weight * feat_weight))
                    out[cur_slot] = IS_NOT_SINGLE_MASK | (
                        ((ns_tail_start << 16) + len(out)) & 0xFFFFFFFF
                    )
                cur_num_features += 1
            pos += 1

        out[0] = len(out)
        return np.asarray(out, dtype=np.uint32)

    # -- stream interface ---------------------------------------------------

    def next_vowpal(self, stream) -> np.ndarray:
        """Read a line from a binary stream and parse it. Empty array = EOF."""
        line = stream.readline()
        if not line:
            return np.zeros(0, dtype=np.uint32)
        return self.parse_line(line)
