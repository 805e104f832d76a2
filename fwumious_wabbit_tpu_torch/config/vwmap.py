"""Namespace map — parses ``vw_namespace_map.csv`` and provides the
namespace-name → descriptor lookup used by the parser and translator.

Mirrors the reference's config contract (reference: src/vwmap.rs:10-151):
namespaces must be predeclared; each gets a dense ``namespace_index`` (CSV row
order), an optional ``f32`` format tag in column 3, and the whole map is
serializable to JSON for embedding into caches and model files.

The port's own copy of fwumious_wabbit_tpu/config/vwmap.py, the same in
behaviour; it imports nothing of that package.
"""

from __future__ import annotations

import csv
import io
import json
from dataclasses import dataclass, field
from enum import IntEnum
from pathlib import Path

from ..hashing import namespace_seed


class NamespaceType(IntEnum):
    PRIMITIVE = 0
    TRANSFORMED = 1


class NamespaceFormat(IntEnum):
    CATEGORICAL = 0
    F32 = 1


@dataclass(frozen=True)
class NamespaceDescriptor:
    namespace_index: int  # u16
    namespace_type: NamespaceType = NamespaceType.PRIMITIVE
    namespace_format: NamespaceFormat = NamespaceFormat.CATEGORICAL


@dataclass
class VwNamespaceMapEntry:
    namespace_vwname: str
    namespace_verbose: str
    namespace_index: int
    namespace_format: NamespaceFormat


@dataclass
class VwNamespaceMap:
    """Parsed namespace map.

    ``num_namespaces`` is max(namespace_index)+1 (reference: src/vwmap.rs:83-87).
    """

    entries: list[VwNamespaceMapEntry] = field(default_factory=list)
    namespace_skip_prefix: int = 0

    # derived lookups
    vwname_to_descriptor: dict[bytes, NamespaceDescriptor] = field(default_factory=dict)
    verbose_to_descriptor: dict[str, NamespaceDescriptor] = field(default_factory=dict)
    vwname_to_seed: dict[bytes, int] = field(default_factory=dict)
    num_namespaces: int = 0

    def _build(self) -> None:
        self.vwname_to_descriptor = {}
        self.verbose_to_descriptor = {}
        self.vwname_to_seed = {}
        self.num_namespaces = 0
        for e in self.entries:
            desc = NamespaceDescriptor(
                namespace_index=e.namespace_index,
                namespace_type=NamespaceType.PRIMITIVE,
                namespace_format=e.namespace_format,
            )
            key = e.namespace_vwname.encode()
            self.vwname_to_descriptor[key] = desc
            self.verbose_to_descriptor[e.namespace_verbose] = desc
            self.vwname_to_seed[key] = namespace_seed(key)
            if e.namespace_index >= self.num_namespaces:
                self.num_namespaces = e.namespace_index + 1

    # -- construction ------------------------------------------------------

    @classmethod
    def from_string(cls, data: str) -> "VwNamespaceMap":
        """Parse the CSV body (reference: src/vwmap.rs:106-151)."""
        vw = cls()
        rdr = csv.reader(io.StringIO(data))
        i = 0
        for record in rdr:
            if not record:
                continue
            vwname = record[0]
            if vwname == "_namespace_skip_prefix":
                vw.namespace_skip_prefix = int(record[1])
                continue
            verbose = record[1] if len(record) > 1 else ""
            fmt_tag = record[2] if len(record) > 2 else ""
            if fmt_tag == "f32":
                fmt = NamespaceFormat.F32
            elif fmt_tag == "":
                fmt = NamespaceFormat.CATEGORICAL
            else:
                raise ValueError(
                    f'Unknown type used for the feature in vw_namespace_map.csv: "{fmt_tag}".'
                    ' Only "f32" is possible.'
                )
            vw.entries.append(
                VwNamespaceMapEntry(
                    namespace_vwname=vwname,
                    namespace_verbose=verbose,
                    namespace_index=i,
                    namespace_format=fmt,
                )
            )
            i += 1
        vw._build()
        return vw

    @classmethod
    def from_csv_file(cls, path: str | Path) -> "VwNamespaceMap":
        return cls.from_string(Path(path).read_text())

    @classmethod
    def from_dataset_dir(cls, data_path: str | Path) -> "VwNamespaceMap":
        """Find vw_namespace_map.csv next to the input dataset, as the
        reference does (reference: src/main.rs:164-168)."""
        p = Path(data_path)
        return cls.from_csv_file(p.parent / "vw_namespace_map.csv")

    # -- (de)serialization (JSON layout matches the reference's serde output
    #    of VwNamespaceMapSource, reference: src/vwmap.rs:39-51) -------------

    def to_source_json(self) -> str:
        src = {
            "namespace_skip_prefix": self.namespace_skip_prefix,
            "entries": [
                {
                    "namespace_vwname": e.namespace_vwname,
                    "namespace_verbose": e.namespace_verbose,
                    "namespace_index": e.namespace_index,
                    "namespace_format": "F32"
                    if e.namespace_format == NamespaceFormat.F32
                    else "Categorical",
                }
                for e in self.entries
            ],
        }
        return json.dumps(src, separators=(",", ":"))

    @classmethod
    def from_source_json(cls, data: str) -> "VwNamespaceMap":
        src = json.loads(data)
        vw = cls(namespace_skip_prefix=src.get("namespace_skip_prefix", 0))
        for e in src["entries"]:
            vw.entries.append(
                VwNamespaceMapEntry(
                    namespace_vwname=e["namespace_vwname"],
                    namespace_verbose=e["namespace_verbose"],
                    namespace_index=e["namespace_index"],
                    namespace_format=NamespaceFormat.F32
                    if e["namespace_format"] == "F32"
                    else NamespaceFormat.CATEGORICAL,
                )
            )
        vw._build()
        return vw
