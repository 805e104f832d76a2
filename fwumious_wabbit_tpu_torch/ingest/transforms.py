"""Feature transforms — host-side namespace transformations.

Reproduces the reference's transform subsystem exactly:

* grammar ``out=Func(A,B)(p1,p2)`` with dependency ordering by DFS and cycle
  detection (reference: src/feature_transform_parser.rs:99-238,297-368);
* per-target-namespace 5-seed derivation: murmur3 of four fixed byte quads
  seeded with ``to_namespace_index ^ (1<<31)`` (reference:
  src/feature_transform_executor.rs:17-27);
* emission primitives ``emit_i32`` / ``emit_f32`` (interpolated splits a float
  between floor/ceil bins with proportional weights) and ``emit_i32_i32``
  (reference: src/feature_transform_executor.rs:49-94);
* the four transform families (reference:
  src/feature_transform_implementations.rs): BinnerSqrt[Plain],
  BinnerLog[Plain], BinnerLogRatio[Plain], Weight, Combine.

The port's own copy of fwumious_wabbit_tpu/ingest/transforms.py, the same in
behaviour; it imports nothing of that package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..config.vwmap import (
    NamespaceDescriptor,
    NamespaceFormat,
    NamespaceType,
    VwNamespaceMap,
)
from ..hashing import MASK31, murmur3_32
from .parser import HEADER_LEN, IS_NOT_SINGLE_MASK


def default_seeds(to_namespace_index: int) -> list[int]:
    """5 precomputed murmur3 seeds per target namespace
    (reference: src/feature_transform_executor.rs:17-27)."""
    seed = (to_namespace_index ^ (1 << 31)) & 0xFFFFFFFF
    quads = [
        bytes([214, 231, 1, 55]),
        bytes([255, 6, 14, 69]),
        bytes([50, 6, 71, 123]),
        bytes([10, 3, 0, 43]),
        bytes([0, 53, 10, 201]),
    ]
    return [murmur3_32(q, seed) for q in quads]


SEED_DEFAULT, SEED_ONE, SEED_TWO, SEED_THREE = 0, 1, 2, 3


def _i32_le_bytes(x: int) -> bytes:
    return int(np.int32(np.uint32(x & 0xFFFFFFFF)).item()).to_bytes(4, "little", signed=True)


class _Emitter:
    """Collects (hash, value) pairs for one transformed namespace."""

    def __init__(self, seeds: list[int]):
        self.seeds = seeds
        self.out: list[tuple[int, float]] = []

    def emit_i32(self, seed_id: int, to_data: int, hash_value: float) -> None:
        h = murmur3_32(_i32_le_bytes(to_data), self.seeds[seed_id]) & MASK31
        self.out.append((h, hash_value))

    def emit_f32(self, seed_id: int, f: float, hash_value: float, interpolated: bool) -> None:
        if not math.isfinite(f):
            bits = int(np.float32(f).view(np.uint32))
            self.emit_i32(seed_id, bits, hash_value)
        elif interpolated:
            floor = math.floor(f)
            part = f - floor
            if part != 0.0:
                self.emit_i32(seed_id, floor + 1, hash_value * part)
            part = 1.0 - part
            if part != 0.0:
                self.emit_i32(seed_id, floor, hash_value * part)
        else:
            # Rust `f as i32` saturates; Python int() truncates the same way
            self.emit_i32(seed_id, int(np.float32(f)), hash_value)

    def emit_i32_i32(self, seed_id: int, d1: int, d2: int, hash_value: float) -> None:
        h1 = murmur3_32(_i32_le_bytes(d1), self.seeds[seed_id])
        h = murmur3_32(_i32_le_bytes(d2), h1) & MASK31
        self.out.append((h, hash_value))


def _read_float_namespace(record: np.ndarray, desc: NamespaceDescriptor):
    """feature_reader_float_namespace! — yields (hash, 1.0, float_value)
    (reference: src/feature_buffer.rs:110-135)."""
    if desc.namespace_format != NamespaceFormat.F32:
        raise ValueError("Not a float namespace when float namespace expected")
    first_token = int(record[HEADER_LEN + desc.namespace_index])
    if (first_token & IS_NOT_SINGLE_MASK) == 0:
        # single in-place feature has no float payload; reference would read
        # the tail only — in practice f32 namespaces always spill to the tail.
        return
    start = (first_token >> 16) & 0x3FFF
    end = first_token & 0xFFFF
    for off in range(start, end, 2):
        yield (
            int(record[off]),
            1.0,
            float(np.uint32(record[off + 1]).view(np.float32)),
        )


# ---------------------------------------------------------------------------
# transform families
# ---------------------------------------------------------------------------


@dataclass
class TransformerBinner:
    from_desc: NamespaceDescriptor
    greater_than: float
    resolution: float
    interpolated: bool
    fn_name: str  # 'sqrt' | 'ln'

    def __call__(self, record, emitter: _Emitter, executors: "TransformExecutors"):
        f = math.sqrt if self.fn_name == "sqrt" else math.log
        for _h, hash_value, float_value in _read_float_namespace(record, self.from_desc):
            if float_value < self.greater_than:
                emitter.emit_i32(SEED_DEFAULT, int(np.float32(float_value)), hash_value)
            else:
                x = float_value - self.greater_than
                try:
                    transformed = np.float32(f(x)) * np.float32(self.resolution)
                except ValueError:  # math domain error -> NaN like Rust
                    transformed = float("nan")
                emitter.emit_f32(SEED_ONE, float(transformed), hash_value, self.interpolated)


@dataclass
class TransformerLogRatioBinner:
    from_desc1: NamespaceDescriptor
    from_desc2: NamespaceDescriptor
    greater_than: float
    resolution: float
    interpolated: bool

    def __call__(self, record, emitter: _Emitter, executors: "TransformExecutors"):
        for _h1, hv1, val1 in _read_float_namespace(record, self.from_desc1):
            for _h2, hv2, val2 in _read_float_namespace(record, self.from_desc2):
                joint = hv1 * hv2
                if val2 + val1 < self.greater_than:
                    emitter.emit_i32_i32(
                        SEED_ONE, int(np.float32(val1)), int(np.float32(val2)), joint
                    )
                elif val1 == 0.0:
                    emitter.emit_f32(
                        SEED_TWO,
                        _safe_ln(val2 - self.greater_than),
                        joint,
                        self.interpolated,
                    )
                elif val2 == 0.0:
                    emitter.emit_f32(
                        SEED_THREE,
                        _safe_ln(val1 - self.greater_than),
                        joint,
                        self.interpolated,
                    )
                else:
                    o = _safe_ln(val1 / val2) * self.resolution
                    emitter.emit_f32(SEED_DEFAULT, o, joint, self.interpolated)


def _safe_ln(x: float) -> float:
    if x > 0:
        return math.log(x)
    if x == 0:
        return float("-inf")
    return float("nan")


@dataclass
class TransformerWeight:
    from_desc: NamespaceDescriptor
    multiplier: float

    def __call__(self, record, emitter: _Emitter, executors: "TransformExecutors"):
        from .translator import read_namespace_features

        for h, v in read_namespace_features(record, self.from_desc, executors):
            emitter.emit_i32(SEED_DEFAULT, h, v * self.multiplier)


@dataclass
class TransformerCombine:
    from_descs: list[NamespaceDescriptor]

    def __call__(self, record, emitter: _Emitter, executors: "TransformExecutors"):
        from .translator import read_namespace_features

        def rec(i: int, acc_hash: int, acc_value: float):
            if i == len(self.from_descs):
                emitter.emit_i32(SEED_DEFAULT, acc_hash, acc_value)
                return
            for h, v in read_namespace_features(record, self.from_descs[i], executors):
                rec(i + 1, acc_hash ^ h, acc_value * v)

        rec(0, 0, 1.0)


# ---------------------------------------------------------------------------
# parsing + dependency resolution
# ---------------------------------------------------------------------------


@dataclass
class NamespaceTransform:
    to_verbose: str
    to_descriptor: NamespaceDescriptor
    from_namespaces: list[tuple[str, NamespaceDescriptor]]
    function_name: str
    function_parameters: list[float]


@dataclass
class NamespaceTransforms:
    v: list[NamespaceTransform] = field(default_factory=list)

    def descriptor_for_name(self, verbose: str) -> NamespaceDescriptor | None:
        for t in self.v:
            if t.to_verbose == verbose:
                return t.to_descriptor
        return None

    def to_json_obj(self):
        def nsd(d: NamespaceDescriptor):
            return {
                "namespace_index": d.namespace_index,
                "namespace_type": "Primitive"
                if d.namespace_type == NamespaceType.PRIMITIVE
                else "Transformed",
                "namespace_format": "Categorical"
                if d.namespace_format == NamespaceFormat.CATEGORICAL
                else "F32",
            }

        return {
            "v": [
                {
                    "to_namespace": {
                        "namespace_descriptor": nsd(t.to_descriptor),
                        "namespace_verbose": t.to_verbose,
                    },
                    "from_namespaces": [
                        {"namespace_descriptor": nsd(d), "namespace_verbose": n}
                        for (n, d) in t.from_namespaces
                    ],
                    "function_name": t.function_name,
                    "function_parameters": t.function_parameters,
                }
                for t in self.v
            ]
        }

    @classmethod
    def from_json_obj(cls, obj) -> "NamespaceTransforms":
        def nsd(j):
            return NamespaceDescriptor(
                namespace_index=j["namespace_index"],
                namespace_type=NamespaceType.PRIMITIVE
                if j["namespace_type"] == "Primitive"
                else NamespaceType.TRANSFORMED,
                namespace_format=NamespaceFormat.CATEGORICAL
                if j["namespace_format"] == "Categorical"
                else NamespaceFormat.F32,
            )

        out = cls()
        for t in obj["v"]:
            out.v.append(
                NamespaceTransform(
                    to_verbose=t["to_namespace"]["namespace_verbose"],
                    to_descriptor=nsd(t["to_namespace"]["namespace_descriptor"]),
                    from_namespaces=[
                        (f["namespace_verbose"], nsd(f["namespace_descriptor"]))
                        for f in t["from_namespaces"]
                    ],
                    function_name=t["function_name"],
                    function_parameters=t["function_parameters"],
                )
            )
        return out


def parse_namespace_statement(s: str):
    """Parse ``out=Func(A,B)(1.0,2.0)`` → (to, func, [from...], [params...])
    (reference: src/feature_transform_parser.rs:297-368)."""
    s = s.strip()
    eq = s.index("=")
    to_name = s[:eq].strip()
    rest = s[eq + 1 :].strip()
    p1 = rest.index("(")
    func = rest[:p1].strip()
    p2 = rest.index(")", p1)
    from_namespaces = [x.strip() for x in rest[p1 + 1 : p2].split(",") if x.strip()]
    params: list[float] = []
    rest2 = rest[p2 + 1 :].strip()
    if rest2.startswith("("):
        p3 = rest2.index(")")
        inner = rest2[1:p3].strip()
        if inner:
            params = [float(x) for x in inner.split(",")]
    if not to_name or not func:
        raise ValueError(f"Error parsing {s}")
    return to_name, func, from_namespaces, params


class NamespaceTransformsParser:
    """Two-stage parse: collect, then DFS-resolve dependency order
    (reference: src/feature_transform_parser.rs:43-158)."""

    def __init__(self):
        self.denormalized: dict[str, dict] = {}

    def add_transform_namespace(self, vw: VwNamespaceMap, s: str) -> None:
        to_name, _func, from_names, _params = parse_namespace_statement(s)
        if to_name in vw.verbose_to_descriptor:
            raise ValueError(
                f"To namespace of {s} already exists as primitive namespace: {to_name!r}"
            )
        self.denormalized[to_name] = {
            "definition": s,
            "from": from_names,
            "processing": False,
            "done": False,
        }

    def resolve(self, vw: VwNamespaceMap) -> NamespaceTransforms:
        nst = NamespaceTransforms()
        for key in sorted(self.denormalized.keys()):
            self._dfs(vw, nst, key)
        return nst

    def _dfs(self, vw: VwNamespaceMap, nst: NamespaceTransforms, verbose: str) -> None:
        if verbose in vw.verbose_to_descriptor:
            return
        n = self.denormalized.get(verbose)
        if n is None:
            raise ValueError(f"Could not find namespace {verbose!r}")
        if n["done"]:
            return
        if n["processing"]:
            raise ValueError(
                f"Cyclic dependency detected, one of the namespaces involved is {verbose!r}"
            )
        n["processing"] = True
        for frm in n["from"]:
            self._dfs(vw, nst, frm)
        self._add_transform(vw, nst, n["definition"])
        n["processing"] = False
        n["done"] = True

    def _add_transform(self, vw: VwNamespaceMap, nst: NamespaceTransforms, s: str) -> None:
        to_name, func, from_names, params = parse_namespace_statement(s)
        if nst.descriptor_for_name(to_name) is not None:
            raise ValueError(f"To namespace of {s} already exists: {to_name!r}")
        to_descriptor = NamespaceDescriptor(
            namespace_index=len(nst.v),
            namespace_type=NamespaceType.TRANSFORMED,
            namespace_format=NamespaceFormat.CATEGORICAL,
        )
        from_namespaces = []
        for fn in from_names:
            d = nst.descriptor_for_name(fn)
            if d is None:
                d = vw.verbose_to_descriptor.get(fn)
            if d is None:
                raise ValueError(f"Unknown verbose namespace in command line: {fn}")
            from_namespaces.append((fn, d))
        for i, (n1, d1) in enumerate(from_namespaces):
            for _n2, d2 in from_namespaces[i + 1 :]:
                if d1 == d2:
                    raise ValueError(
                        "Using the same from namespace in multiple arguments to a function"
                        f" is not supported: {n1!r}"
                    )
        nt = NamespaceTransform(
            to_verbose=to_name,
            to_descriptor=to_descriptor,
            from_namespaces=from_namespaces,
            function_name=func,
            function_parameters=params,
        )
        _make_function(nt)  # early validation
        nst.v.append(nt)


def _make_function(t: NamespaceTransform):
    """Build the executor callable for one transform
    (reference: src/feature_transform_executor.rs:128-194)."""
    name = t.function_name
    descs = [d for (_n, d) in t.from_namespaces]
    params = t.function_parameters

    def binner(fn_name: str, interpolated: bool):
        if len(params) > 2:
            raise ValueError(f"Function {name} takes up to two float arguments")
        greater_than = params[0] if len(params) >= 1 else 0.0
        if greater_than < 0.0:
            raise ValueError(f"Function {name} parameter greater_than cannot be negative")
        resolution = params[1] if len(params) >= 2 else 1.0
        if len(descs) != 1:
            raise ValueError(f"Function {name} takes exactly one namespace argument")
        if descs[0].namespace_format != NamespaceFormat.F32:
            raise ValueError(f"All namespaces of function {name} have to be of type f32")
        return TransformerBinner(descs[0], greater_than, resolution, interpolated, fn_name)

    if name == "BinnerSqrtPlain":
        return binner("sqrt", False)
    if name == "BinnerSqrt":
        return binner("sqrt", True)
    if name == "BinnerLogPlain":
        return binner("ln", False)
    if name == "BinnerLog":
        return binner("ln", True)
    if name in ("BinnerLogRatioPlain", "BinnerLogRatio"):
        if len(params) > 2:
            raise ValueError(f"Function {name} takes up to two float arguments")
        greater_than = params[0] if len(params) >= 1 else 0.0
        if greater_than < 0.0:
            raise ValueError(f"Function {name} parameter greater_than cannot be negative")
        resolution = params[1] if len(params) >= 2 else 1.0
        if len(descs) != 2:
            raise ValueError(f"Function {name} takes exactly two namespace arguments")
        for d in descs:
            if d.namespace_format != NamespaceFormat.F32:
                raise ValueError(f"All namespaces of function {name} have to be of type f32")
        return TransformerLogRatioBinner(
            descs[0], descs[1], greater_than, resolution, name == "BinnerLogRatio"
        )
    if name == "Weight":
        if len(params) != 1:
            raise ValueError(f"Function {name} takes exactly one float argument")
        if len(descs) != 1:
            raise ValueError(f"Function {name} takes exactly one namespace argument")
        return TransformerWeight(descs[0], params[0])
    if name == "Combine":
        if params:
            raise ValueError(f"Function {name} takes no float arguments")
        if not (2 <= len(descs) <= 4):
            raise ValueError(f"Function {name} takes between 2 and 4 namespace arguments")
        return TransformerCombine(descs)
    raise ValueError(f"Unknown transformer function: {name}")


class TransformExecutors:
    """Runtime: executes transform i on demand during translation."""

    def __init__(self, transforms: NamespaceTransforms):
        self.transforms = transforms
        self.functions = [_make_function(t) for t in transforms.v]
        self.seeds = [default_seeds(t.to_descriptor.namespace_index) for t in transforms.v]

    def execute(self, index: int, record: np.ndarray):
        emitter = _Emitter(self.seeds[index])
        self.functions[index](record, emitter, self)
        return emitter.out
