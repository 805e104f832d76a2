"""ctypes bindings for the port's copy of the C++ host engine
(``fw_core.h``, ``fw_native.cpp``, ``fw_ffi.cpp`` in this directory, the
same sources as the JAX package's ``native/``).

The port's own copy of fwumious_wabbit_tpu/native/__init__.py: the
loader, :class:`EmbeddedPredictor` (the embedded-inference C API, reference:
src/lib.rs:151-252), :func:`format_preds`, and the training path's C++
ingest: :class:`NativeIngest` (parse + translate + batch fill, host counts,
the fused wire emit), :class:`VocabEncoder` and the bit-packers
(:func:`bitpack_ids`, :func:`bitpack_mixed`, :func:`counts_table`), which
train/packed.py and train/producer.py drive, with the record cache's
bindings (``translate_records``, ``records_consumed``, ``records``),
and the build of the model-diff tool ``weight_patcher.cpp``
(:func:`weight_patcher`, for tools/weight_patcher.py).
``persistence/quantization.py`` binds its F16C helpers on the library
:func:`load` returns.

The library is built by ``g++`` on first use into
``fwumious_wabbit_tpu_torch/build/`` (listed in ``.gitignore``), with the
JAX package's Makefile flags, and named by a hash of the sources, the flags
and this host's CPU (``-march=native`` code runs only where it was built).
It is compiled to a temporary name and renamed into place under a file
lock, so processes that start at once build it once. :func:`load` returns
None when it cannot be built (the formatter then falls back to Python);
:func:`require` raises with the compiler's message, which is what the
embedded engine does: it never falls back to another engine.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "build"
SOURCES = ("fw_native.cpp", "fw_ffi.cpp")
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-ffp-contract=off",
            "-shared", "-pthread"]
_lock = threading.Lock()
_lib = None
_lib_tried = False
load_error = ""  # why the library could not be built or loaded


def _cpu_key() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            for line in fh:
                if line.startswith((b"model name", b"flags")):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def _hashed(stem: str, suffix: str, flags: list, names) -> Path:
    """``BUILD_DIR/<stem>-<hash><suffix>``, the hash of the flags, this
    host's CPU and the sources ``names``."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(_cpu_key())
    for name in names:
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{suffix}"


def library_path() -> Path:
    return _hashed("libfw_native", ".so", CXXFLAGS, (*SOURCES, "fw_core.h"))


def _build(target: Path, sources, flags: list, libs=()) -> None:
    """Compile ``target`` to a temporary name and rename it into place,
    holding a file lock so concurrent processes build it once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = target.name.split("-")[0]
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            return
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *flags, "-o", str(tmp),
               *(str(_DIR / s) for s in sources), *libs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({r.returncode}): {' '.join(cmd)}\n"
                               f"{r.stderr}")
        os.replace(tmp, target)


# the model-diff tool (tools/weight_patcher.py), an executable linked with
# zlib, with the JAX package's Makefile flags (its native/Makefile:14-15)
PATCHER_SOURCE = "weight_patcher.cpp"
PATCHER_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
                 "-Wextra", "-ffp-contract=off"]


def patcher_path() -> Path:
    return _hashed("weight_patcher", "", PATCHER_FLAGS, (PATCHER_SOURCE,))


def weight_patcher() -> Path:
    """The weight patcher executable, built by g++ on first use; raises
    RuntimeError with the compiler's message when it cannot be built."""
    exe = patcher_path()
    if not exe.exists():
        _build(exe, (PATCHER_SOURCE,), PATCHER_FLAGS, ("-lz",))
    return exe


def load():
    """Load (building if needed) the native library; None if unavailable,
    with the reason in ``load_error``."""
    global _lib, _lib_tried, load_error
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            so = library_path()
            if not so.exists():
                _build(so, SOURCES, CXXFLAGS)
            lib = ctypes.CDLL(str(so))
        except Exception as e:  # noqa: BLE001 — reported by require()
            load_error = str(e)
            return None
        _configure(lib)
        _lib = lib
        return _lib


def require():
    """The native library, or RuntimeError with the compiler's message."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"the embedded C++ engine is unavailable: {load_error}")
    return lib


def _configure(lib):
    u32, i32, i64, f32 = ctypes.c_uint32, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
    i8, u8 = ctypes.c_int8, ctypes.c_uint8
    P = ctypes.POINTER
    lib.fwn_create.restype = ctypes.c_void_p
    lib.fwn_create.argtypes = [
        ctypes.c_int, ctypes.c_char_p, P(ctypes.c_int), P(ctypes.c_int),
        P(ctypes.c_int), ctypes.c_int, ctypes.c_int, P(ctypes.c_int),
        P(ctypes.c_int), P(ctypes.c_int), P(f32), ctypes.c_int, u32, u32,
        ctypes.c_int, P(ctypes.c_int), P(ctypes.c_int), P(ctypes.c_int),
        ctypes.c_int, P(ctypes.c_int), P(f32), P(f32), P(ctypes.c_int),
        P(ctypes.c_int), P(ctypes.c_int), ctypes.c_int,
    ]
    lib.fwn_destroy.argtypes = [ctypes.c_void_p]
    lib.fwn_last_error.restype = ctypes.c_char_p
    lib.fwn_last_error.argtypes = [ctypes.c_void_p]
    lib.fwn_translate_block.restype = i64
    lib.fwn_translate_block.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64]
    lib.fwn_translate_records.restype = i64
    lib.fwn_translate_records.argtypes = [ctypes.c_void_p, P(u32), i64]
    lib.fwn_records_consumed.restype = i64
    lib.fwn_records_consumed.argtypes = [ctypes.c_void_p]
    lib.fwn_records_len.restype = i64
    lib.fwn_records_len.argtypes = [ctypes.c_void_p]
    lib.fwn_records_copy.argtypes = [ctypes.c_void_p, P(u32)]
    lib.fwn_lr_max.restype = ctypes.c_int
    lib.fwn_lr_max.argtypes = [ctypes.c_void_p]
    lib.fwn_ffm_max.restype = ctypes.c_int
    lib.fwn_ffm_max.argtypes = [ctypes.c_void_p]
    lib.fwn_stop_offset.restype = i64
    lib.fwn_stop_offset.argtypes = [ctypes.c_void_p]
    lib.fwn_fill_range.argtypes = [
        ctypes.c_void_p, i64, i64, i64, i64, i64, P(f32), P(f32), P(i32),
        P(f32), P(i8), P(i32), P(f32), P(i8),
    ]
    lib.fwn_set_build_records.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fwn_carry_tail.argtypes = [ctypes.c_void_p, i64]
    lib.fwn_all_ones.restype = ctypes.c_int
    lib.fwn_all_ones.argtypes = [ctypes.c_void_p]
    lib.fwn_batch_counts.argtypes = [P(i32), P(i8), P(f32), i64,
                                     ctypes.c_int32, P(u8)]
    lib.fwn_count_byte.restype = i64
    lib.fwn_count_byte.argtypes = [ctypes.c_char_p, i64, ctypes.c_int]
    lib.fwn_format_preds.restype = i64
    lib.fwn_format_preds.argtypes = [P(f32), i64, ctypes.c_char_p]
    lib.fwn_bitpack_ids.restype = ctypes.c_int
    lib.fwn_bitpack_ids.argtypes = [P(i32), i64, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_int32, P(u32)]
    lib.fwn_bitpack_mixed.restype = ctypes.c_int
    lib.fwn_bitpack_mixed.argtypes = [P(i32), i64, ctypes.c_int32,
                                      P(i32), ctypes.c_int32, P(u32)]
    lib.fwn_vocab_create.restype = ctypes.c_void_p
    lib.fwn_vocab_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.fwn_vocab_destroy.argtypes = [ctypes.c_void_p]
    lib.fwn_vocab_encode2.restype = ctypes.c_int
    lib.fwn_vocab_encode2.argtypes = [ctypes.c_void_p, P(i32), i64,
                                      ctypes.c_int32, i64, ctypes.c_int32,
                                      u32, P(i32), P(i32), P(i32)]
    lib.fwn_counts_table.argtypes = [P(i32), P(u8), i64, i64,
                                     ctypes.c_int32, P(i32), P(u8)]
    lib.fwn_vocab_export.restype = i64
    lib.fwn_vocab_export.argtypes = [ctypes.c_void_p, ctypes.c_int32, i64,
                                     P(i32)]
    lib.fwn_vocab_col_size.restype = i64
    lib.fwn_vocab_col_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.fwn_vocab_col_direct.restype = ctypes.c_int
    lib.fwn_vocab_col_direct.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.fwn_vocab_dirty.restype = ctypes.c_int
    lib.fwn_vocab_dirty.argtypes = [ctypes.c_void_p]
    lib.fwn_vocab_clear_dirty.argtypes = [ctypes.c_void_p]
    lib.fwn_emit_fused.restype = ctypes.c_int
    lib.fwn_emit_fused.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, i64,  # ctx, vocab, start, count
        ctypes.c_int32, u32,                          # W_all, const_id
        P(i32), P(i32),                               # widths, tab_bases
        ctypes.c_int32, i64, ctypes.c_int32,          # words, tab_len, n_direct
        P(u32), P(u8), P(u8), P(u32),                 # ids, tab, direct, label
        P(i32), P(i32),                               # combo_row, const_code
        ctypes.c_int32, ctypes.c_int32,               # n_ffm_pad, ffm_bits
        ctypes.c_int32, ctypes.c_int32,               # ffm_words, ffm_shift
        P(u32), P(u8), P(i32),                        # ffm ids/counts/fields
    ]


def _configure_ffi(lib):
    i64, f32 = ctypes.c_int64, ctypes.c_float
    P = ctypes.POINTER
    lib.new_fw_predictor_prototype.restype = ctypes.c_void_p
    lib.new_fw_predictor_prototype.argtypes = [ctypes.c_char_p]
    lib.clone_lite.restype = ctypes.c_void_p
    lib.clone_lite.argtypes = [ctypes.c_void_p]
    lib.fw_predict.restype = ctypes.c_float
    lib.fw_predict.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.free_predictor.argtypes = [ctypes.c_void_p]
    lib.fw_ffi_last_error.restype = ctypes.c_char_p
    lib.fw_predict_block_mt.restype = i64
    lib.fw_predict_block_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64, P(f32), i64, P(i64),
        P(ctypes.c_int32), ctypes.c_int32,
    ]


class EmbeddedPredictor:
    """Python face of the embedded-inference C API (fw_ffi.cpp) — the
    equivalent of the reference's cdylib FfiPredictor (reference:
    src/lib.rs:151-252): the calls the port makes (the context cache and
    the serial ``predict_block`` wait for a caller). Raises with the
    compiler's message when the library cannot be built."""

    def __init__(self, command: str, _ptr=None, _proto=None):
        lib = require()
        if not hasattr(lib, "_ffi_configured"):
            _configure_ffi(lib)
            lib._ffi_configured = True
        self._lib = lib
        if _ptr is not None:
            self._ptr = _ptr
            self._proto = _proto  # keep the prototype alive
            return
        self._proto = None
        self._ptr = lib.new_fw_predictor_prototype(command.encode())
        if not self._ptr:
            raise RuntimeError(lib.fw_ffi_last_error().decode())

    def clone_lite(self) -> "EmbeddedPredictor":
        ptr = self._lib.clone_lite(self._ptr)
        return EmbeddedPredictor("", _ptr=ptr, _proto=self)

    def predict(self, line: str | bytes) -> float:
        if isinstance(line, str):
            line = line.encode()
        return float(self._lib.fw_predict(self._ptr, line))

    # bulk-predict block status codes (fw_ffi.cpp fw_predict_block)
    BLOCK_OK = 0
    BLOCK_EOF = 1        # empty line: end of stream
    BLOCK_FLUSH = 2      # in-band 'flush'
    BLOCK_HOGWILD = 3    # in-band 'hogwild_load'
    BLOCK_ERROR = 4      # parse error (message via last_error)

    def predict_block_mt(self, buf: bytes, threads: int | None = None):
        """Predict every complete VW line in ``buf``, sharded across host
        threads (fw_ffi.cpp predict_block_mt): weights shared, scratch per
        thread, output in line order, stopping before the first special
        line. Returns ``(preds float32[n], consumed_bytes, status)``; a
        trailing partial line is left for the caller to carry into the
        next chunk. The C side walks serially for small blocks or
        threads <= 1."""
        if threads is None:
            threads = max(1, min(8, (os.cpu_count() or 2) - 1))
        cap = self._lib.fwn_count_byte(buf, len(buf), 10) + 1
        out = np.empty(cap, np.float32)
        consumed = ctypes.c_int64()
        status = ctypes.c_int32()
        n = self._lib.fw_predict_block_mt(
            self._ptr, buf, len(buf),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
            ctypes.byref(consumed), ctypes.byref(status), threads)
        return out[:n], consumed.value, status.value

    def last_error(self) -> str:
        return self._lib.fw_ffi_last_error().decode()

    def close(self) -> None:
        if getattr(self, "_ptr", None):
            self._lib.free_predictor(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()


def format_preds(preds: np.ndarray) -> bytes | None:
    """'%.6f\\n' lines for a float32 vector; None if no native lib."""
    lib = load()
    if lib is None:
        return None
    preds = np.ascontiguousarray(preds, np.float32)
    buf = ctypes.create_string_buffer(16 * preds.size + 1)
    n = lib.fwn_format_preds(
        preds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), preds.size, buf
    )
    return ctypes.string_at(buf, n)


def bitpack_ids(a: np.ndarray, bits: int, words: int):
    """Bit-pack a non-negative [B, W] i32 id column to `bits` per entry
    ([B, words] u32). Returns the packed array, False when a value
    overflows `bits` (ship unpacked), or None if no native lib."""
    lib = load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.int32)
    out = np.empty((a.shape[0], words), np.uint32)
    ok = lib.fwn_bitpack_ids(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        a.shape[0], a.shape[1], bits, words,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out if ok else False


def bitpack_mixed(a: np.ndarray, bits, words: int):
    """Bit-pack a non-negative [B, W] i32 block with a per-column bit
    width (`bits`, len W) into [B, words] u32. Returns the packed array,
    False on value overflow, or None if no native lib."""
    lib = load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.int32)
    bits = np.ascontiguousarray(bits, np.int32)
    out = np.empty((a.shape[0], words), np.uint32)
    ok = lib.fwn_bitpack_mixed(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        a.shape[0], a.shape[1],
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), words,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out if ok else False


def counts_table(idx: np.ndarray, codes: np.ndarray, bases,
                 tab_len: int):
    """Build the vocabulary-shadow count table: a [tab_len] u8 array with
    ``tab[bases[j] + idx[b, j]] = codes[b, j]`` for dictionary columns
    (``bases[j] >= 0``). Returns the table, or None without the native
    lib. ``codes`` may be a column-sliced view."""
    lib = load()
    if lib is None:
        return None
    idx = np.ascontiguousarray(idx, np.int32)
    if codes.dtype != np.uint8 or codes.ndim != 2:
        codes = np.ascontiguousarray(codes, np.uint8)
    if codes.strides[1] != 1 or codes.strides[0] < codes.shape[1]:
        codes = np.ascontiguousarray(codes)
    bases = np.ascontiguousarray(bases, np.int32)
    tab = np.zeros(tab_len, np.uint8)
    lib.fwn_counts_table(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        codes.strides[0], idx.shape[0], idx.shape[1],
        bases.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tab.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return tab


class VocabEncoder:
    """Persistent per-column id→index dictionaries for the vocab-encoded
    packed transfer (train/packed.py encode_vocab_ids).

    ``encode2(raw, shift, mask)`` maps each column of a [B, W] i32 id
    block to dense first-seen indices (row-major assignment order —
    deterministic per stream); a column whose dictionary would exceed
    ``max_cap`` flips to direct permanently and passes raw (masked) ids
    through. ``sizes[j]`` is the dictionary size after the call, −1 once
    direct."""

    def __init__(self, n_cols: int, max_cap: int = 1 << 16):
        lib = require()
        self._lib = lib
        self._ptr = lib.fwn_vocab_create(n_cols, max_cap)
        self.n_cols = n_cols
        self.max_cap = max_cap

    def encode2(self, raw: np.ndarray, shift: int, mask: int):
        """Fused single-sweep encode: ``raw`` may carry combo+1 in the
        bits at/above ``shift`` (0 = pure ids). Returns
        (idx, sizes, combo_row) — combo_row only meaningful when
        shift > 0 — or None when the combo layout is not row-uniform.
        A column-sliced view (e.g. the constant-strip's ``ids[:, :-1]``)
        passes zero-copy via the row stride."""
        if raw.dtype != np.int32 or raw.ndim != 2:
            raw = np.ascontiguousarray(raw, np.int32)
        B, W = raw.shape
        if raw.strides[1] == 4 and raw.strides[0] % 4 == 0 \
                and raw.strides[0] >= 4 * W:
            stride = raw.strides[0] // 4
        else:
            raw = np.ascontiguousarray(raw)
            stride = W
        out = np.empty((B, W), np.int32)
        sizes = np.empty(W, np.int32)
        combo_row = np.empty(W, np.int32)
        p = ctypes.POINTER(ctypes.c_int32)
        ok = self._lib.fwn_vocab_encode2(
            self._ptr, raw.ctypes.data_as(p), B, W, stride, shift,
            ctypes.c_uint32(mask), out.ctypes.data_as(p),
            sizes.ctypes.data_as(p), combo_row.ctypes.data_as(p))
        return (out, sizes, combo_row) if ok else None

    def export_col(self, col: int, cap: int) -> np.ndarray:
        """First ``cap`` dictionary entries of column ``col`` — the write
        is capped C-side: the dictionary may have grown past the layout's
        snapshot region between layout and export (the producer encodes
        the NEXT batch before flushing the pending group), and indices
        >= cap cannot appear in the pending group's payload."""
        out = np.zeros(cap, np.int32)
        n = self._lib.fwn_vocab_export(
            self._ptr, col, cap,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out[:n]

    def col_size(self, col: int) -> int:
        """Entries minted so far in column ``col`` (retained across a
        direct flip); -1 when out of range."""
        return int(self._lib.fwn_vocab_col_size(self._ptr, col))

    def col_direct(self, col: int) -> bool:
        """Whether column ``col`` has overflowed to direct (raw ids)."""
        return self._lib.fwn_vocab_col_direct(self._ptr, col) == 1

    @property
    def dirty(self) -> bool:
        return bool(self._lib.fwn_vocab_dirty(self._ptr))

    def clear_dirty(self) -> None:
        self._lib.fwn_vocab_clear_dirty(self._ptr)

    def close(self):
        if self._ptr:
            self._lib.fwn_vocab_destroy(self._ptr)
            self._ptr = None

    def __del__(self):  # best-effort; close() is the real path
        try:
            self.close()
        except Exception:
            pass


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


class NativeIngest:
    """Text block → padded batch arrays, in C++.

    One instance per (vwmap, model config, thread count). Not thread-safe;
    use one per pipeline stage. Raises with the compiler's message when
    the library cannot be built: the training path has no other ingest to
    fall back to (``--fwt_no_native`` chooses the Python one).
    """

    def __init__(self, mi, vw, num_threads: int | None = None):
        from ..config.vwmap import NamespaceFormat, NamespaceType

        lib = require()
        self._lib = lib
        if num_threads is None:
            num_threads = max(1, min(8, (os.cpu_count() or 2) - 1))

        names, name_lens, ns_indices, ns_formats = b"", [], [], []
        for name, desc in vw.vwname_to_descriptor.items():
            names += name
            name_lens.append(len(name))
            ns_indices.append(desc.namespace_index)
            ns_formats.append(1 if desc.namespace_format == NamespaceFormat.F32 else 0)
        name_lens = np.asarray([len(name_lens)] + name_lens, np.int32)

        is_t = lambda d: 1 if d.namespace_type == NamespaceType.TRANSFORMED else 0  # noqa: E731
        combo_offsets, combo_ns, combo_ns_types, combo_weights = [0], [], [], []
        for combo in mi.feature_combo_descs:
            combo_ns.extend(d.namespace_index for d in combo.namespace_descriptors)
            combo_ns_types.extend(is_t(d) for d in combo.namespace_descriptors)
            combo_offsets.append(len(combo_ns))
            combo_weights.append(getattr(combo, "weight", 1.0))

        field_offsets, field_ns, field_ns_types = [0], [], []
        for f in mi.ffm_fields:
            field_ns.extend(d.namespace_index for d in f)
            field_ns_types.extend(is_t(d) for d in f)
            field_offsets.append(len(field_ns))

        # --transform statements in resolved dependency order
        _KINDS = {"BinnerSqrt": 0, "BinnerSqrtPlain": 1, "BinnerLog": 2,
                  "BinnerLogPlain": 3, "BinnerLogRatio": 4,
                  "BinnerLogRatioPlain": 5, "Weight": 6, "Combine": 7}
        t_kinds, t_p0, t_p1 = [], [], []
        t_from_offsets, t_from, t_from_types = [0], [], []
        if mi.transform_namespaces is not None:
            for t in mi.transform_namespaces.v:
                t_kinds.append(_KINDS[t.function_name])
                params = t.function_parameters
                t_p0.append(params[0] if len(params) >= 1 else 0.0)
                t_p1.append(params[1] if len(params) >= 2 else 1.0)
                for _name, d in t.from_namespaces:
                    t_from.append(d.namespace_index)
                    t_from_types.append(is_t(d))
                t_from_offsets.append(len(t_from))

        self._ctx = lib.fwn_create(
            vw.num_namespaces,
            names,
            _iptr(name_lens),
            _iptr(np.asarray(ns_indices, np.int32)),
            _iptr(np.asarray(ns_formats, np.int32)),
            int(vw.namespace_skip_prefix),
            len(mi.feature_combo_descs),
            _iptr(np.asarray(combo_offsets, np.int32)),
            _iptr(np.asarray(combo_ns, np.int32)),
            _iptr(np.asarray(combo_ns_types, np.int32)),
            np.asarray(combo_weights, np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)
            ),
            1 if mi.add_constant_feature else 0,
            np.uint32(mi.lr_hash_mask),
            np.uint32(mi.ffm_hash_mask if mi.ffm_k > 0 else 0),
            len(mi.ffm_fields) if mi.ffm_k > 0 else 0,
            _iptr(np.asarray(field_offsets, np.int32)),
            _iptr(np.asarray(field_ns, np.int32)),
            _iptr(np.asarray(field_ns_types, np.int32)),
            len(t_kinds),
            _iptr(np.asarray(t_kinds, np.int32)),
            np.asarray(t_p0, np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
            np.asarray(t_p1, np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
            _iptr(np.asarray(t_from_offsets, np.int32)),
            _iptr(np.asarray(t_from, np.int32)),
            _iptr(np.asarray(t_from_types, np.int32)),
            num_threads,
        )
        if not self._ctx:
            raise RuntimeError("fwn_create failed")

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.fwn_destroy(self._ctx)
            self._ctx = None

    def translate_block(self, text: bytes) -> int:
        """Parse+translate a block of newline-separated VW lines.

        In-band command lines are surfaced as the same exception classes
        the Python parser raises (the reference aborts a training run on
        them, src/main.rs:218-221)."""
        n = self._lib.fwn_translate_block(self._ctx, text, len(text))
        if n < 0:
            msg = self._lib.fwn_last_error(self._ctx).decode()
            from ..ingest.parser import FlushCommand, HogwildLoadCommand

            if '"flush" command' in msg:
                raise FlushCommand()
            if '"hogwild_load" command' in msg:
                raise HogwildLoadCommand("")
            raise ValueError(msg)
        return int(n)

    def translate_records(self, records: np.ndarray) -> int:
        """Translate packed u32 records (the cache read path)."""
        records = np.ascontiguousarray(records, np.uint32)
        n = self._lib.fwn_translate_records(
            self._ctx, records.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            records.size)
        if n < 0:
            raise ValueError(self._lib.fwn_last_error(self._ctx).decode())
        return int(n)

    def records_consumed(self) -> int:
        """Words consumed by the last translate_records (a partial trailing
        record is left for the caller to carry over)."""
        return int(self._lib.fwn_records_consumed(self._ctx))

    def records(self) -> np.ndarray:
        """Packed u32 records of the last translated block (cache writing)."""
        n = self._lib.fwn_records_len(self._ctx)
        out = np.empty(int(n), np.uint32)
        if n:
            self._lib.fwn_records_copy(
                self._ctx, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return out

    def stop_offset(self) -> int:
        """Byte offset of the empty line (= end-of-stream, reference
        src/main.rs:215-222) that ended the last translate_block, or -1.
        Detected during the parse walk — callers stop reading further input
        instead of pre-scanning each chunk for "\\n\\n" patterns."""
        return int(self._lib.fwn_stop_offset(self._ctx))

    def set_build_records(self, on: bool) -> None:
        """Disable packed-record accumulation when no cache is written."""
        self._lib.fwn_set_build_records(self._ctx, 1 if on else 0)

    def all_ones_flags(self) -> int:
        """bit0: all LR values 1.0; bit1: all FFM values 1.0; bit2: all
        importances 1.0 — arrays the device can reconstruct (ones) instead of
        transferring."""
        return int(self._lib.fwn_all_ones(self._ctx))

    def widths(self) -> tuple[int, int]:
        return int(self._lib.fwn_lr_max(self._ctx)), int(self._lib.fwn_ffm_max(self._ctx))

    def fill_range(self, start: int, count: int, B: int, L: int, N: int):
        """Batch dict for examples [start, start+count) of the last block."""
        i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
        f32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa: E731
        label = np.zeros(B, np.float32)
        importance = np.zeros(B, np.float32)
        lr_ids = np.zeros((B, L), np.int32)
        lr_vals = np.zeros((B, L), np.float32)
        # combo/field indices are tiny (< 128) — int8 keeps host→device
        # transfer bytes down. Padding slots get -1: a combo or field of -1
        # adds nothing, so padding is inert even when the values array is
        # elided (see fwn_all_ones)
        lr_combos = np.full((B, L), -1, np.int8)
        ffm_ids = np.zeros((B, N), np.int32)
        ffm_vals = np.zeros((B, N), np.float32)
        ffm_fields = np.full((B, N), -1, np.int8)
        i8p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))  # noqa: E731
        self._lib.fwn_fill_range(
            self._ctx, start, count, B, L, N, f32p(label), f32p(importance),
            i32p(lr_ids), f32p(lr_vals), i8p(lr_combos), i32p(ffm_ids),
            f32p(ffm_vals), i8p(ffm_fields),
        )
        return {
            "label": label, "importance": importance,
            "lr_ids": lr_ids, "lr_vals": lr_vals, "lr_combos": lr_combos,
            "ffm_ids": ffm_ids, "ffm_vals": ffm_vals, "ffm_fields": ffm_fields,
        }

    def carry_tail(self, consumed: int) -> None:
        """Keep examples [consumed, n) of the last translated block for
        the NEXT translate call (they re-appear at index 0): the stream
        emits only full batches mid-stream and carries the remainder, so
        batch boundaries don't depend on the chunk size."""
        self._lib.fwn_carry_tail(self._ctx, consumed)

    def batch_counts(self, ids: np.ndarray, mark: np.ndarray,
                     shift: int = 0,
                     vals: np.ndarray | None = None) -> np.ndarray:
        """Per-entry multiplicity of (id >> shift) over the whole batch as
        8-bit soft-float codes (exact to 15, rounded UP within 12.5% above;
        decode with ops.adagrad.decode_counts), 0 on padding slots
        (mark < 0) — the host side of the batch-mean cap.

        ``vals``: optional per-entry feature values; entries with value 0
        are excluded (zero gradient → not 'touched'), matching the Python
        path (train/loop.py np_counts). Pass None when the values are known
        all-ones."""
        if ids.dtype != np.int32 or mark.dtype != np.int8:
            raise TypeError("batch_counts takes i32 ids and i8 marks")
        if ids.size >= (1 << 28):  # entry index packed in 28 bits
            raise ValueError("batch_counts takes fewer than 2^28 entries")
        if vals is not None and (vals.dtype != np.float32 or vals.size != ids.size):
            raise TypeError("batch_counts takes f32 values of the ids' size")
        out = np.zeros(ids.shape, np.uint8)
        self._lib.fwn_batch_counts(
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mark.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            None if vals is None
            else vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ids.size, shift,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out

    def emit_fused(self, venc, start: int, count: int, W_all: int,
                   const_id: int, widths: np.ndarray, tab_bases,
                   words: int, tab_len: int, n_direct: int,
                   out_ids, out_tab, out_direct, out_label,
                   combo_row: np.ndarray, const_code: np.ndarray,
                   n_ffm_pad: int = 0, ffm_bits: int = 0,
                   ffm_words: int = 0, ffm_shift: int = -1,
                   out_ffm_ids=None, out_ffm_counts=None,
                   ffm_field_row=None) -> bool:
        """One-sweep steady-state emit of examples [start, start+count) of
        the last translated block straight to the packed wire arrays (see
        fw_native.cpp fwn_emit_fused for the full contract). The out_*
        arguments are 1-D u32/u8 SLICES of the caller's buffers (typically
        views into one packed row); ``tab_len < 0`` disables LR counts,
        ``n_ffm_pad > 0`` adds the FFM columns (``ffm_shift < 0``: no FFM
        counts). Returns False on bail — the caller must use the general
        path."""
        Pu8 = ctypes.POINTER(ctypes.c_uint8)
        Pu32 = ctypes.POINTER(ctypes.c_uint32)
        Pi32 = ctypes.POINTER(ctypes.c_int32)
        ok = self._lib.fwn_emit_fused(
            self._ctx, venc._ptr, start, count, W_all,
            ctypes.c_uint32(const_id),
            widths.ctypes.data_as(Pi32),
            None if tab_bases is None else tab_bases.ctypes.data_as(Pi32),
            words, tab_len, n_direct,
            out_ids.ctypes.data_as(Pu32),
            None if out_tab is None else out_tab.ctypes.data_as(Pu8),
            None if out_direct is None else out_direct.ctypes.data_as(Pu8),
            out_label.ctypes.data_as(Pu32),
            combo_row.ctypes.data_as(Pi32),
            const_code.ctypes.data_as(Pi32),
            n_ffm_pad, ffm_bits, ffm_words, ffm_shift,
            None if out_ffm_ids is None else out_ffm_ids.ctypes.data_as(Pu32),
            None if out_ffm_counts is None
            else out_ffm_counts.ctypes.data_as(Pu8),
            None if ffm_field_row is None
            else ffm_field_row.ctypes.data_as(Pi32))
        return bool(ok)
