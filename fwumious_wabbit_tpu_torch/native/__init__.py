"""ctypes bindings for the port's copy of the C++ host engine
(``fw_core.h``, ``fw_native.cpp``, ``fw_ffi.cpp`` in this directory, the
same sources as the JAX package's ``native/``).

The port's own copy of part of fwumious_wabbit_tpu/native/__init__.py: the
loader, :class:`EmbeddedPredictor` (the embedded-inference C API, reference:
src/lib.rs:151-252) and :func:`format_preds`; ``persistence/quantization.py``
binds its F16C helpers on the library :func:`load` returns. ``NativeIngest``,
``VocabEncoder`` and the bit-packers wait for the C++-ingest slice.

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


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(_cpu_key())
    for name in (*SOURCES, "fw_core.h"):
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    return BUILD_DIR / f"libfw_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile the library to a temporary name and rename it into place,
    holding a file lock so concurrent processes build it once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libfw_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp),
               *(str(_DIR / s) for s in SOURCES)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({r.returncode}): {' '.join(cmd)}\n"
                               f"{r.stderr}")
        os.replace(tmp, so)


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
                _build(so)
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
    i64 = ctypes.c_int64
    P = ctypes.POINTER
    lib.fwn_count_byte.restype = i64
    lib.fwn_count_byte.argtypes = [ctypes.c_char_p, i64, ctypes.c_int]
    lib.fwn_format_preds.restype = i64
    lib.fwn_format_preds.argtypes = [P(ctypes.c_float), i64, ctypes.c_char_p]


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
