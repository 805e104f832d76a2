"""FFM-weight 16-bit quantization for inference export.

Same on-disk format as the reference (reference: src/quantization.rs:41-95):
an 8-byte header (f32 weight_increment LE, f32 min LE) followed by one f16
per weight holding the *bucket index* ``round((w − min) / increment)``.
65025 buckets over the [min, max] range; min/max are rounded to 1e-4; a
|mean| > 10 triggers the exploded-weights warning.

The port's own copy of fwumious_wabbit_tpu/persistence/quantization.py, the
same in behaviour; it imports nothing of that package.
"""

from __future__ import annotations

import logging

import numpy as np

NUM_BUCKETS = 65025.0
CRITICAL_WEIGHT_BOUND = 10.0
MEAN_SAMPLING_RATIO = 10
PREC = 10_000.0

log = logging.getLogger(__name__)


def weight_statistics(weights: np.ndarray):
    w = np.asarray(weights, np.float32)
    mn = np.float32(np.round(w.min() * PREC) / PREC)
    mx = np.float32(np.round(w.max() * PREC) / PREC)
    mean = np.float32(w[::MEAN_SAMPLING_RATIO].mean())
    return mn, mx, mean


def _native_lib():
    """The C++ engine's F16C conversion kernels — numpy's f16↔f32 astype is
    a scalar loop (~450 ms for 10M weights, above the reference's 300 ms
    perf gate, src/quantization.rs:162-175); F16C converts 8 lanes per
    instruction with the same IEEE nearest-even rounding (bit-identical
    output, asserted in tests)."""
    try:
        import ctypes

        from .. import native

        lib = native.load()
        if lib is None:
            return None
        if not hasattr(lib, "_quant_configured"):
            u16p = ctypes.POINTER(ctypes.c_uint16)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.fwn_quantize_buckets.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, u16p]
            lib.fwn_dequantize_f16.argtypes = [
                u16p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, f32p]
            lib._quant_configured = True
        return lib
    except Exception:  # noqa: BLE001
        return None


def quantize_ffm_weights(weights: np.ndarray) -> bytes:
    """→ bytes: 8-byte header + len(weights) f16 bucket indices."""
    import ctypes

    w = np.ascontiguousarray(weights, np.float32)
    mn, mx, mean = weight_statistics(w)
    increment = np.float32((mx - mn) / np.float32(NUM_BUCKETS))
    if abs(float(mean)) > CRITICAL_WEIGHT_BOUND:
        log.warning(
            "Identified a very skewed weight distribution indicating exploded weights,"
            " not serving that! Mean weight value: %s", mean,
        )
    header = np.array([increment, mn], np.float32).tobytes()
    lib = _native_lib()
    if lib is not None and float(increment) != 0.0:
        out = np.empty(w.size, np.uint16)
        lib.fwn_quantize_buckets(
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w.size,
            ctypes.c_float(float(mn)), ctypes.c_float(float(increment)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        )
        return header + out.tobytes()
    with np.errstate(all="ignore"):
        intervals = np.round((w - mn) / increment).astype(np.float16)
    return header + intervals.tobytes()


def dequantize_ffm_weights(data: bytes, n: int) -> np.ndarray:
    """Inverse of :func:`quantize_ffm_weights` for ``n`` weights."""
    import ctypes

    header = np.frombuffer(data[:8], np.float32)
    increment, mn = np.float32(header[0]), np.float32(header[1])
    lib = _native_lib()
    if lib is not None:
        buf = np.frombuffer(data[8 : 8 + 2 * n], np.uint16)
        buf = np.ascontiguousarray(buf)
        out = np.empty(n, np.float32)
        lib.fwn_dequantize_f16(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n,
            ctypes.c_float(float(mn)), ctypes.c_float(float(increment)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out
    intervals = np.frombuffer(data[8 : 8 + 2 * n], np.float16).astype(np.float32)
    return mn + intervals * increment


def quantized_size(n: int) -> int:
    return 8 + 2 * n
