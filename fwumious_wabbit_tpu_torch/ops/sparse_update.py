"""The sparse AdaGrad row update — the counterpart of
fwumious_wabbit_tpu/ops/pallas/sparse_update.py::sparse_adagrad_update.

:func:`sparse_adagrad_update` updates a ``[R, 128]`` f32 table ``w`` and its
accumulator ``acc`` in place from K gradient rows: per weight
``acc += Σg²``, then ``w −= rate(acc_new)·Σg`` (``w −= lr·Σg`` for SGD, which
has no ``acc``), the rate by the LUT or the flex rule of ops/adagrad.py.

On a CUDA tensor it sorts the row ids (``torch.sort``, stable, as the JAX
wrapper sorts outside its ``pallas_call``), allocates the kernel's scratch,
takes the LUT from the device-table cache (ops/adagrad.device_lut) and
launches the hand-written kernel in ``csrc/sparse_update.cu``: a segmented
sum over tiles of :data:`TILE` sorted positions, in two launches, which
touches only the rows in ``rid``. It raises on any failure; there is no
fallback. On a CPU tensor it runs the plain version,
ops/adagrad.apply_rows_plain.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import adagrad
from .kernels import build
from .tables import LANE

LAUNCHES = 0  # kernel launches made by sparse_adagrad_update (CUDA tensors only)
# sorted positions per block of the kernel's first pass: kTile in
# csrc/sparse_update.cu, which refuses any other value; it sizes the scratch
TILE = 64
_count_lock = threading.Lock()


def _check(w, acc, rid, grows, kind) -> None:
    if w.dim() != 2 or w.shape[1] != LANE:
        raise ValueError(f"w must be [R, {LANE}], got {tuple(w.shape)}")
    if kind not in (adagrad.OPT_SGD, adagrad.OPT_ADAGRAD_FLEX,
                    adagrad.OPT_ADAGRAD_LUT):
        raise ValueError(f"unknown optimizer kind {kind}")
    if (acc is None) != (kind == adagrad.OPT_SGD):
        raise ValueError("acc must be given for AdaGrad and None for SGD")
    if acc is not None and acc.shape != w.shape:
        raise ValueError(f"acc must be shaped like w {tuple(w.shape)}, got "
                         f"{tuple(acc.shape)}")
    K = rid.shape[0]
    if rid.dim() != 1 or tuple(grows.shape) != (K, LANE):
        raise ValueError(f"rid must be [K] and grows [K, {LANE}], got "
                         f"{tuple(rid.shape)} and {tuple(grows.shape)}")
    tensors = [w, grows] + ([acc] if acc is not None else [])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("w, acc and grows must be float32")
    if rid.dtype != torch.int32:
        raise TypeError("rid must be int32")
    if any(t.device != w.device for t in tensors + [rid]):
        raise ValueError("w, acc, rid and grows must be on one device")
    if not all(t.is_contiguous() for t in tensors + [rid]):
        raise ValueError("w, acc, rid and grows must be contiguous")
    if w.shape[0] >= 1 << 31:
        raise ValueError("the table has more rows than an int32 id addresses")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("w, acc and grows must be 16-byte aligned (the "
                         "kernel copies rows in 16-byte pieces)")


def sparse_adagrad_update(w: torch.Tensor, acc: torch.Tensor | None,
                          rid: torch.Tensor, grows: torch.Tensor, lr: float,
                          power_t: float, iag: float,
                          kind: int = adagrad.OPT_ADAGRAD_LUT):
    """Update ``w`` (and ``acc``) in place from ``rid [K]`` i32 row ids
    (repeats allowed; an id ≥ R is padding) and ``grows [K, 128]`` f32.
    Returns ``(w, acc)``."""
    if w.device.type == "cpu":
        return adagrad.apply_rows_plain(w, acc, rid, grows, kind, lr,
                                        power_t, iag)
    if w.device.type != "cuda":
        raise ValueError(f"sparse_adagrad_update runs on CUDA or CPU tensors, "
                         f"not {w.device.type}")
    _check(w, acc, rid, grows, kind)
    if w.device.index != torch.cuda.current_device():
        raise ValueError(f"sparse_adagrad_update launches on the current "
                         f"device cuda:{torch.cuda.current_device()}, not "
                         f"{w.device}")
    global LAUNCHES
    K = rid.shape[0]
    if K == 0:
        return w, acc
    rs, order = torch.sort(rid, stable=True)
    lut = (adagrad.device_lut(lr, power_t, iag, w.device)
           if kind == adagrad.OPT_ADAGRAD_LUT else None)
    scratch = torch.empty((-(-K // TILE), 2, 2, LANE), dtype=torch.float32,
                          device=w.device)
    lib = build.load("sparse_update")
    stream = torch.cuda.current_stream(w.device).cuda_stream
    rc = lib.fwt_sparse_adagrad_update(
        w.data_ptr(), acc.data_ptr() if acc is not None else None,
        rs.data_ptr(), order.data_ptr(), grows.data_ptr(),
        lut.data_ptr() if lut is not None else None, scratch.data_ptr(),
        w.shape[0], K, TILE, kind, ctypes.c_float(lr),
        ctypes.c_float(power_t), stream)
    build.check(lib, rc, "sparse_adagrad_update")
    with _count_lock:
        LAUNCHES += 1
    return w, acc
