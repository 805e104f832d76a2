"""Build and bind the port's CUDA kernels.

Each ``*.cu`` file under ``fwumious_wabbit_tpu_torch/csrc/`` is compiled
with ``nvcc`` for Hopper (``sm_90a``) into a shared library of its own with
a plain C interface, loaded with ``ctypes``. A library is built on first use
into ``fwumious_wabbit_tpu_torch/build/`` (listed in ``.gitignore``) and
named by a hash of its source and the flags, so an edited source is never
served by a stale build. The first :func:`load` of an unbuilt library
starts one ``nvcc`` per unbuilt source, all at once. Only sources in this
repository are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# no --use_fast_math: it would flush denormal accumulators to zero, which
# the CPU path does not do
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points of csrc/*.cu and their argument types
_SIGNATURES = {
    "fwt_ffm_fused": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "fwt_ffm_fused_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "fwt_ffm_fused_warp_lanes": [_I, _I, _I],
    "fwt_sparse_adagrad_update": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _F, _F, _P],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log = ""  # nvcc's output of the builds so far (ptxas register report)
build_seconds = 0.0  # wall time of the last build; 0.0 when it was cached


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _build(srcs: list[Path]) -> None:
    """Compile ``srcs``, one ``nvcc`` each, all started together."""
    global build_log, build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in srcs:
        so = _library_path(src)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((proc, cmd, tmp, so))
    failed = []
    for proc, cmd, tmp, so in jobs:
        out, _ = proc.communicate()
        build_log += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def _open(src: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_library_path(src)))
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
    lib.fwt_cuda_error_string.argtypes = [_I]
    lib.fwt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``. When it is not built yet, every
    source without a library is built, in parallel. Raises if one cannot be
    built: there is no fallback."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(f"no kernel source {src}")
        if not _library_path(src).exists():
            _build([s for s in sources() if not _library_path(s).exists()])
        lib = _libs[name] = _open(src)
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if rc != 0:
        msg = lib.fwt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")
