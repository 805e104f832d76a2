"""Bit-exact hashing primitives shared by the whole framework.

These reproduce the reference engine's hashing contract exactly:

* ``murmur3_32`` — MurmurHash3 x86_32. The reference hashes feature bytes with
  murmur3 seeded by the murmur3 of the namespace name
  (reference: src/parser.rs:79-88,382-385).
* ``fnv_combine`` — Vowpal-Wabbit-compatible interaction hash chaining
  ``h_next = h_from ^ (h_acc * FNV_PRIME)`` (reference:
  src/feature_buffer.rs:6,241-258).
* ``merand48`` — the 48-bit LCG used for FFM weight initialization
  (reference: src/block_ffm.rs:799-821, via the ``merand48`` crate which
  mirrors Vowpal Wabbit's ``merand48``).

Both scalar (pure Python) and vectorized (NumPy) variants are provided; the
NumPy variants are used by the host ingest pipeline, and a C++ implementation
(fwumious_wabbit_tpu/native) supersedes them on the hot path when built.

The port's own copy of fwumious_wabbit_tpu/hashing.py, the same in
behaviour; it imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

MASK32 = 0xFFFFFFFF

IS_NOT_SINGLE_MASK = 1 << 31
MASK31 = IS_NOT_SINGLE_MASK - 1

# Vowpal magic numbers (reference: src/feature_buffer.rs:6-8)
VOWPAL_FNV_PRIME = 16777619
CONSTANT_HASH = 11650396


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & MASK32


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 of ``data`` with ``seed``; returns unsigned 32-bit."""
    c1 = 0xCC9E2D51
    c2 = 0x1B873593
    h = seed & MASK32
    n = len(data)
    nblocks = n // 4

    for i in range(nblocks):
        k = int.from_bytes(data[4 * i : 4 * i + 4], "little")
        k = (k * c1) & MASK32
        k = _rotl32(k, 15)
        k = (k * c2) & MASK32
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & MASK32

    # tail
    k = 0
    tail = data[nblocks * 4 :]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & MASK32
        k = _rotl32(k, 15)
        k = (k * c2) & MASK32
        h ^= k

    # finalization
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MASK32
    h ^= h >> 16
    return h


def namespace_seed(vwname: bytes | str) -> int:
    """Seed used for hashing features of a namespace: murmur3 of its vw name
    (reference: src/parser.rs:82-88)."""
    if isinstance(vwname, str):
        vwname = vwname.encode()
    return murmur3_32(vwname, 0)


def feature_hash(feature: bytes | str, seed: int) -> int:
    """31-bit feature hash as emitted by the parser (reference:
    src/parser.rs:382-385)."""
    if isinstance(feature, str):
        feature = feature.encode()
    return murmur3_32(feature, seed) & MASK31


def fnv_combine(h_acc, h_from):
    """VW interaction chaining: ``h_from ^ (h_acc * FNV_PRIME)`` on u32.

    Works on Python ints and NumPy uint32 arrays alike (reference:
    src/feature_buffer.rs:241-258).
    """
    if isinstance(h_acc, np.ndarray) or isinstance(h_from, np.ndarray):
        half = (np.asarray(h_acc, dtype=np.uint32) * np.uint32(VOWPAL_FNV_PRIME)).astype(
            np.uint32
        )
        return np.asarray(h_from, dtype=np.uint32) ^ half
    return (h_from ^ ((h_acc * VOWPAL_FNV_PRIME) & MASK32)) & MASK32


# ---------------------------------------------------------------------------
# merand48 — deterministic FFM init (VW-compatible 48-bit LCG)
# ---------------------------------------------------------------------------

_MERAND_A = 0xECE66D5DEECE66D * 16 + 0xD  # 0xeece66d5deece66d
_MERAND_A = 0xEECE66D5DEECE66D
_MERAND_C = 2147483647
_MASK64 = (1 << 64) - 1


def merand48(x: int) -> float:
    """One draw of the reference's ``merand48(x)`` in [0, 1).

    state = A*x + C (mod 2^64); mantissa = bits 25..47; value =
    float(bits | 127<<23) - 1.0 (reference: src/block_ffm.rs:799-821 via the
    ``merand48`` crate, which mirrors VW's merand48).
    """
    state = (_MERAND_A * (x & _MASK64) + _MERAND_C) & _MASK64
    bits = ((state >> 25) & 0x7FFFFF) | (127 << 23)
    return float(np.uint32(bits).view(np.float32)) - 1.0


def merand48_array(indices: np.ndarray) -> np.ndarray:
    """Vectorized ``merand48`` over an int64/uint64 index array → float32."""
    x = np.asarray(indices, dtype=np.uint64)
    state = (np.uint64(_MERAND_A) * x + np.uint64(_MERAND_C)) & np.uint64(_MASK64)
    bits = ((state >> np.uint64(25)) & np.uint64(0x7FFFFF)).astype(np.uint32) | np.uint32(
        127 << 23
    )
    return bits.view(np.float32) - np.float32(1.0)


# ---------------------------------------------------------------------------
# Vectorized murmur3 over fixed-width byte matrices (host pipeline fast path)
# ---------------------------------------------------------------------------


def murmur3_32_batch(data: np.ndarray, lengths: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """murmur3_32 of many byte strings at once.

    ``data`` is [N, Wmax] uint8 (zero-padded rows), ``lengths`` [N], ``seeds``
    [N] uint32. Returns [N] uint32. Used by the NumPy ingest fallback; the C++
    parser is the production path.
    """
    data = np.asarray(data, dtype=np.uint8)
    n, wmax = data.shape
    lengths = np.asarray(lengths, dtype=np.int64)
    h = np.asarray(seeds, dtype=np.uint32).copy()
    c1 = np.uint32(0xCC9E2D51)
    c2 = np.uint32(0x1B873593)

    max_blocks = wmax // 4
    data32 = np.zeros((n, max_blocks), dtype=np.uint32)
    if max_blocks:
        usable = data[:, : max_blocks * 4].reshape(n, max_blocks, 4).astype(np.uint32)
        data32 = (
            usable[..., 0]
            | (usable[..., 1] << np.uint32(8))
            | (usable[..., 2] << np.uint32(16))
            | (usable[..., 3] << np.uint32(24))
        )

    nblocks = lengths // 4
    with np.errstate(over="ignore"):
        for i in range(max_blocks):
            active = nblocks > i
            k = (data32[:, i] * c1) & np.uint32(MASK32)
            k = ((k << np.uint32(15)) | (k >> np.uint32(17))) & np.uint32(MASK32)
            k = (k * c2) & np.uint32(MASK32)
            hh = h ^ k
            hh = ((hh << np.uint32(13)) | (hh >> np.uint32(19))) & np.uint32(MASK32)
            hh = (hh * np.uint32(5) + np.uint32(0xE6546B64)) & np.uint32(MASK32)
            h = np.where(active, hh, h)

        # tails
        tail_start = (nblocks * 4).astype(np.int64)
        tail_len = lengths - tail_start
        k = np.zeros(n, dtype=np.uint32)
        idx = np.arange(n)
        for tl, shift in ((3, 16), (2, 8)):
            m = tail_len >= tl
            if m.any():
                k[m] ^= data[idx[m], tail_start[m] + (tl - 1)].astype(np.uint32) << np.uint32(
                    shift
                )
        m = tail_len >= 1
        if m.any():
            k[m] ^= data[idx[m], tail_start[m]].astype(np.uint32)
            kk = (k[m] * c1) & np.uint32(MASK32)
            kk = ((kk << np.uint32(15)) | (kk >> np.uint32(17))) & np.uint32(MASK32)
            kk = (kk * c2) & np.uint32(MASK32)
            h[m] ^= kk

        h ^= lengths.astype(np.uint32)
        h ^= h >> np.uint32(16)
        h = (h * np.uint32(0x85EBCA6B)) & np.uint32(MASK32)
        h ^= h >> np.uint32(13)
        h = (h * np.uint32(0xC2B2AE35)) & np.uint32(MASK32)
        h ^= h >> np.uint32(16)
    return h
