"""The plain reference's feature ids, worked out from the Eat-Rate columns
through the strings the VW text holds.

The hashing follows the reference engine's contract (fwumious_wabbit
``src/parser.rs``, ``src/feature_buffer.rs``): a feature's hash is
MurmurHash3 x86_32 of its bytes, seeded with the MurmurHash3 of its
namespace's name and cut to 31 bits; an interaction chains
``h_next = h_from ^ (h_acc · 16777619)`` on 32 bits; the constant feature
is 11650396; LR ids keep the low ``bit_precision`` bits, FFM ids the low
``ffm_bit_precision`` bits with the ``ceil(log2 k)`` lowest cleared. This
file is its own, frozen implementation: it imports nothing of the program.

Each distinct string is hashed once (about 104,000 of them), and the rows'
ids are gathered from those tables by the columns' indices.
"""

from __future__ import annotations

import numpy as np

from . import eatrate

FNV_PRIME = 16777619
CONSTANT_HASH = 11650396
_M32 = np.uint64(0xFFFFFFFF)


def murmur3_32(strings: list[bytes], seed: int) -> np.ndarray:
    """MurmurHash3 x86_32 of each byte string with ``seed``, vectorised
    over the strings: ``[len(strings)]`` u32."""
    n = len(strings)
    lens = np.array([len(s) for s in strings], np.int64)
    width = int(-(-max(lens.max(), 1) // 4) * 4)
    buf = np.frombuffer(b"".join(s.ljust(width, b"\0") for s in strings),
                        np.uint8).reshape(n, width).astype(np.uint64)
    words = (buf[:, 0::4] | (buf[:, 1::4] << np.uint64(8))
             | (buf[:, 2::4] << np.uint64(16)) | (buf[:, 3::4] << np.uint64(24)))
    c1, c2 = np.uint64(0xCC9E2D51), np.uint64(0x1B873593)

    def rotl(x, r):
        return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _M32

    def mix(k):
        return (rotl((k * c1) & _M32, 15) * c2) & _M32

    h = np.full(n, seed & 0xFFFFFFFF, np.uint64)
    nblocks = lens // 4
    for i in range(words.shape[1]):
        hh = rotl(h ^ mix(words[:, i]), 13)
        hh = (hh * np.uint64(5) + np.uint64(0xE6546B64)) & _M32
        h = np.where(nblocks > i, hh, h)
    tail = lens - nblocks * 4
    rows = np.arange(n)
    k = np.zeros(n, np.uint64)
    for t in (3, 2, 1):
        has = tail >= t
        k[has] ^= buf[rows[has], nblocks[has] * 4 + t - 1] << np.uint64(8 * (t - 1))
    h = np.where(tail > 0, h ^ mix(k), h)
    h ^= lens.astype(np.uint64)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & _M32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & _M32
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32)


def namespace_hashes(feature_variety: int, num_random: int) -> dict:
    """Per namespace, the 31-bit hash of each of its feature strings, in
    the order of :func:`eatrate.tokens`."""
    out = {}
    for ns, strings in eatrate.tokens(feature_variety, num_random).items():
        seed = int(murmur3_32([ns.encode()], 0)[0])
        out[ns] = murmur3_32([s.encode() for s in strings], seed) & np.uint32(0x7FFFFFFF)
    return out


class Ids:
    """The LR and FFM ids of the configuration ``cfg`` (its ``model``
    group), for the columns of :func:`eatrate.draw`."""

    def __init__(self, model: dict, feature_variety: int, num_random: int):
        self.model = model
        self.hashes = namespace_hashes(feature_variety, num_random)
        self.lr_mask = (1 << model["bit_precision"]) - 1
        if model["ffm_fields"]:
            dim_bits = max(0, (model["ffm_k"] - 1).bit_length())
            self.ffm_mask = ((1 << model["ffm_bit_precision"]) - 1) ^ ((1 << dim_bits) - 1)

    def _ns(self, cols: dict, ns: str) -> np.ndarray:
        h = self.hashes[ns]
        if ns == "A":
            return h[cols["a"]]
        if ns == "B":
            return h[cols["b"]]
        return h[cols["rand"][:, ord(ns) - ord("C")]]

    def lr(self, cols: dict) -> np.ndarray:
        """``[n, combos]`` i64: one id per combo, in the order the combos
        are declared (``keep``, then ``interactions``, then the constant).
        In this schema every namespace holds exactly one feature of value
        1, so every combo has exactly one feature."""
        out = []
        for combo in self.model["lr_combos"]:
            acc = self._ns(cols, combo[0]).astype(np.uint64)
            for ns in combo[1:]:
                acc = self._ns(cols, ns).astype(np.uint64) ^ (
                    (acc * np.uint64(FNV_PRIME)) & _M32)
            out.append(acc & np.uint64(self.lr_mask))
        if self.model["constant"]:
            out.append(np.full(len(cols["label"]), CONSTANT_HASH & self.lr_mask,
                               np.uint64))
        return np.stack(out, axis=1).astype(np.int64)

    def ffm(self, cols: dict) -> np.ndarray:
        """``[n, fields]`` i64: each field's one feature id (``[n, 0]``
        where the model has no FFM)."""
        if not self.model["ffm_fields"]:
            return np.zeros((len(cols["label"]), 0), np.int64)
        return np.stack([self._ns(cols, field).astype(np.int64) & self.ffm_mask
                         for field in self.model["ffm_fields"]], axis=1)
