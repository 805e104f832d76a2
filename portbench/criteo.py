"""A Criteo-like click log for the 39-field FFM, drawn from a seed and
rendered as VW text in bulk.

The shape is that of the Criteo Display Advertising Challenge (Kaggle) as
libffm's winning preprocessing fed it to the FFM (Juan et al., RecSys
2016): a label and 39 fields, 13 integer (I1..I13, binned, standing in
for ``⌊log²v⌋``) and 26 categorical (C1..C26, hashed 32-bit values
written as 8 hex digits), one feature of value 1 in every field of every
line; a missing value is its field's own token (rank 0 below), so every
line has all 39 fields.

The program's flags take a namespace as one character (``--keep``,
``--ffm_field``), so the fields are the namespaces ``a``..``m`` (I1..I13)
and ``A``..``Z`` (C1..C26); the namespace map names each by its Criteo
name.

The draws: each categorical field's value is a rank in ``[0, card)``,
``card`` the field's number of distinct values in the Kaggle set (the
DLRM benchmark's Kaggle embedding sizes, :data:`CAT_CARD`), drawn from a
truncated power law with exponent :data:`ZIPF` (the continuous inverse
CDF, floored); each integer field's a rank in ``[0, INT_BINS)`` from the
same law. A rank's token is a fixed bijective mix of (field, rank), so
distinct ranks are distinct strings. The label is a seeded planted
logistic rule: a weight per token, a few field-pair products, and a bias
set so that the positives' expected share is :data:`POSITIVE_SHARE`.

As a configuration's data schema (spec.py) it gives :func:`columns`,
:func:`write_text` and :func:`ids`, each reading only the traffic's
``lines``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import features

CHUNK = 200_000
INT_NAMES = [f"I{i}" for i in range(1, 14)]
CAT_NAMES = [f"C{i}" for i in range(1, 27)]
# the namespace of each field, in the order I1..I13, C1..C26
NAMESPACES = [chr(ord("a") + i) for i in range(13)] + [chr(ord("A") + i) for i in range(26)]
FIELDS = len(NAMESPACES)
# distinct values of C1..C26 in the Kaggle set (DLRM's Kaggle embedding sizes)
CAT_CARD = [1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683, 8351593,
            3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15, 286181, 105,
            142572]
INT_BINS = 64  # values of a binned integer field, its missing token included
CARD = [INT_BINS] * 13 + CAT_CARD
ZIPF = 1.05  # the power law's exponent: P(rank r) ∝ (r + 1)^-ZIPF
POSITIVE_SHARE = 0.256  # the Kaggle set's share of clicks
WEIGHT_SCALE = 0.6  # a token's planted weight is uniform in ±WEIGHT_SCALE
# the planted field pairs (I1·C1 … ), each a product of two ±PAIR_SCALE signs
PAIRS = [(0, 13), (2, 15), (13, 21), (14, 29), (18, 33), (5, 24)]
PAIR_SCALE = 0.4
NAMESPACE_MAP = "vw_namespace_map.csv"
_M32 = np.uint64(0xFFFFFFFF)
_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


def _fmix32(h: np.ndarray) -> np.ndarray:
    """MurmurHash3's 32-bit finalizer on u64 holding u32 values: a
    bijection of 32-bit values."""
    h = h & _M32
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & _M32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & _M32
    h ^= h >> np.uint64(16)
    return h


def token_values(field: int, ranks: np.ndarray) -> np.ndarray:
    """The 32-bit value of each rank's token in ``field``: distinct ranks
    give distinct values."""
    r = ranks.astype(np.uint64)
    return _fmix32(r * np.uint64(0x9E3779B1) + np.uint64(0x7F4A7C15 * (field + 1)))


def hex_tokens(values: np.ndarray) -> np.ndarray:
    """``[n, 8]`` u8: each 32-bit value as 8 lowercase hex digits."""
    v = values.astype(np.uint64)
    shifts = np.arange(28, -1, -4, dtype=np.uint64)
    return _HEX[((v[:, None] >> shifts) & np.uint64(15)).astype(np.intp)]


def _draw_ranks(rng, n: int) -> np.ndarray:
    """``[FIELDS, n]`` i32 ranks, each field from its truncated power law."""
    card = np.asarray(CARD, np.float64)[:, None]
    top = (card + 1.0) ** (1.0 - ZIPF) - 1.0
    x = (top * rng.random((FIELDS, n)) + 1.0) ** (1.0 / (1.0 - ZIPF))
    return np.minimum(np.floor(x) - 1.0, card - 1.0).astype(np.int32)


def columns(traffic: dict, seed: int) -> dict:
    """The run's columns: ``label`` [n] (1 or −1), ``idx`` [FIELDS, n]
    (each field's index into its distinct drawn tokens) and ``tok``, per
    field the u32 values of those tokens."""
    n = int(traffic["lines"])
    rng = np.random.default_rng(seed)
    idx = np.empty((FIELDS, n), np.int32)
    for lo in range(0, n, CHUNK):
        idx[:, lo:lo + CHUNK] = _draw_ranks(rng, min(CHUNK, n - lo))
    tok = []
    for f, card in enumerate(CARD):  # ranks → indices of the distinct ranks
        seen = np.zeros(card, bool)
        seen[idx[f]] = True
        remap = np.cumsum(seen, dtype=np.int32) - 1
        idx[f] = remap[idx[f]]
        tok.append(token_values(f, np.flatnonzero(seen)).astype(np.uint32))
    salt = int(rng.integers(0, 1 << 32))
    logit = np.zeros(n, np.float64)
    for f in range(FIELDS):
        u = _fmix32(tok[f].astype(np.uint64) ^ np.uint64(salt)).astype(np.float64)
        logit += (WEIGHT_SCALE * (2.0 * u / 2.0 ** 32 - 1.0))[idx[f]]
    sign = [(_fmix32(t.astype(np.uint64) ^ np.uint64(salt ^ 0x5BD1E995)) & np.uint64(1))
            .astype(np.float64) * 2.0 - 1.0 for t in tok]
    for i, j in PAIRS:
        logit += PAIR_SCALE * sign[i][idx[i]] * sign[j][idx[j]]
    lo_b, hi_b = -20.0, 20.0  # the bias whose mean probability is the share
    for _ in range(32):
        mid = 0.5 * (lo_b + hi_b)
        if np.mean(1.0 / (1.0 + np.exp(-(logit + mid)))) < POSITIVE_SHARE:
            lo_b = mid
        else:
            hi_b = mid
    p = 1.0 / (1.0 + np.exp(-(logit + 0.5 * (lo_b + hi_b))))
    label = np.where(rng.random(n) < p, 1, -1).astype(np.int64)
    return {"label": label, "idx": idx, "tok": tok}


def write_namespace_map(directory: Path) -> None:
    """``vw_namespace_map.csv``: each field's namespace and Criteo name."""
    Path(directory, NAMESPACE_MAP).write_text(
        "".join(f"{ns},{name}\n" for ns, name in zip(NAMESPACES, INT_NAMES + CAT_NAMES)))


# one line: the label ("-1" or "1 ", the parsers skip any run of spaces),
# then " |a " and a token per field, then a newline: 471 bytes, so a
# chunk's lines are one structured array with no separator to remove
_LINE = np.dtype([("label", "<u2")]
                 + [(k, t) for f in range(FIELDS) for k, t in
                    ((f"h{f}", "<u4"), (f"t{f}", "<u8"))]
                 + [("newline", "u1")])
_LABELS = np.frombuffer(b"-11 ", "<u2")  # −1, 1


def write_text(traffic: dict, cols: dict, path: Path) -> None:
    """``cols`` rendered as VW text at ``path`` (``-1 |a 1f3a09c2 |b …``),
    the namespace map beside it."""
    path = Path(path)
    write_namespace_map(path.parent)
    tables = [hex_tokens(t).view("<u8")[:, 0] for t in cols["tok"]]
    n = len(cols["label"])
    buf = np.empty(min(CHUNK, n), _LINE)
    for f, ns in enumerate(NAMESPACES):
        buf[f"h{f}"] = np.frombuffer(f" |{ns} ".encode(), "<u4")[0]
    buf["newline"] = ord("\n")
    with open(path, "wb") as out:
        for lo in range(0, n, CHUNK):
            m = min(CHUNK, n - lo)
            part = buf[:m]
            part["label"] = _LABELS[(cols["label"][lo:lo + m] > 0).astype(np.intp)]
            for f in range(FIELDS):
                part[f"t{f}"] = tables[f][cols["idx"][f, lo:lo + m]]
            out.write(part.tobytes())


class Ids:
    """The LR and FFM ids of a configuration's ``model`` group for these
    columns, as the program hashes the text (features.py's rules): each
    distinct token of a field hashed once with the field's namespace seed.
    Every combo is one namespace, every FFM field one namespace."""

    def __init__(self, model: dict):
        self.model = model
        self.lr_mask = (1 << model["bit_precision"]) - 1
        dim_bits = max(0, (model["ffm_k"] - 1).bit_length())
        self.ffm_mask = ((1 << model["ffm_bit_precision"]) - 1) ^ ((1 << dim_bits) - 1)
        self.field = {ns: f for f, ns in enumerate(NAMESPACES)}
        self.cache: dict = {}  # (id of the columns' token table, ns) → hashes

    def _hashes(self, cols: dict, ns: str) -> np.ndarray:
        """``[n]`` u32: each row's 31-bit feature hash in namespace ``ns``."""
        f = self.field[ns]
        key = (id(cols["tok"][f]), ns)
        if key not in self.cache:
            seed = int(features.murmur3_32([ns.encode()], 0)[0])
            strings = [bytes(r) for r in hex_tokens(cols["tok"][f])]
            self.cache[key] = features.murmur3_32(strings, seed) & np.uint32(0x7FFFFFFF)
        return self.cache[key][cols["idx"][f]]

    def lr(self, cols: dict) -> np.ndarray:
        """``[n, combos]`` i64: one id per combo, in the order declared,
        then the constant."""
        for combo in self.model["lr_combos"]:
            if len(combo) != 1:
                raise ValueError(f"this schema has no interaction combos: {combo}")
        out = [self._hashes(cols, c[0]).astype(np.int64) & self.lr_mask
               for c in self.model["lr_combos"]]
        if self.model["constant"]:
            out.append(np.full(len(cols["label"]), features.CONSTANT_HASH & self.lr_mask,
                               np.int64))
        return np.stack(out, axis=1)

    def ffm(self, cols: dict) -> np.ndarray:
        """``[n, fields]`` i64: each FFM field's one feature id."""
        return np.stack([self._hashes(cols, ns).astype(np.int64) & self.ffm_mask
                         for ns in self.model["ffm_fields"]], axis=1)


def ids(model: dict, traffic: dict) -> Ids:
    return Ids(model)
