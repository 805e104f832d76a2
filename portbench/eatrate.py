"""The Eat-Rate dataset, drawn from a seed and rendered as VW text in bulk.

The schema and distribution are those of the reference's benchmark
generator (fwumious_wabbit ``benchmark/generate.py``): a label, namespace A
(an animal: Herbivore or Carnivore and a name), namespace B (a food: Plant
or Meat and a name), whose match decides the label, and ``num_random``
namespaces C, D, ... of one random feature each. The draws are those of
``fwumious_wabbit_tpu_torch.synthetic.generate_dataset``, in the same order
and chunks, so the text is byte for byte the same; this copy renders a
chunk with a few numpy operations instead of one Python string per line.

:func:`draw` gives the integer columns the text is rendered from; the
plain reference (reference.py) derives its feature ids from them through
the same strings the text holds (:func:`tokens`).

As the default data schema of a configuration (spec.py), it gives
:func:`columns`, :func:`write_text` and :func:`ids`, each reading the
traffic's ``lines``, ``feature_variety`` and ``num_random``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

CHUNK = 200_000
NAMESPACE_MAP = "vw_namespace_map.csv"
ANIMALS = ("Herbivore", "Carnivore")  # atype 1, 2
FOODS = ("Plant", "Meat")  # btype 100, 101
RAND_VALUES = 10_001


def random_namespaces(num_random: int) -> list[str]:
    return [chr(ord("C") + x) for x in range(num_random)]


def draw_chunks(rows: int, seed: int, feature_variety: int = 1000,
                num_random: int = 10):
    """Yield one dict of integer columns per chunk of at most
    :data:`CHUNK` rows: ``label`` (1 or −1), ``a`` (index into
    ``tokens()["A"]``), ``b`` (into ``tokens()["B"]``) and ``rand``
    ``[n, num_random]`` (the value of each random namespace)."""
    rng = np.random.default_rng(seed)
    block = feature_variety // 4
    done = 0
    while done < rows:
        n = min(CHUNK, rows - done)
        atype = rng.choice([1, 2], n)
        btype = rng.choice([100, 101], n)
        missone = rng.integers(0, 2, n).astype(bool)
        aname = np.where(missone, rng.integers(0, feature_variety + 1, n),
                         rng.integers(0, block + 1, n))
        bname = np.where(missone, rng.integers(0, block + 1, n),
                         rng.integers(0, feature_variety + 1, n))
        label = np.where(((atype == 1) & (btype == 100))
                         | ((atype == 2) & (btype == 101)), 1, -1)
        rand = rng.integers(0, RAND_VALUES, (n, num_random))
        yield {"label": label,
               "a": (atype - 1) * (feature_variety + 1) + aname,
               "b": (btype - 100) * (feature_variety + 1) + bname,
               "rand": rand}
        done += n


def draw(rows: int, seed: int, feature_variety: int = 1000,
         num_random: int = 10) -> dict:
    """:func:`draw_chunks` joined into whole columns."""
    parts = list(draw_chunks(rows, seed, feature_variety, num_random))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def tokens(feature_variety: int = 1000, num_random: int = 10) -> dict:
    """The feature strings of each namespace, indexed as :func:`draw`'s
    columns index them: ``A`` and ``B`` by ``kind·(variety+1) + name``, a
    random namespace ``X`` by its value (``X0`` … ``X10000``)."""
    names = range(feature_variety + 1)
    out = {"A": [f"{k}-{i}" for k in ANIMALS for i in names],
           "B": [f"{k}-{i}" for k in FOODS for i in names]}
    for ns in random_namespaces(num_random):
        out[ns] = [f"{ns}{v}" for v in range(RAND_VALUES)]
    return out


def _table(strings: list[str]) -> np.ndarray:
    """``[len(strings), width]`` u8, each string's bytes zero-padded."""
    raw = [s.encode() for s in strings]
    width = max(len(r) for r in raw)
    return np.frombuffer(b"".join(r.ljust(width, b"\0") for r in raw),
                         np.uint8).reshape(len(raw), width)


def _const(text: str, n: int) -> np.ndarray:
    return np.broadcast_to(np.frombuffer(text.encode(), np.uint8),
                           (n, len(text)))


class Renderer:
    """Render :func:`draw_chunks`' chunks as the generator's VW lines."""

    def __init__(self, feature_variety: int = 1000, num_random: int = 10):
        toks = tokens(feature_variety, num_random)
        self.namespaces = random_namespaces(num_random)
        self.tables = {k: _table(v) for k, v in toks.items()}
        self.labels = _table(["-1", "1"])

    def chunk(self, cols: dict) -> bytes:
        n = len(cols["label"])
        parts = [self.labels[(cols["label"] > 0).astype(np.int64)],
                 _const(" |A ", n), self.tables["A"][cols["a"]],
                 _const(" |B ", n), self.tables["B"][cols["b"]]]
        for j, ns in enumerate(self.namespaces):
            parts += [_const(f" |{ns} ", n), self.tables[ns][cols["rand"][:, j]]]
        parts.append(_const("\n", n))
        mat = np.concatenate(parts, axis=1)
        return mat[mat != 0].tobytes()


def write_dataset(path: Path, rows: int, seed: int, feature_variety: int = 1000,
                  num_random: int = 10) -> None:
    """Write ``rows`` lines to ``path`` (through a temporary name) and the
    namespace map beside it."""
    path = Path(path)
    write_namespace_map(path.parent, num_random)
    renderer = Renderer(feature_variety, num_random)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        for cols in draw_chunks(rows, seed, feature_variety, num_random):
            f.write(renderer.chunk(cols))
    os.replace(tmp, path)


def write_namespace_map(directory: Path, num_random: int = 10) -> None:
    """``vw_namespace_map.csv``: A is the animal, B the food, the random
    namespaces a feature each."""
    Path(directory, NAMESPACE_MAP).write_text(
        "A,animal\nB,food\n"
        + "".join(f"{ns},somefeature\n" for ns in random_namespaces(num_random)))


# -- the data schema (spec.py) ---------------------------------------------


def columns(traffic: dict, seed: int) -> dict:
    """The run's columns: :func:`draw` of the traffic's lines."""
    return draw(int(traffic["lines"]), seed, traffic["feature_variety"],
                traffic["num_random"])


def write_text(traffic: dict, cols: dict, path: Path) -> None:
    """``cols`` rendered as VW text at ``path``, the namespace map
    beside it."""
    path = Path(path)
    write_namespace_map(path.parent, traffic["num_random"])
    renderer = Renderer(traffic["feature_variety"], traffic["num_random"])
    with open(path, "wb") as f:
        for lo in range(0, len(cols["label"]), CHUNK):
            f.write(renderer.chunk({k: v[lo:lo + CHUNK] for k, v in cols.items()}))


def ids(model: dict, traffic: dict):
    """The LR and FFM ids of ``model`` for these columns
    (features.Ids)."""
    from .features import Ids

    return Ids(model, traffic["feature_variety"], traffic["num_random"])
