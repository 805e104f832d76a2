"""A synthetic CTR dataset and the LR+FFM k=8 configuration at full width,
for smoke tests and benchmarks of the port: served (weights only) or
trained (with the flags' AdaGrad state); and the FFM gate's
herbivore/carnivore dataset (:func:`generate_ffm_dataset`).

The dataset has the schema and distribution of the reference's benchmark
generator (reference: benchmark/generate.py), and is byte for byte what
bench.py's ``generate_dataset`` writes for the same rows and seed: a label,
namespaces A (animal) and B (food) whose match decides the label, and ten
random namespaces C..L. The configuration is bench.py's "FFM k=8" one:
``_base_argv`` plus ``--ffm_k 8 --ffm_bit_precision 25 --ffm_field A
--ffm_field B`` — 2^25 LR weights, 2^25+16 FFM weights, fields A and B.
The tower configuration puts BASELINE.json's config 3 tower ("Deep FFM":
one ReLU layer of 16, topology one; the flags of
tests/test_baseline_flows.py) on the same tables.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .config.cmdline import build_parser
from .config.model_instance import ModelInstance, Optimizer
from .config.vwmap import VwNamespaceMap

NAMESPACE_MAP = "vw_namespace_map.csv"


def generate_dataset(path: Path, rows: int, feature_variety: int = 1000,
                     num_random: int = 10, seed: int = 1) -> None:
    """Write ``rows`` VW lines to ``path`` (through a temporary file, so a
    partial file is never left under the final name)."""
    rng = np.random.default_rng(seed)
    block = feature_variety // 4
    chunk = 200_000
    adict = {1: "Herbivore", 2: "Carnivore"}
    bdict = {100: "Plant", 101: "Meat"}
    ns_names = [chr(ord("C") + x) for x in range(num_random)]
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        done = 0
        while done < rows:
            n = min(chunk, rows - done)
            atype = rng.choice([1, 2], n)
            btype = rng.choice([100, 101], n)
            missone = rng.integers(0, 2, n).astype(bool)
            aname = np.where(missone, rng.integers(0, feature_variety + 1, n),
                             rng.integers(0, block + 1, n))
            bname = np.where(missone, rng.integers(0, block + 1, n),
                             rng.integers(0, feature_variety + 1, n))
            score = np.where(
                ((atype == 1) & (btype == 100)) | ((atype == 2) & (btype == 101)),
                1, -1)
            rand_feats = rng.integers(0, 10001, (n, num_random))
            lines = []
            for i in range(n):
                parts = [str(score[i]), "|A", f"{adict[atype[i]]}-{aname[i]}",
                         "|B", f"{bdict[btype[i]]}-{bname[i]}"]
                for j, ns in enumerate(ns_names):
                    parts += ["|" + ns, f"{ns}{rand_feats[i, j]}"]
                lines.append(" ".join(parts))
            f.write("\n".join(lines) + "\n")
            done += n
    os.replace(tmp, path)


def _render_ffm(kind_a: int, name_a: int, kind_b: int, name_b: int) -> str:
    label = 1 if (kind_a, kind_b) in ((0, 0), (1, 1)) else -1
    animal = ("Herbivore" if kind_a == 0 else "Carnivore") + f"-{name_a}"
    food = ("Plant" if kind_b == 0 else "Meat") + f"-{name_b}"
    return f"{label} |A {animal} |B {food}\n"


def generate_ffm_dataset(out: Path, num_animals: int = 300,
                         num_foods: int = 200, num_train_examples: int = 30000,
                         num_test_examples: int = 10000,
                         block_beyond: int = 3) -> None:
    """The FFM gate's data, byte for byte what examples/ffm/generate.py
    writes for the same arguments (``random.Random(1)``): ``train.vw``,
    ``test-easy.vw`` and ``test-hard.vw`` under ``out``, with the
    two-namespace map. An animal eats a food of its kind (label 1, else
    −1); a train or easy-test pair anchors its animal or its food in the
    first ``block_beyond`` + 1 ids, a hard-test pair neither, so only the
    FFM's latent factors can score it."""
    import random

    rng = random.Random(1)
    out = Path(out)
    out.mkdir(exist_ok=True)
    (out / NAMESPACE_MAP).write_text("A,animal\nB,food\n")

    def common_pair():
        ka, kb = rng.randint(0, 1), rng.randint(0, 1)
        if rng.randint(0, 1):
            return ka, rng.randint(0, num_animals), kb, rng.randint(0, block_beyond)
        return ka, rng.randint(0, block_beyond), kb, rng.randint(0, num_foods)

    with open(out / "train.vw", "w") as f:
        for _ in range(num_train_examples):
            f.write(_render_ffm(*common_pair()))
    with open(out / "test-easy.vw", "w") as f:
        for _ in range(num_test_examples):
            f.write(_render_ffm(*common_pair()))
    with open(out / "test-hard.vw", "w") as f:
        for _ in range(num_test_examples):
            f.write(_render_ffm(
                rng.randint(0, 1), rng.randint(block_beyond + 1, num_animals),
                rng.randint(0, 1), rng.randint(block_beyond + 1, num_foods)))


def write_namespace_map(directory: Path) -> None:
    """The Eat-Rate dataset's namespace map in ``directory``, unless it is
    there."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    csv = directory / NAMESPACE_MAP
    if not csv.exists():
        csv.write_text("A,animal\nB,food\n" + "".join(
            chr(ord("C") + x) + ",somefeature\n" for x in range(10)))


def ensure_dataset(directory: Path, rows: int) -> Path:
    """``directory/train_<rows>.vw`` and its namespace map, written once."""
    directory = Path(directory)
    write_namespace_map(directory)
    data = directory / f"train_{rows}.vw"
    if not data.exists():
        generate_dataset(data, rows)
    return data


def serving_argv() -> list[str]:
    """The flags of the LR+FFM k=8 configuration (bench.py ``_base_argv``
    and its FFM k=8 options, without the data and output paths)."""
    argv = ["-l", "0.1", "-b", "25", "--adaptive", "--sgd",
            "--loss_function", "logistic", "--link", "logistic",
            "--power_t", "0.0", "--l2", "0.0", "--hash", "all",
            "--interactions", "AB"]
    for ns in "ABCDEFGHIJKL":
        argv += ["--keep", ns]
    return argv + ["--ffm_k", "8", "--ffm_bit_precision", "25",
                   "--ffm_field", "A", "--ffm_field", "B"]


def serving_config(data: Path) -> tuple[ModelInstance, VwNamespaceMap]:
    """``(mi, vw)`` of the LR+FFM k=8 configuration over the dataset at
    ``data``, in the inference layout: weights only, no optimizer state."""
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    mi = ModelInstance.from_cmdline(build_parser().parse_args(serving_argv()), vw)
    mi.optimizer = Optimizer.SGD
    return mi, vw


def training_config(data: Path) -> tuple[ModelInstance, VwNamespaceMap]:
    """``(mi, vw)`` of the same configuration for training: the optimizer
    as the flags give it (``--adaptive`` with fastmath: AdagradLUT, with
    power_t 0 in both scopes)."""
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    mi = ModelInstance.from_cmdline(build_parser().parse_args(serving_argv()), vw)
    return mi, vw


# BASELINE config 3's dense tower (tests/test_baseline_flows.py:61-63)
TOWER_FLAGS = ["--nn_layers", "1", "--nn", "0:width:16", "--nn", "0:activation:relu",
               "--nn_topology", "one", "--nn_learning_rate", "0.02",
               "--nn_power_t", "0.5"]


def tower_argv() -> list[str]:
    """The LR+FFM k=8 flags with the dense tower."""
    return serving_argv() + TOWER_FLAGS


def tower_training_config(data: Path) -> tuple[ModelInstance, VwNamespaceMap]:
    """``(mi, vw)`` of :func:`training_config`'s tables with the tower:
    AdagradLUT in every scope, power_t 0 in the LR and FFM scopes (the
    batch-mean cap) and 0.5 in the tower's."""
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    mi = ModelInstance.from_cmdline(build_parser().parse_args(tower_argv()), vw)
    return mi, vw
