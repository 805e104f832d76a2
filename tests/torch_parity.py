"""Shared set-up for the parity tests of the PyTorch port (tests/test_torch_*):
small models built with the JAX package, VW lines made from a numpy seed,
and the helpers that carry parameters and batches across. The port gets its
own configuration objects, built from the same namespace map and argv
(:func:`port_config`); what crosses between the packages is files and
numpy arrays."""

from __future__ import annotations

import dataclasses
import fcntl
import importlib
import os
import random
import socket
import subprocess
import tempfile
import time

import numpy as np
import pytest

import jax

from fwumious_wabbit_tpu.config.cmdline import build_parser
from fwumious_wabbit_tpu.config.model_instance import ModelInstance
from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu.ingest.parser import VowpalParser
from fwumious_wabbit_tpu.ingest.translator import Batcher, FeatureTranslator
from fwumious_wabbit_tpu.models.model import FwModel as JaxModel
from fwumious_wabbit_tpu.train.loop import _batch_dict
from fwumious_wabbit_tpu_torch.config import cmdline as port_cmdline
from fwumious_wabbit_tpu_torch.config import model_instance as port_mi
from fwumious_wabbit_tpu_torch.config import vwmap as port_vwmap
from fwumious_wabbit_tpu_torch.convert import params_from_numpy
from fwumious_wabbit_tpu_torch.models.model import FwModel

VW_CSV = "A,animal\nB,food\nC,color\n"
BASE_ARGV = ["--keep", "A", "--keep", "B", "--keep", "C", "--interactions", "AB",
             "-b", "12", "--adaptive", "-l", "0.1", "--data", "x"]
FFM_ARGV = ["--ffm_k", "4", "--ffm_bit_precision", "12",
            "--ffm_field", "A", "--ffm_field", "BC"]


def free_port() -> int:
    """A TCP port for a process group's rank 0, free now and below Linux's
    ephemeral range (32768-60999): a port the kernel hands out for port 0
    can be taken, before rank 0 binds it, by any socket another test's
    gloo ranks open meanwhile."""
    while True:
        port = random.randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


def make_vw(tmp_path) -> VwNamespaceMap:
    (tmp_path / "vw_namespace_map.csv").write_text(VW_CSV)
    return VwNamespaceMap.from_dataset_dir(str(tmp_path / "d.vw"))


def make_mi(vw, extra=()) -> ModelInstance:
    return ModelInstance.from_cmdline(
        build_parser().parse_args(BASE_ARGV + list(extra)), vw)


def port_config(tmp_path, extra=(), **overrides):
    """The port's own ``(vw, mi)`` from the namespace map :func:`make_vw`
    wrote and the argv :func:`make_mi` takes; ``overrides`` set fields
    afterwards (an optimizer by its name, e.g. ``optimizer="SGD"``)."""
    vw = port_vwmap.VwNamespaceMap.from_dataset_dir(str(tmp_path / "d.vw"))
    mi = port_mi.ModelInstance.from_cmdline(
        port_cmdline.build_parser().parse_args(BASE_ARGV + list(extra)), vw)
    for name, value in overrides.items():
        if name == "optimizer":
            value = port_mi.Optimizer[value]
        setattr(mi, name, value)
    return vw, mi


def config_fields(obj) -> dict:
    """A config object's fields, nested dataclasses as dicts: equal for the
    two packages' objects of one configuration (their enums are ints)."""
    return dataclasses.asdict(obj)


def vw_lines(n: int, seed: int = 0) -> list[bytes]:
    """VW lines with a label, 1-3 features in A and B, and an optional C."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = [str(rng.choice([1, -1]))]
        for ns, vocab in (("A", 30), ("B", 20)):
            feats = [f"{ns.lower()}{rng.integers(vocab)}"
                     for _ in range(rng.integers(1, 4))]
            parts.append(f"|{ns} " + " ".join(feats))
        if rng.random() < 0.7:
            parts.append(f"|C c{rng.integers(10)}:{rng.uniform(0.5, 2):.3f}")
        out.append((" ".join(parts) + "\n").encode())
    return out


def batches(vw, mi, lines, batch_size: int = 16):
    parser, ft = VowpalParser(vw), FeatureTranslator(mi)
    tes = [ft.translate(parser.parse_line(line)) for line in lines]
    b = Batcher(batch_size)
    return [b.make_batch(tes[i : i + batch_size])
            for i in range(0, len(tes), batch_size)]


def jax_params(jmodel: JaxModel, seed: int = 0, train_lines=(), vw=None):
    """JAX params: the model's own init, random LR weights (so predictions
    are not all 0.5), then a few train steps over ``train_lines``."""
    from fwumious_wabbit_tpu.train.step import make_train_step

    params = jmodel.init_params()
    rng = np.random.default_rng(seed)
    params["lr_w"] = jax.numpy.asarray(
        rng.normal(scale=0.3, size=params["lr_w"].shape).astype(np.float32))
    if train_lines:
        step = make_train_step(jmodel)
        for b in batches(vw, jmodel.mi, train_lines, 8):
            params, _ = step(params, _batch_dict(b))
    return params


def to_numpy(params):
    return jax.tree.map(np.asarray, params)


def port_model(mi, params, device="cpu") -> FwModel:
    """The port's model of the port's ``mi`` with the JAX ``params``."""
    model = FwModel(mi)
    return model.load_params(params_from_numpy(to_numpy(params), model, device))


def both_configs(csv: str, argv: list[str]):
    """``((jax mi, jax vw), (port mi, port vw))`` of one namespace map and
    argv, each package's own objects."""
    jvw = VwNamespaceMap.from_string(csv)
    pvw = port_vwmap.VwNamespaceMap.from_string(csv)
    return ((ModelInstance.from_cmdline(build_parser().parse_args(argv), jvw), jvw),
            (port_mi.ModelInstance.from_cmdline(
                port_cmdline.build_parser().parse_args(argv), pvw), pvw))


def eat_rate_stream(tmp_path, rows: int = 600) -> tuple[str, list[str], bytes]:
    """``(namespace map, argv, text)``: the port's synthetic Eat-Rate data
    (synthetic.generate_dataset, seed 1) with the flags of its LR+FFM
    training configuration (synthetic.training_config: AdagradLUT at
    power_t 0, so the batch-mean cap's host counts are on) at small
    widths (-b 18, --ffm_bit_precision 18)."""
    from fwumious_wabbit_tpu_torch import synthetic

    data = synthetic.ensure_dataset(tmp_path, rows)
    argv = synthetic.serving_argv()
    argv[argv.index("-b") + 1] = "18"
    argv[argv.index("--ffm_bit_precision") + 1] = "18"
    return ((tmp_path / synthetic.NAMESPACE_MAP).read_text(), argv,
            data.read_bytes())


def require_jax_native():
    """The JAX package's C++ library, for a test that holds the port to the
    JAX native path. ``fwumious_wabbit_tpu.native.load()`` runs ``make`` in
    every process and its Makefile links straight onto the library, so
    test workers that start at once can link it together, and one that
    loads a half-written file gets None (and the JAX side then takes its
    Python path: a different stream). Here the load runs under a file lock
    shared by the port's tests; a None is retried once after reloading the
    module (which forgets the failed attempt), and a second None fails the
    test with make's output — never a skip, never a comparison against the
    JAX package's Python fallback."""
    from fwumious_wabbit_tpu import native as jnative

    lock = os.path.join(tempfile.gettempdir(), "fwt_jax_native_load.lock")
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            lib = jnative.load()
            if lib is None:
                time.sleep(2.0)  # let a link another process started finish
                lib = importlib.reload(jnative).load()
            if lib is None:
                r = subprocess.run(["make", "-C", str(jnative._DIR), "-s"],
                                   capture_output=True, text=True)
                pytest.fail("the JAX package's C++ library did not load after "
                            f"a locked retry; make exited {r.returncode}:\n"
                            f"{r.stdout}{r.stderr}")
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    return lib


@pytest.fixture(autouse=True)
def jax_native_loaded():
    """Autouse in each test file that imports it: the JAX package's C++
    library, loaded first and under a lock (:func:`require_jax_native`),
    for tests that hold the port to the JAX native path."""
    return require_jax_native()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Autouse in each test file that imports it: one intra-op thread for
    the port's CPU runs in this process, for the whole module, and the
    pool's size restored after it. The suite's xdist workers share the
    host's cores, and torch's OpenMP pool spin-waits at every parallel
    region: on an 8-core host with six cores kept busy,
    tests/test_torch_auto_matrix.py took 123 s with the default pool and
    13.9 s with one thread (11.5 s on an idle host)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
