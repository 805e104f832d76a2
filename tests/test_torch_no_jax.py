"""The port stands alone: in a fresh interpreter where importing jax, jaxlib,
the JAX package fwumious_wabbit_tpu or zstandard (which a host may lack)
fails, every module of
fwumious_wabbit_tpu_torch imports, a CPU predict runs from a model file the
port itself writes, on the device engine and on the port's own build of the
embedded C++ engine (``--fwt_serve_engine native``) with equal predictions,
and a short CPU training through the CLI's default path (the C++ ingest and
packed superbatches) writes predictions and a model file with optimizer
state, its predictions equal to the ``--fwt_no_native`` path's; and a
tower (``--nn``) trains twice with ``-c``, recording a raw record cache and
reading it back, with equal predictions and a model file that keeps its
tower; and the last modules ported: convert (quantized, served by the
embedded engine), the weight patcher's C++ tool between two trained model
files, the sharded step on a gloo group of one rank, and the FFM gate
(gates.py) over a small dataset; and the one-command launcher
(parallel/launch.py) and multicard.py, which on a host of fewer than four
cards exits 1 and says so; and deployment.py's soak of a served model hot
swapped with another under load."""

import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "fwumious_wabbit_tpu", "zstandard")

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, BlockJax())

    import numpy as np
    import fwumious_wabbit_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)

    from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
    from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance, Optimizer
    from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
    from fwumious_wabbit_tpu_torch.convert import params_from_numpy
    from fwumious_wabbit_tpu_torch.models.model import FwModel
    from fwumious_wabbit_tpu_torch.persistence.model_file import save_model
    from fwumious_wabbit_tpu_torch.train.loop import main

    tmp = sys.argv[1]
    open(tmp + "/vw_namespace_map.csv", "w").write("A,animal\\nB,food\\n")
    vw = VwNamespaceMap.from_dataset_dir(tmp + "/d.vw")
    mi = ModelInstance.from_cmdline(build_parser().parse_args(
        ["--keep", "A", "--keep", "B", "-b", "10", "--ffm_k", "4",
         "--ffm_bit_precision", "10", "--ffm_field", "A", "--ffm_field", "B"]), vw)
    mi.optimizer = Optimizer.SGD
    model = FwModel(mi)
    rng = np.random.default_rng(0)
    model.load_params(params_from_numpy(
        {"lr_w": rng.normal(size=model.lr_size),
         "ffm_w": rng.normal(scale=0.1, size=model.ffm_size)}, model, "cpu"))
    save_model(tmp + "/m.fwt", mi, vw, model)
    open(tmp + "/d.vw", "w").write("1 |A a |B b\\n|A c |B d e\\n")
    assert main(["-t", "-i", tmp + "/m.fwt", "--data", tmp + "/d.vw",
                 "-p", tmp + "/p.out", "--fwt_platform", "cpu"]) == 0
    preds = [float(x) for x in open(tmp + "/p.out").read().split()]
    assert len(preds) == 2 and all(0.0 < p < 1.0 for p in preds), preds
    assert main(["-t", "-i", tmp + "/m.fwt", "--data", tmp + "/d.vw",
                 "-p", tmp + "/n.out", "--fwt_serve_engine", "native"]) == 0
    native = [float(x) for x in open(tmp + "/n.out").read().split()]
    assert len(native) == 2 and all(abs(a - b) <= 2e-6
                                    for a, b in zip(native, preds)), native
    from fwumious_wabbit_tpu_torch import native as port_native
    assert "fwumious_wabbit_tpu_torch/build/" in str(port_native.library_path())
    open(tmp + "/t.vw", "w").write("1 |A a |B b\\n-1 |A c |B d e\\n" * 4)
    train = ["--data", tmp + "/t.vw", "--keep", "A", "--keep", "B",
             "-b", "10", "--ffm_k", "4", "--ffm_bit_precision", "10",
             "--ffm_field", "A", "--ffm_field", "B", "--adaptive",
             "--power_t", "0", "--fwt_batch_size", "2", "--fwt_platform", "cpu"]
    import json, os
    os.environ["FWT_COUNTERS_OUT"] = tmp + "/c.json"
    assert main(train + ["-p", tmp + "/t.out", "-f", tmp + "/t.fwt",
                         "--save_resume"]) == 0  # the default: C++ ingest, packed
    counters = json.load(open(tmp + "/c.json"))
    assert counters["examples"] == 8 and counters["counters"]["xfer_puts"] > 0
    preds = [float(x) for x in open(tmp + "/t.out").read().split()]
    assert len(preds) == 8 and preds[6] > preds[0] + 0.1, preds  # it learns
    assert main(train + ["-p", tmp + "/py.out", "--fwt_no_native"]) == 0
    py = [float(x) for x in open(tmp + "/py.out").read().split()]
    assert max(abs(a - b) for a, b in zip(py, preds)) <= 2e-6, (py, preds)
    from fwumious_wabbit_tpu_torch.persistence.model_file import load_model
    _, _, trained = load_model(tmp + "/t.fwt", device="cpu")
    assert trained.has_state and float(trained.lr_acc.abs().sum()) > 0
    tower = train + ["--nn_layers", "1", "--nn", "0:width:4", "--nn",
                     "0:activation:relu", "-c", "--fwt_pack_cache", "off"]
    assert main(tower + ["-p", tmp + "/n1.out", "-f", tmp + "/n.fwt",
                         "--save_resume"]) == 0
    assert main(tower + ["-p", tmp + "/n2.out"]) == 0
    n1 = open(tmp + "/n1.out").read()
    assert n1 == open(tmp + "/n2.out").read() and n1.count("\\n") == 8
    raw = open(tmp + "/t.vw.fwcache", "rb").read()
    assert int.from_bytes(raw[8:12], "little") == 0  # no zstandard: raw
    _, _, towered = load_model(tmp + "/n.fwt", device="cpu")
    assert towered.has_nn and float(towered.layers[0].w_acc.abs().sum()) > 0
    for name in ("tools.weight_patcher", "parallel.distributed",
                 "parallel.mesh", "parallel.sharded", "parallel.launch",
                 "multicard", "deployment"):
        assert "fwumious_wabbit_tpu_torch." + name in names, name
    # convert, quantized, and the converted file on the embedded engine
    assert main(["--convert_inference_regressor", tmp + "/q.fwt", "-i",
                 tmp + "/t.fwt", "--weight_quantization",
                 "--fwt_platform", "cpu"]) == 0
    assert main(["-t", "-i", tmp + "/q.fwt", "--data", tmp + "/t.vw",
                 "-p", tmp + "/q.out", "--fwt_serve_engine", "native"]) == 0
    assert len(open(tmp + "/q.out").read().split()) == 8
    # the weight patcher's C++ tool between two trained models
    from fwumious_wabbit_tpu_torch.tools import weight_patcher
    assert weight_patcher.native_tool() is not None
    assert main(train + ["-f", tmp + "/t2.fwt", "--save_resume",
                         "--fwt_batch_size", "4"]) == 0
    weight_patcher.create_diff(tmp + "/t.fwt", tmp + "/t2.fwt", tmp + "/d")
    weight_patcher.recreate(tmp + "/t.fwt", tmp + "/d", tmp + "/t2r.fwt")
    assert open(tmp + "/t2r.fwt", "rb").read() == open(tmp + "/t2.fwt", "rb").read()
    # a gloo group of one rank, a 1x1 mesh and the sharded step
    import socket
    from fwumious_wabbit_tpu_torch.ingest import (
        Batcher, FeatureTranslator, VowpalParser)
    from fwumious_wabbit_tpu_torch.parallel import distributed, sharded
    from fwumious_wabbit_tpu_torch.parallel import mesh as pmesh
    from fwumious_wabbit_tpu_torch.train.step import train_batch_dict
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, "cpu")
    tmi, tvw, tmodel = load_model(tmp + "/t.fwt", device="cpu")
    pmesh.shard_model(tmodel, pmesh.Mesh(1, 1))
    parser, ft = VowpalParser(tvw), FeatureTranslator(tmi)
    batch = Batcher(8).make_batch(
        [ft.translate(parser.parse_line(l)) for l in open(tmp + "/t.vw", "rb")])
    p = sharded.make_sharded_train_step(tmodel, tmodel.mesh, "a2a")(
        train_batch_dict(batch))
    assert p.shape == (8,) and bool(((p > 0) & (p < 1)).all())
    distributed.shutdown()
    # the FFM gate (gates.py) over a small dataset of its own generator
    from pathlib import Path
    from fwumious_wabbit_tpu_torch import gates, synthetic
    assert "fwumious_wabbit_tpu_torch.gates" in names
    os.makedirs(tmp + "/gates/data")
    synthetic.generate_ffm_dataset(Path(tmp) / "gates/data/ffm", 300, 200, 600, 200)
    res = gates.run("ffm", cpu=True, work=Path(tmp) / "gates")
    assert res["lines"] == 200 and res["inference_equals_full"] == 200
    assert res["train"]["rows"] == 600 and res["device"] == "cpu"
    # deployment.py's soak: a served model swapped with another under load
    from fwumious_wabbit_tpu_torch import deployment
    from fwumious_wabbit_tpu_torch.serve.server import Serving
    model.load_params(params_from_numpy(
        {"lr_w": rng.normal(size=model.lr_size),
         "ffm_w": rng.normal(scale=0.1, size=model.ffm_size)}, model, "cpu"))
    save_model(tmp + "/m2.fwt", mi, vw, model)
    open(tmp + "/pool.vw", "w").write("".join(
        f"|A a{i} |B b{i % 7} c{i % 3}\\n" for i in range(64)))
    pool = deployment.probe_pool(Path(tmp) / "pool.vw",
                                 (Path(tmp) / "m.fwt", Path(tmp) / "m2.fwt"),
                                 Path(tmp), 64)
    smi, svw, smodel = load_model(tmp + "/m.fwt", immutable=True, device="cpu")
    srv = Serving(build_parser().parse_args(["--daemon", "--port", "0"]),
                  smi, svw, smodel)
    srv.serve_in_background()
    out = deployment.soak(srv.port, pool, (Path(tmp) / "m2.fwt",
                                           Path(tmp) / "m.fwt"),
                          rr_clients=1, burst_clients=1, n_swaps=2)
    srv.shutdown()
    assert out["swaps"] == 2 and out["max_err_to_either_model"] <= 2e-6
    import torch
    from fwumious_wabbit_tpu_torch import multicard
    if torch.cuda.device_count() < multicard.CARDS:
        assert multicard.main(["a"]) == 1
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("imported", len(names), "modules")
""")


def test_port_runs_without_jax(tmp_path):
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                            "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported" in r.stdout
