"""The deployment flows of tests/test_baseline_flows.py through the port's
CLI, each held against the JAX CLI on the same flags, the same
``gen_ctr_stream`` data and seeds (``--fwt_platform cpu``):

* BASELINE config 3 (Deep FFM) learns: the test logloss clears the JAX
  test's bar, and the progressive logloss of training is within 1e-4 of
  the JAX CLI's (power_t 0.5 makes the tower's sums order-dependent, so
  it is held by logloss, as multicard.py's run d is);
* BASELINE config 5 at one process: v1, v2 from ``-i v1 --save_resume``,
  both converted with ``--weight_quantization``, the patcher's diff and
  ``recreate`` byte-equal to v2q, v1q served and the recreated v2q swapped
  in on the live connection. The served reply differs from before the
  swap, is within 2e-6 of the port's offline ``-t -i`` of v2q, within
  2e-5 of the JAX chain's served reply, and within 5e-3 of the unquantized
  v2's; the port's v2 tables within 1e-5·(1+max) of the JAX CLI's v2;
* the same chain with v1 and v2 trained on the one-command mesh of
  ``--fwt_data_axis 4 --fwt_table_axis 2 --fwt_exchange a2a`` (eight gloo
  ranks), against the JAX test's two processes of four virtual devices
  each: the served probe within 2e-5 of the JAX chain's and within 2e-6 of
  the port's offline ``-t -i`` of v2q.
"""

from __future__ import annotations

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from fwumious_wabbit_tpu.config.cmdline import build_parser as jax_build_parser
from fwumious_wabbit_tpu.persistence import model_file as jmf
from fwumious_wabbit_tpu.serve import server as jserver
from fwumious_wabbit_tpu.tools import weight_patcher as jpatcher
from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
from fwumious_wabbit_tpu_torch.persistence import model_file as pmf
from fwumious_wabbit_tpu_torch.serve.server import Serving
from fwumious_wabbit_tpu_torch.tools import weight_patcher
from fwumious_wabbit_tpu_torch.train.loop import main

from test_baseline_flows import Client, gen_ctr_stream, logloss
from torch_parity import (free_port, jax_native_loaded,  # noqa: F401 (autouse)
                          one_torch_thread, to_numpy)

REPO = Path(__file__).resolve().parents[1]
SERVE_ATOL = 2e-6  # tests/test_serving.py:176
CHAIN_ATOL = 2e-5  # tests/test_baseline_flows.py's served-vs-offline bound
QUANT_ATOL = 5e-3  # the JAX package's quantized-vs-full bound
PROBE = b"|A a1 |B b1\n"
RUN_TIMEOUT_S = 300
NS_CSV = "A,a\nB,b\nC,c\nD,d\n"
MESH = (4, 2)  # data × table, the JAX test's



def test_deep_ffm_learns(tmp_path):
    """BASELINE config 3: FFM + relu tower end to end through both CLIs."""
    (tmp_path / "vw_namespace_map.csv").write_text(NS_CSV)
    train, test = tmp_path / "train.vw", tmp_path / "test.vw"
    gen_ctr_stream(train, 12000, seed=7)
    gen_ctr_stream(test, 3000, seed=8)
    flags = [
        "--keep", "A", "--keep", "B", "--keep", "C", "--keep", "D",
        "--interactions", "AB",
        "--ffm_k", "4", "--ffm_field", "A", "--ffm_field", "B",
        "--nn_layers", "1", "--nn", "0:width:16", "--nn", "0:activation:relu",
        "--nn_topology", "one", "--nn_learning_rate", "0.02",
        "--nn_power_t", "0.5",
        "-l", "0.1", "-b", "20", "--ffm_bit_precision", "20", "--adaptive",
        "--sgd", "--loss_function", "logistic", "--link", "logistic",
        "--power_t", "0.5", "--hash", "all",
        "--fwt_platform", "cpu", "--fwt_batch_size", "512",
    ]
    progressive = {}
    for tag, cli in (("jax", jax_main), ("port", main)):
        model = tmp_path / f"{tag}.fwt"
        assert cli(flags + ["--data", str(train), "-f", str(model),
                            "--save_resume", "-p", str(tmp_path / f"{tag}_tr.out")]) == 0
        assert cli(flags + ["-i", str(model), "-t", "--data", str(test),
                            "-p", str(tmp_path / f"{tag}_te.out")]) == 0
        progressive[tag] = logloss(tmp_path / f"{tag}_tr.out", train)
    ll = logloss(tmp_path / "port_te.out", test)
    base = 0.6365  # chance (p(label=1) ≈ 1/3), the JAX test's bar
    assert ll < base - 0.05, f"deep FFM logloss {ll:.4f} vs chance {base:.4f}"
    assert abs(progressive["port"] - progressive["jax"]) <= 1e-4, progressive


def assert_tables_close(port_path: Path, jax_path: Path) -> None:
    """Every table of the port's file within 1e-5·(1+max|jax|) of the JAX
    CLI's file (both read by the JAX reader)."""
    assert port_path.stat().st_size == jax_path.stat().st_size
    _, _, _, got = jmf.load_model(port_path)
    _, _, _, want = jmf.load_model(jax_path)
    got, want = to_numpy(got), to_numpy(want)
    assert set(got) == set(want)
    for key, w in want.items():
        err = float(np.abs(got[key] - w).max())
        assert err <= 1e-5 * (1 + float(np.abs(w).max())), (key, err)


def export_and_patch(cli, patcher, flags, v1, v2, tmp_path, tag):
    """Both checkpoints converted with --weight_quantization, v1q→v2q
    shipped as a patcher diff and recreated, byte-equal to v2q."""
    v1q, v2q = tmp_path / f"{tag}_v1q.fwt", tmp_path / f"{tag}_v2q.fwt"
    for src, dst in ((v1, v1q), (v2, v2q)):
        assert cli(flags + ["-i", str(src), "--convert_inference_regressor",
                            str(dst), "--weight_quantization"]) == 0
    diff, v2q_re = tmp_path / f"{tag}_update.patch", tmp_path / f"{tag}_v2q_re.fwt"
    patcher.create_diff(str(v1q), str(v2q), str(diff))
    patcher.recreate(str(v1q), str(diff), str(v2q_re))
    assert v2q_re.read_bytes() == v2q.read_bytes()
    return v1q, v2q, v2q_re


def serve_and_swap(v1q: Path, v2q_re: Path, flags: list, jax: bool) -> tuple:
    """Serve v1q, hot-swap the recreated v2q on the live connection: the
    probe's reply before and after. The port's daemon on its device engine
    (CPU), the JAX daemon as its test starts it."""
    if jax:
        args = jax_build_parser().parse_args(flags + ["--data", "x"])
        mi, vw, model, params = jmf.load_model(v1q, immutable=True, args=args)
        srv = jserver.Serving(args, mi, vw, model, params, model_path=str(v1q))
        s = jserver._PooledTCPServer(("127.0.0.1", 0), jserver._Handler, 4)
        s.fwt_serving = srv
        srv._server = s
        threading.Thread(target=s.serve_forever, daemon=True).start()
        port = s.server_address[1]
    else:
        args = build_parser().parse_args(flags + ["--data", "x", "--port", "0"])
        mi, vw, model = pmf.load_model(v1q, immutable=True, args=args, device="cpu")
        srv = Serving(args, mi, vw, model, model_path=str(v1q))
        srv.serve_in_background()
        port = srv.port
    try:
        c = Client(port)
        before = float(c.send(PROBE))
        assert c.send(f"hogwild_load {v2q_re}\n".encode()) == b"hogwild_load success\n"
        after = float(c.send(PROBE))
        c.close()
    finally:
        srv.shutdown()
    return before, after


def offline(cli, flags, model, tmp_path, tag) -> float:
    probe = tmp_path / "probe.vw"
    probe.write_bytes(PROBE)
    out = tmp_path / f"{tag}_probe.out"
    assert cli(flags + ["-i", str(model), "-t", "--data", str(probe),
                        "-p", str(out)]) == 0
    return float(out.read_text())


def test_streaming_train_serve_patch_flow(tmp_path):
    """BASELINE config 5 at one process, in both packages."""
    (tmp_path / "vw_namespace_map.csv").write_text(NS_CSV)
    train1, train2 = tmp_path / "t1.vw", tmp_path / "t2.vw"
    gen_ctr_stream(train1, 3000, seed=1)
    gen_ctr_stream(train2, 3000, seed=2)
    flags = [
        "--keep", "A", "--keep", "B", "--interactions", "AB",
        "--ffm_k", "4", "--ffm_field", "A", "--ffm_field", "B",
        "-l", "0.1", "-b", "20", "--ffm_bit_precision", "20", "--adaptive",
        "--sgd", "--loss_function", "logistic", "--link", "logistic",
        "--power_t", "0.5", "--hash", "all",
        "--fwt_platform", "cpu", "--fwt_batch_size", "512",
    ]
    served, v2s = {}, {}
    for tag, cli, patcher in (("jax", jax_main, jpatcher),
                              ("port", main, weight_patcher)):
        v1, v2 = tmp_path / f"{tag}_v1.fwt", tmp_path / f"{tag}_v2.fwt"
        assert cli(flags + ["--data", str(train1), "-f", str(v1),
                            "--save_resume"]) == 0
        assert cli(flags + ["-i", str(v1), "--data", str(train2),
                            "-f", str(v2), "--save_resume"]) == 0
        v1q, v2q, v2q_re = export_and_patch(cli, patcher, flags, v1, v2,
                                            tmp_path, tag)
        served[tag] = serve_and_swap(v1q, v2q_re, flags, jax=tag == "jax")
        v2s[tag] = (v2, v2q)
    before, after = served["port"]
    assert before != after  # v2's weights serve on the same connection
    assert abs(after - offline(main, flags, v2s["port"][1], tmp_path, "port_v2q")) \
        <= SERVE_ATOL
    assert abs(after - served["jax"][1]) <= CHAIN_ATOL, (after, served["jax"])
    assert abs(after - offline(main, flags, v2s["port"][0], tmp_path, "port_v2")) \
        <= QUANT_ATOL
    assert_tables_close(v2s["port"][0], v2s["jax"][0])


def rank_env(d: Path, **extra) -> dict:
    return {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(d),
            "OMP_NUM_THREADS": "1", **extra}


def jax_mesh_train(data, flags, out_model, extra, tmp_path, tag) -> None:
    """The JAX CLI on two processes of MESH's devices between them (the
    JAX test's ``_distributed_train``); rank 0 writes ``out_model``."""
    port = free_port()
    env = rank_env(tmp_path, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count="
                   f"{MESH[0] * MESH[1] // 2}")
    procs = []
    for rank in range(2):
        argv = flags + extra + [
            "--data", str(data),
            "-f", str(out_model if rank == 0 else tmp_path / f"{tag}_r{rank}.fw"),
            "--fwt_hosts", "2", "--fwt_host_id", str(rank),
            "--fwt_coordinator", f"127.0.0.1:{port}"]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fwumious_wabbit_tpu", *argv], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=RUN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, \
            f"{tag} rank {rank} failed:\n{out.decode(errors='replace')[-4000:]}"


def port_mesh_train(data, flags, out_model, extra, tmp_path) -> None:
    """The port's one command: it starts the mesh's gloo ranks itself."""
    r = subprocess.run(
        [sys.executable, "-m", "fwumious_wabbit_tpu_torch", *flags, *extra,
         "--data", str(data), "-f", str(out_model)],
        cwd=REPO, env=rank_env(tmp_path), capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-4000:]
    assert f"[rank {MESH[0] * MESH[1] - 1}]" in r.stderr


def test_distributed_train_patch_hotswap_chain(tmp_path):
    """BASELINE config 5 as one chain, v1 and v2 trained on a 2×2 a2a mesh
    in both packages."""
    (tmp_path / "vw_namespace_map.csv").write_text(NS_CSV)
    train1, train2 = tmp_path / "t1.vw", tmp_path / "t2.vw"
    gen_ctr_stream(train1, 1024, seed=31)
    gen_ctr_stream(train2, 1024, seed=32)
    flags = [
        "--keep", "A", "--keep", "B", "--interactions", "AB",
        "-l", "0.1", "-b", "18", "--adaptive", "--sgd",
        "--loss_function", "logistic", "--link", "logistic",
        "--power_t", "0.5", "--hash", "all",
        "--fwt_platform", "cpu", "--fwt_batch_size", "64", "--save_resume",
    ]
    mesh = flags + ["--fwt_data_axis", str(MESH[0]), "--fwt_table_axis",
                    str(MESH[1]), "--fwt_exchange", "a2a"]
    served = {}
    for tag, cli, patcher in (("jax", jax_main, jpatcher),
                              ("port", main, weight_patcher)):
        v1, v2 = tmp_path / f"{tag}_v1.fwt", tmp_path / f"{tag}_v2.fwt"
        if tag == "jax":
            jax_mesh_train(train1, mesh, v1, [], tmp_path, "v1")
            jax_mesh_train(train2, mesh, v2, ["-i", str(v1)], tmp_path, "v2")
        else:
            port_mesh_train(train1, mesh, v1, [], tmp_path)
            port_mesh_train(train2, mesh, v2, ["-i", str(v1)], tmp_path)
        # the exports, the serving and the offline probe in one process
        v1q, v2q, v2q_re = export_and_patch(cli, patcher, flags, v1, v2,
                                            tmp_path, tag)
        served[tag] = serve_and_swap(v1q, v2q_re, flags, jax=tag == "jax")
        if tag == "port":
            assert abs(served[tag][1] - offline(main, flags, v2q, tmp_path, "port")) \
                <= SERVE_ATOL
    before, after = served["port"]
    assert before != after
    assert abs(after - served["jax"][1]) <= CHAIN_ATOL, (after, served["jax"])
