"""The port's CLI under a mesh, one process per device: N ranks of
``python -m fwumious_wabbit_tpu_torch --fwt_platform cpu --fwt_hosts N
--fwt_host_id r --fwt_coordinator 127.0.0.1:P`` (gloo) against the JAX
CLI's mesh runs on the 8 virtual CPU devices of tests/conftest.py — the
runs of tests/test_cli_multidevice.py (a2a by ``auto``, psum on 4×2, all on
data, an explicit a2a capacity) and of tests/test_multiprocess.py (every
rank's ``-f`` and ``-p`` the same file). The ``-p`` files within 2e-6 of
the JAX mesh run's (each side rounds to %.6f) and of the port's own
single-rank run; the ``-f`` files of the same size as a plain run's (the
mesh padding cut off) with every table within rtol 1e-5 / atol 1e-6 of the
port's single-rank run and of the JAX mesh run (the training CLI parity
bound of tests/test_torch_train_cli.py). Besides: ``-t -i`` under a mesh,
``a2a_dropped`` in FWT_COUNTERS_OUT, the tower under a 1×2 mesh started by
one command (parallel/launch.py) byte-equal to its explicit launch, and a
mesh larger than an explicit process group exiting 1 with the flags named.

Each launch starts its ranks once per module, from one module-scoped
fixture, every rank with its own timeout."""

from __future__ import annotations

import json
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fwumious_wabbit_tpu.persistence import model_file as jmf
from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch import synthetic
from fwumious_wabbit_tpu_torch.train.loop import main

from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import free_port, jax_native_loaded, to_numpy  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240
PRED_ATOL = 2e-6
COMMON = ["--keep", "A", "--keep", "B", "--interactions", "AB",
          "--ffm_k", "4", "--ffm_field", "A", "--ffm_field", "B",
          "-b", "18", "--adaptive", "-l", "0.1", "--power_t", "0.5",
          "--fwt_batch_size", "64", "--save_resume"]
# name → (ranks, mesh flags): tests/test_cli_multidevice.py's cases on 8
# ranks (one on the Python ingest), and a 2-rank 1×2 mesh
LAUNCHES = {
    "table2": (8, ["--fwt_table_axis", "2"]),
    "psum": (8, ["--fwt_data_axis", "4", "--fwt_table_axis", "2",
                 "--fwt_exchange", "psum"]),
    "data8_python_ingest": (8, ["--fwt_data_axis", "8", "--fwt_no_native"]),
    "a2a_explicit_1x2": (2, ["--fwt_table_axis", "2", "--fwt_exchange", "a2a",
                             "--fwt_a2a_capacity", "8.0"]),
}
# BASELINE config 3's tower on a 1×2 mesh: the tower's dense all_reduce
TOWER_1X2 = ["--fwt_table_axis", "2", *synthetic.TOWER_FLAGS]


def write_dataset(d: Path, rows: int = 256) -> Path:
    """tests/test_cli_multidevice.py write_dataset."""
    rng = np.random.default_rng(1)
    (d / "vw_namespace_map.csv").write_text("A,animal\nB,food\n")
    data = d / "data.vw"
    with open(data, "w") as f:
        for _ in range(rows):
            a, b = rng.integers(0, 30), rng.integers(0, 30)
            f.write(f"{1 if (a * b) % 3 == 0 else -1} |A a{a} |B b{b}\n")
    return data


def rank_env(d: Path, counters: Path | None = None) -> dict:
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(d),
           "OMP_NUM_THREADS": "1"}
    if counters is not None:
        env["FWT_COUNTERS_OUT"] = str(counters)
    return env


def launch(d: Path, tag: str, world: int, argv: list) -> list:
    """``world`` ranks of the port's CLI with ``argv``; each writes
    ``{tag}_{r}.out``, ``{tag}_{r}.fwt`` and ``{tag}_{r}.json``. Returns
    the ranks' outputs."""
    port = free_port()
    procs = []
    for r in range(world):
        env = rank_env(d, d / f"{tag}_{r}.json")
        cmd = [sys.executable, "-m", "fwumious_wabbit_tpu_torch", *argv,
               "--fwt_platform", "cpu", "-p", str(d / f"{tag}_{r}.out"),
               "--fwt_hosts", str(world), "--fwt_host_id", str(r),
               "--fwt_coordinator", f"127.0.0.1:{port}"]
        if "-t" not in argv:
            cmd += ["-f", str(d / f"{tag}_{r}.fwt")]
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{tag}: rank {r} of {world} failed:\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch, the port's single-rank run, ``-t -i`` of the
    single-rank model on a 2-rank a2a mesh and on one rank, and the tower
    on a 1×2 mesh, launched explicitly and by one command."""
    d = tmp_path_factory.mktemp("mesh_cli")
    data = write_dataset(d)
    base = COMMON + ["--data", str(data)]
    for tag, (world, flags) in LAUNCHES.items():
        launch(d, tag, world, base + flags)
    launch(d, "tower_1x2", 2, base + TOWER_1X2)
    one = subprocess.run(
        [sys.executable, "-m", "fwumious_wabbit_tpu_torch", *base, *TOWER_1X2,
         "--fwt_platform", "cpu", "-p", str(d / "tower_one.out"),
         "-f", str(d / "tower_one.fwt")], cwd=REPO, env=rank_env(d),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=RANK_TIMEOUT_S)
    assert one.returncode == 0, one.stdout.decode(errors="replace")[-4000:]
    single = [*base, "--fwt_platform", "cpu", "-p", str(d / "single.out"),
              "-f", str(d / "single.fwt")]
    assert main(single) == 0
    predict = ["-t", "-i", str(d / "single.fwt"), "--data", str(data)]
    launch(d, "predict_1x2", 2, predict + ["--fwt_table_axis", "2"])
    assert main([*predict, "--fwt_platform", "cpu",
                 "--fwt_serve_engine", "device",
                 "-p", str(d / "predict_single.out")]) == 0
    return d, data


def preds(path: Path) -> np.ndarray:
    return np.array([float(x) for x in path.read_text().split()])


def jax_mesh_run(d: Path, data: Path, tag: str) -> tuple:
    """The JAX CLI with the launch's mesh flags on the 8 virtual devices."""
    flags = [a for a in LAUNCHES[tag][1] if a != "--fwt_no_native"]
    p, f = d / f"jax_{tag}.out", d / f"jax_{tag}.fwt"
    if not f.exists():
        assert jax_main(COMMON + ["--data", str(data), "--fwt_platform", "cpu",
                                  "-p", str(p), "-f", str(f), *flags]) == 0
    return preds(p), f


def tables(path: Path) -> dict:
    return {k: v for k, v in to_numpy(jmf.load_model(path)[3]).items()
            if k in ("lr_w", "lr_acc", "ffm_w", "ffm_acc")}


@pytest.mark.parametrize("tag", list(LAUNCHES))
def test_every_rank_writes_the_same_files(tag, runs):
    """tests/test_multiprocess.py: every rank's -p and -f byte for byte,
    the whole stream on each."""
    d, _ = runs
    world = LAUNCHES[tag][0]
    p0, f0 = (d / f"{tag}_0.out").read_bytes(), (d / f"{tag}_0.fwt").read_bytes()
    assert len(p0.splitlines()) == 256
    for r in range(1, world):
        assert (d / f"{tag}_{r}.out").read_bytes() == p0, r
        assert (d / f"{tag}_{r}.fwt").read_bytes() == f0, r


@pytest.mark.parametrize("tag", list(LAUNCHES))
def test_cli_mesh_matches_jax_cli_and_single_rank(tag, runs):
    """tests/test_cli_multidevice.py: the mesh run's predictions equal the
    JAX CLI's mesh run's and the port's single-rank run's."""
    d, data = runs
    got = preds(d / f"{tag}_0.out")
    jax_p, _ = jax_mesh_run(d, data, tag)
    np.testing.assert_allclose(got, jax_p, rtol=0, atol=PRED_ATOL)
    np.testing.assert_allclose(got, preds(d / "single.out"), rtol=0, atol=PRED_ATOL)


@pytest.mark.parametrize("tag", list(LAUNCHES))
def test_mesh_model_file_is_the_unsharded_layout(tag, runs):
    """tests/test_cli_multidevice.py::test_cli_mesh_save_load_roundtrip: the
    gathered, de-padded file has the plain run's size and header, and its
    tables are the single-rank run's and the JAX mesh run's."""
    d, data = runs
    path = d / f"{tag}_0.fwt"
    assert path.stat().st_size == (d / "single.fwt").stat().st_size
    _, jax_f = jax_mesh_run(d, data, tag)
    assert path.stat().st_size == jax_f.stat().st_size
    got = tables(path)
    for ref in (tables(d / "single.fwt"), tables(jax_f)):
        assert set(got) == set(ref)
        for key in got:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-6,
                                       err_msg=key)


def test_a2a_dropped_is_counted_in_the_counters(runs):
    """tests/test_sharded.py::test_a2a_overflow_counter_via_cli_loop: the
    run's a2a_dropped reaches FWT_COUNTERS_OUT, 0 at a healthy capacity, on
    every rank."""
    d, _ = runs
    for r in range(2):
        result = json.loads((d / f"a2a_explicit_1x2_{r}.json").read_text())
        assert result["examples"] == 256
        assert result["a2a_dropped"] == 0


def test_testonly_predicts_through_the_mesh(runs):
    """``-t -i`` on a 1×2 a2a mesh: the same predictions as one rank."""
    d, _ = runs
    want = (d / "predict_single.out").read_bytes()
    assert len(want.splitlines()) == 256
    for r in range(2):
        assert (d / f"predict_1x2_{r}.out").read_bytes() == want


def test_one_command_tower_mesh_equals_the_explicit_run(runs):
    """The tower under ``--fwt_table_axis 2`` with no process-group flags:
    one command starts both ranks, and rank 0's ``-p`` and ``-f`` are the
    explicit launch's byte for byte."""
    d, _ = runs
    for ext in ("out", "fwt"):
        assert (d / f"tower_one.{ext}").read_bytes() == \
            (d / f"tower_1x2_0.{ext}").read_bytes(), ext
    assert len((d / "tower_one.out").read_bytes().splitlines()) == 256


def test_a_mesh_larger_than_the_group_exits_1(tmp_path, caplog):
    """One process per device: --fwt_table_axis 2 in an explicit process
    group of one rank (``--fwt_hosts 1 --fwt_coordinator``) is refused,
    naming the flags, and writes nothing. Without the group's flags the
    same mesh starts its own ranks
    (test_one_command_tower_mesh_equals_the_explicit_run)."""
    data = write_dataset(tmp_path, rows=8)
    with caplog.at_level(logging.ERROR):
        rc = main(COMMON + ["--data", str(data), "--fwt_platform", "cpu",
                            "--fwt_table_axis", "2", "--fwt_hosts", "1",
                            "--fwt_coordinator", f"127.0.0.1:{free_port()}",
                            "-p", str(tmp_path / "p.out")])
    assert rc == 1
    assert "--fwt_table_axis" in caplog.text and "--fwt_hosts" in caplog.text
    assert not (tmp_path / "p.out").exists()
