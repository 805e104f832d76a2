"""The training stream's semantics through the port's CLI, held against the
JAX CLI on the same file (the counterparts of tests/test_loop_semantics.py):
an empty line ends the stream, on the C++ ingest and on the Python one,
and with the C++ ingest's parse shards; an in-band ``flush`` aborts
training with exit code 1 and publishes no record cache; a ``flush`` after
the empty line is never seen; ``--predictions_stdout`` writes the ``-p``
lines; ``--quiet`` silences the progress line; and the flags that are
accepted for compatibility train. Each compares the port's ``-p`` (within
2e-6: each side rounds to %.6f) and exit code with the JAX CLI's."""

import logging

import numpy as np
import pytest

from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu_torch.train.loop import main

from torch_parity import jax_native_loaded, one_torch_thread  # noqa: F401 (autouse)

PRED_ATOL = 2e-6
LOOP_ARGV = ["--keep", "A", "--keep", "B", "--interactions", "AB", "-b", "20",
             "--adaptive", "-l", "0.1", "--power_t", "0.0",
             "--fwt_batch_size", "64", "--fwt_platform", "cpu"]
INGEST = {"native": [], "python": ["--fwt_no_native"]}


def write_dataset(tmp_path, rows=300, seed=0):
    """tests/test_loop_semantics.py's data: the label is the parity of two
    feature ids."""
    rng = np.random.default_rng(seed)
    (tmp_path / "vw_namespace_map.csv").write_text("A,animal\nB,food\n")
    data = tmp_path / "data.vw"
    with open(data, "w") as f:
        for _ in range(rows):
            a, b = rng.integers(0, 20), rng.integers(0, 20)
            f.write(f"{1 if (a + b) % 2 == 0 else -1} |A a{a} |B b{b}\n")
    return data


def preds(path) -> np.ndarray:
    return np.array([float(x) for x in path.read_text().split()])


def both(tmp_path, argv, tag) -> np.ndarray:
    """``argv`` through the JAX CLI and the port's, exit 0 each; the port's
    ``-p`` within PRED_ATOL of the JAX CLI's, line for line."""
    got = {}
    for name, cli in (("jax", jax_main), ("port", main)):
        out = tmp_path / f"{tag}_{name}.out"
        assert cli(argv + ["-p", str(out)]) == 0, name
        got[name] = preds(out)
    assert got["port"].shape == got["jax"].shape
    np.testing.assert_allclose(got["port"], got["jax"], rtol=0, atol=PRED_ATOL)
    return got["port"]


def cut_dataset(tmp_path, after: bytes = b"") -> object:
    """tests/test_loop_semantics.py's 50-line file with an empty line after
    line 30, and ``after`` behind it."""
    data = write_dataset(tmp_path, rows=50)
    lines = data.read_bytes().splitlines(keepends=True)
    data.write_bytes(b"".join(lines[:30]) + b"\n" + after + b"".join(lines[30:]))
    return data


@pytest.mark.parametrize("ingest", list(INGEST))
def test_empty_line_terminates_stream(tmp_path, ingest):
    data = cut_dataset(tmp_path)
    got = both(tmp_path, LOOP_ARGV + ["--data", str(data)] + INGEST[ingest], "cut")
    assert got.size == 30


@pytest.mark.parametrize("ingest", list(INGEST))
def test_inband_command_after_empty_line_is_never_seen(tmp_path, ingest):
    """A flush after the empty line does not abort: the stream ended
    before it."""
    data = cut_dataset(tmp_path, after=b"flush\n")
    got = both(tmp_path, LOOP_ARGV + ["--data", str(data)] + INGEST[ingest],
               "cutflush")
    assert got.size == 30


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "no_cache"])
@pytest.mark.parametrize("ingest", list(INGEST))
def test_inband_command_in_training_file_aborts(tmp_path, ingest, cache):
    """An in-band flush in a training file aborts the run with exit code 1
    in both CLIs, and an aborted -c run publishes no cache."""
    (tmp_path / "vw_namespace_map.csv").write_text("A,a\nB,b\n")
    data = tmp_path / "d.vw"
    data.write_text("1 |A x |B y\nflush\n-1 |A z |B w\n")
    flags = ["--data", str(data), "--keep", "A", "--keep", "B", "-b", "18",
             "--adaptive", "-l", "0.1", "--fwt_platform", "cpu",
             "--fwt_batch_size", "8", *INGEST[ingest], *(["-c"] if cache else [])]
    for name, cli in (("jax", jax_main), ("port", main)):
        assert cli(flags + ["-p", str(tmp_path / f"{name}.out")]) == 1, name
        assert not (tmp_path / "d.vw.fwcache").exists(), name


def test_predictions_stdout(tmp_path, capsys):
    """--predictions_stdout writes the -p file's %.6f lines to stdout."""
    (tmp_path / "vw_namespace_map.csv").write_text("A,a\nB,b\n")
    data = tmp_path / "d.vw"
    data.write_text("".join(
        f"{1 if i % 2 else -1} |A a{i % 5} |B b{i % 3}\n" for i in range(32)))
    argv = ["--data", str(data), "--keep", "A", "--keep", "B", "-b", "18",
            "--adaptive", "-l", "0.1", "--fwt_platform", "cpu",
            "--fwt_batch_size", "8", "--predictions_stdout"]
    capsys.readouterr()
    both(tmp_path, argv, "stdout")
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line and line[0].isdigit()]
    jax_lines = (tmp_path / "stdout_jax.out").read_text().splitlines()
    port_lines = (tmp_path / "stdout_port.out").read_text().splitlines()
    assert lines == jax_lines + port_lines  # the JAX CLI ran first
    assert len(port_lines) == 32
    assert all(len(line.split(".")[1]) == 6 for line in port_lines)


@pytest.mark.parametrize("name,cli", [("jax", jax_main), ("port", main)])
def test_quiet_suppresses_progress(tmp_path, caplog, name, cli):
    """--quiet raises the root log level to WARNING, so the progress line
    is not logged; without it, it is; both CLIs exit 0."""
    (tmp_path / "vw_namespace_map.csv").write_text("A,a\n")
    data = tmp_path / "d.vw"
    data.write_text("".join(f"{1 if i % 2 else -1} |A a{i % 4}\n" for i in range(16)))
    common = ["--data", str(data), "--keep", "A", "-b", "16", "--adaptive",
              "--fwt_platform", "cpu", "--fwt_batch_size", "8"]
    root = logging.getLogger()
    before = root.level
    try:
        with caplog.at_level(logging.INFO):
            assert cli(common) == 0
        assert [r for r in caplog.records if "Elapsed" in r.getMessage()]
        caplog.clear()
        root.setLevel(before)
        assert cli(common + ["--quiet"]) == 0
        assert root.level == logging.WARNING
        assert not [r for r in caplog.records
                    if r.levelno < logging.WARNING and "Elapsed" in r.getMessage()]
    finally:
        root.setLevel(before)


@pytest.mark.parametrize("extra", [
    ["--fwt_batch_cap", "4", "--fwt_batch_mean", "on"],
    ["--fwt_pallas_update", "off"],
    ["--hogwild_training", "--hogwild_threads", "4"],
], ids=["batch_cap", "pallas_flag", "hogwild"])
def test_accepted_flag_smoke(tmp_path, extra):
    """The knobs that remain parse and train end to end in both CLIs, with
    the same predictions. ``--fwt_pallas_update`` only parses in the port
    (on a CUDA tensor the sparse update kernel always runs), as it only
    parses on the JAX package's CPU backend."""
    (tmp_path / "vw_namespace_map.csv").write_text("A,a\n")
    data = tmp_path / "d.vw"
    data.write_text("".join(f"{1 if i % 2 else -1} |A a{i % 4}\n" for i in range(24)))
    got = both(tmp_path, ["--data", str(data), "--keep", "A", "-b", "16",
                          "--adaptive", "-l", "0.1", "--fwt_platform", "cpu",
                          "--fwt_batch_size", "8", *extra], "flags")
    assert got.size == 24


def test_empty_line_stop_with_parallel_shards(tmp_path, monkeypatch):
    """An empty line early in a block wide enough to span every parse
    shard of the port's C++ ingest: the later shards parse bytes after the
    end of the stream, and are dropped whole. The JAX test's count, and
    the JAX CLI's -p on the same file."""
    from fwumious_wabbit_tpu_torch import native
    from fwumious_wabbit_tpu_torch.train.producer import native_batch_stream

    data = write_dataset(tmp_path, rows=20000)
    lines = data.read_bytes().splitlines(keepends=True)
    data.write_bytes(b"".join(lines[:100]) + b"\n" + b"".join(lines[100:]))
    argv = ["--keep", "A", "--keep", "B", "-b", "20", "--adaptive", "-l", "0.1",
            "--data", str(data), "--fwt_batch_size", "64"]
    args = build_parser().parse_args(argv)
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    mi = ModelInstance.from_cmdline(args, vw)
    orig = native.NativeIngest.__init__

    def four_shards(self, mi_, vw_, num_threads=None):
        orig(self, mi_, vw_, num_threads=4)

    monkeypatch.setattr(native.NativeIngest, "__init__", four_shards)
    assert sum(k for _bd, k in native_batch_stream(args, mi, vw, 64)) == 100
    got = both(tmp_path, argv + ["--fwt_platform", "cpu"], "shards")
    assert got.size == 100
