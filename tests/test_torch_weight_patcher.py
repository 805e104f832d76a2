"""The port's weight patcher (fwumious_wabbit_tpu_torch/tools/weight_patcher.py
and its C++ tool native/weight_patcher.cpp, built from the port's sources
by g++ with zlib at first use, under a file lock) against the JAX module
fwumious_wabbit_tpu/tools/weight_patcher.py: the cases of
tests/test_weight_patcher.py, the diff payloads byte-equal to the JAX
module's on the same files (the gzip stream's header holds a timestamp, so
the payload inside it is what is compared), the C++ tool and the Python
path interoperating in both directions, a model file patched, the CLI, and
a tool that cannot be built logging g++'s message before the Python path
takes over."""

import gzip
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fwumious_wabbit_tpu.tools import weight_patcher as jwp
from fwumious_wabbit_tpu_torch import native
from fwumious_wabbit_tpu_torch.tools import weight_patcher as wp

REPO = Path(__file__).resolve().parents[1]


def payload(path: Path) -> bytes:
    return gzip.decompress(path.read_bytes())


def random_pair(seed: int, n: int, flips: int) -> tuple[bytes, bytes]:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    b = bytearray(a)
    for i in rng.integers(0, len(a), flips):
        b[i] = (b[i] ^ 0x5A) & 0xFF
    return a, bytes(b)


def test_python_roundtrip_identical():
    a = bytes(range(256)) * 10
    diff = wp.create_diff_bytes(a, a)
    assert diff == b""
    assert wp.recreate_bytes(a, diff) == a


def test_python_roundtrip_random():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, 10000, dtype=np.uint8).tobytes()
    b = bytearray(a)
    for i in rng.integers(0, len(a), 500):
        b[i] = (b[i] + 1) % 256
    b = bytes(b)
    diff = wp.create_diff_bytes(a, b)
    assert wp.recreate_bytes(a, diff) == b


def test_first_byte_differs():
    a, b = b"xbc", b"ybc"
    diff = wp.create_diff_bytes(a, b)
    assert diff == b"\x00" + b"y"
    assert wp.recreate_bytes(a, diff) == b


@pytest.mark.parametrize("seed,n,flips", [(0, 1, 1), (1, 1000, 3), (2, 70000, 900),
                                          (3, 5000, 0)])
def test_payload_equals_the_jax_module(seed, n, flips):
    a, b = random_pair(seed, n, flips)
    diff = wp.create_diff_bytes(a, b)
    assert diff == jwp.create_diff_bytes(a, b)
    assert wp.recreate_bytes(a, diff) == jwp.recreate_bytes(a, diff) == b
    # unequal lengths take the JAX module's rule too
    assert wp.create_diff_bytes(a, b + b"\x01\x02") == jwp.create_diff_bytes(a, b + b"\x01\x02")


def test_the_tool_is_built_from_the_port_sources():
    exe = native.weight_patcher()
    assert exe.parent == native.BUILD_DIR and exe.name.startswith("weight_patcher-")
    assert exe == native.patcher_path() and exe.exists()
    assert wp.native_tool() == exe
    r = subprocess.run([str(exe)], capture_output=True, text=True)
    assert r.returncode == 2 and "create_diff" in r.stderr


def test_native_python_interop(tmp_path):
    a, b = random_pair(1, 300000, 4000)
    pa, pb = tmp_path / "a", tmp_path / "b"
    pa.write_bytes(a)
    pb.write_bytes(b)
    # the port's C++ tool → Python recreate, and the JAX module's Python
    wp.create_diff(pa, pb, tmp_path / "d1", use_native=True)
    wp.recreate(pa, tmp_path / "d1", tmp_path / "o1", use_native=False)
    assert (tmp_path / "o1").read_bytes() == b
    jwp.recreate(pa, tmp_path / "d1", tmp_path / "o1j", use_native=False)
    assert (tmp_path / "o1j").read_bytes() == b
    # Python create (the port's and the JAX module's) → the C++ recreate
    wp.create_diff(pa, pb, tmp_path / "d2", use_native=False)
    jwp.create_diff(pa, pb, tmp_path / "d3", use_native=False)
    wp.recreate(pa, tmp_path / "d3", tmp_path / "o2", use_native=True)
    assert (tmp_path / "o2").read_bytes() == b
    assert payload(tmp_path / "d1") == payload(tmp_path / "d2") == payload(tmp_path / "d3")


def test_patch_model_files(tmp_path):
    """Ship a checkpoint as a diff against the previous one: two model files
    of the port's training CLI, a few lines apart."""
    from fwumious_wabbit_tpu_torch.train.loop import main

    from torch_parity import BASE_ARGV, FFM_ARGV, make_vw, vw_lines

    make_vw(tmp_path)
    argv = [a for a in BASE_ARGV if a not in ("--data", "x")] + FFM_ARGV + [
        "--fwt_platform", "cpu", "--fwt_no_native", "--save_resume"]
    lines = vw_lines(64, seed=3)
    for name, n in (("m1", 48), ("m2", 64)):
        data = tmp_path / f"{name}.vw"
        data.write_bytes(b"".join(lines[:n]))
        assert main(argv + ["--data", str(data), "-f", str(tmp_path / f"{name}.fwt")]) == 0
    m1, m2 = tmp_path / "m1.fwt", tmp_path / "m2.fwt"
    wp.create_diff(m1, m2, tmp_path / "patch")
    wp.recreate(m1, tmp_path / "patch", tmp_path / "m2r.fwt")
    assert (tmp_path / "m2r.fwt").read_bytes() == m2.read_bytes()
    assert (tmp_path / "patch").stat().st_size < m2.stat().st_size / 4
    assert payload(tmp_path / "patch") == jwp.create_diff_bytes(m1.read_bytes(),
                                                                m2.read_bytes())


def test_cli(tmp_path):
    a, b = random_pair(4, 20000, 50)
    (tmp_path / "a").write_bytes(a)
    (tmp_path / "b").write_bytes(b)

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "fwumious_wabbit_tpu_torch.tools.weight_patcher",
             *map(str, args)], cwd=REPO, capture_output=True, text=True,
            env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                 "HOME": str(tmp_path)})

    assert cli("create_diff", tmp_path / "a", tmp_path / "b", tmp_path / "d").returncode == 0
    assert cli("recreate", tmp_path / "a", tmp_path / "d", tmp_path / "o").returncode == 0
    assert (tmp_path / "o").read_bytes() == b
    r = cli("bogus")
    assert r.returncode == 2 and "create_diff" in r.stderr


def test_a_failed_build_is_logged_then_python_runs(tmp_path, monkeypatch, caplog):
    def broken():
        raise RuntimeError("g++ failed (1): g++ ... weight_patcher.cpp\n"
                           "fatal error: zlib.h: No such file or directory")

    monkeypatch.setattr(native, "weight_patcher", broken)
    a, b = random_pair(5, 4000, 30)
    (tmp_path / "a").write_bytes(a)
    (tmp_path / "b").write_bytes(b)
    with caplog.at_level(logging.WARNING):
        wp.create_diff(tmp_path / "a", tmp_path / "b", tmp_path / "d")
    assert "zlib.h: No such file" in caplog.text
    assert payload(tmp_path / "d") == jwp.create_diff_bytes(a, b)
