"""One command on a host of several devices (parallel/launch.py): ``python
-m fwumious_wabbit_tpu_torch ... --fwt_platform cpu --fwt_data_axis 4
--fwt_table_axis 2`` with no process-group flags starts its gloo ranks
itself, as the JAX CLI drives every local device from one process.

* The one-command runs of a 4×2 psum mesh and of a 1×2 a2a mesh write
  ``-p`` and ``-f`` byte-equal to the explicit launch of the same mesh
  (``--fwt_hosts N --fwt_host_id r --fwt_coordinator``, every rank given
  paths of its own), and within tests/test_torch_mesh_cli.py's bounds of
  the JAX CLI's run of the same flags on the 8 virtual devices of
  tests/conftest.py.
* Each named path is written once: rank 0 writes ``-p`` and ``-f``, the
  other ranks nothing the user named, and FWT_COUNTERS_OUT gives every rank
  a file of its own.
* With the batch-mean cap (power_t 0) a mesh trains what one process
  trains: the sharded step reads the host's multiplicity counts, as the
  single-device step does, where a partial last batch's count is one the
  8-bit count code rounds up.
* On a 1×4 a2a mesh at the default capacity the padded FFM positions take
  no slot of owner 0's bucket: no drop, and the single process's result.
* A failing rank ends the run at once: a non-zero exit that names the rank
  and its last lines, no process left behind, and a return well inside the
  process group's timeout.
* The cover rule is the JAX package's ``make_mesh``: the same (devices,
  n_data, n_table) cases are accepted, with the same shape, or refused; on
  a host of cards a mesh that does not cover them exits 1 naming the flags
  and the count, and starts and writes nothing.

The launches start once per module, from one module-scoped fixture, each
with its own timeout."""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import jax

from fwumious_wabbit_tpu.parallel.mesh import make_mesh
from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch.parallel import distributed, launch
from fwumious_wabbit_tpu_torch.train.loop import main

from test_torch_mesh_cli import (COMMON, PRED_ATOL, RANK_TIMEOUT_S, REPO,
                                 preds, rank_env, tables, write_dataset)
from test_torch_mesh_cli import launch as explicit_launch
from torch_parity import jax_native_loaded  # noqa: F401 (autouse)

# name → (ranks, mesh flags)
MESHES = {
    "psum_4x2": (8, ["--fwt_data_axis", "4", "--fwt_table_axis", "2",
                     "--fwt_exchange", "psum"]),
    "a2a_1x2": (2, ["--fwt_table_axis", "2"]),
}
# a failed rank's run returns within this, far inside the group's timeout
FAIL_FAST_S = 60


def one_command(d: Path, data: Path, tag: str, flags: list, predictions: Path):
    """The port's CLI with ``flags`` and no process-group flags, in a
    process of its own, ``-p predictions`` and ``-f`` beside it."""
    out = d / tag
    out.mkdir(exist_ok=True)
    return subprocess.run(
        [sys.executable, "-m", "fwumious_wabbit_tpu_torch", *COMMON,
         "--data", str(data), "--fwt_platform", "cpu", *flags,
         "-p", str(predictions), "-f", str(out / "m.fwt")],
        cwd=REPO, env=rank_env(d, out / "counters.json"), capture_output=True,
        text=True, timeout=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh by one command and by its explicit launch, and the JAX
    CLI's run of its flags."""
    d = tmp_path_factory.mktemp("launch")
    data = write_dataset(d)
    for tag, (world, flags) in MESHES.items():
        r = one_command(d, data, tag, flags, d / tag / "p.out")
        assert r.returncode == 0, r.stderr[-4000:]
        explicit_launch(d, f"explicit_{tag}", world,
                        COMMON + ["--data", str(data), *flags])
        assert jax_main(COMMON + ["--data", str(data), "--fwt_platform", "cpu",
                                  "-p", str(d / f"jax_{tag}.out"),
                                  "-f", str(d / f"jax_{tag}.fwt"), *flags]) == 0
    return d


@pytest.mark.parametrize("tag", list(MESHES))
def test_one_command_equals_the_explicit_launch(tag, runs):
    d = runs
    assert (d / tag / "p.out").read_bytes() == (d / f"explicit_{tag}_0.out").read_bytes()
    assert (d / tag / "m.fwt").read_bytes() == (d / f"explicit_{tag}_0.fwt").read_bytes()
    assert len((d / tag / "p.out").read_bytes().splitlines()) == 256


@pytest.mark.parametrize("tag", list(MESHES))
def test_one_command_matches_the_jax_cli(tag, runs):
    """Within the bounds of tests/test_torch_mesh_cli.py: ``-p`` within
    2e-6 and every table within rtol 1e-5 / atol 1e-6 of the JAX CLI's
    run of the same flags on 8 devices (a 4×2 mesh for both: the 1×2 a2a
    run does the same arithmetic with no drops)."""
    d = runs
    np.testing.assert_allclose(preds(d / tag / "p.out"), preds(d / f"jax_{tag}.out"),
                               rtol=0, atol=PRED_ATOL)
    got, want = tables(d / tag / "m.fwt"), tables(d / f"jax_{tag}.fwt")
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("tag", list(MESHES))
def test_each_named_path_is_written_once(tag, runs):
    """Rank 0 wrote ``-p`` and ``-f``, no other rank wrote a file the user
    named, and every rank's counters are in a file of their own."""
    d = runs
    world = MESHES[tag][0]
    extra = {f"counters.json.rank{r}" for r in range(1, world)}
    assert {p.name for p in (d / tag).iterdir()} == {"p.out", "m.fwt",
                                                     "counters.json", *extra}
    for r in range(world):
        name = "counters.json" + (f".rank{r}" if r else "")
        result = json.loads((d / tag / name).read_text())
        assert result["mesh"]["rank"] == r
        assert result["examples"] == 256
        want = [str(d / tag / "p.out"), str(d / tag / "m.fwt")] if r == 0 else []
        assert result["files_written"] == want, r


@pytest.mark.parametrize("flags", [["--fwt_data_axis", "2"],
                                   ["--fwt_table_axis", "2"]],
                         ids=["psum_2x1", "a2a_1x2"])
def test_mesh_with_the_batch_mean_cap_trains_what_one_process_trains(flags, tmp_path):
    """At power_t 0 (the batch-mean cap) over 145 lines at B=64 the last
    batch holds 17 examples, and the constant feature's count 17 is coded
    18 by the host's 8-bit count code: the single-process step scales by
    8/18. The mesh reads the same counts, so its ``-p`` and tables are the
    single process's within tests/test_torch_mesh_cli.py's bounds (the
    rows' own count, 17, moved the constant's weight by 6.5e-4 in a run
    of this kind)."""
    data = write_dataset(tmp_path, rows=145)
    common = [*COMMON, "--power_t", "0", "--fwt_platform", "cpu", "--data", str(data)]
    assert main(common + ["-p", str(tmp_path / "one.out"),
                          "-f", str(tmp_path / "one.fwt")]) == 0
    r = subprocess.run(
        [sys.executable, "-m", "fwumious_wabbit_tpu_torch", *common, *flags,
         "-p", str(tmp_path / "mesh.out"), "-f", str(tmp_path / "mesh.fwt")],
        cwd=REPO, env=rank_env(tmp_path), capture_output=True, text=True,
        timeout=RANK_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-4000:]
    np.testing.assert_allclose(preds(tmp_path / "mesh.out"), preds(tmp_path / "one.out"),
                               rtol=0, atol=PRED_ATOL)
    got, want = tables(tmp_path / "mesh.fwt"), tables(tmp_path / "one.fwt")
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_padding_takes_no_a2a_slot(tmp_path):
    """``--fwt_table_axis 4`` at the default a2a capacity (2.0) and B=256:
    a rank's 64 examples hold 256 FFM positions, 128 of them the ingest's
    padding (id 0, field −1), and each owner's bucket has 128 slots.
    Padding that took slots would fill owner 0's and drop its real rows; it
    takes none, so no rank drops and the mesh trains what one process
    trains."""
    data = write_dataset(tmp_path, rows=512)
    common = [*COMMON, "--fwt_platform", "cpu", "--data", str(data),
              "--fwt_batch_size", "256"]
    assert main(common + ["-p", str(tmp_path / "one.out"),
                          "-f", str(tmp_path / "one.fwt")]) == 0
    r = one_command(tmp_path, data, "a2a_1x4",
                    ["--fwt_table_axis", "4", "--fwt_batch_size", "256"],
                    tmp_path / "a2a_1x4" / "p.out")
    assert r.returncode == 0, r.stderr[-4000:]
    for rank in range(4):
        name = "counters.json" + (f".rank{rank}" if rank else "")
        assert json.loads((tmp_path / "a2a_1x4" / name).read_text())["a2a_dropped"] == 0
    np.testing.assert_allclose(preds(tmp_path / "a2a_1x4" / "p.out"),
                               preds(tmp_path / "one.out"), rtol=0, atol=PRED_ATOL)
    got, want = tables(tmp_path / "a2a_1x4" / "m.fwt"), tables(tmp_path / "one.fwt")
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def _processes_naming(text: str) -> list:
    """Pids of live processes whose command line holds ``text``."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            cmdline = Path(f"/proc/{pid}/cmdline").read_bytes()
        except OSError:
            continue
        if text.encode() in cmdline:
            found.append(int(pid))
    return found


def test_a_failing_rank_ends_the_run(tmp_path):
    """Rank 0 cannot open its ``-p`` (no such directory) while rank 1
    waits for it in the group: the command exits 1 at once, names rank 0
    and its last lines, and leaves no process behind."""
    data = write_dataset(tmp_path, rows=64)
    t0 = time.perf_counter()
    r = one_command(tmp_path, data, "fails", MESHES["a2a_1x2"][1],
                    tmp_path / "missing" / "p.out")
    took = time.perf_counter() - t0
    assert r.returncode == 1
    assert "rank 0 of 2 exited 1" in r.stderr
    assert "FileNotFoundError" in r.stderr.split("rank 0 of 2 exited 1")[1]
    assert took < FAIL_FAST_S < distributed.TIMEOUT.total_seconds()
    assert _processes_naming(str(data)) == []
    assert not (tmp_path / "fails" / "m.fwt").exists()


def test_a_rank_that_fails_after_its_peer_is_named_first(caplog):
    """Rank 1 exits at once (as a peer that lost rank 0 in a collective
    does); rank 0, the cause, exits 0.3 s later: both are named, rank 0
    first with its own last lines, and the call returns 1."""
    def rank(code: int, delay: float, said: str):
        return ([sys.executable, "-c", f"import sys, time; time.sleep({delay}); "
                 f"print({said!r}, file=sys.stderr); sys.exit({code})"],
                dict(os.environ))

    with caplog.at_level(logging.ERROR):
        rc = launch.supervise([rank(3, 0.3, "the cause"), rank(5, 0.0, "a peer")])
    assert rc == 1
    said = [r.getMessage() for r in caplog.records if "exited" in r.getMessage()]
    assert len(said) == 2
    assert said[0].startswith("rank 0 of 2 exited 3") and "the cause" in said[0]
    assert said[1].startswith("rank 1 of 2 exited 5") and "a peer" in said[1]


# (devices, n_data, n_table): accepted and refused by make_mesh
COVER_CASES = [(1, None, 1), (4, None, 4), (4, None, 2), (4, None, 1),
               (4, 2, 2), (4, 1, 4), (8, None, 2), (8, 8, 1), (1, None, 4),
               (4, None, 3), (4, 2, 1), (4, 4, 4), (8, 2, 2), (2, 4, 1)]


@pytest.mark.parametrize("devices,n_data,n_table", COVER_CASES)
def test_the_cover_rule_is_make_mesh(devices, n_data, n_table):
    try:
        want = make_mesh(n_data, n_table, devices=jax.devices()[:devices])
    except ValueError:
        with pytest.raises(ValueError, match=f"--fwt_table_axis {n_table}"):
            launch.mesh_shape(devices, n_data, n_table)
        return
    assert launch.mesh_shape(devices, n_data, n_table) == (
        want.shape["data"], want.shape["table"])


@pytest.mark.parametrize("cards,flags", [(1, ["--fwt_table_axis", "4"]),
                                         (4, ["--fwt_data_axis", "2"]),
                                         (4, ["--fwt_table_axis", "3"])])
def test_a_mesh_that_does_not_cover_the_cards_exits_1(cards, flags, tmp_path,
                                                      monkeypatch, caplog):
    """On a host of ``cards`` cards (torch.cuda mocked) the command refuses
    a mesh that does not cover them: exit 1, the flags and the count
    named, no rank started and nothing written."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    started = []
    monkeypatch.setattr(launch, "supervise", started.append)
    data = write_dataset(tmp_path, rows=8)
    with caplog.at_level(logging.ERROR):
        rc = main(COMMON + ["--data", str(data), *flags,
                            "-p", str(tmp_path / "p.out"),
                            "-f", str(tmp_path / "m.fwt")])
    assert rc == 1
    assert " ".join(flags) in caplog.text
    assert f"the {cards} device(s)" in caplog.text
    assert started == []
    assert sorted(p.name for p in tmp_path.iterdir()) == ["data.vw",
                                                          "vw_namespace_map.csv"]
