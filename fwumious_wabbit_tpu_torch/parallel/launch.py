"""One command on a host of several devices — the counterpart of the JAX
CLI's single-host mesh (fwumious_wabbit_tpu/train/loop.py:161-219,
parallel/mesh.py ``make_mesh``), where one process drives every local
device.

The port runs one process per device (parallel/distributed.py). When the
flags ask for a mesh (``--fwt_data_axis`` / ``--fwt_table_axis`` > 1) and
name no process group (no ``--fwt_hosts``, no ``--fwt_coordinator``), the
CLI starts one rank per device, as ``torchrun`` does: each rank is the same
command with ``--fwt_hosts N --fwt_host_id r --fwt_coordinator
127.0.0.1:P`` appended, ``P`` a free local port, and rank ``r`` takes card
``r`` (utils/device.resolve_device).

* **The mesh rule is make_mesh's** (:func:`mesh_shape`): on the card the
  devices are ``torch.cuda.device_count()`` and ``n_data`` defaults to
  ``count // n_table``; a mesh that does not cover every device is refused
  before anything is started or written. With ``--fwt_platform cpu`` the
  ranks are ``n_data × n_table`` gloo processes, ``n_data`` 1 by default.
* **Each output path is written once**, as by the single JAX process: rank
  0 writes ``-p`` (or stdout), ``-f`` and the record cache of ``-c``; the
  other ranks take part in every collective (the predictions' gather, the
  tables' gather) and write no file the user named (:func:`writes_files`).
  ``FWT_COUNTERS_OUT=<path>`` gives rank 0 ``<path>`` and rank ``r``
  ``<path>.rank<r>``.
* **A rank that fails ends the run**: the others are stopped at once (each
  rank runs in a session of its own, so its children go with it), and the
  command exits 1 naming the rank, its exit code and its last lines, with
  no process left and no wait for the process group's timeout.

Every rank's log lines reach this process's stderr prefixed ``[rank r]``;
rank 0's stdout is this process's (``--predictions_stdout``).
"""

from __future__ import annotations

import collections
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

from ..utils.logging import get_logger

log = get_logger(__name__)

# set in the environment of each rank this module starts
LAUNCHED_ENV = "FWT_LAUNCHED"
TAIL_LINES = 30  # a failed rank's last lines in the error
FAIL_GRACE_S = 1.0  # after a rank fails, for its peers to exit on their own
STOP_GRACE_S = 5.0  # SIGTERM, then SIGKILL after this long
_PKG_PARENT = str(Path(__file__).resolve().parents[2])


def requested(args) -> bool:
    """Whether the flags ask for a mesh and name no process group."""
    n_table = int(args.fwt_table_axis or 1)
    n_data = int(args.fwt_data_axis or 1)
    return ((n_table > 1 or n_data > 1) and args.fwt_hosts is None
            and not args.fwt_coordinator)


def mesh_shape(devices: int, n_data: int | None, n_table: int) -> tuple[int, int]:
    """``(n_data, n_table)`` over ``devices`` by the JAX package's
    ``make_mesh`` (its parallel/mesh.py:32-44): ``n_data`` defaults to
    ``devices // n_table``, and a mesh that does not cover every device
    raises ValueError naming the flags and the count."""
    shape_data = devices // n_table if n_data is None else n_data
    if shape_data * n_table != devices:
        flags = f"--fwt_table_axis {n_table}"
        if n_data is not None:
            flags = f"--fwt_data_axis {n_data} " + flags
        raise ValueError(
            f"the mesh of {flags} ({shape_data}x{n_table}) does not cover the "
            f"{devices} device(s) of this host: one command runs one rank "
            f"per device, so --fwt_data_axis x --fwt_table_axis must be "
            f"{devices}")
    return shape_data, n_table


def device_count(platform: str | None, n_data: int | None, n_table: int) -> int:
    """The devices one command spans: every card of the host, or with
    ``--fwt_platform cpu`` as many gloo ranks as the mesh asks for."""
    if platform == "cpu":
        return (n_data or 1) * n_table
    import torch

    from ..utils.device import NoDeviceError

    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available for the mesh's ranks; pass "
            "--fwt_platform cpu to run them on the CPU instead")
    return torch.cuda.device_count()


def writes_files(host_id: int | None) -> bool:
    """Whether this process writes the files the user named: always,
    unless it is a rank other than 0 of a launch of this module."""
    return os.environ.get(LAUNCHED_ENV) != "1" or int(host_id or 0) == 0


def free_port() -> int:
    """A TCP port for the group's rank 0, free now and below Linux's
    ephemeral range (32768-60999), where a port the kernel hands out for
    port 0 could be taken by another socket before rank 0 binds it."""
    while True:
        port = random.randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


class _Rank:
    """One started rank: its process and a thread that passes its output
    on, prefixed, keeping the last :data:`TAIL_LINES` lines."""

    def __init__(self, rank: int, argv: list, env: dict, own_stdout: bool, out):
        self.rank = rank
        self.out = out
        self.tail: collections.deque = collections.deque(maxlen=TAIL_LINES)
        self.proc = subprocess.Popen(
            argv, env=env, stdin=subprocess.DEVNULL,
            stdout=None if own_stdout else subprocess.PIPE,
            stderr=subprocess.PIPE if own_stdout else subprocess.STDOUT,
            start_new_session=True)
        stream = self.proc.stderr if own_stdout else self.proc.stdout
        self.pump = threading.Thread(target=self._pump, args=(stream,), daemon=True)
        self.pump.start()

    def _pump(self, stream) -> None:
        with stream:
            for raw in iter(stream.readline, b""):
                line = raw.decode(errors="replace")
                self.tail.append(line)
                out = self.out or sys.stderr
                out.write(f"[rank {self.rank}] {line}")
                out.flush()

    def stop(self) -> None:
        """End the rank's session: SIGTERM, then SIGKILL after the grace."""
        for sig in (signal.SIGTERM, signal.SIGKILL):
            if self.proc.poll() is not None:
                break
            try:
                os.killpg(self.proc.pid, sig)
            except ProcessLookupError:
                break
            try:
                self.proc.wait(timeout=STOP_GRACE_S)
            except subprocess.TimeoutExpired:
                continue
        self.proc.wait()
        self.pump.join(timeout=STOP_GRACE_S)


def _raise_exit(signum, _frame):
    raise SystemExit(128 + signum)


def supervise(commands: list, out=None) -> int:
    """Run ``commands`` — ``(argv, env)`` per rank, rank 0 first — and wait
    for all of them, their output passed to the text stream ``out``
    (stderr by default). Returns 0 when every rank exits 0; when one
    fails, stops the others and returns 1 after logging each rank that
    failed, in rank order, with its exit code and its last lines. A failed
    rank's peers lose it in a collective and may exit before it does, so
    the ranks get FAIL_GRACE_S to exit on their own before they are
    stopped. No rank outlives the call, whatever ends it (a SIGTERM to this
    process included, on the main thread)."""
    main_thread = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGTERM, _raise_exit) if main_thread else None
    ranks: list[_Rank] = []
    failed: list[_Rank] = []
    try:
        for r, (argv, env) in enumerate(commands):
            ranks.append(_Rank(r, argv, env, own_stdout=r == 0, out=out))
        while True:
            codes = [rk.proc.poll() for rk in ranks]
            if any(c not in (None, 0) for c in codes):
                deadline = time.monotonic() + FAIL_GRACE_S
                while (time.monotonic() < deadline
                       and any(rk.proc.poll() is None for rk in ranks)):
                    time.sleep(0.05)
                failed = [rk for rk in ranks if rk.proc.poll() not in (None, 0)]
                break
            if all(c == 0 for c in codes):
                break
            time.sleep(0.05)
    finally:
        for rk in ranks:
            rk.stop()
        if main_thread:
            signal.signal(signal.SIGTERM, old)
    for rk in failed:
        rk.pump.join(timeout=2.0)  # its last lines, read to the end
        log.error("rank %d of %d exited %s; the other ranks were stopped. Its "
                  "last lines:\n%s", rk.rank, len(ranks), rk.proc.returncode,
                  "".join(rk.tail).rstrip() or "(none)")
    return 1 if failed else 0


def rank_env(rank: int, counters: str | None = None) -> dict:
    """The environment of a started rank: this process's, the package
    importable, the launch marked, and rank ``r > 0``'s counters at
    ``<counters>.rank<r>``."""
    env = dict(os.environ)
    env[LAUNCHED_ENV] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p)
    if counters and rank:
        env["FWT_COUNTERS_OUT"] = f"{counters}.rank{rank}"
    return env


def main(args, argv: list) -> int:
    """Start one rank of the CLI's ``argv`` per device of the mesh the
    flags ask for, and wait for them (module docstring). Exits 1 with the
    flags named when the mesh does not cover the host's devices."""
    from ..utils.device import NoDeviceError

    n_table = int(args.fwt_table_axis or 1)
    n_data = int(args.fwt_data_axis) if args.fwt_data_axis is not None else None
    try:
        count = device_count(args.fwt_platform, n_data, n_table)
        n_data, n_table = mesh_shape(count, n_data, n_table)
    except (NoDeviceError, ValueError) as e:
        log.error("%s", e)
        return 1
    world = n_data * n_table
    coordinator = f"127.0.0.1:{free_port()}"
    log.info("mesh %dx%d: starting %d ranks (coordinator %s)", n_data, n_table,
             world, coordinator)
    counters = os.environ.get("FWT_COUNTERS_OUT")
    cmd = [sys.executable, "-m", "fwumious_wabbit_tpu_torch", *argv,
           "--fwt_hosts", str(world), "--fwt_coordinator", coordinator]
    return supervise([(cmd + ["--fwt_host_id", str(r)], rank_env(r, counters))
                      for r in range(world)])
