"""``--daemon`` without ``--foreground`` detaches the port's daemon (a
double fork) and it serves after its launcher has exited (the counterpart
of tests/test_daemonize.py, ``--fwt_platform cpu``): its reply equals the
JAX daemon's on the same model file within 2e-6, it is found by its
listening socket and its parent is not the launcher, and SIGTERM ends it
with its counters written (``FWT_COUNTERS_OUT``). The fork must come
before CUDA is initialised: a daemon asked for the card reaches no
``torch.cuda`` call before ``_daemonize``, on either engine."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from fwumious_wabbit_tpu_torch.deployment import alive, pid_listening_on
from fwumious_wabbit_tpu_torch.parallel.launch import free_port
from fwumious_wabbit_tpu_torch.train import loop

from test_torch_serving import Client, jax_device_port, save_jax_model
from torch_parity import jax_native_loaded  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
LINE = b"|A a1 |B b2 |C c3\n"


def test_daemon_detaches_and_serves(tmp_path):
    path = save_jax_model(tmp_path, "m.fwt", trained=True)
    port = free_port()
    counters = tmp_path / "counters.json"
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(tmp_path),
           "FWT_COUNTERS_OUT": str(counters)}
    launcher = subprocess.Popen(
        [sys.executable, "-m", "fwumious_wabbit_tpu_torch", "--daemon", "-i",
         str(path), "--port", str(port), "--fwt_platform", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    _, err = launcher.communicate(timeout=120)  # it returns: the first fork's parent
    assert launcher.returncode == 0, err.decode()
    pid = None
    try:
        deadline = time.time() + 60
        while True:
            try:
                c = Client(port)
                break
            except OSError:
                assert time.time() < deadline, "the daemon never listened"
                time.sleep(0.3)
        reply = c.send(LINE)
        c.close()
        jsrv, jport = jax_device_port(path)
        try:
            ref = Client(jport)
            want = float(ref.send(LINE))
            ref.close()
        finally:
            jsrv.shutdown()
        assert reply.endswith(b"\n") and abs(float(reply) - want) <= 2e-6
        pid = pid_listening_on(port)
        assert pid is not None and pid != os.getpid()
        ppid = int(Path(f"/proc/{pid}/status").read_text()
                   .split("PPid:")[1].split()[0])
        assert ppid not in (os.getpid(), launcher.pid)  # re-parented
        assert os.getsid(pid) != os.getsid(0)  # a session of its own
        os.kill(pid, signal.SIGTERM)
        deadline = time.time() + 30
        while alive(pid) and time.time() < deadline:
            time.sleep(0.1)
        assert not alive(pid), "SIGTERM did not end the daemon"
        pid = None
        facts = json.loads(counters.read_text())
        assert facts["hogwild_loads"] == 0
        assert facts["launches"]["ffm_triangle"] == 0  # the CPU: no kernel
    finally:
        if pid is not None and alive(pid):
            os.kill(pid, signal.SIGKILL)


class Forked(Exception):
    """Raised where the daemon would fork."""


@pytest.mark.parametrize("engine", ["device", "native"])
def test_no_cuda_before_the_fork(tmp_path, monkeypatch, engine):
    """Every torch.cuda entry point the CLI could reach is recorded; the
    daemon asked for the card (no --fwt_platform) forks before any."""
    path = save_jax_model(tmp_path, "m.fwt", trained=True)
    calls = []
    for name in ("is_available", "device_count", "current_device", "set_device",
                 "init", "_lazy_init", "get_device_name", "synchronize",
                 "memory_allocated", "max_memory_allocated", "current_stream",
                 "empty_cache"):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _name=name, **k: calls.append(_name))

    def fork_here():
        raise Forked(list(calls))

    monkeypatch.setattr(loop, "_daemonize", fork_here)
    with pytest.raises(Forked) as seen:
        loop.main(["--daemon", "-i", str(path), "--port", str(free_port()),
                   "--fwt_serve_engine", engine])
    assert seen.value.args[0] == []
    assert not torch.cuda.is_initialized()
