"""The deployment loop through the port's CLI: train, quantized export,
weight patch, and a live hot swap under concurrent load in a daemon that
detached itself — the product's loop, in which training hosts ship weight
diffs and serving daemons swap them in while they answer requests
(BASELINE.json config 5; the JAX package's
tests/test_baseline_flows.py::test_distributed_train_patch_hotswap_chain).

    python -m fwumious_wabbit_tpu_torch.deployment [--cpu]

The chain, at the full width of the LR+FFM k=8 configuration
(synthetic.py), on the card over the 1M-line synthetic file (the CPU over
the 10k-line file with ``--cpu``):

1. train v1 on the first half of the synthetic file, then v2 on the second
   half from ``-i v1 --save_resume`` (the CLI's default path);
2. convert both with ``--weight_quantization``; the weight patcher's
   ``create_diff`` v1q→v2q and ``recreate``, byte-equal to v2q;
3. ``--daemon`` without ``--foreground`` on v1q: the CLI's double fork,
   found by its listening port; one that does not answer within 60 s fails
   the chain after the same command has run 30 s with ``--foreground`` and
   its standard error is printed;
4. a run without swaps, then the soak: 8 request/response clients (200
   lines each at least), 4 pipelined clients (6 bursts of 150–250 lines at
   least) and one client that alternates ``hogwild_load`` of v1q and the
   recreated v2q 20 times, ending on v2q; the clients go on until the last
   swap has replied. Every reply well-formed, one per line and in order,
   and within 2e-6 of the CPU's plain prediction (``-t -i --fwt_platform
   cpu``) of its line under v1q or under v2q;
5. after the last swap, 64 lines on a fresh connection within 2e-6 of
   ``-t -i`` of the recreated v2q through the device engine, through
   ``--fwt_serve_engine native``, and of the CPU's plain path;
6. SIGTERM ends the daemon, which writes its launches, its swaps, the
   card's allocated bytes after each swap (read in the daemon as the next
   swap starts, and as it ends) and the allocator's peak
   (``FWT_COUNTERS_OUT``); on the card the FFM forward must have launched,
   and the bytes after swap 4 and after swap 20 must agree within one
   model's table bytes, the peak reported beside three models' bytes.
   ``nvidia-smi --query-compute-apps`` is read for the daemon's pid beside
   them, where it lists that pid.

Each failed step raises :class:`ChainFailed`; the module exits 1.
``chip_smoke.py`` (phase 12) and ``multicard.py`` (run h, v1 and v2 trained
on a mesh) drive the same steps.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from . import synthetic
from .parallel.launch import free_port

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / ".bench_cache" / "deployment"
REPLY_ATOL = 2e-6  # tests/test_serving.py:176
DIFFERS = 1e-4  # a probe line "differs" under v1q and v2q past this
START_S = 60
DIAGNOSE_S = 30
SWAPS = 20
MEMORY_AT = (4, SWAPS)
RR_CLIENTS, RR_LINES = 8, 200
BURST_CLIENTS, BURSTS, BURST_LINES = 4, 6, (150, 250)
SETTLE_LINES = 64
NUM_CHILDREN = 16  # one worker per connection of the soak
BATCH = 1024
SOCKET_TIMEOUT_S = 120


class ChainFailed(RuntimeError):
    """A step of the chain failed or a reply is outside its bound."""


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ChainFailed(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def platform_argv(cpu: bool) -> list:
    return ["--fwt_platform", "cpu"] if cpu else []


def cli(argv: list) -> float:
    """One run of the port's CLI in this process; its seconds."""
    from .train.loop import main

    t0 = time.perf_counter()
    rc = main([str(a) for a in argv])
    require(rc == 0, f"the CLI exited {rc}: {' '.join(map(str, argv))}")
    return time.perf_counter() - t0


def launch_counts() -> dict:
    from .ops import ffm, sparse_update

    return {"ffm_triangle": ffm.LAUNCHES, "ffm_triangle_bwd": ffm.BWD_LAUNCHES,
            "sparse_adagrad_update": sparse_update.LAUNCHES}


def reset_launch_counts() -> None:
    from .ops import ffm, sparse_update

    ffm.LAUNCHES = ffm.BWD_LAUNCHES = sparse_update.LAUNCHES = 0


def split_halves(data: Path) -> tuple[Path, Path]:
    """The first and the second half of ``data``'s lines, as two files
    beside it (with its namespace map)."""
    lines = data.read_bytes().splitlines(keepends=True)
    half = len(lines) // 2
    first = data.with_name(f"{data.stem}_first.vw")
    last = data.with_name(f"{data.stem}_last.vw")
    first.write_bytes(b"".join(lines[:half]))
    last.write_bytes(b"".join(lines[half:]))
    return first, last


def model_table_bytes(argv: list) -> int:
    """The bytes of one served model's tables (weights only) of the
    configuration ``argv``."""
    from .config.cmdline import build_parser
    from .config.model_instance import ModelInstance
    from .config.vwmap import VwNamespaceMap
    from .models.model import FwModel

    vw = VwNamespaceMap.from_string(
        "A,animal\nB,food\n" + "".join(f"{chr(ord('C') + x)},somefeature\n"
                                       for x in range(10)))
    model = FwModel(ModelInstance.from_cmdline(build_parser().parse_args(argv), vw))
    floats = model.lr_spec.padded_size
    if model.has_ffm:
        floats += model.ffm_spec.padded_size
    return 4 * floats


def train_pair(first: Path, last: Path, work: Path, argv: list, cpu: bool) -> dict:
    """v1 on ``first``, then v2 on ``last`` from ``-i v1 --save_resume``, in
    this process; the kernels' launches over both (counts set to 0 just
    before v1)."""
    v1, v2 = work / "v1.fwt", work / "v2.fwt"
    base = list(argv) + ["--fwt_batch_size", str(BATCH), *platform_argv(cpu)]
    reset_launch_counts()
    s1 = cli(base + ["--data", first, "-f", v1, "--save_resume"])
    s2 = cli(base + ["-i", v1, "--data", last, "-f", v2, "--save_resume"])
    launches = launch_counts()
    say(f"deployment: trained v1 ({s1:.2f} s) and v2 from -i v1 ({s2:.2f} s); "
        f"kernel launches {json.dumps(launches)}")
    return {"v1": v1, "v2": v2, "seconds": {"v1": s1, "v2": s2},
            "launches": launches}


def export_and_patch(v1: Path, v2: Path, work: Path, cpu: bool) -> dict:
    """Both converted with ``--weight_quantization``; the patcher's diff
    v1q→v2q and v2q recreated from it, byte-equal."""
    from .tools import weight_patcher

    v1q, v2q = work / "v1q.fwt", work / "v2q.fwt"
    seconds = {}
    for src, dst in ((v1, v1q), (v2, v2q)):
        seconds[f"convert_{dst.stem}"] = cli(
            ["-i", src, "--convert_inference_regressor", dst,
             "--weight_quantization", *platform_argv(cpu)])
    diff, v2q_re = work / "v1q_to_v2q.patch", work / "v2q_recreated.fwt"
    t0 = time.perf_counter()
    weight_patcher.create_diff(v1q, v2q, diff)
    seconds["create_diff"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    weight_patcher.recreate(v1q, diff, v2q_re)
    seconds["recreate"] = time.perf_counter() - t0
    require(v2q_re.read_bytes() == v2q.read_bytes(),
            "the recreated v2q differs from v2q")
    out = {"v1q": v1q, "v2q": v2q, "v2q_re": v2q_re,
           "diff_bytes": diff.stat().st_size, "file_bytes": v2q.stat().st_size,
           "seconds": seconds}
    say(f"deployment: quantized exports of {out['file_bytes']} bytes "
        f"(convert {seconds['convert_v1q']:.2f} s and "
        f"{seconds['convert_v2q']:.2f} s); diff v1q→v2q {out['diff_bytes']} "
        f"bytes, create_diff {seconds['create_diff']:.2f} s, recreate "
        f"{seconds['recreate']:.2f} s; the recreated v2q is byte-equal to v2q")
    return out


def read_preds(path: Path) -> np.ndarray:
    return np.array(Path(path).read_bytes().split(), np.float64)


def predict(model: Path, data: Path, tag: str, argv=()) -> np.ndarray:
    """``-t -i model`` over ``data`` through the CLI in this process."""
    out = data.with_name(f"{data.stem}.{tag}.out")
    cli(["-t", "-i", model, "--data", data, "-p", out, *argv])
    return read_preds(out)


def probe_pool(source: Path, models: tuple, work: Path, n: int) -> dict:
    """Up to ``n`` lines of ``source`` and the CPU's plain predictions of
    each under v1q and v2q. When fewer than half differ by more than 1e-4,
    the pool keeps only the lines that do."""
    lines = source.read_bytes().splitlines(keepends=True)[:n]
    pool = work / "probe.vw"
    pool.write_bytes(b"".join(lines))
    want = [predict(m, pool, f"plain_{m.stem}", platform_argv(True)) for m in models]
    require(all(w.shape == (len(lines),) for w in want),
            "the CPU's plain path did not predict every probe line")
    differs = np.abs(want[0] - want[1]) > DIFFERS
    share = float(differs.mean())
    say(f"deployment: {share:.4f} of {len(lines)} probe lines differ by more "
        f"than {DIFFERS} under v1q and v2q")
    if share < 0.5:
        keep = np.flatnonzero(differs)
        require(keep.size >= SETTLE_LINES,
                f"only {keep.size} probe lines differ under v1q and v2q")
        lines = [lines[i] for i in keep]
        want = [w[keep] for w in want]
        pool.write_bytes(b"".join(lines))
    return {"path": pool, "lines": lines, "want": want, "share_differs": share}


# -- the daemon --------------------------------------------------------------


def pid_listening_on(port: int) -> int | None:
    """The pid of the process with a socket listening on ``port``, from
    /proc (tests/test_daemonize.py)."""
    want = f":{port:04X}"
    inodes = set()
    for tcp in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            rows = Path(tcp).read_text().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            parts = row.split()
            if parts[1].endswith(want) and parts[3] == "0A":  # LISTEN
                inodes.add(parts[9])
    if not inodes:
        return None
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            for fd in os.listdir(f"/proc/{pid}/fd"):
                try:
                    target = os.readlink(f"/proc/{pid}/fd/{fd}")
                except OSError:
                    continue
                if target.startswith("socket:[") and target[8:-1] in inodes:
                    return int(pid)
        except OSError:
            continue
    return None


def alive(pid: int) -> bool:
    """The process exists and is not a zombie."""
    try:
        status = Path(f"/proc/{pid}/status").read_text()
    except OSError:
        return False
    return "\nState:\tZ" not in status


class Daemon:
    """The port's CLI daemon started without ``--foreground``: it detaches
    itself (a double fork), so it is found by its port and ended by its
    pid."""

    def __init__(self, model: Path, work: Path, cpu: bool):
        self.port = free_port()
        self.argv = [sys.executable, "-m", "fwumious_wabbit_tpu_torch", "--daemon",
                     "-i", str(model), "--num_children", str(NUM_CHILDREN),
                     *platform_argv(cpu)]
        self.counters = work / "daemon_counters.json"
        self.pid = None

    def env(self) -> dict:
        env = dict(os.environ, FWT_COUNTERS_OUT=str(self.counters))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        return env

    def start(self) -> float:
        """Start it and wait until it accepts a connection; its seconds."""
        self.counters.unlink(missing_ok=True)
        t0 = time.perf_counter()
        launcher = subprocess.run(self.argv + ["--port", str(self.port)],
                                  cwd=ROOT, env=self.env(), capture_output=True,
                                  text=True, timeout=120)
        require(launcher.returncode == 0, "the daemon's launcher exited "
                f"{launcher.returncode}:\n{launcher.stderr[-3000:]}")
        deadline = time.time() + START_S
        while time.time() < deadline:
            try:
                socket.create_connection(("127.0.0.1", self.port), timeout=1).close()
                break
            except OSError:
                time.sleep(0.2)
        else:
            said = self.diagnose()
            raise ChainFailed(f"the detached daemon did not answer on port "
                              f"{self.port} within {START_S} s; the same command "
                              f"with --foreground said:\n{said}")
        seconds = time.perf_counter() - t0
        self.pid = pid_listening_on(self.port)
        require(self.pid is not None and self.pid != os.getpid(),
                f"no process of its own listens on port {self.port}")
        ppid = int(Path(f"/proc/{self.pid}/status").read_text()
                   .split("PPid:")[1].split()[0])
        require(ppid != os.getpid(), "the daemon did not detach from its launcher")
        say(f"deployment: the detached daemon (pid {self.pid}, parent {ppid}) "
            f"answered on port {self.port} after {seconds:.2f} s")
        return seconds

    def diagnose(self) -> str:
        """The same command with ``--foreground`` for DIAGNOSE_S seconds:
        its standard error (the detached daemon's goes to /dev/null)."""
        proc = subprocess.Popen(self.argv + ["--port", str(free_port()), "--foreground"],
                                cwd=ROOT, env=self.env(), stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        try:
            _, err = proc.communicate(timeout=DIAGNOSE_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        say(f"deployment: the daemon with --foreground said:\n{err[-4000:]}")
        return err[-4000:]

    def stop(self) -> dict | None:
        """SIGTERM, then its counters (written as it ends); SIGKILL if it is
        still there after 30 s. None when it wrote none."""
        pid = self.pid if self.pid is not None else pid_listening_on(self.port)
        if pid is None:
            return None
        self.pid = None
        os.kill(pid, signal.SIGTERM)
        deadline = time.time() + 30
        while alive(pid) and time.time() < deadline:
            time.sleep(0.1)
        if alive(pid):
            os.kill(pid, signal.SIGKILL)
            return None
        if not self.counters.exists():
            return None
        return json.loads(self.counters.read_text())


def device_memory(pid: int) -> int | None:
    """The device memory of ``pid`` as ``nvidia-smi --query-compute-apps``
    lists it; None where it lists no such pid (in a pid namespace)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60).stdout
    for row in out.splitlines():
        parts = [p.strip() for p in row.split(",")]
        if len(parts) == 2 and parts[0] == str(pid):
            return int(parts[1]) << 20
    return None


# -- the soak ----------------------------------------------------------------


class Client:
    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=SOCKET_TIMEOUT_S)
        self.fh = self.sock.makefile("rwb")

    def send(self, line: bytes) -> bytes:
        self.fh.write(line)
        self.fh.flush()
        return self.fh.readline()

    def burst(self, lines: list) -> bytes:
        """All of ``lines`` in one send; then exactly their replies."""
        self.sock.sendall(b"".join(lines))
        data = bytearray()
        while data.count(b"\n") < len(lines):
            chunk = self.sock.recv(65536)
            if not chunk:
                break
            data += chunk
        return bytes(data)

    def close(self) -> None:
        self.fh.close()
        self.sock.close()


def reply_value(reply: bytes) -> float:
    require(reply.endswith(b"\n") and not reply.startswith(b"ERR"),
            f"a malformed reply {reply!r}")
    return float(reply)


def soak(port: int, pool: dict, swap_to: tuple | None = None, memory=None,
         rr_clients: int = RR_CLIENTS, burst_clients: int = BURST_CLIENTS,
         n_swaps: int = SWAPS) -> dict:
    """``rr_clients`` request/response and ``burst_clients`` pipelined
    clients at once; with ``swap_to`` (v1q, v2q) a swapper alternates
    ``hogwild_load`` of them ``n_swaps`` times (odd swaps v1q, even v2q)
    and the clients go on until it is done; ``memory(i)``, where given, is
    called after swap i. Every reply is held to the pool's plain predictions under
    either model."""
    lines, want = pool["lines"], pool["want"]
    n = len(lines)
    rr_idx = [np.arange(k * RR_LINES, (k + 1) * RR_LINES) % n
              for k in range(rr_clients)]
    done = threading.Event()
    if swap_to is None:
        done.set()
    errors: list = []
    rr_lat: list = []
    got: list = []  # (line index, reply value)
    bursts: list = []  # (lines, seconds)
    swaps: list = []
    lock = threading.Lock()

    def rr_client(k):
        try:
            c = Client(port)
            i = 0
            while i < RR_LINES or not done.is_set():
                j = int(rr_idx[k][i % RR_LINES])
                t0 = time.perf_counter()
                v = reply_value(c.send(lines[j]))
                dt = time.perf_counter() - t0
                with lock:
                    rr_lat.append(dt)
                    got.append((j, v))
                i += 1
            c.close()
        except Exception as e:  # noqa: BLE001 — reported after the join
            errors.append(f"request/response client {k}: {type(e).__name__}: {e}")

    def burst_client(k):
        try:
            rng = np.random.default_rng(k)
            r = 0
            while r < BURSTS or not done.is_set():
                size = int(rng.integers(BURST_LINES[0], BURST_LINES[1] + 1))
                idx = rng.integers(0, n, size)
                c = Client(port)
                t0 = time.perf_counter()
                data = c.burst([lines[j] for j in idx])
                dt = time.perf_counter() - t0
                c.close()
                replies = data.split(b"\n")
                require(len(replies) == size + 1 and replies[-1] == b"",
                        f"a burst of {size} lines got {len(replies) - 1} replies")
                with lock:
                    bursts.append((size, dt))
                    got.extend((int(j), reply_value(rep + b"\n"))
                               for j, rep in zip(idx, replies))
                r += 1
        except Exception as e:  # noqa: BLE001
            errors.append(f"pipelined client {k}: {type(e).__name__}: {e}")

    def swapper():
        try:
            c = Client(port)
            for i in range(1, n_swaps + 1):
                path = swap_to[1] if i % 2 == 0 else swap_to[0]
                t0 = time.perf_counter()
                reply = c.send(f"hogwild_load {path}\n".encode())
                swaps.append(time.perf_counter() - t0)
                require(reply == b"hogwild_load success\n",
                        f"hogwild_load {i} replied {reply!r}")
                if memory is not None:
                    memory(i)
            c.close()
        except Exception as e:  # noqa: BLE001
            errors.append(f"swapper: {type(e).__name__}: {e}")
        finally:
            done.set()

    threads = [threading.Thread(target=rr_client, args=(k,)) for k in range(rr_clients)]
    threads += [threading.Thread(target=burst_client, args=(k,))
                for k in range(burst_clients)]
    if swap_to is not None:
        threads.append(threading.Thread(target=swapper))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SOCKET_TIMEOUT_S * 3)
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "a client of the soak hangs")
    require(not errors, "; ".join(errors))
    idx = np.array([j for j, _ in got])
    val = np.array([v for _, v in got])
    err = np.minimum(np.abs(val - want[0][idx]), np.abs(val - want[1][idx]))
    worst = float(err.max())
    require(bool(np.isfinite(val).all()) and worst <= REPLY_ATOL,
            f"{int((err > REPLY_ATOL).sum())} of {len(val)} replies are more than "
            f"{REPLY_ATOL} from the line's plain prediction under either model "
            f"(worst {worst})")
    burst_lines = sum(b for b, _ in bursts)
    out = {"replies": len(val), "rr_lines": len(rr_lat), "bursts": len(bursts),
           "burst_lines": burst_lines, "wall_s": wall,
           "max_err_to_either_model": worst}
    if rr_lat:
        lat = np.array(rr_lat) * 1e6
        out.update(rr_p50_us=float(np.percentile(lat, 50)),
                   rr_p99_us=float(np.percentile(lat, 99)))
    if bursts:
        out.update(burst_lines_s_median=float(np.median([b / s for b, s in bursts])),
                   burst_lines_s_aggregate=burst_lines / wall)
    if swaps:
        out.update(swaps=len(swaps),
                   swap_p50_s=float(np.percentile(swaps, 50)),
                   swap_max_s=float(max(swaps)))
        v1, v2 = (np.abs(val - w[idx]) <= REPLY_ATOL for w in want)
        out["replies_v1q_only"] = int((v1 & ~v2).sum())
        out["replies_v2q_only"] = int((v2 & ~v1).sum())
    return out


def settle(port: int, pool: dict, v2q_re: Path, work: Path, cpu: bool) -> dict:
    """After the last swap: SETTLE_LINES lines on a fresh connection against
    ``-t -i`` of the recreated v2q on both engines and the CPU's plain
    path."""
    lines = pool["lines"][:SETTLE_LINES]
    head = work / "settle.vw"
    head.write_bytes(b"".join(lines))
    c = Client(port)
    got = np.array([reply_value(c.send(line)) for line in lines])
    c.close()
    before = launch_counts()["ffm_triangle"]
    refs = {"device engine": predict(v2q_re, head, "device", platform_argv(cpu))}
    launches = launch_counts()["ffm_triangle"] - before
    refs["native engine"] = predict(v2q_re, head, "native",
                                    ["--fwt_serve_engine", "native"])
    refs["the CPU's plain path"] = pool["want"][1][:SETTLE_LINES]
    errs = {}
    for name, want in refs.items():
        require(want.shape == got.shape, f"-t -i ({name}) predicted {want.shape}")
        errs[name] = float(np.abs(got - want).max())
        require(errs[name] <= REPLY_ATOL, f"after the last swap the replies are "
                f"{errs[name]} from -t -i ({name}) of the recreated v2q")
    require(cpu or launches > 0, "-t -i on the card never launched the FFM forward")
    say(f"deployment: after the last swap, {len(got)} replies on a fresh "
        f"connection: max |reply − ·| {json.dumps(errs)}")
    return {"max_abs_err": errs, "testonly_ffm_launches": launches}


def serve_chain(versions: dict, pool_source: Path, work: Path, cpu: bool,
                table_bytes: int) -> dict:
    """Steps 2–6 of the chain for the trained ``versions`` (v1, v2)."""
    work.mkdir(parents=True, exist_ok=True)
    exp = export_and_patch(versions["v1"], versions["v2"], work, cpu)
    need = RR_CLIENTS * RR_LINES + BURST_CLIENTS * BURSTS * BURST_LINES[1]
    pool = probe_pool(pool_source, (exp["v1q"], exp["v2q"]), work, need)
    daemon = Daemon(exp["v1q"], work, cpu)
    out = {"export": {k: v for k, v in exp.items() if not isinstance(v, Path)},
           "share_differs": pool["share_differs"], "table_bytes": table_bytes}
    try:
        out["daemon_start_s"] = daemon.start()
        out["no_swap"] = soak(daemon.port, pool)
        smi: dict = {}

        def sample(i):
            smi[i] = device_memory(daemon.pid)

        out["soak"] = soak(daemon.port, pool, (exp["v1q"], exp["v2q_re"]),
                           None if cpu else sample)
        out["settle"] = settle(daemon.port, pool, exp["v2q_re"], work, cpu)
        counters = daemon.stop()
    finally:
        daemon.stop()
    require(counters is not None, "SIGTERM did not end the daemon with its counters")
    require(counters["hogwild_loads"] == SWAPS,
            f"the daemon made {counters['hogwild_loads']} swaps, not {SWAPS}")
    out["daemon"] = counters
    if not cpu:
        require(counters["launches"]["ffm_triangle"] > 1,
                "the daemon never launched the FFM forward after its warm-up")
        held = {int(i): b for i, b in counters["resident_bytes_after_swap"].items()}
        require(all(i in held for i in MEMORY_AT),
                f"the daemon read its allocated bytes after swaps {sorted(held)}")
        grew = held[MEMORY_AT[1]] - held[MEMORY_AT[0]]
        out["memory"] = {"allocated_after_swap": held,
                         "peak_allocated_bytes": counters["peak_device_bytes"],
                         "growth_bytes": grew, "three_models_bytes": 3 * table_bytes,
                         "nvidia_smi_after_swap": smi}
        require(abs(grew) <= table_bytes,
                f"the daemon's device memory moved by {grew} bytes from swap "
                f"{MEMORY_AT[0]} to swap {MEMORY_AT[1]}, more than one model's "
                f"{table_bytes}")
    return out


def report(out: dict) -> None:
    s, n = out["soak"], out["no_swap"]
    say(f"deployment: soak under {s['swaps']} swaps: {s['replies']} replies "
        f"({s['rr_lines']} request/response, {s['bursts']} bursts of "
        f"{s['burst_lines']} lines) in {s['wall_s']:.2f} s, max |reply − the "
        f"line's plain prediction under v1q or v2q| {s['max_err_to_either_model']!r}; "
        f"replies only v1q's {s['replies_v1q_only']}, only v2q's {s['replies_v2q_only']}")
    say(f"timing: daemon request/response with swaps in flight p50 "
        f"{s['rr_p50_us']:.1f} us, p99 {s['rr_p99_us']:.1f} us; with no swap p50 "
        f"{n['rr_p50_us']:.1f} us, p99 {n['rr_p99_us']:.1f} us "
        f"({RR_CLIENTS} request/response and {BURST_CLIENTS} pipelined clients)")
    say(f"timing: pipelined bursts under swaps {s['burst_lines_s_median']:.0f} "
        f"lines/s per burst (median), {s['burst_lines_s_aggregate']:.0f} lines/s "
        f"over the soak; with no swap {n['burst_lines_s_median']:.0f} and "
        f"{n['burst_lines_s_aggregate']:.0f}")
    say(f"timing: hogwild_load reply p50 {s['swap_p50_s'] * 1e3:.1f} ms, max "
        f"{s['swap_max_s'] * 1e3:.1f} ms over {s['swaps']} swaps")
    e = out["export"]
    say(f"timing: diff {e['diff_bytes']} bytes of a {e['file_bytes']}-byte file, "
        f"create_diff {e['seconds']['create_diff']:.2f} s, recreate "
        f"{e['seconds']['recreate']:.2f} s")
    say(f"deployment: the daemon's launches {json.dumps(out['daemon']['launches'])}"
        f" over {out['daemon']['hogwild_loads']} swaps")
    if "memory" in out:
        m = out["memory"]
        say(f"memory: the daemon's allocated device bytes after swaps "
            f"{json.dumps(m['allocated_after_swap'])}; swap {MEMORY_AT[0]} → "
            f"{MEMORY_AT[1]}: {m['growth_bytes']} bytes (bound {out['table_bytes']}); "
            f"allocator peak {m['peak_allocated_bytes']}, beside 3 models' "
            f"{m['three_models_bytes']}")
        listed = {i: b for i, b in m["nvidia_smi_after_swap"].items() if b is not None}
        say("memory: nvidia-smi lists the daemon's pid with "
            f"{json.dumps(listed)} bytes after swaps" if listed else
            "memory: nvidia-smi lists no process for the daemon's pid")


def run(data: Path, pool_source: Path, work: Path, cpu: bool = False,
        argv: list | None = None) -> dict:
    """The whole chain on one device, v1 and v2 trained in this process."""
    work.mkdir(parents=True, exist_ok=True)
    argv = list(argv or synthetic.serving_argv())
    first, last = split_halves(data)
    t0 = time.perf_counter()
    versions = train_pair(first, last, work, argv, cpu)
    out = serve_chain(versions, pool_source, work, cpu, model_table_bytes(argv))
    out["train"] = {"seconds": versions["seconds"], "launches": versions["launches"]}
    out["seconds"] = time.perf_counter() - t0
    if not cpu:
        for k, v in versions["launches"].items():
            require(v > 0, f"training v1 and v2 never launched the {k} kernel")
    for p in (first, last, versions["v1"], versions["v2"]):
        p.unlink()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fwumious_wabbit_tpu_torch.deployment",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU, over the 10k-line file")
    args = ap.parse_args(argv)
    if not args.cpu:
        import torch

        from .utils.device import nvidia_smi_line

        if not torch.cuda.is_available():
            print("deployment: FAILED: no CUDA card (--cpu runs on the CPU)",
                  file=sys.stderr)
            return 1
        say(f"device: {nvidia_smi_line()}")
    pool = synthetic.ensure_dataset(WORK / "data", 10_000)
    data = pool if args.cpu else synthetic.ensure_dataset(WORK / "data", 1_000_000)
    try:
        out = run(data, pool, WORK / ("cpu" if args.cpu else "cuda"), args.cpu)
    except Exception as e:  # noqa: BLE001 — any failure fails the module
        print(f"deployment: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    report(out)
    say(f"deployment: PASSED in {out['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
