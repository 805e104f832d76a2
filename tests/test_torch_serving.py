"""The port's TCP daemon (fwumious_wabbit_tpu_torch/serve/server.py) over real
loopback sockets, on the CPU: the same wire contract as tests/test_serving.py
(exact bytes, parse-error reply and drop, flush, several clients, live
hogwild_load, pipelined bursts), with replies held against the JAX package's
device engine on the same model file within 2e-6."""

import socket
import threading

import numpy as np
import pytest

from fwumious_wabbit_tpu.config.cmdline import build_parser as jax_build_parser
from fwumious_wabbit_tpu.models.model import FwModel as JaxModel
from fwumious_wabbit_tpu.persistence import model_file as jmf
from fwumious_wabbit_tpu.serve import server as jserver
from fwumious_wabbit_tpu_torch import native
from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
from fwumious_wabbit_tpu_torch.persistence import model_file as pmf
from fwumious_wabbit_tpu_torch.serve.server import Serving

from torch_parity import FFM_ARGV, jax_params, make_mi, make_vw, vw_lines


def save_jax_model(tmp_path, name, trained: bool):
    vw = make_vw(tmp_path)
    mi = make_mi(vw, FFM_ARGV)
    jmodel = JaxModel(mi)
    if trained:
        params = jax_params(jmodel, seed=11, train_lines=vw_lines(16, seed=12),
                            vw=vw)
    else:  # zero LR weights, and an FFM block that adds nothing
        params = jmodel.init_params()
        params["ffm_w"] = params["ffm_w"] * 0.0
    path = tmp_path / name
    jmf.save_model(path, mi, vw, jmodel, params)
    return path


def args_for(engine="device", num_children=4, parser=build_parser):
    """Daemon flags parsed by the port's CLI parser (``parser``: the JAX
    package's, for its own daemon)."""
    args = parser().parse_args(["--daemon", "--port", "0"])
    args.fwt_serve_engine = engine
    args.num_children = num_children
    return args


@pytest.fixture
def serve(tmp_path):
    started = []

    def start(path, num_children=4):
        mi, vw, model = pmf.load_model(path, immutable=True, device="cpu")
        srv = Serving(args_for(num_children=num_children), mi, vw, model)
        srv.serve_in_background()
        started.append(srv)
        return srv.port

    yield start
    for srv in started:
        srv.shutdown()


def jax_device_port(path):
    """The JAX package's daemon with its device engine, on the same file."""
    mi, vw, model, params = jmf.load_model(path, immutable=True)
    srv = jserver.Serving(args_for(parser=jax_build_parser), mi, vw, model,
                          params)
    s = jserver._PooledTCPServer(("127.0.0.1", 0), jserver._Handler, 2)
    s.fwt_serving = srv
    srv._server = s
    threading.Thread(target=s.serve_forever, daemon=True).start()
    return srv, s.server_address[1]


class Client:
    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        self.fh = self.sock.makefile("rwb")

    def send(self, line: bytes) -> bytes:
        self.fh.write(line)
        self.fh.flush()
        return self.fh.readline()

    def close(self):
        self.fh.close()
        self.sock.close()


def recv_lines(sock, n):
    data = bytearray()
    while data.count(b"\n") < n:
        chunk = sock.recv(65536)
        if not chunk:
            break
        data += chunk
    return bytes(data).split(b"\n")[:n]


def test_wire_format_on_zero_weights(tmp_path, serve):
    port = serve(save_jax_model(tmp_path, "zero.fwt", trained=False))
    c = Client(port)
    assert c.send(b"|A cat |B milk\n") == b"0.500000\n"
    assert c.send(b"1 |A dog |B stone |C red\n") == b"0.500000\n"
    c.close()


def test_parse_error_reply_and_drop(tmp_path, serve):
    port = serve(save_jax_model(tmp_path, "m.fwt", trained=True))
    c = Client(port)
    assert c.send(b"|Z unknown_namespace\n").startswith(b"ERR: ")
    assert c.fh.readline() == b""  # dropped after the error
    c.close()


def test_flush_and_four_clients(tmp_path, serve):
    path = save_jax_model(tmp_path, "m.fwt", trained=True)
    port = serve(path)
    jsrv, jport = jax_device_port(path)
    try:
        ref = Client(jport)
        want = float(ref.send(b"|A a1 |B b2\n"))
        ref.close()
        clients = [Client(port) for _ in range(4)]
        for c in clients:
            assert abs(float(c.send(b"|A a1 |B b2\n")) - want) <= 2e-6
        clients[0].fh.write(b"flush\n")  # no reply, connection stays open
        clients[0].fh.flush()
        assert abs(float(clients[0].send(b"|A a1 |B b2\n")) - want) <= 2e-6
        for c in clients:
            c.close()
    finally:
        jsrv.shutdown()


def test_hogwild_load(tmp_path, serve):
    zero = save_jax_model(tmp_path, "zero.fwt", trained=False)
    trained = save_jax_model(tmp_path, "trained.fwt", trained=True)
    port = serve(zero)
    jsrv, jport = jax_device_port(trained)
    try:
        c = Client(port)
        assert c.send(b"|A a1 |B b2 |C c3\n") == b"0.500000\n"
        assert c.send(f"hogwild_load {trained}\n".encode()) == b"hogwild_load success\n"
        after = float(c.send(b"|A a1 |B b2 |C c3\n"))
        ref = Client(jport)
        assert abs(after - float(ref.send(b"|A a1 |B b2 |C c3\n"))) <= 2e-6
        assert after != 0.5
        ref.close()
        c.close()
        c = Client(port)
        assert c.send(b"hogwild_load /nonexistent/model.fwt\n") == \
            b"ERR: hogwild_load fail\n"
        c.close()
    finally:
        jsrv.shutdown()


def test_pipelined_burst_matches_jax_device_engine(tmp_path, serve):
    path = save_jax_model(tmp_path, "m.fwt", trained=True)
    port = serve(path)
    jsrv, jport = jax_device_port(path)
    lines = vw_lines(300, seed=13)  # more than one 256-example batch
    try:
        ref = Client(jport)
        ref.sock.sendall(b"".join(lines))
        want = np.array([float(x) for x in recv_lines(ref.sock, len(lines))])
        ref.close()
        c = Client(port)
        single = [c.send(line) for line in lines[:8]]
        c.close()
        c = Client(port)
        c.sock.sendall(b"".join(lines))
        got = recv_lines(c.sock, len(lines))
        c.close()
        assert got[:8] == [s.rstrip(b"\n") for s in single]
        np.testing.assert_allclose(np.array([float(x) for x in got]), want,
                                   rtol=0, atol=2e-6)
        # a burst with a parse error: earlier replies first, then ERR, drop
        c = Client(port)
        c.sock.sendall(lines[0] + b"|Z nope\n" + lines[1])
        got = recv_lines(c.sock, 2)
        assert got[0] == single[0].rstrip(b"\n") and got[1].startswith(b"ERR: ")
        assert c.sock.recv(4096) == b""
        c.close()
    finally:
        jsrv.shutdown()


@pytest.mark.parametrize("engine", ["auto", "device", "native"])
def test_engine_selection(tmp_path, engine):
    """auto means the device engine in the port; native must be asked for."""
    path = save_jax_model(tmp_path, "m.fwt", trained=True)
    mi, vw, model = pmf.load_model(path, immutable=True, device="cpu")
    if engine == "native":
        if native.load() is None:
            pytest.skip("the embedded C++ engine does not build here")
    srv = Serving(args_for(engine), mi, vw, model, model_path=str(path))
    assert (srv.predictor is None) == (engine == "native")
    assert (srv.native_predictor is None) == (engine != "native")
