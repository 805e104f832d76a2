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
from fwumious_wabbit_tpu_torch import deployment, native
from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
from fwumious_wabbit_tpu_torch.persistence import model_file as pmf
from fwumious_wabbit_tpu_torch.serve.server import Serving

from torch_parity import (FFM_ARGV, jax_params, make_mi, make_vw,
                          one_torch_thread, vw_lines)  # noqa: F401 (autouse)


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

    def start(path, num_children=4, engine="device"):
        mi, vw, model = pmf.load_model(path, immutable=True, device="cpu")
        srv = Serving(args_for(engine, num_children), mi, vw, model,
                      model_path=str(path))
        srv.serve_in_background()
        started.append(srv)
        return srv.port

    yield start
    for srv in started:
        srv.shutdown()


def jax_device_port(path, engine="device"):
    """The JAX package's daemon with its device engine (or ``engine``), on
    the same file."""
    mi, vw, model, params = jmf.load_model(path, immutable=True)
    srv = jserver.Serving(args_for(engine, parser=jax_build_parser), mi, vw,
                          model, params, model_path=str(path))
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


# -- the counterparts of tests/test_serving.py's daemon behaviours -----------

ENGINES = ["device", "native"]


@pytest.fixture
def engine(request):
    """The engine of a parametrized case; the native one skips where the
    embedded C++ engine does not build (checked in the test, not when the
    file is collected)."""
    if request.param == "native" and native.load() is None:
        pytest.skip("the embedded C++ engine does not build here")
    return request.param


def jax_predictions(path, lines) -> np.ndarray:
    """The JAX package's device predictions of ``lines`` under ``path``."""
    from fwumious_wabbit_tpu.ingest.parser import VowpalParser
    from fwumious_wabbit_tpu.ingest.translator import Batcher, FeatureTranslator
    from fwumious_wabbit_tpu.train.loop import _batch_dict
    from fwumious_wabbit_tpu.train.step import make_predict_step

    mi, vw, model, params = jmf.load_model(path, immutable=True)
    parser, ft = VowpalParser(vw), FeatureTranslator(mi)
    tes = [ft.translate(parser.parse_line(line)) for line in lines]
    batch = Batcher(len(tes)).make_batch(tes, pad_to_batch=False)
    return np.asarray(make_predict_step(model)(params, _batch_dict(batch)),
                      np.float64)


def soak_pool(tmp_path, n):
    """A zero model and a trained one, and ``n`` lines with the JAX
    package's prediction of each under both."""
    zero = save_jax_model(tmp_path, "zero.fwt", trained=False)
    trained = save_jax_model(tmp_path, "trained.fwt", trained=True)
    lines = vw_lines(n, seed=41)
    want = [jax_predictions(p, lines) for p in (zero, trained)]
    assert (np.abs(want[1] - want[0]) > 1e-4).mean() > 0.5
    return zero, trained, {"lines": lines, "want": want}


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
def test_soak_under_hot_swap(tmp_path, serve, engine):
    """8 request/response clients (200 lines each at least) while a client
    swaps between two models 30 times: every reply well-formed and within
    2e-6 of the JAX package's prediction of its line under one of them."""
    zero, trained, pool = soak_pool(tmp_path, 1600)
    port = serve(zero, num_children=10, engine=engine)
    out = deployment.soak(port, pool, (trained, zero), rr_clients=8,
                          burst_clients=0, n_swaps=30)
    assert out["swaps"] == 30 and out["replies"] >= 1600
    assert out["max_err_to_either_model"] <= 2e-6
    if engine == "native":  # the JAX test's bound, on its engine
        assert out["rr_p99_us"] < 0.5e6, out


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
def test_burst_soak_under_hot_swap(tmp_path, serve, engine):
    """4 pipelined clients (6 bursts of 150–250 lines each at least) while
    a client swaps 20 times: exactly one in-order reply per line, each
    within 2e-6 of its line's prediction under one of the two models."""
    zero, trained, pool = soak_pool(tmp_path, 1500)
    port = serve(zero, num_children=8, engine=engine)
    out = deployment.soak(port, pool, (trained, zero), rr_clients=0,
                          burst_clients=4, n_swaps=20)
    assert out["swaps"] == 20 and out["bursts"] >= 24
    assert out["max_err_to_either_model"] <= 2e-6


def test_num_children_pool_is_bounded(tmp_path, serve):
    """--num_children caps the worker threads: with a pool of 2, twelve
    sequential connections are served without thread growth, and two
    persistent clients saturate the pool and are both served; every reply
    equals the JAX daemon's for the line within 2e-6."""
    path = save_jax_model(tmp_path, "m.fwt", trained=True)
    before_names = {t.ident for t in threading.enumerate()}
    port = serve(path, num_children=2)
    workers = [t for t in threading.enumerate()
               if t.name.startswith("fwt-serve-") and t.ident not in before_names]
    assert len(workers) == 2
    lines = vw_lines(14, seed=42)
    want = jax_predictions(path, lines)
    before = threading.active_count()
    for k in range(12):
        c = Client(port)
        assert abs(float(c.send(lines[k])) - want[k]) <= 2e-6
        c.close()
    assert threading.active_count() <= before + 1
    c1, c2 = Client(port), Client(port)
    assert abs(float(c1.send(lines[12])) - want[12]) <= 2e-6
    assert abs(float(c2.send(lines[13])) - want[13]) <= 2e-6
    c1.close()
    c2.close()


def test_bind_failure_raises_oserror():
    """The pool's server_close runs inside TCPServer.__init__ when bind()
    fails, before the pool exists: the OSError comes through."""
    from fwumious_wabbit_tpu_torch.serve import server as server_mod

    a = server_mod._PooledTCPServer(("127.0.0.1", 0), server_mod._Handler, 2)
    try:
        with pytest.raises(OSError) as seen:
            server_mod._PooledTCPServer(("127.0.0.1", a.server_address[1]),
                                        server_mod._Handler, 2)
        assert not isinstance(seen.value, AttributeError)
    finally:
        a.server_close()


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
def test_whitespace_only_line_closes_cleanly(tmp_path, serve, engine):
    """A whitespace-only line ends the stream cleanly on both engines (the
    C parser calls it an error; the wire contract calls any blank line the
    end), with no ERR reply — as the JAX daemon does."""
    path = save_jax_model(tmp_path, "m.fwt", trained=True)
    jsrv, jport = jax_device_port(path, engine)
    try:
        for p in (serve(path, num_children=2, engine=engine), jport):
            c = Client(p)
            one = c.send(b"1 |A a1 |B b2\n")
            assert one.endswith(b"\n") and not one.startswith(b"ERR")
            c.sock.sendall(b"  \n")
            assert c.sock.recv(4096) == b""
            c.close()
    finally:
        jsrv.shutdown()


def test_predict_examples_shape_stable(tmp_path):
    """predict_examples pads every chunk to the batcher's batch size: one
    input shape for every burst size, and the same prediction for the same
    line whatever the burst (the JAX package's own reply for it, within
    2e-6)."""
    from fwumious_wabbit_tpu_torch.ingest.parser import VowpalParser
    from fwumious_wabbit_tpu_torch.ingest.translator import FeatureTranslator

    path = save_jax_model(tmp_path, "m.fwt", trained=True)
    mi, vw, model = pmf.load_model(path, immutable=True, device="cpu")
    srv = Serving(args_for(), mi, vw, model)
    line = b"1 |A a1 |B b2 |C c3\n"
    ex = FeatureTranslator(mi).translate(VowpalParser(vw).parse_line(line))
    shapes = set()
    model, step = srv.predictor._current

    def spy(bd):
        shapes.add(tuple(np.asarray(bd[k]).shape for k in sorted(bd)))
        return step(bd)

    srv.predictor._current = (model, spy)
    single = float(srv.predictor.predict_examples([ex])[0])
    assert abs(single - jax_predictions(path, [line])[0]) <= 2e-6
    for n in (1, 3, 7, 50, 300):
        preds = srv.predictor.predict_examples([ex] * n)
        assert preds.shape == (n,)
        assert all(float(p) == single for p in preds)
    assert len(shapes) == 1, shapes


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
def test_burst_segmentation_fuzz(tmp_path, serve, engine):
    """Any segmentation of one byte stream into sends gives the same reply
    stream, byte for byte the JAX daemon's on the same engine and model
    (tests/test_serving.py's model, lines and stream). Streams mix
    predictions, flush and a hogwild_load."""
    import random

    from test_serving import build

    *_, mpath = build(tmp_path, train_steps=4)
    port = serve(mpath, num_children=2, engine=engine)
    jsrv, jport = jax_device_port(mpath, engine)
    vocab = [b"1 |A cat |B milk\n", b"-1 |A dog |B stone\n",
             b"|A cat |B stone\n", b"flush\n",
             b"hogwild_load %s\n" % str(mpath).encode()]
    rng = random.Random(7)
    try:
        for trial in range(6):
            stream = b"".join(rng.choice(vocab) for _ in range(40))
            want = stream.count(b"|A") + stream.count(b"hogwild_load")
            replies = []
            for p, segmented in ((jport, False), (port, False), (port, True)):
                c = Client(p)
                if not segmented:
                    c.sock.sendall(stream)
                else:
                    i = 0
                    while i < len(stream):
                        j = min(len(stream), i + rng.randint(1, 37))
                        c.sock.sendall(stream[i:j])
                        i = j
                replies.append(b"".join(recv_lines(c.sock, want)))
                c.close()
            assert replies[1] == replies[0], f"trial {trial}: port vs JAX"
            assert replies[2] == replies[0], f"trial {trial}: segmented"
            assert replies[0].count(b"hogwild_load success") == \
                stream.count(b"hogwild_load")
    finally:
        jsrv.shutdown()


@pytest.mark.parametrize("bits", [["-b", "10"], ["-b", "14"],
                                  ["--ffm_bit_precision", "10"]],
                         ids=["smaller_lr", "larger_lr", "smaller_ffm"])
def test_hogwild_load_of_another_configuration_is_refused(tmp_path, serve, bits):
    """A file of another table size would have the served translator
    gather past (or beside) its tables. The JAX daemon swaps it in and
    serves what those gathers give; the port's device engine replies
    ``ERR: hogwild_load fail`` and keeps serving the model it had."""
    path = save_jax_model(tmp_path, "m.fwt", trained=True)
    vw = make_vw(tmp_path)
    mi = make_mi(vw, FFM_ARGV + bits)
    jmodel = JaxModel(mi)
    other = tmp_path / "other.fwt"
    jmf.save_model(other, mi, vw, jmodel, jax_params(jmodel, seed=3))
    port = serve(path)
    jsrv, jport = jax_device_port(path)
    line = b"|A a1 |B b2 |C c3\n"
    try:
        j = Client(jport)
        assert j.send(f"hogwild_load {other}\n".encode()) == b"hogwild_load success\n"
        j.close()
        c = Client(port)
        before = c.send(line)
        assert c.send(f"hogwild_load {other}\n".encode()) == b"ERR: hogwild_load fail\n"
        c.close()
        c = Client(port)
        assert c.send(line) == before
        c.close()
    finally:
        jsrv.shutdown()
