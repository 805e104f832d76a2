"""TCP line-protocol daemon on the port's device engine — the counterpart of
fwumious_wabbit_tpu/serve/server.py (reference: src/serving.rs:28-253).

Protocol: one VW text line in → one ``%.6f\\n`` prediction out; ``flush``
and ``hogwild_load <path>`` in-band; a parse error replies ``ERR: <message>``
and drops the connection. The connection handler (drain-and-reply
micro-batching), the pooled TCP server, the reply formatter and the
embedded-engine predictor are the port's own copies of the JAX package's
(``NativeSharedPredictor``, ``_format_preds``, ``_Handler`` and
``_PooledTCPServer`` of fwumious_wabbit_tpu/serve/server.py), beside the
port's device predictor. Worker threads share one model; a ``hogwild_load``
builds a new model and swaps the reference, so in-flight predictions keep
their snapshot. Unlike the JAX server, the device engine refuses a file of
another configuration (``ERR: hogwild_load fail``) and keeps serving.
"""

from __future__ import annotations

import queue
import signal
import socket
import socketserver
import threading

import numpy as np
import torch

from ..ingest import Batcher, TranslatedExample
from ..ingest.parser import FlushCommand, HogwildLoadCommand, ParseError, VowpalParser
from ..ingest.translator import FeatureTranslator
from ..models.model import FwModel
from ..persistence import model_file
from ..train.step import batch_dict, make_predict_step
from ..utils.logging import get_logger

log = get_logger(__name__)

# how long a memory reading waits for the predictions that began before
# the last swap to return their snapshots
RELEASE_WAIT_S = 5.0


class SharedPredictor:
    """The device model behind the daemon, hot-swappable. A swap takes only
    a file of the served configuration (``model_file.serving_layout`` of
    ``mi`` and ``vw``): the connections' translators were built for it.

    Each model has its own predict step — on the card one CUDA graph per
    batch signature (train/step.py ``make_predict_step``) — and a lock
    around its copy-in, replay and the copy of its output, since a graph
    owns its inputs and its output; the device→host copy and its wait
    run outside the lock. A swapped-out model's graphs and pools are
    released once its last prediction in flight returns."""

    def __init__(self, mi, vw, model: FwModel, batch_size: int = 256):
        self.mi = mi
        self._layout = model_file.serving_layout(mi, vw)
        self._lock = threading.Lock()
        # predictions in flight by the count of swaps made when each began,
        # and a condition notified when a count's last one returns
        self._holding: dict[int, int] = {}
        self._released = threading.Condition(self._lock)
        self._current = (model, make_predict_step(model))
        # around the current step's copy-in, replay and output copy
        self._step_lock = threading.Lock()
        # the steps of swapped-out models still predicting, by the count of
        # swaps their predictions began under
        self._retired: dict[int, object] = {}
        # the predict graphs' counts and signatures of released models
        self._done_counts: dict = {}
        self._done_signatures: set = set()
        self.batcher = Batcher(batch_size)
        self.swaps = 0
        # on a card: the bytes allocated once ``swaps`` swaps were made
        self.resident_bytes: dict[int, int] = {}

    @property
    def model(self) -> FwModel:
        return self._current[0]

    def note_resident(self) -> None:
        """Record the card's allocated bytes under the count of swaps made
        so far, once no prediction that began before the last swap is in
        flight: then no snapshot holds an earlier model, and its graphs
        are released. Called as a swap starts and as the daemon ends; no
        reading when such a prediction is still in flight after
        RELEASE_WAIT_S."""
        device = self.model.lr_w.device
        if device.type != "cuda":
            return
        with self._released:
            released = self._released.wait_for(
                lambda: all(g == self.swaps for g in self._holding), RELEASE_WAIT_S)
            if released:
                self.resident_bytes[self.swaps] = torch.cuda.memory_allocated(device)

    def hogwild_load(self, path: str) -> None:
        self.note_resident()
        model = model_file.hogwild_load(path, self._layout,
                                        device=self.model.lr_w.device)
        with self._lock:
            old = self._current[1]
            self._current = (model, make_predict_step(model))
            self._step_lock = threading.Lock()
            if self._holding.get(self.swaps):
                self._retired[self.swaps] = old
            else:
                self._release(old)
            self.swaps += 1

    def _release(self, step) -> None:
        """Release a swapped-out model's graphs and pools, keeping their
        counts; under ``self._lock``."""
        step.release()
        for k, v in step.counts.items():
            self._done_counts[k] = self._done_counts.get(k, 0) + v
        self._done_signatures.update(step.graphs)

    def graph_counts(self) -> dict:
        """The predict steps' counts over every model served
        (``graph_captures``, ``graph_replays``, ``eager_batches`` and their
        host seconds) and ``signatures``, the distinct batch signatures
        they met."""
        with self._lock:
            step = self._current[1]
            out = dict(self._done_counts)
            for k, v in step.counts.items():
                out[k] = out.get(k, 0) + v
            out["signatures"] = len(self._done_signatures | set(step.graphs))
        return out

    def predict_examples(self, examples) -> np.ndarray:
        """Predict translated examples of any count, in chunks of
        ``batch_size`` padded to the full batch, all by one snapshot of
        the model."""
        if not examples:
            return np.zeros(0, np.float32)
        with self._lock:
            gen, step, step_lock = self.swaps, self._current[1], self._step_lock
            self._holding[gen] = self._holding.get(gen, 0) + 1
        try:
            bs = self.batcher.batch_size
            outs = []
            for i in range(0, len(examples), bs):
                chunk = examples[i : i + bs]
                batch = self.batcher.make_batch(chunk, pad_to_batch=True)
                with step_lock:
                    # the next replay overwrites the graph's output: copy
                    # it on the stream first
                    out = step(batch_dict(batch)).clone()
                outs.append(out.cpu().numpy()[: len(chunk)])
            return outs[0] if len(outs) == 1 else np.concatenate(outs)
        finally:
            del step
            with self._released:
                self._holding[gen] -= 1
                if not self._holding[gen]:
                    del self._holding[gen]
                    retired = self._retired.pop(gen, None)
                    if retired is not None:
                        self._release(retired)
                        del retired
                    self._released.notify_all()


class NativeSharedPredictor:
    """Serving engine backed by the embedded C++ predictor (fw_ffi.cpp):
    microsecond single-line latency vs a device round-trip per line. Each
    connection works on a cheap clone_lite of the shared prototype; a
    ``hogwild_load`` swaps the prototype and bumps a generation counter so
    open connections pick up the new weights on their next line (matching
    the reference's live hot swap, src/serving.rs:112-140)."""

    def __init__(self, model_path: str):
        from .. import native as fw_native

        self._lock = threading.Lock()
        self._proto = fw_native.EmbeddedPredictor(f"-i {model_path}")
        self.generation = 1

    def hogwild_load(self, path: str) -> None:
        from .. import native as fw_native

        proto = fw_native.EmbeddedPredictor(f"-i {path}")  # raises on failure
        with self._lock:
            self._proto = proto
            self.generation += 1

    def clone(self):
        with self._lock:
            return self._proto.clone_lite(), self.generation


_BULK_CHUNK = 4096  # device-path examples per predict call on a drained burst


def _format_preds(out: bytearray, preds) -> None:
    """Append '%.6f\\n' per prediction — one call into the C formatter
    (fwn_format_preds, the CLI predict path's writer); plain loop fallback
    for device-engine deployments without the native lib."""
    from .. import native as fw_native

    arr = np.asarray(preds, np.float32)
    b = fw_native.format_preds(arr)
    if b is not None:
        out += b
        return
    for p in arr.tolist():
        out.extend(b"%.6f\n" % p)


class _Handler(socketserver.StreamRequestHandler):
    """Drain-and-reply connection loop: every complete line already buffered
    on the socket is processed before replying — device-path examples batch
    into ONE predict call (one dispatch per burst, not per line) and the
    burst's replies coalesce into ONE ``sendall``. Replies go out the moment
    no complete line is left, *before* blocking on ``recv``, so a
    request/response client sees per-line latency unchanged. The reference
    serves strictly line-at-a-time (src/serving.rs:72-110) — its per-line
    cost is a hash walk; ours is a device round-trip, hence the batching."""

    def handle(self):
        server: Serving = self.server.fwt_serving  # type: ignore[attr-defined]
        native_pred = server.native_predictor
        parser = VowpalParser(server.vw)
        translator = (
            FeatureTranslator(server.predictor.mi) if native_pred is None else None
        )
        clone, gen = (None, 0)
        sock = self.connection
        buf = bytearray()
        out = bytearray()
        pending: list = []  # device-path examples awaiting a batched predict

        def flush_pending():
            while pending:
                chunk = pending[:_BULK_CHUNK]
                del pending[:_BULK_CHUNK]
                _format_preds(out, server.predictor.predict_examples(chunk))

        def send_out():
            flush_pending()
            if out:
                sock.sendall(out)
                out.clear()

        at_eof = False
        while True:
            nl = buf.find(b"\n")
            if nl < 0:
                send_out()  # input drained: reply before blocking
                if at_eof:
                    return
                data = sock.recv(65536)
                if not data:
                    if not buf:
                        return
                    at_eof = True
                    buf += b"\n"  # process the trailing unterminated line
                else:
                    buf += data
                continue
            try:
                if native_pred is not None:
                    # block-predict the whole buffered complete-line region
                    # in ONE C call (fw_predict_block_mt: thread-sharded for
                    # big bursts, serial walk for lone lines — so a
                    # request/response client keeps per-line latency). The
                    # engine stops BEFORE the first special line (empty/
                    # flush/hogwild_load/parse error), which the per-line
                    # logic below then handles from the head of the buffer.
                    if clone is None or gen != native_pred.generation:
                        clone, gen = native_pred.clone()
                    end = buf.rfind(b"\n") + 1
                    preds, consumed, status = clone.predict_block_mt(
                        bytes(buf[:end]))
                    del buf[:consumed]
                    _format_preds(out, preds)
                    if status == clone.BLOCK_OK:
                        continue
                    if status == clone.BLOCK_ERROR:
                        hnl = buf.find(b"\n")
                        bad = bytes(buf[: hnl + 1])
                        if not bad.strip():
                            # whitespace-only line: the C parser calls it an
                            # error, but the wire contract (and the device
                            # path) treats any blank line as end-of-stream
                            send_out()
                            return
                        parser.parse_line(bad)
                        raise ParseError("prediction failed")
                    nl = buf.find(b"\n")  # special line at the head
                line = bytes(buf[: nl + 1])
                del buf[: nl + 1]
                stripped = line.strip()
                if not stripped:
                    send_out()
                    return
                if stripped == b"flush":
                    send_out()
                    continue
                if stripped.startswith(b"hogwild_load "):
                    raise HogwildLoadCommand(stripped[13:].decode().strip())
                if native_pred is None:
                    rec = parser.parse_line(line)
                    if rec.size == 0:
                        send_out()
                        return
                    pending.append(translator.translate(rec))
                    if len(pending) >= _BULK_CHUNK:
                        flush_pending()
            except FlushCommand:
                send_out()
            except HogwildLoadCommand as cmd:
                flush_pending()  # earlier predictions reply first, in order
                try:
                    if native_pred is not None:
                        native_pred.hogwild_load(cmd.filename)
                    if server.predictor is not None:
                        server.predictor.hogwild_load(cmd.filename)
                    out += b"hogwild_load success\n"
                    send_out()
                except Exception as e:  # noqa: BLE001
                    log.error("hogwild_load failed: %s", e)
                    out += b"ERR: hogwild_load fail\n"
                    send_out()
                    return
            except ParseError as e:
                flush_pending()
                out += f"ERR: {e}\n".encode()
                send_out()
                return


class _PooledTCPServer(socketserver.TCPServer):
    """Fixed worker pool: the accept loop hands connections to
    ``num_children`` worker threads through a bounded queue — the same
    shape as the reference's accept → mpsc channel → WorkerThread design
    (reference: src/serving.rs:231-253). The bounded queue is the
    backpressure: under a connection flood the accept loop blocks once
    ``2·num_children`` connections are waiting, and further clients queue in
    the kernel backlog instead of spawning unbounded threads."""

    allow_reuse_address = True
    request_queue_size = 64  # listen(2) backlog

    def __init__(self, addr, handler, num_children: int):
        super().__init__(addr, handler)
        self.num_children = max(1, int(num_children))
        self._queue: queue.Queue = queue.Queue(maxsize=2 * self.num_children)
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"fwt-serve-{i}")
            for i in range(self.num_children)
        ]
        for t in self._workers:
            t.start()

    def process_request(self, request, client_address):
        self._queue.put((request, client_address))  # blocks when full

    def _worker(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            request, client_address = item
            try:
                self.finish_request(request, client_address)
            except Exception:  # noqa: BLE001
                self.handle_error(request, client_address)
            finally:
                self.shutdown_request(request)

    def server_close(self):
        # Called by TCPServer.__init__ itself when bind() fails — before
        # the pool attributes exist — so guard the worker drain.
        super().server_close()
        for _ in getattr(self, "_workers", ()):
            self._queue.put(None)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


class Serving:
    """The daemon: N worker threads share one predictor (reference:
    src/serving.rs:184-253; default port 26542, localhost).

    ``--fwt_serve_engine``: ``auto`` and ``device`` serve from the device
    model; ``native`` serves from the embedded C++ engine and must be asked
    for (``model`` may then be None)."""

    def __init__(self, args, mi, vw, model: FwModel | None,
                 model_path: str | None = None):
        self.vw = vw
        port = getattr(args, "port", None)
        self.port = 26542 if port is None else int(port)  # 0 = any free port
        self.num_children = int(getattr(args, "num_children", None) or 10)
        engine = getattr(args, "fwt_serve_engine", "auto") or "auto"
        self.native_predictor = None
        self.predictor = None
        if engine == "native":
            if not model_path:
                raise ValueError("--fwt_serve_engine native needs a model file")
            self.native_predictor = NativeSharedPredictor(str(model_path))
            log.info("serving with the embedded C++ engine")
        else:
            if model is None:
                raise ValueError("the device engine needs a model")
            self.predictor = SharedPredictor(mi, vw, model)
            self._warm(mi)
        self._server = None

    def _warm(self, mi) -> None:
        """One predict now, so the first request does not pay for building
        the kernels (nvcc) or the reply formatter's library."""
        ffm = bool(getattr(mi, "ffm_k", 0))
        dummy = TranslatedExample(
            0.0, 0.0, [0], [0.0], [0],
            [0] if ffm else [], [0.0] if ffm else [], [0] if ffm else [])
        _format_preds(bytearray(), self.predictor.predict_examples([dummy]))

    def _bind(self, host: str) -> None:
        self._server = _PooledTCPServer((host, self.port), _Handler,
                                        self.num_children)
        self._server.fwt_serving = self  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]

    def serve(self, host: str = "127.0.0.1") -> None:
        """Serve until interrupted; on the main thread SIGTERM ends the
        loop as Ctrl-C does, so the caller's clean-up runs."""
        self._bind(host)
        log.info("serving on %s:%d (%d workers)", host, self.port,
                 self.num_children)
        main = threading.current_thread() is threading.main_thread()
        previous = signal.signal(signal.SIGTERM, _interrupt) if main else None
        try:
            self._server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._server.server_close()
            if main:
                signal.signal(signal.SIGTERM, previous)

    def serve_in_background(self, host: str = "127.0.0.1") -> threading.Thread:
        """Serve on a daemon thread (tests and embedders); port 0 picks a
        free port, readable from ``self.port`` on return."""
        self._bind(host)
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
