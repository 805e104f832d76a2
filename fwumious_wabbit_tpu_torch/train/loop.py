"""The command line — the counterpart of ``main`` in
fwumious_wabbit_tpu/train/loop.py, for the modes ported so far:

* ``--daemon -i model.fwt``: the TCP line server (serve/server.py);
* training: ``--data x.vw <model flags> [-p preds] [-f model.fwt
  --save_resume] [-i start.fwt]`` — forward, backward and the sparse AdaGrad
  update on the device; the training-path predictions (the forward values
  before each update) are written ``%.6f`` per example after
  ``--predictions_after``, and the final model to ``-f``.
  ``--holdout_after``, ``--prediction_model_delay``, ``--fwt_exact`` (batch
  1) and ``--fwt_batch_size`` keep their meaning;
* ``-t`` (with or without ``-i``): the same loop without updates;
* ``--build_cache_without_training``: the record cache only;
* ``--convert_inference_regressor OUT -i IN [--weight_quantization]``: the
  inference form of a model file (:func:`convert`).

Training takes a dense tower (``--nn``, its manual backward and dense
update on the device, train/step.py) as the JAX CLI does, and ``-c`` reads
and writes the record cache (ingest/cache.py) on both ingest paths: the
Python parser reads records through :func:`record_stream`, the C++ ingest
through producer.native_batch_stream; with ``-c``, ``--fwt_pack_cache
auto`` records and replays the pack cache as well, whose replay then comes
first. ``--fwt_profile DIR`` writes a torch.profiler trace of a window of
the run's steps into DIR (:class:`_ProfileWindow`).

Training and ``-t`` (on the device engine) read their input through the JAX
CLI's default path, as its ``_use_native`` chooses it for both: the C++
ingest (native/ ``NativeIngest``: parse + translate, host counts, slimming,
bit-packing and vocabulary encoding, train/producer.py) on one thread; K
batches packed into one u32 buffer (train/packed.py, ``--fwt_superbatch``,
default 8); one host→device copy per superbatch through a ring of pinned
buffers on a thread and stream of their own (producer ``Transferrer``); K
train steps on the card, from the second superbatch of a (layout, K) on
replayed as one CUDA graph (the JAX CLI's jitted ``lax.scan``; a graph that
fails ends the run with exit 1); one prediction fetch per superbatch, copied back
without blocking and written by the writer thread once its event has
completed. ``-t`` sends its batches one at a time through the same copy
stage. Every batch that is not packed — ``-t``, holdout, delayed learning,
``--fwt_exact``, ``--fwt_no_native``, a partial or tail batch — runs the
per-batch train or predict step, on the card one CUDA graph per batch
signature after that signature's first batch ran step by step (the JAX
CLI's jitted steps, train/step.py ``BatchStep``; a graph that fails ends
the run with exit 1). The daemon parses in Python. ``--fwt_bitpack``, ``--fwt_vocab``,
``--fwt_pack_cache`` and ``--fwt_fetch_stack`` keep their meaning. ``--fwt_no_native`` chooses the
Python parser instead (the JAX CLI's fallback path). Unlike the JAX CLI,
which quietly trains on the Python path when its C++ library does not load,
the default path here fails with the compiler's message and exits
non-zero: only ``--fwt_no_native`` chooses the Python ingest.

Under a mesh (``--fwt_data_axis``/``--fwt_table_axis``, and a process
group of as many ranks, one per device, :func:`_join`) every rank reads the
whole input, trains its shard of each batch through parallel/sharded.py on
its own row blocks of the tables, gathers the predictions back in one
global order, and ``-f`` gathers the tables. On one host one command starts
the ranks (parallel/launch.py), and rank 0 alone writes ``-p``, ``-f`` and
the ``-c`` cache, as the JAX CLI's one process does; across hosts
(``--fwt_hosts N --fwt_host_id r --fwt_coordinator host:port``) every rank
writes them, as every JAX host does. Batches are not packed under a mesh,
as in the JAX CLI. The flag vocabulary is the JAX package's (the port's copy in
config/cmdline.py).
Every mode runs on the CUDA card; the CPU only with ``--fwt_platform cpu``.
``--fwt_serve_engine`` keeps its meaning, except that ``auto`` means the
device engine here: ``native`` (the port's copy of the embedded C++ engine,
native/) must be asked for, and fails rather than falls back when it
cannot be built; as in the JAX CLI, it predicts only what
``native_predict_eligible`` admits (no ``-f``, ``-c``, delay, sharding or
``--fwt_no_native``), and the device engine takes the rest.
``--fwt_pallas_update`` is accepted and ignored (on a CUDA tensor the
sparse update kernel always runs).

``FWT_PIPELINE_DEPTH`` bounds the prediction fetches in flight to the
writer (default 3); ``FWT_COUNTERS_OUT=<path>`` writes the run's examples,
elapsed seconds and in-run counters as JSON (the packed graphs' and, as
``train_*`` and ``predict_*``, the per-batch graphs'; ``graph_releases``
and ``graph_release_s``, the graphs this run released, packed and
per-batch, and the seconds that took; ``graph_pool_bytes``, what the
pools of the model's live packed graphs hold at the end; ``pass_open_s`` and
``pass_close_s``, the run's edges; ``ffm_update_bytes`` and
``ffm_update_examples``, the FFM update rows the steps handed the sparse
update and their examples, :class:`_Run`), with the kernels' launches,
the files it wrote, the card's peak memory and, under a mesh, the process
group's set-up seconds and the sharded steps' collective bytes. The
device-engine daemon writes its launches, its hot swaps, the card's
allocated bytes after each swap, its predict graphs' counts and its peak
memory there when SIGTERM (or Ctrl-C) ends it. Each timed counter of the
training loop is a span too (utils/spans.py): a ``fwt.*`` range in the
trace of a profiler that records it.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import sys
import threading
import time

import numpy as np
import torch

from ..config.cmdline import build_parser
from ..config.model_instance import ModelInstance
from ..config.vwmap import VwNamespaceMap
from ..ingest import (
    Batcher,
    FeatureTranslator,
    FlushCommand,
    HogwildLoadCommand,
    VowpalParser,
    create_buffered_input,
)
from ..utils.device import NoDeviceError, resolve_device
from ..utils.logging import get_logger
from ..utils.spans import span
from .step import GraphError
from .predict import PredictionWriter, native_predict_eligible

log = get_logger(__name__)


def _daemonize() -> None:
    """Classic double fork (the reference daemonizes unless --foreground,
    src/serving.rs:215-225); runs before CUDA is initialized. A copy of the
    JAX loop's: that module imports the training pipeline and its record
    cache, which needs ``zstandard``, a package the serving path must not
    require."""
    if os.fork() > 0:
        os._exit(0)
    os.setsid()
    if os.fork() > 0:
        os._exit(0)
    devnull = os.open(os.devnull, os.O_RDWR)
    for fd in (0, 1, 2):
        os.dup2(devnull, fd)
    os.close(devnull)


def _join(args):
    """``(device, mesh or None)``: with ``--fwt_hosts``/``--fwt_coordinator``
    this process joins the process group as rank ``--fwt_host_id`` on its
    own card (gloo and the CPU with ``--fwt_platform cpu``,
    parallel/distributed.py); a mesh — ``--fwt_data_axis`` ×
    ``--fwt_table_axis``, or every rank on data — is made when the axes ask
    for more than one device or the group has more than one rank. One
    process per device: a mesh must have exactly the group's ranks, and
    one that does not raises ValueError naming the flags. The mesh's
    ``setup_s`` is the seconds from joining the group to the mesh's
    subgroups made."""
    from ..parallel import distributed

    n_table = int(args.fwt_table_axis or 1)
    n_data = args.fwt_data_axis
    t0 = time.perf_counter()
    if distributed.wanted(args.fwt_coordinator, args.fwt_hosts):
        device = distributed.initialize(args.fwt_coordinator, args.fwt_hosts,
                                        args.fwt_host_id, args.fwt_platform)
    else:
        device = resolve_device(args.fwt_platform)
    world = distributed.world_size()
    if n_table <= 1 and (n_data is None or n_data <= 1) and world == 1:
        return device, None
    n_data = int(n_data) if n_data is not None else max(1, world // n_table)
    if n_data * n_table != world:
        raise ValueError(
            f"a {n_data}x{n_table} mesh (--fwt_data_axis x --fwt_table_axis) "
            f"needs {n_data * n_table} ranks, one process per device; this "
            f"run has {world}: start that many with --fwt_hosts N "
            f"--fwt_host_id r --fwt_coordinator host:port")
    from ..parallel import mesh as pmesh

    mesh = pmesh.Mesh(n_data, n_table)
    mesh.setup_s = time.perf_counter() - t0
    return device, mesh


def record_stream(args, vw):
    """Yield parsed u32 records from the record cache (if valid) or from
    the text, writing the cache when ``-c`` (the reference's RecordCache
    drive, src/cache.rs:53-131, src/main.rs:213-228; a copy of
    fwumious_wabbit_tpu/train/loop.py:49-89)."""
    from ..ingest import cache as fwcache

    use_cache = bool(args.cache)
    cpath = fwcache.cache_path_for(args.data)
    if use_cache and os.path.exists(cpath):
        try:
            reader = fwcache.RecordCacheReader(cpath, vw)
        except (fwcache.StaleCacheError, ValueError) as e:
            log.warning("cache rejected (%s); reparsing", e)
        else:
            log.info("using cache file %s (%s)", cpath,
                     fwcache.CODEC_NAMES.get(reader.codec, reader.codec))
            try:
                yield from reader
            finally:
                reader.close()
            return

    writer = fwcache.RecordCacheWriter(cpath, vw) if use_cache else None
    parser = VowpalParser(vw)
    stream = create_buffered_input(args.data)
    try:
        while True:
            # in-band commands in a training file abort the run, as in the
            # reference (src/main.rs:218-221)
            rec = parser.next_vowpal(stream)
            if rec.size == 0:
                break
            if writer is not None:
                writer.push_record(rec)
            yield rec
    except BaseException:
        # never publish a truncated cache (the reference renames the
        # .writing temp only on clean completion, src/cache.rs:147-153)
        if writer is not None:
            writer.abort()
        raise
    else:
        if writer is not None:
            writer.write_finish()
    finally:
        stream.close()


def build_cache_without_training(args, vw) -> int:
    """--build_cache_without_training (reference: src/main.rs:50-94): the
    record cache of ``--data``, written by :func:`record_stream`."""
    n = sum(1 for _ in record_stream(args, vw))
    log.info("cache built: %d records", n)
    return n


class _ProfileWindow:
    """``--fwt_profile DIR``: a torch.profiler trace of a window of the
    run's dispatches — a single batch's step, or a packed superbatch's K
    steps — written to ``DIR/fwt_trace_<pid>.json`` in the Chrome trace
    format: the CPU ops and ``fwt.*`` spans of every thread (the consumer,
    the producer, the transfer and writer threads), and the card's kernels
    and copies on CUDA. The first dispatch (first use of each kernel and
    allocation) is left out, the next :attr:`STEPS` are traced; a run that
    ends inside the window writes what it traced (the JAX CLI traces its
    whole run with jax.profiler, fwumious_wabbit_tpu/train/loop.py:860-877).
    The trace's ``fwt_counters`` entry holds the traced dispatches' count
    and what they added to the loop's :attr:`COUNTERS`."""

    SKIP = 1
    STEPS = 8
    COUNTERS = ("ffm_update_bytes", "ffm_update_examples")

    def __init__(self, directory: str, device: torch.device, counters: dict):
        self.directory = directory
        self.device = device
        self.counters = counters
        self.start = {}
        self.dispatches = 0
        self.prof = None
        self.path = None

    def step(self) -> None:
        """Called after each dispatch."""
        self.dispatches += 1
        if self.dispatches == self.SKIP:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(
                activities=acts,
                experimental_config=torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True))
            self.start = {k: self.counters[k] for k in self.COUNTERS}
            self.prof.start()
        elif self.dispatches == self.SKIP + self.STEPS:
            self.close()

    def close(self) -> None:
        """Stop and write the trace, once; a run of at most SKIP dispatches
        has traced nothing and writes nothing."""
        if self.path is not None:
            return
        if self.prof is None:
            log.warning("--fwt_profile: the run ended before its profile "
                        "window (after %d dispatch)", self.SKIP)
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        traced = min(self.dispatches - self.SKIP, self.STEPS)
        window = {k: self.counters[k] - v for k, v in self.start.items()}
        self.prof.add_metadata_json("fwt_counters",
                                    json.dumps(dict(window, dispatches=traced)))
        self.prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory, f"fwt_trace_{os.getpid()}.json")
        self.prof.export_chrome_trace(self.path)
        log.info("profiler trace of %d dispatches written to %s (%s)", traced,
                 self.path, ", ".join(f"{k} {v}" for k, v in window.items()))


def np_counts(ids: np.ndarray, vals: np.ndarray, shift: int) -> np.ndarray:
    """Multiplicity counts of the keys ``ids >> shift`` over one batch, as
    u8 codes (ops/adagrad.encode_counts) — a copy of the JAX loop's
    Python-ingest ``np_counts``. Entries with value 0 (padding included)
    are not counted: their gradient is 0."""
    from ..ops.adagrad import encode_counts

    keys = ids.astype(np.uint32) >> shift
    real = (vals != 0.0).reshape(-1)
    flat = keys.reshape(-1)
    c = np.zeros(flat.shape, np.int64)
    if real.any():
        _, inv, cnt = np.unique(flat[real], return_inverse=True,
                                return_counts=True)
        c[real] = cnt[inv]
    return encode_counts(c).reshape(ids.shape)


def _to_host(preds: torch.Tensor):
    """``(host tensor, event or None)``: the predictions copied back to the
    host. On the card the copy goes into pinned memory without blocking,
    and the event marks its end (the writer waits on it: the counterpart
    of the JAX loop's ``copy_to_host_async``). On the CPU a plain copy, so
    a later in-place write (the fetch ring) cannot reach it. The copy is
    enqueued on the current stream before this returns, so a later write
    to ``preds`` on that stream (the next replay of a step's CUDA graph,
    which owns its output) cannot overtake it."""
    if preds.device.type != "cuda":
        return preds.detach().clone(), None
    host = torch.empty(preds.shape, dtype=preds.dtype, pin_memory=True)
    host.copy_(preds, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


class _Run:
    """One training (or ``-t``) run's state, shared by both ingest paths:
    the steps, the prediction writer thread and its bounded queue
    (``FWT_PIPELINE_DEPTH`` fetches in flight), the delayed-learning queue,
    the example count and the in-run counters — each counter written by
    its stage's own thread, and each timed one by a span of the same name
    (utils/spans.py):

    * producer span ≈ producer_busy_s + producer_stall_s
      (``fwt.producer.item``, ``fwt.producer.put``)
    * transferrer ≈ xfer_starve_s + xfer_busy_s + xfer_stall_s
      (``fwt.xfer.wait``, ``.copy``, ``.put``)
    * consumer ≈ pass_open_s + consumer_starve_s + dispatch_s +
      writer_stall_s + pass_close_s (``fwt.pass.open``,
      ``fwt.consumer.wait_input``, ``fwt.dispatch.packed`` or ``.batch``
      with their ``fwt.graph.*`` children, ``fwt.consumer.fetch``,
      ``fwt.pass.close``)
    * writer ≈ (queue wait) + fetch_force_s + write_s (``fwt.writer.wait``,
      ``fwt.writer.write``)

    pass_open_s runs from here to the consumer's first wait for input, and
    pass_close_s from the end of the stream to :meth:`finish`'s return.
    fetch_force_s is the writer's wait for a prediction copy's event, and
    so for the steps before it: the in-run proxy of the card's busy time
    (fwumious_wabbit_tpu/train/loop.py:235-342). graph_releases and
    graph_release_s count this run's own graph releases, packed and
    per-batch; graph_pool_bytes is what the pools of the model's live
    packed graphs hold at the run's end."""

    def __init__(self, args, model):
        from . import packed
        from .step import ffm_update_bytes, make_predict_step, make_train_step

        self.ctr = {
            "producer_busy_s": 0.0, "producer_stall_s": 0.0,
            "xfer_starve_s": 0.0, "xfer_busy_s": 0.0, "xfer_stall_s": 0.0,
            "xfer_bytes": 0, "xfer_puts": 0,
            "consumer_starve_s": 0.0, "dispatch_s": 0.0,
            "writer_stall_s": 0.0, "fetch_force_s": 0.0, "fetch_count": 0,
            "fetch_bytes": 0, "write_s": 0.0,
            "pass_open_s": 0.0, "pass_close_s": 0.0,
            "ffm_update_bytes": 0, "ffm_update_examples": 0,
        }
        # the FFM update rows' bytes per trained example and FFM entry
        self.ffm_entry_bytes = ffm_update_bytes(model, 1, 1)
        self.opening = span("fwt.pass.open", self.ctr, "pass_open_s").open()
        self.closing = span("fwt.pass.close", self.ctr, "pass_close_s")
        # the model's packed graphs count over its life: this run's are
        # the difference
        self.packed_releases = packed.release_counts(model)
        self.packed_releases0 = dict(self.packed_releases)
        self.packed_pool = lambda: packed.pool_bytes(model)
        self.profile = (_ProfileWindow(args.fwt_profile, model.lr_w.device,
                                       self.ctr)
                        if args.fwt_profile else None)
        self.testonly = bool(args.testonly)
        self.batch_size = (1 if args.fwt_exact
                           else max(1, int(args.fwt_batch_size or 1024)))
        # under a mesh (the model's tables are this rank's row blocks): the
        # sharded steps, each batch cut to this rank's shard and the
        # predictions gathered back in one global order
        self.mesh = getattr(model, "mesh", None)
        self.dropped = None  # the a2a overflow count, summed on the device
        self.predictions_after = int(args.predictions_after or 0)
        self.holdout_after = (int(args.holdout_after)
                              if args.holdout_after is not None else None)
        # batches end at the train/holdout boundary
        self.cut_at = (self.holdout_after - 1
                       if self.holdout_after is not None else None)
        self.delay = int(args.prediction_model_delay or 0)
        self.writer = PredictionWriter(args.predictions,
                                       bool(args.predictions_stdout))
        if self.mesh is None:
            # on the card one CUDA graph per batch signature each, the JAX
            # loop's jitted steps
            self.train_step = None if self.testonly else make_train_step(model)
            self.predict_step = make_predict_step(model)
        else:
            self._sharded(args, model)
        # host multiplicity counts for the scopes with the batch-mean cap,
        # keyed per weight for LR (id) and per window for FFM (id >> log2
        # align)
        self.count_keys = {}
        if model.opt_lr.batch_mean:
            self.count_keys["lr"] = 0
        if (model.has_ffm and model.opt_ffm.batch_mean
                and model.ffm_spec.rows_per_slab == 1):
            self.count_keys["ffm"] = (model.ffm_spec.align - 1).bit_length()
        self.count_keys = self.count_keys or None
        self.delayed: list = []  # (batch dict, n) awaiting training
        self.delayed_examples = 0
        self.example_num = 0
        self.wq: queue.Queue = queue.Queue(
            maxsize=int(os.environ.get("FWT_PIPELINE_DEPTH", "3")))
        self.werr: list = []
        self.wt = threading.Thread(target=self._write_preds, daemon=True)
        self.t0, self.t0_cpu = time.time(), time.process_time()
        self.t0_thread = time.thread_time()  # the consumer thread's CPU
        self.wt.start()

    def _sharded(self, args, model) -> None:
        """The mesh branch (fwumious_wabbit_tpu/train/loop.py:161-219):
        the exchange (``auto`` = a2a when the table axis is > 1), the batch
        rounded up to the shard count, the sharded train and predict
        steps."""
        from ..parallel import mesh as pmesh
        from ..parallel import sharded

        mesh = self.mesh
        exchange = sharded.resolve_exchange(args.fwt_exchange or "auto", mesh)
        self.both_axes = exchange == "a2a"
        nshard = mesh.shards(self.both_axes)[0]
        self.batch_size = pmesh.round_up(self.batch_size, nshard)
        log.info("mesh: %s exchange=%s (batch %d)", mesh.shape, exchange,
                 self.batch_size)
        step = (None if self.testonly else sharded.make_sharded_train_step(
            model, mesh, exchange, float(args.fwt_a2a_capacity or 2.0),
            with_stats=True))

        def train_step(bd):
            p, stats = step(bd)
            d = stats["a2a_dropped"]
            self.dropped = d if self.dropped is None else self.dropped + d
            return p

        self.train_step = None if step is None else train_step
        self.predict_step = sharded.make_sharded_predict_step(model, mesh,
                                                              exchange)

    def _write_preds(self) -> None:
        """The writer thread: one fetch per item — [B] from a single step,
        [K, B] from a packed one, [M, K, B] from the fetch ring — whose
        metas map its leading rows back to example segments."""
        ctr = self.ctr
        cpu0 = time.thread_time()
        try:
            while (item := self.wq.get()) is not None:
                host, ev, metas = item
                with span("fwt.writer.wait", ctr, "fetch_force_s"):
                    if ev is not None:
                        ev.synchronize()
                    arr = host.numpy()
                ctr["fetch_count"] += 1
                ctr["fetch_bytes"] += arr.nbytes
                with span("fwt.writer.write", ctr, "write_s"):
                    arr = arr.reshape(len(metas), -1)
                    for row, (first_num, n) in zip(arr, metas):
                        skip = max(0, self.predictions_after - first_num + 1)
                        self.writer.write_block(row[:n][skip:])
        except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
            self.werr.append(e)
            while self.wq.get() is not None:  # unblock the consumer
                pass
        finally:
            ctr.setdefault("cpu_s_by_thread", {})["writer"] = (
                time.thread_time() - cpu0)

    def fetch(self, preds: torch.Tensor, metas: list) -> None:
        """Pass predictions for the segments ``metas`` (first example
        number, count) to the writer; blocks when the pipeline is full."""
        with span("fwt.consumer.fetch", self.ctr, "writer_stall_s"):
            self.wq.put((*_to_host(preds), metas))
        if self.werr:
            raise self.werr[0]

    def count(self, n: int) -> int:
        """Number the next ``n`` examples; returns the first (1-based)."""
        self.example_num += n
        return self.example_num - n + 1

    def process(self, bd: dict, n: int) -> None:
        """One batch: train or predict, and pass its predictions to the
        writer. Batches never span the train/holdout boundary (the
        producers cut there), so the update flag is uniform per batch."""
        first_num = self.count(n)
        update = not self.testonly and (self.holdout_after is None
                                        or first_num < self.holdout_after)
        if self.mesh is not None:
            from ..parallel import mesh as pmesh

            bd = pmesh.shard_batch(bd, self.mesh, self.both_axes)
        if self.delay == 0:
            with span("fwt.dispatch.batch", self.ctr, "dispatch_s"):
                preds = self.train(bd) if update else self.predict_step(bd)
        else:
            # predict with the lagging model, then train what left the
            # queue; the reference's delay path trains every delayed
            # example, holdout or not (src/main.rs:249-258); a span that
            # feeds no counter
            with span("fwt.dispatch.batch"):
                preds = self.predict_step(bd)
                self.delayed.append((bd, n))
                self.delayed_examples += n
                while self.delayed and \
                        self.delayed_examples - self.delayed[0][1] >= self.delay:
                    old_bd, old_n = self.delayed.pop(0)
                    self.delayed_examples -= old_n
                    if self.train_step is not None:
                        self.train(old_bd)
        self.profile_step()
        if self.mesh is not None:
            # every rank writes the whole stream: gathered here, on the main
            # thread, so the collectives keep one global order; on every
            # rank, with -p or without, so that none waits for another
            from ..parallel import mesh as pmesh

            preds = pmesh.gather_batch(preds, self.mesh, self.both_axes)
        if self.writer.active:
            self.fetch(preds, [(first_num, n)])

    def count_ffm_update(self, examples: int, width: int) -> None:
        """Count the FFM update rows of ``examples`` trained examples of
        ``width`` FFM entries each: ``ffm_update_bytes``, the bytes of the
        rows the FFM scope hands the sparse update (train/step.py
        ``ffm_update_bytes``), and ``ffm_update_examples``; nothing without
        FFM."""
        if self.ffm_entry_bytes:
            self.ctr["ffm_update_bytes"] += examples * width * self.ffm_entry_bytes
            self.ctr["ffm_update_examples"] += examples

    def train(self, bd: dict):
        """One batch's train step, its FFM update rows counted from the
        batch's shape."""
        ids = bd.get("ffm_ids")
        if ids is not None:
            self.count_ffm_update(*ids.shape)
        return self.train_step(bd)

    def profile_step(self) -> None:
        if self.profile is not None:
            self.profile.step()

    def finish(self) -> dict:
        """Train what the delay still holds, drain the writer, log the rate
        and return ``{'examples', 'elapsed', 'counters'}``."""
        if self.train_step is not None:
            for bd, _n in self.delayed:
                self.train(bd)
        releases = {k: v - self.packed_releases0[k]
                    for k, v in self.packed_releases.items()}
        if self.mesh is None:
            # the per-batch steps' graphs, apart from the packed ones
            for kind in ("train", "predict"):
                step = getattr(self, kind + "_step")
                if step is not None:
                    self.ctr.update({f"{kind}_{k}": v for k, v in step.counts.items()})
                    for k, v in step.releases.items():
                        releases[k] += v
        self.ctr.update(releases, graph_pool_bytes=self.packed_pool())
        self.close()
        if self.werr:
            raise self.werr[0]
        dropped = int(self.dropped) if self.dropped is not None else 0
        if dropped > 0:
            log.warning(
                "a2a exchange dropped %d occurrence(s) past the static "
                "per-destination capacity this run (their lookups read zero "
                "and their updates were skipped) — raise --fwt_a2a_capacity "
                "if the id distribution is skewed", dropped)
        elapsed = time.time() - self.t0
        self.ctr.setdefault("cpu_s_by_thread", {})["consumer"] = (
            time.thread_time() - self.t0_thread)
        log.info("Elapsed: %.2fs rows: %d (%.0f ex/s)", elapsed,
                 self.example_num, self.example_num / max(elapsed, 1e-9))
        self.closing.close()
        return {"examples": self.example_num, "elapsed": elapsed,
                "a2a_dropped": dropped,
                "counters": dict(self.ctr, elapsed_s=elapsed,
                                 process_cpu_s=time.process_time() - self.t0_cpu)}

    def close(self) -> None:
        if self.profile is not None:
            self.profile.close()
        if self.wt.is_alive():
            self.wq.put(None)
            self.wt.join()
        self.writer.close()


def run_train_loop(args, mi, vw, model) -> dict:
    """Train (or, with ``-t``, only predict) over ``args.data``, updating
    the model's tables in place, and log the rate
    (fwumious_wabbit_tpu/train/loop.py ``run_train_loop``, without its
    multi-host branch and its fetch ring's automatic engagement). Returns
    ``{'examples', 'elapsed', 'counters'}``."""
    run = _Run(args, model)
    try:
        if args.fwt_no_native:
            _python_ingest(args, mi, vw, run)
        else:
            _native_ingest(args, mi, vw, model, run)
        return run.finish()
    finally:
        run.close()


def _python_ingest(args, mi, vw, run: _Run) -> None:
    """``--fwt_no_native``: the Python parser (or the record cache, with
    ``-c``), translator and batcher, with numpy host counts, one batch at a
    time (the JAX loop's fallback path)."""
    from .step import train_batch_dict

    translator = FeatureTranslator(mi)
    batcher = Batcher(run.batch_size)
    count_keys = run.count_keys
    pending: list = []

    def flush() -> None:
        if not pending:
            return
        batch = batcher.make_batch(pending)
        bd = train_batch_dict(batch)
        if count_keys is not None:
            if "lr" in count_keys:
                bd["lr_counts"] = np_counts(batch.lr_ids, batch.lr_vals,
                                            count_keys["lr"])
            if "ffm" in count_keys and batch.ffm_ids.size:
                bd["ffm_counts"] = np_counts(batch.ffm_ids, batch.ffm_vals,
                                             count_keys["ffm"])
        run.process(bd, batch.num_examples)
        pending.clear()

    seen = 0
    run.opening.close()
    for rec in record_stream(args, vw):
        seen += 1
        pending.append(translator.translate(rec))
        if len(pending) >= run.batch_size or (run.cut_at is not None
                                              and seen == run.cut_at):
            flush()
    run.closing.open()
    flush()


def _native_ingest(args, mi, vw, model, run: _Run) -> None:
    """The default path (fwumious_wabbit_tpu/train/loop.py:432-633): the
    producer thread (C++ ingest → slim → superbatch pack), the transfer
    thread (pinned ring → the card) and this thread consuming: K train
    steps per packed superbatch and one prediction fetch for them. Groups
    never span the train/holdout boundary; partial, holdout, ``-t`` and
    delayed-learning batches arrive one at a time (``"s"``)."""
    from . import packed as packed_mod
    from .producer import SuperbatchProducer, arrived, run_transferrer

    K = int(args.fwt_superbatch or 0)
    if K <= 0:
        K = 8
    ctr, batch_size = run.ctr, run.batch_size
    can_pack = (K > 1 and run.delay == 0 and run.train_step is not None
                and run.mesh is None)
    bitpack_on = (args.fwt_bitpack or "auto") != "off"
    # the producer owns the persistent per-column dictionaries; a full
    # snapshot rides the queue ahead of any group that grew them
    vocab_state = (packed_mod.VocabTransferState()
                   if bitpack_on and (args.fwt_vocab or "auto") != "off"
                   else None)

    # the pack cache: record the producer's queue stream on the first pass,
    # replay it on re-runs over the same input and config; auto engages it
    # with -c (the sibling record cache's own trigger)
    pc_mode = args.fwt_pack_cache or "auto"
    pack_iter = pack_writer = None
    if can_pack and pc_mode != "off" and os.path.isfile(args.data) and (
            pc_mode == "on" or bool(args.cache)):
        from . import pack_cache as pcache

        ppath = pcache.pack_cache_path_for(args.data)
        psig = pcache.stream_signature(
            mi, vw, batch_size=batch_size, K=K, bitpack_on=bitpack_on,
            vocab_on=vocab_state is not None, count_keys=run.count_keys,
            cut_at=run.cut_at, data_path=args.data)
        pack_iter = pcache.open_pack_cache(ppath, psig)
        if pack_iter is not None:
            log.info("using pack cache %s", ppath)
        else:
            try:
                pack_writer = pcache.PackCacheWriter(ppath, psig)
            except OSError as e:
                log.warning("pack cache disabled (%s)", e)

    q: queue.Queue = queue.Queue(maxsize=3)
    q2: queue.Queue = queue.Queue(maxsize=3)
    xfer_stats = {"starve_s": 0.0, "xfer_s": 0.0, "put_s": 0.0, "bytes": 0}
    producer = SuperbatchProducer(
        args, mi, vw, batch_size=batch_size, K=K, can_pack=can_pack,
        count_keys=run.count_keys, cut_at=run.cut_at,
        holdout_after=run.holdout_after, out_queue=q, ctr=ctr,
        xfer_stats=xfer_stats, vocab_state=vocab_state, pack_iter=pack_iter,
        pack_writer=pack_writer, bitpack_on=bitpack_on)
    prod_t = threading.Thread(target=producer.run, daemon=True)
    xfer_t = threading.Thread(target=run_transferrer,
                              args=(q, q2, ctr, xfer_stats, model.lr_w.device),
                              daemon=True)
    prod_t.start()
    xfer_t.start()

    # --fwt_fetch_stack M > 1: each packed step writes its [K, B]
    # predictions into row `slot` of a device ring of M superbatches, and
    # the ring is fetched once per M (a tail flushes it early)
    M = int(args.fwt_fetch_stack or 0)
    use_ring = M > 1 and run.writer.active
    ring = None
    ring_metas: list = []

    def flush_ring():
        if ring_metas:
            run.fetch(ring[:len(ring_metas)], list(ring_metas))
            ring_metas.clear()

    vocab = None  # the [n_rows, 128] i32 dictionary snapshot on the device
    run.opening.close()
    while True:
        with span("fwt.consumer.wait_input", ctr, "consumer_starve_s"):
            item = q2.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        if item[0] == "v":
            vocab = arrived(item[1], item[2])
        elif item[0] == "p":
            _, buf, lay, gn, ev = item
            buf = arrived(buf, ev)
            first_num = run.count(gn)
            kk = int(buf.shape[0])  # K' — short tails pack too
            vargs = (vocab,) if lay.vocabs else ()
            to_ring = use_ring and kk == K
            if not to_ring:
                flush_ring()  # a tail: keep the prediction stream in order
            with span("fwt.dispatch.packed", ctr, "dispatch_s"):
                if to_ring:
                    if ring is None:
                        ring = torch.zeros((M, K, batch_size), device=buf.device)
                    packed_mod.make_packed_train_step_ring(model, lay, K, M)(
                        buf, ring, len(ring_metas), *vargs)
                else:
                    preds = packed_mod.make_packed_train_step(model, lay, kk)(
                        buf, *vargs)
            run.count_ffm_update(kk * batch_size, packed_mod.ffm_width(lay))
            run.profile_step()
            if to_ring:
                ring_metas.append((first_num, gn))
                if len(ring_metas) == M:
                    flush_ring()
            elif run.writer.active:
                run.fetch(preds, [(first_num, gn)])
        else:
            _, bd, n, ev = item
            flush_ring()  # keep the prediction stream in order
            run.process({k: arrived(v, ev) for k, v in bd.items()}, n)
    run.closing.open()
    flush_ring()
    ctr.update(packed_mod.graph_counts(model))
    # the producer writes ctr['producer_busy_s'] in its finally block: join
    # both stage threads before the counters are read
    prod_t.join(timeout=10.0)
    xfer_t.join(timeout=10.0)
    if prod_t.is_alive() or xfer_t.is_alive():
        ctr["counters_partial"] = True
        log.warning("pipeline stage thread still alive after join timeout "
                    "(producer=%s transfer=%s); in-run counters are partial",
                    prod_t.is_alive(), xfer_t.is_alive())
    if vocab_state is not None:
        vocab_state.close()


def convert(args) -> int:
    """``--convert_inference_regressor OUT -i IN``: the inference form of a
    model file — its weights without optimizer state, the configuration
    turned to SGD, and with ``--weight_quantization`` the FFM weights as
    f16 buckets, marked to be dequantized on load
    (fwumious_wabbit_tpu/train/loop.py:785-800). The weights pass through
    the device untouched, so the card and the CPU write the same bytes."""
    from ..persistence import model_file

    if not args.initial_regressor:
        log.error("Convert mode requires --initial_regressor")
        return 1
    try:
        device = resolve_device(args.fwt_platform)
    except (NoDeviceError, ValueError) as e:
        log.error("%s", e)
        return 1
    mi, vw, model = model_file.load_model(args.initial_regressor,
                                          immutable=True, args=args,
                                          device=device)
    if args.weight_quantization:
        mi.dequantize_weights = True
    model_file.save_model(args.convert_inference_regressor, mi, vw, model,
                          quantize_weights=bool(args.weight_quantization))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.quiet:
        logging.getLogger().setLevel(logging.WARNING)

    if args.final_regressor and not args.save_resume:
        log.error("You need to use --save_resume with --final_regressor,"
                  " for vowpal wabbit compatibility")
        return 1
    engine = args.fwt_serve_engine or "auto"

    if args.daemon:
        if not args.initial_regressor:
            log.error("Daemon mode only supports serving from --initial_regressor")
            return 1
        if not args.foreground:
            _daemonize()
    elif engine == "native" and native_predict_eligible(args):
        # -t -i on the embedded C++ engine, asked for explicitly; -f, -c,
        # a delay or --fwt_no_native take the device path, as in JAX
        from .predict import run_native_predict

        try:
            run_native_predict(args)
        except (FlushCommand, HogwildLoadCommand, RuntimeError) as e:
            log.error("Global error: %s", e)
            return 1
        return 0

    from ..parallel import distributed, launch
    from ..persistence import model_file
    from ..serve.server import Serving

    if args.convert_inference_regressor and not args.daemon:
        return convert(args)
    if args.daemon and engine == "native":
        mi, vw = model_file.read_header(args.initial_regressor)
        Serving(args, mi, vw, None, model_path=args.initial_regressor).serve()
        return 0
    if args.build_cache_without_training:
        # parse only: no model and no device
        if args.initial_regressor:
            _mi, vw = model_file.read_header(args.initial_regressor)
        elif not args.data:
            log.error("--data expected")
            return 1
        else:
            vw = VwNamespaceMap.from_dataset_dir(args.data)
        build_cache_without_training(args, vw)
        return 0

    if args.daemon:
        try:
            device = resolve_device(args.fwt_platform)
        except (NoDeviceError, ValueError) as e:
            log.error("%s", e)
            return 1
        mi, vw, model = model_file.load_model(
            args.initial_regressor, immutable=True, args=args, device=device)
        srv = Serving(args, mi, vw, model, model_path=args.initial_regressor)
        del model  # a hot swap must be able to free the first model
        srv.serve()
        if srv.predictor is not None:
            srv.predictor.note_resident()
            result = {"hogwild_loads": srv.predictor.swaps,
                      "resident_bytes_after_swap": srv.predictor.resident_bytes,
                      "predict_graphs": srv.predictor.graph_counts()}
            _add_run_facts(result, srv.predictor.model, None)
            _write_counters(result)
        return 0
    if launch.requested(args):
        return launch.main(args, list(sys.argv[1:] if argv is None else argv))
    writes = launch.writes_files(args.fwt_host_id)
    if not writes:
        # a launched rank other than 0: rank 0 writes the -p stream and the
        # record cache; this one parses the text
        args.predictions, args.predictions_stdout, args.cache = None, False, False
    rc = 1
    try:
        try:
            device, mesh = _join(args)
        except (NoDeviceError, ValueError) as e:
            log.error("%s", e)
            return 1
        rc = _train(args, device, mesh, writes)
        return rc
    finally:
        distributed.shutdown(wait=rc == 0)


def _add_run_facts(result: dict, model, mesh) -> None:
    """The kernels' launches in this process, the card's peak memory
    (allocated and reserved) and,
    under a mesh, the group's set-up seconds and the sharded steps'
    collective bytes on this rank: what FWT_COUNTERS_OUT adds to the
    counters."""
    from ..ops import ffm, sparse_update

    result["launches"] = {"ffm_triangle": ffm.LAUNCHES,
                          "ffm_triangle_bwd": ffm.BWD_LAUNCHES,
                          "sparse_adagrad_update": sparse_update.LAUNCHES}
    device = model.lr_w.device
    if device.type == "cuda":
        result["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
        # a CUDA graph's private pool is reserved, not allocated, between
        # its replays
        result["peak_device_reserved_bytes"] = torch.cuda.max_memory_reserved(device)
    if mesh is not None:
        from ..parallel import sharded

        result["mesh"] = {"shape": [mesh.shape["data"], mesh.shape["table"]],
                          "rank": mesh.rank, "setup_s": mesh.setup_s,
                          "collective_bytes": sharded.COLLECTIVE_BYTES}


def _train(args, device, mesh, writes: bool = True) -> int:
    """Training or ``-t`` on ``device``: the model from ``-i`` or fresh,
    this rank's row blocks of it under a mesh, the loop, ``-f`` (written
    when ``writes``; a rank that does not write still takes part in the
    gather of rank 0's table group)."""
    from ..models.model import FwModel
    from ..persistence import model_file

    if args.initial_regressor:
        mi, vw, model = model_file.load_model(
            args.initial_regressor, immutable=args.testonly, args=args,
            device=device)
    else:
        if not args.data:
            log.error("--data expected")
            return 1
        vw = VwNamespaceMap.from_dataset_dir(args.data)
        mi = ModelInstance.from_cmdline(args, vw)
        model = FwModel(mi, batch_mean_mode=args.fwt_batch_mean or "auto",
                        batch_cap=float(args.fwt_batch_cap or 8.0))
        model.load_params(model.init_params(device))
    if mesh is not None:
        from ..parallel import mesh as pmesh

        pmesh.shard_model(model, mesh)
    if not args.fwt_no_native:
        from .. import native

        try:
            native.require()
        except RuntimeError as e:
            log.error("%s (--fwt_no_native trains through the Python ingest)", e)
            return 1
    try:
        result = run_train_loop(args, mi, vw, model)
    except (FlushCommand, HogwildLoadCommand) as e:
        # reference: in-band commands in an input FILE abort the run
        # (src/main.rs:44-47,218-221)
        log.error("Global error: %s", e)
        return 1
    except GraphError as e:
        log.error("%s", e)
        return 1
    result["files_written"] = [args.predictions] if args.predictions else []
    if args.final_regressor and writes:
        model_file.save_model(args.final_regressor, mi, vw, model,
                              quantize_weights=bool(args.weight_quantization))
        result["files_written"].append(args.final_regressor)
    elif args.final_regressor and mesh is not None and mesh.data_index == 0:
        from ..parallel import mesh as pmesh

        pmesh.gather_tables(model.params(), mesh, pmesh.table_rows(model))
    _add_run_facts(result, model, mesh)
    _write_counters(result)
    return 0


def _write_counters(result: dict) -> None:
    cpath = os.environ.get("FWT_COUNTERS_OUT")
    if cpath:
        try:
            with open(cpath, "w") as f:
                json.dump(result, f)
        except OSError as e:
            log.warning("FWT_COUNTERS_OUT write failed: %s", e)
