"""The train loop's host-side pipeline stages: the batch PRODUCER (C++
ingest → slim → superbatch pack, with the adaptive vocab-flip policy and
pack-cache recording) and the host→device TRANSFERRER.

The port's own copy of fwumious_wabbit_tpu/train/producer.py: the producer
emits the same queue stream, byte for byte (tests/test_torch_producer.py),
and :func:`run_transferrer` is written anew for CUDA (the JAX version's
``jax.device_put`` hid the transfer): a ring of pinned host buffers, one
non-blocking copy per item on a stream of its own, and an event the
consumer waits on (:class:`Transferrer`). The reference has no analogue —
its "producer" is the single-threaded parse+translate in the main loop
(reference: src/main.rs:213-270); these stages exist because the card
consumes padded batches over PCIe and the host work must overlap with it.

Threading contract: ``SuperbatchProducer.run`` is one thread's body
feeding a bounded queue; ``run_transferrer`` is another, moving items
host→device; the consumer (loop.py) drains the second queue. Counters are
written into a shared dict from each stage's OWN thread, and each stage
records ``time.thread_time()`` (CPU seconds of that thread alone) next to
its wall-clock counters, so a CPU-stolen window shows up as wall ≫ cpu.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ingest.reader import create_buffered_input
from ..utils.logging import get_logger
from ..utils.spans import span, spanned
from .packed import _DTYPES

log = get_logger(__name__)


def native_batch_stream(args, mi, vw, batch_size: int,
                        cut_at: int | None = None,
                        count_keys: dict | None = None,
                        fused_hook=None):
    """Yield (batch_dict, n_examples) using the C++ ingest engine
    (the port's native/): text or record-cache records (``-c``) are
    translated in parallel and scattered straight into padded arrays.
    Behaviourally identical to the Python path (cross-checked in tests);
    padded widths are exact with a high-water mark, so a stable schema
    keeps one shape.

    ``cut_at``: an absolute example number a block must not cross (the
    train/holdout boundary). Line blocks are cut conservatively by line
    count — in-band command lines only shrink a block, never push an
    example past the boundary."""
    from .. import native as fw_native
    from ..ingest import cache as fwcache

    ni = fw_native.NativeIngest(mi, vw)
    input_filename = args.data
    use_cache = bool(getattr(args, "cache", False))
    cpath = fwcache.cache_path_for(input_filename)
    # high-water exact batch widths: padded width only ever grows (one new
    # layout per growth, usually none — schemas have a fixed entry
    # count). Power-of-two bucketing cost 18% pure padding on the
    # 13-wide Eat-Rate schema, straight into the transfer and scatter
    # streams. Floor of 4 avoids degenerate sub-lane widths.
    hw = {"L": 4, "N": 4 if mi.ffm_k > 0 else 0}

    def widths():
        lmax, nmax = ni.widths()
        hw["L"] = max(hw["L"], lmax)
        if mi.ffm_k > 0:
            hw["N"] = max(hw["N"], nmax)
        return hw["L"], hw["N"]
    emitted = 0

    # pack combo+1 into the id bits above bit_precision when it fits —
    # drops the combos array from the transfer (padding packs as 0 → −1)
    pack_shift = (
        mi.bit_precision
        if mi.bit_precision + (mi.num_combos + 1).bit_length() <= 31
        else None
    )

    def slim(bd, n):
        """Shrink the batch payload: drop all-ones value arrays (padding is
        inert via combo/field −1 one-hots), pack combos into id bits, u8
        labels, and drop all-ones importance for full (padding-free)
        batches."""
        if count_keys is not None:
            # host-side multiplicity counts for the batch-mean cap: a
            # radix pass on the producer thread in place of a device-side
            # sort per step (ops/adagrad.count_factor). Computed on the
            # pre-pack masked ids with the padding marks still present.
            flags0 = ni.all_ones_flags()
            if "lr" in count_keys:
                bd["lr_counts"] = ni.batch_counts(
                    bd["lr_ids"], bd["lr_combos"], count_keys["lr"],
                    vals=None if flags0 & 1 else bd["lr_vals"])
            if "ffm" in count_keys and mi.ffm_k > 0:
                bd["ffm_counts"] = ni.batch_counts(
                    bd["ffm_ids"], bd["ffm_fields"], count_keys["ffm"],
                    vals=None if flags0 & 2 else bd["ffm_vals"])
        flags = ni.all_ones_flags()
        if flags & 1:
            del bd["lr_vals"]
        if flags & 2 and mi.ffm_k > 0:
            del bd["ffm_vals"]
        if pack_shift is not None:
            # in-place: one i32 temp for the widened combos, then
            # add/shift/or reuse it (fresh [B, W] temporaries cost the
            # producer's critical path)
            c32 = bd["lr_combos"].astype(np.int32)
            np.add(c32, 1, out=c32)
            np.left_shift(c32, pack_shift, out=c32)
            np.bitwise_or(bd["lr_ids"], c32, out=bd["lr_ids"])
            del bd["lr_combos"]
        bd["label"] = bd["label"].astype(np.uint8)
        if flags & 4 and n == batch_size:
            del bd["importance"]
        return bd

    def block_cap() -> int:
        if cut_at is None or emitted >= cut_at:
            return batch_size
        return min(batch_size, cut_at - emitted)

    def emit_range(s: int, cap: int, L: int, N: int):
        """One batch from the translated block: the fused single-sweep
        wire emit (packed.try_fused_emit via the producer's hook) when it
        applies, else the general fill+slim path. The hook returns a
        PreparedBatch (already in wire form) or None."""
        if fused_hook is not None and cap == batch_size:
            res = fused_hook(ni, s, cap, L, N, emitted)
            if res is not None:
                return res
        return slim(ni.fill_range(s, cap, batch_size, L, N), cap)

    carried = [False]  # examples parked in the engine's carry shard

    def drain(n: int, at_eof: bool):
        """Emit batches from the current translated block. Mid-stream,
        only FULL batches (and train/holdout boundary cuts, which are
        semantic) are emitted; the sub-batch remainder is carried into
        the next block (fwn_carry_tail) instead of going out as a padded
        partial — batch boundaries do not depend on the chunk size."""
        nonlocal emitted
        L, N = widths()
        s = 0
        while s < n:
            cap = min(block_cap(), n - s)
            if cap < batch_size and not at_eof \
                    and block_cap() == batch_size:
                break  # chunk tail, not a boundary cut: carry it
            yield emit_range(s, cap, L, N), cap
            emitted += cap
            s += cap
        if s < n:
            ni.carry_tail(s)
        carried[0] = s < n

    if use_cache and os.path.exists(cpath):
        try:
            reader = fwcache.RecordCacheReader(cpath, vw)
        except (fwcache.StaleCacheError, ValueError) as e:
            log.warning("cache rejected (%s); reparsing", e)
        else:
            log.info("using cache file %s (%s)", cpath,
                     fwcache.CODEC_NAMES.get(reader.codec, reader.codec))
            try:
                yield from _cached_blocks(ni, reader, drain, carried)
            finally:
                reader.close()
            return

    writer = fwcache.RecordCacheWriter(cpath, vw) if use_cache else None
    if writer is None:
        ni.set_build_records(False)
    stream = create_buffered_input(input_filename)
    # chunk size does not affect batching (sub-batch remainders carry
    # across blocks), so it is sized for RSS: the chunk buffer + its
    # line-aligned copy + the translated SoA scale with it
    CHUNK_BYTES = int(float(os.environ.get("FWT_CHUNK_MB", "16")) * (1 << 20))
    try:
        tail = b""
        at_eof = False
        while not at_eof:
            raw = stream.read(CHUNK_BYTES)
            if not raw:
                at_eof = True
                raw = tail
                tail = b""
            else:
                raw = tail + raw
                # carry the trailing partial line to the next chunk
                nl = raw.rfind(b"\n")
                if nl < 0:
                    tail, raw = raw, b""
                else:
                    tail, raw = raw[nl + 1 :], raw[: nl + 1]
            if not raw:
                continue
            n = ni.translate_block(raw)
            # empty line = end of stream, mirroring the reference's size-0
            # record (src/main.rs:215-222) — detected during the C parse
            # walk itself (anything after it, including in-band commands,
            # is never seen); the former per-chunk Python "\n\n"/"\n\r\n"
            # pre-scans cost ~9% of ingest CPU
            if ni.stop_offset() >= 0:
                at_eof = True
                tail = b""
            if not n:
                continue
            if writer is not None:
                writer.push_record(ni.records())
            yield from drain(n, at_eof)
        if carried[0]:
            # EOF arrived with no trailing bytes while examples were still
            # parked in the carry shard: surface them as a final block
            n = ni.translate_block(b"")
            if n:
                yield from drain(n, at_eof=True)
    except BaseException:
        if writer is not None:
            writer.abort()  # never publish a truncated cache
        raise
    else:
        if writer is not None:
            writer.write_finish()
    finally:
        stream.close()


def _cached_blocks(ni, reader, drain, carried):
    """The batches of a record cache: its decompressed bytes in chunks,
    each chunk's whole records translated (a record split across chunks
    carries over), a cache that ends inside a record rejected as
    truncated (fwumious_wabbit_tpu/train/producer.py:165-196)."""
    tail = b""
    while True:
        chunk = reader.read_chunk()
        if not chunk and not tail:
            break
        buf = tail + chunk
        words = len(buf) // 4
        if words == 0:
            if not chunk:
                raise ValueError("truncated cache file")
            tail = buf
            continue
        n = ni.translate_records(np.frombuffer(buf[: words * 4], np.uint32))
        consumed = ni.records_consumed()
        if not chunk and consumed < words:
            raise ValueError("truncated cache file")
        tail = buf[consumed * 4:]
        if n == 0:
            continue
        yield from drain(n, at_eof=not chunk)
    if carried[0]:
        # the reader hit EOF with examples still parked in the carry
        # shard: surface them as a final (empty-input) block
        n = ni.translate_records(np.empty(0, np.uint32))
        if n:
            yield from drain(n, at_eof=True)


class VocabFlipPolicy:
    """The adaptive vocab-encode disable decision (--fwt_vocab auto).

    The dictionary encode costs producer CPU to shrink the host→device
    payload. Which side wins depends on the run: producer-bound runs on
    fast links should drop the encode, transfer-bound runs must keep it. The transferrer publishes
    starvation + bandwidth (``xfer_stats``); the producer flips the encoder
    off ONE-WAY when (a) the transferrer mostly starves waiting on the
    producer AND (b) the predicted no-vocab floor min(producer, transfer)
    clears the current floor with hysteresis — over TWO CONSECUTIVE
    evaluation windows (a single noisy CPU-stolen window must not
    permanently degrade a long run). A flip re-signatures the layout.

    Pure decision logic — no threads, no queues — so it is unit-testable
    (tests/test_torch_producer.py) with synthetic window stats.
    """

    MIN_GROUPS = 3  # full groups per window: a 1M-row run at K=8, B=32k
    # only produces 3
    HYSTERESIS = 1.05
    STARVE_FRAC = 0.6
    CONSECUTIVE = 2  # windows that must independently vote "flip"

    def __init__(self, env_mode: str = "auto"):
        self.env_mode = env_mode  # FWT_VOCAB_FLIP: auto|force|off
        self.votes = 0  # consecutive windows that said "flip"

    def evaluate(self, probe, vstat: dict, xfer_stats: dict):
        """One window's verdict. Returns (verdict, detail):

        * ``("flip", why)`` — disable the encode now (the vote carried over
          :attr:`CONSECUTIVE` completed windows, or the env forced it);
        * ``("keep", None)`` — a complete window was evaluated and said no
          (or was the first of the two needed): the caller resets its
          window accounting and keeps encoding;
        * ``("incomplete", None)`` — not enough data to judge: the caller
          keeps accumulating the current window.

        ``probe`` is (dt_prep_per_example_s, bytes_per_example_off);
        ``vstat`` holds the window's producer accounting; ``xfer_stats``
        the transferrer's. Pure arithmetic over the inputs plus the
        consecutive-vote counter."""
        if self.env_mode == "force":
            return "flip", "forced"
        if probe is None or vstat["groups"] < self.MIN_GROUPS:
            return "incomplete", None
        dt_prep, s_off = probe
        t_work = vstat["t_work"] - vstat["t_put"]
        if t_work <= 0 or vstat["ex"] == 0:
            return "incomplete", None
        p_on = vstat["ex"] / t_work
        # dt_prep is PER EXAMPLE (the probe divides by batch_size)
        t_off = t_work - dt_prep * vstat["ex"]
        p_off = vstat["ex"] / max(t_off, 1e-9)
        st = xfer_stats
        busy = st["starve_s"] + st["xfer_s"] + st["put_s"]
        if busy <= 0 or st["xfer_s"] <= 0 or st["bytes"] == 0:
            return "incomplete", None
        starve_frac = st["starve_s"] / busy
        bw = st["bytes"] / st["xfer_s"]  # payload B/s over the link
        s_on = st["bytes"] / vstat["ex"]
        r_on = bw / s_on
        r_off = bw / max(s_off, 1.0)
        if os.environ.get("FWT_VOCAB_DEBUG"):
            log.info(
                "vocab-flip eval: starve %.2f, p_on %.0fk, "
                "p_off %.0fk, r_on %.0fk, r_off %.0fk, "
                "dt_prep %.3fus, s_on %.1f s_off %.1f (votes %d)",
                starve_frac, p_on / 1e3, p_off / 1e3,
                r_on / 1e3, r_off / 1e3, dt_prep * 1e6,
                s_on, s_off, self.votes)
        wants = (starve_frac > self.STARVE_FRAC
                 and min(p_off, r_off) > self.HYSTERESIS * min(p_on, r_on))
        if wants:
            self.votes += 1
            if self.votes >= self.CONSECUTIVE:
                return "flip", (
                    "producer-bound over %d windows: starve %.0f%%, producer "
                    "%.0fk→%.0fk ex/s, transfer %.0fk→%.0fk ex/s at %.1f MB/s"
                    % (self.votes, 100 * starve_frac, p_on / 1e3, p_off / 1e3,
                       r_on / 1e3, r_off / 1e3, bw / 1e6))
        else:
            self.votes = 0  # consecutive means consecutive
        return "keep", None


class SuperbatchProducer:
    """The producer-thread body: drives :func:`native_batch_stream`, slims
    and groups full batches into packed superbatches, manages the vocab
    dictionaries and the adaptive flip, records/replays the pack cache, and
    feeds the output queue. Each item read from the pack cache or the
    ingest is a span (``fwt.producer.item``), and each put one that feeds
    ``producer_stall_s`` (``fwt.producer.put``).

    Unit-testable without threads: construct with a plain queue-like object
    (anything with ``put``) and call :meth:`run` synchronously
    (tests/test_torch_producer.py drives it with a list-backed sink).
    """

    def __init__(self, args, mi, vw, *, batch_size: int, K: int,
                 can_pack: bool, count_keys: dict | None,
                 cut_at: int | None, holdout_after: int | None,
                 out_queue, ctr: dict, xfer_stats: dict,
                 vocab_state=None, pack_iter=None, pack_writer=None,
                 bitpack_on: bool = True):
        self.args, self.mi, self.vw = args, mi, vw
        self.batch_size, self.K = batch_size, K
        self.can_pack = can_pack
        self.count_keys = count_keys
        self.cut_at, self.holdout_after = cut_at, holdout_after
        self.q = out_queue
        self.ctr = ctr
        self.xfer_stats = xfer_stats
        self.vocab_state = vocab_state
        self.pack_iter = pack_iter
        self.pack_writer = pack_writer
        self.bitpack_on = bitpack_on
        _vflip_env = os.environ.get("FWT_VOCAB_FLIP", "auto")
        self.vocab_adaptive = (
            vocab_state is not None and _vflip_env != "off"
            and (getattr(args, "fwt_vocab", "auto") or "auto") == "auto")
        self.flip_policy = VocabFlipPolicy(_vflip_env)

    # -- thread body --------------------------------------------------------
    def run(self):
        from . import packed as packed_mod

        args, mi, vw = self.args, self.mi, self.vw
        batch_size, K = self.batch_size, self.K
        ctr, vocab_state = self.ctr, self.vocab_state
        q = self.q

        _pq = q
        if self.pack_writer is not None:
            from . import pack_cache as pcache

            _pq = pcache.RecordingQueue(q, self.pack_writer)

        class _TimedQ:  # count queue backpressure as producer stall
            def put(_self, item):
                with span("fwt.producer.put", ctr, "producer_stall_s"):
                    _pq.put(item)

        pq = _TimedQ()
        _span0 = time.perf_counter()
        _cpu0 = time.thread_time()
        cpu = ctr.setdefault("cpu_s_by_thread", {})
        try:
            if self.pack_iter is not None:
                for item in spanned("fwt.producer.item", self.pack_iter):
                    pq.put(item)
                pq.put(None)
                return
            group: list = []
            group_n = 0
            glay = None
            seen = 0
            # adaptive-vocab accounting (full superbatches only);
            # 'fused' counts try_fused_emit successes in the current window
            vstat = {"probe": None, "t_work": 0.0, "t_put": 0.0,
                     "ex": 0, "groups": 0, "fused": 0,
                     "t_mark": time.perf_counter()}
            # producer sub-stage CPU (thread CPU seconds, this thread only):
            # ingest = parse+translate+fill+counts (native_batch_stream),
            # prepare = transfer slimming/vocab/bitpack, pack = superbatch
            # assembly + queue handoff marshalling
            sub = {"ingest": 0.0, "prepare": 0.0, "pack": 0.0}

            def _maybe_flip_vocab():
                """One-way: disable the dictionary encode when the producer
                is the certified pipeline floor for two consecutive windows
                and the fatter plain payload would not become a worse one."""
                if not self.vocab_adaptive or vocab_state.disabled:
                    return
                if vstat["fused"] > 0:
                    # the fused emit engaged this window: with it, the
                    # vocab-encoded path IS the cheap producer mode (the
                    # probe's dt_prep measures the GENERAL path's encode
                    # overhead, which fused batches never pay) — flipping
                    # would lose both the fused sweep and the payload
                    # shrink. Reset the window and keep encoding.
                    vstat.update(t_work=0.0, t_put=0.0, ex=0, groups=0,
                                 fused=0)
                    self.xfer_stats.update(starve_s=0.0, xfer_s=0.0,
                                           put_s=0.0, bytes=0)
                    self.flip_policy.votes = 0
                    return
                verdict, detail = self.flip_policy.evaluate(
                    vstat["probe"], vstat, self.xfer_stats)
                if verdict == "incomplete":
                    return  # keep accumulating the current window
                if verdict == "flip":
                    vocab_state.disabled = True
                    log.info("adaptive vocab: encode disabled (%s)", detail)
                # a complete window was judged: reset so the next decision
                # (including the second of two consecutive votes) uses
                # fresh data
                vstat.update(t_work=0.0, t_put=0.0, ex=0, groups=0)
                self.xfer_stats.update(starve_s=0.0, xfer_s=0.0, put_s=0.0,
                                       bytes=0)

            def flush_group():
                nonlocal group, glay, group_n
                if not group:
                    return
                _c0 = time.thread_time()
                # short groups pack too: one copy for K' batches instead
                # of one per array and batch
                if glay.vocabs and vocab_state.venc is not None \
                        and vocab_state.venc.dirty:
                    snap = packed_mod.export_vocab(
                        vocab_state.venc, glay.vocabs[0])
                    # clear the growth flag ONLY if this snapshot fully
                    # covers the dictionaries: the batch that ENDED this
                    # group (already encoded, different signature,
                    # flushed next) may have grown a column past this
                    # layout's region — its own flush must re-export
                    # with its wider layout. (r4 bug: unconditional
                    # clear shipped that group against a stale
                    # snapshot → garbage id resolution.)
                    _key0, _w0, _b0, _n0 = glay.vocabs[0]
                    if all(b < 0
                           or vocab_state.venc.col_size(j) <= (1 << w)
                           for j, (w, b) in enumerate(zip(_w0, _b0))):
                        vocab_state.venc.clear_dirty()
                    pq.put(("v", snap))
                if len(group) in (1, K):
                    buf = packed_mod.pack(glay, group)
                    _tp = time.perf_counter()
                    pq.put(("p", buf, glay, group_n))
                else:
                    # split short tails into CANONICAL lengths (K, then
                    # descending powers of two), as the JAX producer does
                    # to bound its compiled scan programs: the stream
                    # stays byte-identical to it
                    sizes = [K] + [p for p in (8, 4, 2, 1) if p < K]
                    i = 0
                    _tp = time.perf_counter()
                    while i < len(group):
                        kk = next(s for s in sizes
                                  if s <= len(group) - i)
                        buf = packed_mod.pack(glay, group[i:i + kk])
                        pq.put(("p", buf, glay, kk * batch_size))
                        i += kk
                if len(group) == K:
                    # adaptive-vocab accounting: full groups only (the
                    # flip arithmetic normalizes per-group)
                    _now = time.perf_counter()
                    vstat["t_put"] += _now - _tp
                    vstat["t_work"] += _now - vstat["t_mark"]
                    vstat["t_mark"] = _now
                    vstat["ex"] += K * batch_size
                    vstat["groups"] += 1
                    if glay.vocabs:
                        _maybe_flip_vocab()
                else:
                    vstat["t_mark"] = time.perf_counter()
                group, glay, group_n = [], None, 0
                sub["pack"] += time.thread_time() - _c0

            # fused single-sweep emit (packed.try_fused_emit): the steady
            # state of a packed LR run goes SoA → wire arrays in one native
            # sweep, skipping fill_range, the numpy combo pack and the
            # whole prepare_for_transfer chain. The hook declines whenever
            # the general path's data-dependent checks might differ (FFM
            # columns, holdout region, pending flip probe, non-all-ones
            # values/importances); try_fused_emit itself bails to None on
            # anything layout-affecting. Hook time lands in the 'ingest'
            # sub-stage counter (it runs inside the stream generator).
            fused_enabled = (
                self.can_pack and self.bitpack_on
                and vocab_state is not None
                and os.environ.get("FWT_FUSED", "on") != "off"
                and (self.count_keys is None
                     or (set(self.count_keys) <= {"lr", "ffm"}
                         and self.count_keys.get("lr", 0) == 0)))

            def _fused_hook(ni, s, cap, L, N, emitted_before):
                if N and getattr(mi, "ffm_k", 0) <= 0:
                    return None
                if self.holdout_after is not None \
                        and emitted_before >= self.cut_at:
                    return None
                if vocab_state.disabled:
                    return None
                if (self.vocab_adaptive and vstat["probe"] is None
                        and vstat["groups"] >= 1):
                    # let one batch take the general path so the flip
                    # policy gets its cost/payload probe
                    return None
                flags = ni.all_ones_flags()
                # lr values + importances all-ones; ffm values too when
                # the schema has FFM columns
                need = 5 | (2 if N else 0)
                if flags & need != need:
                    return None
                ck = self.count_keys
                res = packed_mod.try_fused_emit(
                    ni, s, cap, L, mi, vocab_state,
                    with_counts=ck is not None and "lr" in ck,
                    ffm_pad_width=N,
                    ffm_count_shift=None if ck is None else ck.get("ffm"))
                if res is not None:
                    vstat["fused"] += 1  # vetoes the vocab flip: with the
                    # fused sweep, encoding IS the cheap producer mode
                return res

            stream = spanned("fwt.producer.item", native_batch_stream(
                args, mi, vw, batch_size, self.cut_at, self.count_keys,
                fused_hook=_fused_hook if fused_enabled else None))
            _c_mark = time.thread_time()
            for bd, n in stream:
                _c_now = time.thread_time()
                sub["ingest"] += _c_now - _c_mark
                lay = None
                slim = bd
                if isinstance(bd, packed_mod.PreparedBatch):
                    slim, lay = bd.slim, bd.lay
                # partial (padded) batches pack too, as their own solo
                # group: the arrays are already [batch_size, W] with
                # inert padding rows, so one packed buffer beats one
                # copy per array
                elif (self.can_pack
                      and (self.holdout_after is None
                           or seen < self.cut_at)):
                    # constant-feature column elision + id bit-packing
                    # + vocab indexing: pure transfer savings, undone
                    # device-side (packed.py unpack_row)
                    _t0 = time.perf_counter()
                    # partial (padded) batches stay OFF the vocab
                    # encoder: their constant column is not stripped
                    # (padding rows break the constancy test), so
                    # column j is a different logical column than in
                    # full batches — feeding them would pollute the
                    # persistent dictionaries with misaligned ids and
                    # padding garbage
                    slim, *spec = packed_mod.prepare_for_transfer(
                        bd, mi, bitpack=self.bitpack_on,
                        vocab_state=vocab_state if n == batch_size
                        else None)
                    _t_on = time.perf_counter() - _t0
                    lay = packed_mod.layout_of(slim, *spec)
                    if self.vocab_adaptive and vstat["probe"] is None \
                            and vstat["groups"] >= 1 \
                            and lay is not None and lay.vocabs:
                        # one-time probe: the plain (no-vocab) prepare's
                        # cost and payload, for the flip arithmetic
                        _t0 = time.perf_counter()
                        plain, *pspec = packed_mod.prepare_for_transfer(
                            bd, mi, bitpack=self.bitpack_on,
                            vocab_state=None)
                        _t_off = time.perf_counter() - _t0
                        _play = packed_mod.layout_of(plain, *pspec)
                        if _play is not None:
                            vstat["probe"] = (
                                max(_t_on - _t_off, 0.0) / batch_size,
                                _play.words * 4 / batch_size)
                sub["prepare"] += time.thread_time() - _c_now
                if lay is not None and n == batch_size and (
                        glay is None or lay.signature == glay.signature):
                    # only the slimmed dict is retained: keeping the
                    # original too would hold up to K full batch dicts
                    # alive per pending group
                    group.append(slim)
                    group_n += n
                    glay = lay
                    if len(group) == K:
                        flush_group()
                else:
                    flush_group()
                    if lay is not None:
                        group, glay, group_n = [slim], lay, n
                        if n != batch_size:
                            flush_group()  # solo: padded partial batch
                    else:
                        pq.put(("s", bd, n))
                seen += n
                _c_mark = time.thread_time()
            sub["ingest"] += time.thread_time() - _c_mark
            flush_group()
            pq.put(None)
            for k, v in sub.items():
                cpu["producer_" + k] = round(v, 3)
        except BaseException as e:  # noqa: BLE001 — re-raised downstream
            pq.put(e)
        finally:
            ctr["producer_busy_s"] = (time.perf_counter() - _span0
                                      - ctr["producer_stall_s"])
            cpu["producer"] = time.thread_time() - _cpu0


class Transferrer:
    """Host→device copies through a ring of pinned host buffers.

    :meth:`stage` copies a list of arrays into one pinned buffer of the
    ring (16-byte aligned offsets), issues ONE non-blocking copy of it to
    the card on the transferrer's own stream, records an event after it,
    and returns device views of the arrays with the event. The consumer
    calls :func:`arrived` before it uses them. A pinned buffer is reused
    only after its previous copy's event has completed: a non-blocking
    copy reads the host buffer later, so an early reuse would corrupt a
    batch without any error. Each buffer grows to the largest item it has
    carried. (A non-blocking copy from pageable memory would be silently
    synchronous: every staged byte goes through the pinned ring.)

    On the CPU (``--fwt_platform cpu``) the same stage makes plain copies
    and no event."""

    SLOTS = 4

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.slots = [[None, None] for _ in range(self.SLOTS)]  # pinned, event
        self.next = 0
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def stage(self, arrays: list) -> tuple[list, object]:
        """``(device tensors, event or None)`` for a list of host arrays;
        u32 arrays arrive as their int32 bit pattern (packed._DTYPES)."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        if not self.cuda:
            return [_view(torch.from_numpy(a.reshape(-1).view(np.uint8).copy()), a)
                    for a in arrays], None
        offs, total = [], 0
        for a in arrays:
            total = -(-total // 16) * 16
            offs.append(total)
            total += a.nbytes
        slot = self.slots[self.next]
        self.next = (self.next + 1) % self.SLOTS
        host, ev = slot
        if ev is not None:
            ev.synchronize()  # this buffer's previous copy has finished
        if host is None or host.numel() < total:
            host = slot[0] = torch.empty(max(total, 16), dtype=torch.uint8,
                                         pin_memory=True)
        hv = host.numpy()
        for a, o in zip(arrays, offs):
            hv[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        with torch.cuda.stream(self.stream):
            dev = host[:total].to(self.device, non_blocking=True)
            ev = slot[1] = torch.cuda.Event()
            ev.record(self.stream)
        return [_view(dev[o:o + a.nbytes], a) for a, o in zip(arrays, offs)], ev


def _view(raw: torch.Tensor, a: np.ndarray) -> torch.Tensor:
    """The bytes ``raw`` of array ``a`` as a tensor of its shape and dtype
    (packed._DTYPES)."""
    if a.size == 0:
        return torch.empty(a.shape, dtype=_DTYPES[a.dtype], device=raw.device)
    return raw.view(_DTYPES[a.dtype]).reshape(a.shape)


def arrived(tensor: torch.Tensor, ev) -> torch.Tensor:
    """Make the consumer's stream wait for a staged copy (its event) and
    tell the allocator that stream uses the copy's memory, which the
    transferrer's stream allocated. No-op on the CPU."""
    if ev is not None:
        cur = torch.cuda.current_stream(tensor.device)
        cur.wait_event(ev)
        tensor.record_stream(cur)
    return tensor


def run_transferrer(q, q2, ctr: dict, xfer_stats: dict, device):
    """The transfer-thread body: packed superbatches (``"p"``), vocabulary
    snapshots (``"v"``) and unpacked batch dicts (``"s"``) through a
    :class:`Transferrer` onto ``device``, each passed on with its event,
    with in-window wall and thread-CPU accounting. Busy time is the host
    side of a transfer: the copy into pinned memory and the issue of the
    non-blocking copy. The wait, the copy and the hand-on of a superbatch
    are spans (``fwt.xfer.wait``, ``.copy``, ``.put``) that feed their
    counters and ``xfer_stats``."""
    _cpu0 = time.thread_time()
    cpu = ctr.setdefault("cpu_s_by_thread", {})
    try:
        tr = Transferrer(device)
        while True:
            with span("fwt.xfer.wait", ctr, "xfer_starve_s") as t:
                item = q.get()
            xfer_stats["starve_s"] += t.seconds
            if item is None or isinstance(item, BaseException):
                q2.put(item)
                return
            if item[0] == "p":
                _, buf, lay, gn = item
                with span("fwt.xfer.copy", ctr, "xfer_busy_s") as t:
                    (dbuf,), ev = tr.stage([buf])
                xfer_stats["xfer_s"] += t.seconds
                xfer_stats["bytes"] += buf.nbytes
                ctr["xfer_bytes"] += buf.nbytes
                ctr["xfer_puts"] += 1
                with span("fwt.xfer.put", ctr, "xfer_stall_s") as t:
                    q2.put(("p", dbuf, lay, gn, ev))
                xfer_stats["put_s"] += t.seconds
            elif item[0] == "v":
                with span("fwt.xfer.copy", ctr, "xfer_busy_s"):
                    (dv,), ev = tr.stage([item[1]])
                ctr["xfer_bytes"] += item[1].nbytes
                ctr["xfer_puts"] += 1
                q2.put(("v", dv, ev))
            else:
                _, bd, n = item
                keys = sorted(bd)
                with span("fwt.xfer.copy", ctr, "xfer_busy_s"):
                    vals, ev = tr.stage([bd[k] for k in keys])
                ctr["xfer_bytes"] += sum(bd[k].nbytes for k in keys)
                ctr["xfer_puts"] += 1
                q2.put(("s", dict(zip(keys, vals)), n, ev))
    except BaseException as e:  # noqa: BLE001 — re-raised on consumer
        q2.put(e)
    finally:
        cpu["transfer"] = time.thread_time() - _cpu0
