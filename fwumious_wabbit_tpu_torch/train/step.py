"""The predict and train steps — the counterparts of ``make_predict_step``
and ``make_train_step`` in fwumious_wabbit_tpu/train/step.py.

As there, the sparse half (LR sums and the FFM triangle) takes its
cotangents from autodiff (``torch.autograd.grad`` to the gathered leaves,
where JAX takes ``jax.vjp``), and the dense tower is backpropagated by hand,
so that the AdaGrad accumulator's per-weight ``Σ_examples g²`` is
``(x²)ᵀ(δ²)`` without per-example weight gradients. Every gradient of a
step is complete before any weight is written: the tower's backward reads
the old dense weights, as JAX's functional update does."""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..models.model import FwModel, normalize_train, predict_prob
from ..ops import ffm, sparse_update, tables
from ..utils.spans import span

# the Batch arrays the forward pass reads
INPUT_KEYS = ("lr_ids", "lr_vals", "lr_combos", "ffm_ids", "ffm_vals",
               "ffm_fields")
# and what the train step reads besides: labels, importances and the
# host's batch-mean multiplicity counts
TRAIN_KEYS = INPUT_KEYS + ("label", "importance", "lr_counts", "ffm_counts")


def batch_dict(batch) -> dict:
    """The input arrays of a ``Batcher`` batch, keyed as the model reads
    them (fwumious_wabbit_tpu/train/loop.py ``_batch_dict``)."""
    return {k: getattr(batch, k) for k in INPUT_KEYS}


def train_batch_dict(batch) -> dict:
    """:func:`batch_dict` plus the labels and importances."""
    return {**batch_dict(batch), "label": batch.label,
            "importance": batch.importance}


def to_device(batch: dict, keys, device) -> dict:
    """The arrays of ``batch`` under ``keys`` as tensors on ``device``: host
    arrays are copied, tensors already there pass through uncopied."""
    out = {}
    for k in keys:
        v = batch.get(k)
        if v is None:
            continue
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device)
    return out


def predict_step_fn(model: FwModel):
    """``step(batch) -> probabilities [B]``, run from Python: the host
    arrays of ``batch`` copied host→device (device tensors pass through),
    the forward under ``torch.inference_mode``."""
    device = model.lr_w.device

    def predict_step(batch: dict) -> torch.Tensor:
        bd = to_device(batch, INPUT_KEYS, device)
        with torch.inference_mode():
            return model.predict(bd)

    return predict_step


def make_predict_step(model: FwModel, graph: bool = True, capturer=None):
    """``step(batch) -> probabilities [B]`` (a tensor on the model's
    device) — the JAX package's jitted predict step
    (fwumious_wabbit_tpu/train/step.py:340-350). ``batch`` is the host dict
    of a ``Batcher`` batch (fwumious_wabbit_tpu/train/loop.py
    ``_batch_dict``) or a dict of device tensors.

    On the card the step is one CUDA graph per batch signature
    (:class:`BatchStep`, captured under ``torch.inference_mode``), kept
    apart from the train step's; its result is the graph's output,
    overwritten by the next replay. On the CPU, and with ``graph=False``,
    it runs from Python. ``capturer`` stands in for
    :class:`CudaGraphCapturer` (tests)."""
    return BatchStep(model, "the predict step", predict_step_fn(model),
                     INPUT_KEYS, graph, capturer)


# -- the train step's stages (one after the other in make_train_step; apart
# for a layer-by-layer timing) ---------------------------------------------------


def gather(model: FwModel, bd: dict) -> list:
    """The leaves the backward is taken with respect to (``jax.vjp`` with
    respect to ``lr_wg, emb``): the gathered LR weights ``lr_wg [B, L]``,
    detached, and for FFM a stride-0 leaf of the slabs' shape ``[B, N,
    F·k]`` (ops/ffm.slab_leaf) — the fused FFM kernels read the slabs from
    the table themselves, and the leaf's gradient is ``d emb``. A table
    itself never requires grad, which would make autograd allocate a dense
    gradient of it."""
    leaves = [model.gather_lr(bd).detach().requires_grad_(True)]
    if model.has_ffm:
        leaves.append(ffm.slab_leaf(bd["ffm_ids"], model.num_fields,
                                    model.ffm_k))
    return leaves


def forward(model: FwModel, bd: dict, leaves: list, ffm_rows=None):
    """``(x, p, dlogit, residuals)``: the vector the tower (or the terminal
    sum) takes, ``x [B, D]``, with its graph to the leaves; the
    probabilities; the reference's general_gradient — ``(p −
    label)·importance`` inside the ±50 clamp, 0 outside and for NaN
    (src/block_loss_functions.rs:122-141); and the tower's residuals for
    :func:`tower_backward` (None without a tower). The label may be u8 and
    the importance left out when all ones. ``ffm_rows``: the FFM slabs'
    table, ids and spec when they are not ``ffm_w`` (FwModel.ffm_outputs)."""
    with torch.enable_grad():
        parts = [model.lr_outputs(leaves[0], bd)]
        if model.has_ffm:
            parts.append(model.ffm_outputs(bd, leaves[1], ffm_rows))
        x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    if model.has_nn:
        lg, residuals = tower_forward(model, x.detach())
    else:
        lg, residuals = x.detach().sum(-1), None
    p = predict_prob(lg)
    gg = p - bd["label"].to(torch.float32)
    imp = bd.get("importance")
    if imp is not None:
        gg = gg * imp
    inside = (lg >= -50.0) & (lg <= 50.0) & ~torch.isnan(lg)
    return x, p, torch.where(inside, gg, torch.zeros_like(gg)), residuals


def backward(model: FwModel, x: torch.Tensor, leaves: list,
             dlogit: torch.Tensor, residuals) -> tuple:
    """``(sparse, dense)``: the cotangents of the leaves, ``(g_lr [B, L],
    g_emb [B, N, F·k]?)``, from the cotangent of ``x`` — ``dlogit`` on
    every column without a tower, the tower's own ``g_x`` with one — and
    the tower's ``(grads, gsqs)`` (None without a tower)."""
    if residuals is None:
        g_x, dense = dlogit[:, None].expand_as(x), None
    else:
        g_x, grads, gsqs = tower_backward(model, residuals, dlogit)
        dense = (grads, gsqs)
    return torch.autograd.grad(x, leaves, g_x), dense


# -- the dense tower (fwumious_wabbit_tpu/train/step.py:35-158) ---------------------


def tower_forward(model: FwModel, x: torch.Tensor):
    """The tower in train mode, keeping what the manual backward needs:
    ``(logit [B], (acts, final_in, sigma0))``. Train mode normalizes as
    ``(t − mean)/σ`` (topology four's input, and each layer norm before or
    after its activation); each layer keeps ``(input, σ_before?, relu
    mask?, σ_after?)``."""
    topo = model.topology
    sigma0 = None
    if topo == "two":
        t, joined = x, None
    elif topo == "four":
        t, sigma0 = normalize_train(x)
        joined = x
    else:  # one; five (its stop-gradient is in tower_backward)
        t, joined = x, x
    acts = []
    for spec, layer in zip(model.nn_layers, model.layers):
        inp = t
        t = torch.matmul(t, layer.w) + layer.b
        sig_b = mask = sig_a = None
        if spec.layernorm == "before":
            t, sig_b = normalize_train(t)
        if spec.activation == "relu":
            mask = t > 0.0
            t = torch.where(mask, t, torch.zeros_like(t))
        if spec.layernorm == "after":
            t, sig_a = normalize_train(t)
        acts.append((inp, sig_b, mask, sig_a))
    final_in = torch.cat([t, joined], dim=-1) if joined is not None else t
    final = model.final
    logit = (torch.matmul(final_in, final.w) + final.b)[:, 0]
    return logit, (acts, final_in, sigma0)


def _grads(inp: torch.Tensor, g: torch.Tensor) -> tuple:
    """``(Σg, Σg²)`` of a layer's ``w`` and ``b`` over the batch: ``inpᵀg``
    and ``(inp²)ᵀ(g²)``, ``Σ_b g`` and ``Σ_b g²``."""
    return ({"w": torch.matmul(inp.T, g), "b": g.sum(0)},
            {"w": torch.matmul((inp * inp).T, g * g), "b": (g * g).sum(0)})


def tower_backward(model: FwModel, residuals, dlogit: torch.Tensor) -> tuple:
    """The manual backward: ``(g_x [B, D], grads, gsqs)``, the last two
    shaped ``{"nn": [{"w", "b"}...], "final": {"w", "b"}}``. A normalize
    block passes g/σ (the reference's rule, not the true gradient); the
    order back through a layer is σ_after, the relu mask, σ_before. The
    readout's input splits at the last layer's width into the tower's part
    and the joined ``x``; topology four divides the tower's part by the
    input's σ0, and five passes only the joined part to ``x``. Reads the
    dense weights as they were in the forward: nothing is written here."""
    acts, final_in, sigma0 = residuals
    final_w = model.final.w
    g_final_in = dlogit[:, None] * final_w[:, 0][None, :]
    g, q = _grads(final_in, dlogit[:, None])
    grads, gsqs = {"nn": [], "final": g}, {"nn": [], "final": q}
    if model.topology != "two":
        width = model.nn_layers[-1].width
        g_t, g_joined = g_final_in[:, :width], g_final_in[:, width:]
    else:
        g_t, g_joined = g_final_in, None
    for layer, (inp, sig_b, mask, sig_a) in zip(reversed(model.layers),
                                                reversed(acts)):
        if sig_a is not None:
            g_t = g_t / sig_a
        if mask is not None:
            g_t = torch.where(mask, g_t, torch.zeros_like(g_t))
        if sig_b is not None:
            g_t = g_t / sig_b
        g, q = _grads(inp, g_t)
        grads["nn"].append(g)
        gsqs["nn"].append(q)
        g_t = torch.matmul(g_t, layer.w.T)
    grads["nn"].reverse()
    gsqs["nn"].reverse()
    topo = model.topology
    if topo == "one":
        g_x = g_t + g_joined
    elif topo == "two":
        g_x = g_t
    elif topo == "four":
        g_x = g_t / sigma0 + g_joined
    else:  # five: no gradient through the tower into x
        g_x = g_joined
    return g_x.contiguous(), grads, gsqs


def apply_maxnorm(w: torch.Tensor, maxnorm: float) -> torch.Tensor:
    """Per-neuron max-norm, in place: each column of ``w`` whose L2 norm
    (with 1e-6 under the root) exceeds ``maxnorm`` is scaled back to it
    (reference: src/block_neural.rs:307-320, once per step here)."""
    norms = torch.sqrt(1e-6 + (w * w).sum(0, keepdim=True))
    scale = torch.where(norms > maxnorm, maxnorm / norms, torch.ones_like(norms))
    return w.mul_(scale)


def tower_update(model: FwModel, grads: dict, gsqs: dict) -> None:
    """The dense update, in place (fwumious_wabbit_tpu/train/step.py:206-240):
    each layer's and the readout's ``w`` and ``b`` through
    ``opt_nn.apply_dense``, then a layer's max-norm on its ``w``."""
    opt = model.opt_nn
    pairs = list(zip(model.layers, grads["nn"], gsqs["nn"], model.nn_layers))
    pairs.append((model.final, grads["final"], gsqs["final"], None))
    for layer, g, q, spec in pairs:
        for key in ("w", "b"):
            opt.apply_dense(getattr(layer, key), getattr(layer, key + "_acc", None),
                            g[key], q[key])
        if spec is not None and spec.maxnorm > 0.0:
            apply_maxnorm(layer.w, spec.maxnorm)


def lr_update_rows(model: FwModel, bd: dict, g_lr: torch.Tensor):
    """``(rid, grows, pre_scaled)`` of the LR table: the host counts' cap
    factor scales the scalars before dedup (every occurrence of an id
    carries the same factor), then per-example dedup keyed by the id and
    the lane expansion (fwumious_wabbit_tpu/train/step.py:250-290)."""
    opt = model.opt_lr
    lr_ids = model.lr_ids_combos(bd)[0]
    counts = bd.get("lr_counts")
    pre_scaled = opt.batch_mean and counts is not None
    if pre_scaled:
        g_lr = g_lr * opt.count_factor(counts)
    if opt.has_state and (not opt.batch_mean or pre_scaled):
        rid, grows = tables.expand_scalar_grads_dedup(lr_ids, g_lr)
    else:
        rid, grows = tables.expand_scalar_grads(lr_ids, g_lr)
        if opt.has_state:
            rid, grows = tables.dedup_rows(rid, grows, g_lr.shape[0], keys=lr_ids)
    return rid, grows, pre_scaled


def ffm_update_rows(model: FwModel, bd: dict, g_emb: torch.Tensor):
    """``(rid, grows, pre_scaled)`` of the FFM table, as for LR, keyed by
    the window id (single-row slabs) or the row (multi-row slabs)
    (fwumious_wabbit_tpu/train/step.py:292-329)."""
    opt, spec = model.opt_ffm, model.ffm_spec
    ffm_ids = bd["ffm_ids"]
    counts = bd.get("ffm_counts")
    pre_scaled = opt.batch_mean and counts is not None
    if pre_scaled:
        g_emb = g_emb * opt.count_factor(counts)[..., None]
    if (opt.has_state and (not opt.batch_mean or pre_scaled)
            and spec.rows_per_slab == 1):
        rid, grows = tables.expand_grads_dedup(ffm_ids, g_emb, spec)
    else:
        rid, grows = tables.expand_grads(ffm_ids, g_emb, spec)
        if opt.has_state:
            keys = (ffm_ids.long() >> (spec.align - 1).bit_length()
                    if spec.rows_per_slab == 1 else None)
            rid, grows = tables.dedup_rows(rid, grows, g_emb.shape[0], keys=keys)
    return rid, grows, pre_scaled


def ffm_update_bytes(model: FwModel, examples: int, width: int) -> int:
    """The bytes of the ``[K, 128]`` f32 rows that :func:`ffm_update_rows`
    hands the sparse update for ``examples`` examples of ``width`` FFM
    entries each: one row an entry where a slab fits a row, its
    ``rows_per_slab`` rows where it spans rows (``tables.expand_grads``);
    0 without FFM."""
    if not model.has_ffm:
        return 0
    return examples * width * model.ffm_spec.rows_per_slab * tables.LANE * 4


def train_step_fn(model: FwModel):
    """``step(batch) -> probabilities [B]``: the forward values before the
    update, as a tensor on the model's device, run from Python. The step
    updates the model's weights in place: gather, forward, the clamped
    logloss gradient, the tower's manual backward, the backward to the
    gathered weights, the tower's dense update, per-example dedup, the
    batch-mean cap and the sparse row update
    (fwumious_wabbit_tpu/train/step.py:161-337).

    ``batch`` is a host dict as :func:`train_batch_dict` gives, optionally
    with ``lr_counts``/``ffm_counts`` (the host's multiplicity codes), or
    the slim form of the C++ ingest (train/producer.py), whose tensors may
    already be on the device (train/packed.py)."""
    device = model.lr_w.device

    def train_step(batch: dict) -> torch.Tensor:
        bd = to_device(batch, TRAIN_KEYS, device)
        leaves = gather(model, bd)
        x, p, dlogit, residuals = forward(model, bd, leaves)
        grads, dense = backward(model, x, leaves, dlogit, residuals)
        if dense is not None:
            tower_update(model, *dense)
        rid, grows, pre = lr_update_rows(model, bd, grads[0])
        model.opt_lr.apply_rows(model.lr_w, getattr(model, "lr_acc", None),
                                rid, grows, pre_scaled=pre)
        if model.has_ffm:
            rid, grows, pre = ffm_update_rows(model, bd, grads[1])
            model.opt_ffm.apply_rows(model.ffm_w, getattr(model, "ffm_acc", None),
                                     rid, grows, pre_scaled=pre)
        return p

    return train_step


def make_train_step(model: FwModel, graph: bool = True, capturer=None):
    """``step(batch) -> probabilities [B]``: :func:`train_step_fn`, the
    JAX package's jitted train step (fwumious_wabbit_tpu/train/step.py:
    333-337). On the card it is one CUDA graph per batch signature
    (:class:`BatchStep`): the tables are updated in place at their
    capture-time addresses, the port's form of ``donate_argnums=(0,)``, and
    the result is the graph's output, overwritten by the next replay, so a
    caller copies it out on the same stream first. On the CPU, and with
    ``graph=False``, the step runs from Python. ``capturer`` stands in for
    :class:`CudaGraphCapturer` (tests)."""
    return BatchStep(model, "the train step", train_step_fn(model),
                     TRAIN_KEYS, graph, capturer)


# -- one CUDA graph per step and signature: the JAX package's jit --------------


class GraphError(RuntimeError):
    """A step's CUDA graph failed to capture or to replay, or the tables it
    updates were rebound since its capture. The run ends: the step is never
    run again step by step."""


def _launch_counts() -> tuple:
    """The launches a capture on the calling thread counts as its own so
    far (its wrappers', the backward's on autograd's thread included),
    whatever the daemon's other threads launch meanwhile."""
    return (*ffm.own_launches(), sparse_update.own_launches())


def _add_launches(n: tuple) -> None:
    """Add ``(forward, backward, update)`` launches to the kernels'
    counters."""
    ffm.add_launches(n[0], n[1])
    sparse_update.add_launches(n[2])


def _table_ptrs(model) -> tuple:
    """The addresses of every tensor the train step updates in place: the
    tables, their accumulators and the tower's tensors."""
    params = model.params()
    tensors = [v for k, v in params.items() if k not in ("nn", "final")]
    for layer in [*params.get("nn", ()), params.get("final", {})]:
        tensors += layer.values()
    return tuple(t.data_ptr() for t in tensors)


class CudaGraphCapturer:
    """Captures the launches of a function as one CUDA graph."""

    # one capture, or one return of released pools to the card, at a time
    # in the process: the daemon's threads capture and release graphs of
    # their own models, and ``empty_cache`` frees memory (cudaFree) that
    # must not meet another thread's capture
    lock = threading.Lock()

    def capture(self, fn) -> tuple:
        """``(replay, out, pool_bytes)``: ``fn()`` captured on a side
        stream, and not run; ``replay()`` launches the whole graph on the
        current stream, ``out`` is what ``fn`` returned, written by every
        replay, and ``pool_bytes`` what the graph's memory pool holds: the
        growth of the card's reserved memory across the capture (with
        what another thread's allocations added meanwhile, if any).

        The capture is ``thread_local``: while the consumer captures, the
        transfer thread allocates device memory and waits on events, and
        the writer thread waits on events. Under the default ``global``
        mode such a call from any thread is a capture error; here only the
        capturing thread's own are."""
        graph = torch.cuda.CUDAGraph()
        with self.lock:
            # taken inside the capture: entering it empties the cache
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                before = torch.cuda.memory_reserved()
                out = fn()
            pool_bytes = max(torch.cuda.memory_reserved() - before, 0)
        return graph.replay, out, pool_bytes


def _free_pools(model) -> None:
    """Return released graphs' pools to the card (``empty_cache``), so that
    the allocator's reserved memory stays bounded; that waits for the
    card."""
    if model.lr_w.is_cuda:
        with CudaGraphCapturer.lock:
            torch.cuda.empty_cache()


class _GraphedStep:
    """One signature's step, as a jitted function is traced on its first
    call and replayed after: its first call runs step by step (it builds
    the kernels, the LUT table and the geometry caches, none of which a
    capture may do), its second is captured as one graph and replayed, and
    every later one is replayed. While the graphs of one owner (``live``,
    the least recently replayed first) fill its limit (:meth:`full`),
    capturing another first releases the least recently replayed one,
    graph, pool and buffers.

    The graph owns its inputs — one device tensor per key of the first
    call's ``inputs`` — and its output: each call copies its inputs in on
    the current stream (from the host or from the device) and replays the
    graph there. The output is overwritten by the next replay, so a caller
    copies it out on the same stream first. The graph reads and writes the
    model's tables at their capture-time addresses: a replay checks them
    and raises if one was rebound. The kernels' launch counters add what
    the graph launches at each replay, and nothing for the capture, which
    launches nothing. ``counts`` takes ``graph_captures``,
    ``graph_replays``, ``eager_key`` (the calls run step by step) and the
    host seconds of each, ``capture_s``, ``replay_s`` and ``eager_s``, each
    also a span (``fwt.graph.capture``, ``.replay``, ``.eager``);
    ``releases``, the owner's, takes ``graph_releases`` and
    ``graph_release_s`` (``fwt.graph.release``)."""

    def __init__(self, model, what: str, name: str, eager, capturer,
                 live: list, releases: dict, counts: dict, eager_key: str):
        self.model, self.eager, self.capturer = model, eager, capturer
        self.what, self.name = what, name
        self.live, self.releases = live, releases
        self.counts, self.eager_key = counts, eager_key
        self.seen = False
        self.graph_replay = self.inputs = self.out = None
        self.pool_bytes = 0  # what the graph's memory pool holds

    def full(self) -> bool:
        """Whether the owner's live graphs fill its limit: they are
        :data:`LIVE_STEP_GRAPHS` or more."""
        return len(self.live) >= LIVE_STEP_GRAPHS

    def __call__(self, inputs: dict):
        counts = self.counts
        if not self.seen:
            self.seen = True
            counts[self.eager_key] += 1
            with span("fwt.graph.eager", counts, "eager_s"):
                return self.eager(inputs)
        if self.graph_replay is None:
            while self.live and self.full():
                self.live.pop(0).release()
            with span("fwt.graph.capture", counts, "capture_s"):
                self._capture(inputs)
            counts["graph_captures"] += 1
        else:
            self.live.remove(self)
        self.live.append(self)
        with span("fwt.graph.replay", counts, "replay_s"):
            out = self._replay(inputs)
        counts["graph_replays"] += 1
        return out

    def drop(self) -> None:
        """Drop the graph and what it owns; should its signature come back,
        it is captured anew."""
        self.graph_replay = self.inputs = self.out = None
        self.pool_bytes = 0

    def release(self) -> None:
        """:meth:`drop`, and its pool returned to the card."""
        with span("fwt.graph.release", self.releases, "graph_release_s"):
            self.drop()
            _free_pools(self.model)
        self.releases["graph_releases"] += 1

    def _error(self, what: str, e) -> GraphError:
        return GraphError(f"{self.what}'s CUDA graph ({self.name}) {what}: {e}")

    def _replay(self, inputs: dict):
        if _table_ptrs(self.model) != self.ptrs:
            raise self._error("updates tables that were rebound after its "
                              "capture", "a replay would write freed memory")
        for key, value in inputs.items():
            self.inputs[key].copy_(value)
        try:
            self.graph_replay()
        except RuntimeError as e:
            raise self._error("failed to replay", e) from e
        _add_launches(self.launches)
        return self.out

    def _capture(self, inputs: dict) -> None:
        device = self.model.lr_w.device
        self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                       for k, v in inputs.items()}
        before = _launch_counts()
        try:
            self.graph_replay, self.out, self.pool_bytes = self.capturer.capture(
                lambda: self.eager(dict(self.inputs)))
        except RuntimeError as e:
            raise self._error("failed to capture", e) from e
        finally:
            # the wrappers counted the launches they captured; none ran
            captured = tuple(a - b for a, b in zip(_launch_counts(), before))
            _add_launches(tuple(-n for n in captured))
        self.launches = captured
        self.ptrs = _table_ptrs(self.model)


# the captured graphs of one per-batch step at once. A run meets a few
# batch signatures: the Python batcher's power-of-two width buckets, the
# C++ ingest's widths growing to their high-water mark, the slim batches'
# key sets, a padded partial batch; each graph holds its own pool, so the
# least recently replayed graph beyond these is released
LIVE_STEP_GRAPHS = 8


def signature(inputs: dict) -> tuple:
    """The batch signature a step is captured for: the sorted ``(key,
    shape, dtype)`` of the arrays it reads."""
    return tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))


def _as_tensor(v) -> torch.Tensor:
    return (v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(v)))


class BatchStep:
    """A per-batch step (``fn``, which reads the arrays under ``keys``):
    on the card one :class:`_GraphedStep` per batch signature, at most
    :data:`LIVE_STEP_GRAPHS` of them captured at once; on the CPU, and
    with ``graph=False``, ``fn`` run from Python. ``counts`` holds the
    step's ``graph_captures``, ``graph_replays``, ``eager_batches`` (the
    batches run step by step: each signature's first, and every one
    without graphs) and the host seconds of each (``capture_s``,
    ``replay_s``, ``eager_s``); ``releases`` its graphs released
    (``graph_releases``) and their host seconds (``graph_release_s``)."""

    def __init__(self, model, what: str, fn, keys: tuple, graph: bool,
                 capturer=None):
        self.model, self.what, self.fn, self.keys = model, what, fn, keys
        self.graphed = graph and (capturer is not None
                                  or model.lr_w.device.type == "cuda")
        self.capturer = capturer or CudaGraphCapturer()
        self.counts = {"graph_captures": 0, "graph_replays": 0,
                       "eager_batches": 0, "capture_s": 0.0, "replay_s": 0.0,
                       "eager_s": 0.0}
        self.releases = {"graph_releases": 0, "graph_release_s": 0.0}
        self.graphs: dict = {}  # signature → _GraphedStep
        self.live: list = []  # the captured ones, least recently replayed first

    def __call__(self, batch: dict) -> torch.Tensor:
        if not self.graphed:
            self.counts["eager_batches"] += 1
            with span("fwt.graph.eager", self.counts, "eager_s"):
                return self.fn(batch)
        inputs = {k: _as_tensor(batch[k]) for k in self.keys
                  if batch.get(k) is not None}
        sig = signature(inputs)
        step = self.graphs.get(sig)
        if step is None:
            name = "signature " + ", ".join(
                f"{k} {list(shape)} {str(dtype).replace('torch.', '')}"
                for k, shape, dtype in sig)
            step = self.graphs[sig] = _GraphedStep(
                self.model, self.what, name, self.fn, self.capturer, self.live,
                self.releases, self.counts, "eager_batches")
        return step(inputs)

    def release(self) -> None:
        """Release every captured graph and return their pools to the
        card: the step is done with (the daemon's retired model)."""
        if self.live:
            n = len(self.live)
            with span("fwt.graph.release", self.releases, "graph_release_s"):
                for step in self.live:
                    step.drop()
                self.live.clear()
                _free_pools(self.model)
            self.releases["graph_releases"] += n
