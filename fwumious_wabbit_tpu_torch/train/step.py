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

import numpy as np
import torch

from ..models.model import FwModel, normalize_train, predict_prob
from ..ops import ffm, tables

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


def make_predict_step(model: FwModel):
    """``step(batch) -> probabilities [B]`` (a tensor on the model's
    device). ``batch`` is the host dict of a ``Batcher`` batch
    (fwumious_wabbit_tpu/train/loop.py ``_batch_dict``); its input arrays
    are copied host→device on each call."""
    device = model.lr_w.device

    def predict_step(batch: dict) -> torch.Tensor:
        bd = to_device(batch, INPUT_KEYS, device)
        with torch.inference_mode():
            return model.predict(bd)

    return predict_step


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


def make_train_step(model: FwModel):
    """``step(batch) -> probabilities [B]``: the forward values before the
    update, as a tensor on the model's device. The step updates the model's
    weights in place: gather, forward, the clamped logloss gradient, the
    tower's manual backward, the backward to the gathered weights, the
    tower's dense update, per-example dedup, the batch-mean cap and the
    sparse row update (fwumious_wabbit_tpu/train/step.py:161-337).

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
