"""The predict and train steps — the counterparts of ``make_predict_step``
and ``make_train_step`` in fwumious_wabbit_tpu/train/step.py (the train step
without a dense tower, which is not ported yet)."""

from __future__ import annotations

import numpy as np
import torch

from ..models.model import FwModel, predict_prob
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


def forward(model: FwModel, bd: dict, leaves: list):
    """``(logit, p, dlogit)``: the logits (with their graph to the leaves),
    the probabilities, and the reference's general_gradient —
    ``(p − label)·importance`` inside the ±50 clamp, 0 outside and for NaN
    (src/block_loss_functions.rs:122-141). The label may be u8 and the
    importance left out when all ones."""
    with torch.enable_grad():
        parts = [model.lr_outputs(leaves[0], bd)]
        if model.has_ffm:
            parts.append(model.ffm_outputs(bd, leaves[1]))
        x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        logit = x.sum(-1)
    lg = logit.detach()
    p = predict_prob(lg)
    gg = p - bd["label"].to(torch.float32)
    imp = bd.get("importance")
    if imp is not None:
        gg = gg * imp
    inside = (lg >= -50.0) & (lg <= 50.0) & ~torch.isnan(lg)
    return logit, p, torch.where(inside, gg, torch.zeros_like(gg))


def backward(logit: torch.Tensor, leaves: list, dlogit: torch.Tensor) -> tuple:
    """The cotangents of the leaves: ``(g_lr [B, L], g_emb [B, N, F·k]?)``."""
    return torch.autograd.grad(logit, leaves, dlogit)


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
    tables in place: gather, forward, the clamped logloss gradient, the
    backward to the gathered weights, per-example dedup, the batch-mean cap
    and the sparse row update (fwumious_wabbit_tpu/train/step.py:161-337).

    ``batch`` is a host dict as :func:`train_batch_dict` gives, optionally
    with ``lr_counts``/``ffm_counts`` (the host's multiplicity codes), or
    the slim form of the C++ ingest (train/producer.py), whose tensors may
    already be on the device (train/packed.py)."""
    if model.has_nn:
        raise NotImplementedError("not yet ported: training a dense tower (--nn)")
    device = model.lr_w.device

    def train_step(batch: dict) -> torch.Tensor:
        bd = to_device(batch, TRAIN_KEYS, device)
        leaves = gather(model, bd)
        logit, p, dlogit = forward(model, bd, leaves)
        grads = backward(logit, leaves, dlogit)
        rid, grows, pre = lr_update_rows(model, bd, grads[0])
        model.opt_lr.apply_rows(model.lr_w, getattr(model, "lr_acc", None),
                                rid, grows, pre_scaled=pre)
        if model.has_ffm:
            rid, grows, pre = ffm_update_rows(model, bd, grads[1])
            model.opt_ffm.apply_rows(model.ffm_w, getattr(model, "ffm_acc", None),
                                     rid, grows, pre_scaled=pre)
        return p

    return train_step
