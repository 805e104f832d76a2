"""FWRE model files — the counterpart of
fwumious_wabbit_tpu/persistence/model_file.py, byte for byte the same format
(reference: src/persistence.rs:17-97, src/regressor.rs:426-469):

    b"FWRE" | u32 version=6 LE
    u64 len | namespace-map JSON
    u64 len | ModelInstance JSON
    u64 total weight bytes
    LR block:  interleaved (weight, acc) f32 pairs when the optimizer keeps
               state, plain f32 weights for SGD
    FFM block: weights [n] f32 (or an 8-byte header + [n] f16 bucket ids
               when quantized), then acc [n] f32 when the optimizer keeps state
    NN layers: [(in+1)·out] f32 neuron-major weights then biases, then acc
               of the same length; the final readout neuron last.

The header half (``MAGIC``, ``VERSION``, ``_read_chunk``,
``_read_header_fh``, ``read_header``) and the NN layer reader
``_nn_layer_from_bytes`` are copies of the JAX package's
(fwumious_wabbit_tpu/persistence/model_file.py), and the f16 quantization
is the port's copy of its ``quantization.py``, so files stay byte-identical
in both directions. ``immutable=True`` loads the weights only and converts
the configuration to SGD — the inference layout.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path

import numpy as np
import torch

from ..config.model_instance import ModelInstance, Optimizer
from ..config.vwmap import VwNamespaceMap
from ..models.model import FwModel
from ..utils.device import resolve_device
from . import quantization

MAGIC = b"FWRE"
VERSION = 6


def _write_chunk(fh, data: bytes) -> None:
    fh.write(struct.pack("<Q", len(data)))
    fh.write(data)


def _read_chunk(fh) -> bytes:
    (n,) = struct.unpack("<Q", fh.read(8))
    return fh.read(n)


def _read_header_fh(fh):
    """Magic/version check + the two embedded config JSONs; leaves ``fh``
    positioned at the weights total."""
    magic = fh.read(4)
    if magic != MAGIC:
        raise ValueError("Model file does not begin with magic bytes FWRE")
    (version,) = struct.unpack("<I", fh.read(4))
    if version != VERSION:
        raise ValueError(
            f"Model file version of this binary: {VERSION}, version of the file: {version}"
        )
    vw = VwNamespaceMap.from_source_json(_read_chunk(fh).decode())
    mi = ModelInstance.from_json(_read_chunk(fh).decode())
    return mi, vw


def read_header(path: str | Path):
    """Read only the embedded (vwmap, model-instance) configs, no weights
    (the native-engine daemon needs the namespace map for parse-error
    replies without loading the device model)."""
    with open(path, "rb") as fh:
        return _read_header_fh(fh)


def _nn_layer_from_bytes(fh, fan_in: int, fan_out: int, with_state: bool,
                         load_state: bool) -> dict:
    n = (fan_in + 1) * fan_out
    flat = np.frombuffer(fh.read(4 * n), np.float32)
    w = flat[: fan_in * fan_out].reshape(fan_out, fan_in).T.copy()
    b = flat[fan_in * fan_out :].copy()
    layer = {"w": w, "b": b}
    if with_state:
        acc = np.frombuffer(fh.read(4 * n), np.float32)
        if load_state:
            layer["w_acc"] = acc[: fan_in * fan_out].reshape(fan_out, fan_in).T.copy()
            layer["b_acc"] = acc[fan_in * fan_out :].copy()
    return layer


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _nn_layer_bytes(layer: dict, with_state: bool) -> bytes:
    """Layer dict {'w': [in,out], 'b': [out], ...} → reference layout bytes."""
    out = np.concatenate([_host(layer["w"]).T.ravel(), _host(layer["b"])]).tobytes()
    if with_state:
        out += np.concatenate([_host(layer["w_acc"]).T.ravel(),
                               _host(layer["b_acc"])]).tobytes()
    return out


def _fetch_global(model: FwModel) -> dict:
    """``model``'s params with whole tables: under a mesh (parallel/mesh.py
    ``shard_model``) each table's row blocks are gathered to every rank and
    the mesh padding cut off (fwumious_wabbit_tpu/persistence/
    model_file.py:94-112), so every rank writes the same file. A collective
    then: every rank of the mesh saves."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return model.params()
    from ..parallel import mesh as pmesh

    return pmesh.gather_tables(model.params(), mesh, pmesh.table_rows(model))


def save_model(path: str | Path, mi: ModelInstance, vw: VwNamespaceMap,
               model: FwModel, quantize_weights: bool = False) -> None:
    """Write ``model``'s weights (and optimizer state, when the optimizer
    keeps it) to ``path``, atomically (under a mesh, gathered first:
    :func:`_fetch_global`): a sibling temp file is renamed into
    place, so a reader never sees a truncated model."""
    params = _fetch_global(model)
    has_state = model.has_state
    tmp = str(path) + ".writing"
    with open(tmp, "wb") as fh:
        fh.write(MAGIC)
        fh.write(struct.pack("<I", VERSION))
        _write_chunk(fh, vw.to_source_json().encode())
        _write_chunk(fh, mi.to_json().encode())

        lr_w = _host(params["lr_w"]).reshape(-1)[: model.lr_size]
        lr_acc = (_host(params["lr_acc"]).reshape(-1)[: model.lr_size]
                  if has_state else None)
        ffm_w = ffm_acc = ffm_q = None
        if model.has_ffm:
            ffm_w = _host(params["ffm_w"]).reshape(-1)[: model.ffm_size]
            if quantize_weights:
                ffm_q = quantization.quantize_ffm_weights(ffm_w)
            if has_state:
                ffm_acc = _host(params["ffm_acc"]).reshape(-1)[: model.ffm_size]
        nn_blocks: list[bytes] = []
        if model.has_nn:
            for layer in params["nn"]:
                nn_blocks.append(_nn_layer_bytes(layer, has_state))
            nn_blocks.append(_nn_layer_bytes(params["final"], has_state))

        total = int(lr_w.nbytes) * (2 if has_state else 1)
        if model.has_ffm:
            total += len(ffm_q) if ffm_q is not None else int(ffm_w.nbytes)
            if ffm_acc is not None:
                total += int(ffm_acc.nbytes)
        total += sum(len(b) for b in nn_blocks)
        fh.write(struct.pack("<Q", total))

        if has_state:
            pairs = np.empty(2 * lr_w.size, np.float32)
            pairs[0::2] = lr_w
            pairs[1::2] = lr_acc
            pairs.tofile(fh)
        else:
            np.ascontiguousarray(lr_w).tofile(fh)
        if model.has_ffm:
            if ffm_q is not None:
                fh.write(ffm_q)
            else:
                np.ascontiguousarray(ffm_w).tofile(fh)
            if ffm_acc is not None:
                np.ascontiguousarray(ffm_acc).tofile(fh)
        for b in nn_blocks:
            fh.write(b)
    os.replace(tmp, path)


def _read_rows(fh, n: int, spec, device, stride: int = 1, offset: int = 0):
    """Read ``n`` f32 (every ``stride``-th from ``offset`` when the values
    are interleaved) into a zero-padded ``[rows, 128]`` tensor."""
    raw = np.frombuffer(fh.read(4 * n * stride), np.float32)
    if raw.size != n * stride:
        raise ValueError("model file is truncated")
    flat = np.zeros(spec.padded_size, np.float32)
    flat[:n] = raw[offset::stride] if stride > 1 else raw
    return torch.from_numpy(flat).reshape(spec.num_rows, -1).to(device)


def load_model(path: str | Path, immutable: bool = False, args=None,
               device=None):
    """Returns ``(mi, vw, model)`` with the weights on ``device`` (``None`` =
    the CUDA card). ``immutable=True`` skips the optimizer state and
    converts the configuration to SGD (reference: src/persistence.rs:127-174).
    ``args`` may override the learning hyperparameters and sets the
    batch-mean cap (``--fwt_batch_mean``, ``--fwt_batch_cap``)."""
    device = resolve_device(device)
    with open(path, "rb") as fh:
        mi, vw = _read_header_fh(fh)
        if args is not None:
            mi.update_hyperparameters_from_cmd(args)
        fh.read(8)  # total weight bytes

        dequantize = bool(mi.dequantize_weights)
        saved = FwModel(mi)  # structure as saved (for the state layout)
        has_state = saved.has_state
        params: dict = {}

        n = saved.lr_size
        if has_state:
            pos = fh.tell()
            params["lr_w"] = _read_rows(fh, n, saved.lr_spec, device, 2, 0)
            if not immutable:
                fh.seek(pos)
                params["lr_acc"] = _read_rows(fh, n, saved.lr_spec, device, 2, 1)
        else:
            params["lr_w"] = _read_rows(fh, n, saved.lr_spec, device)

        if saved.has_ffm:
            n = saved.ffm_size
            if dequantize:
                w = quantization.dequantize_ffm_weights(
                    fh.read(quantization.quantized_size(n)), n)
                flat = np.zeros(saved.ffm_spec.padded_size, np.float32)
                flat[:n] = w
                params["ffm_w"] = torch.from_numpy(flat).reshape(
                    saved.ffm_spec.num_rows, -1).to(device)
            else:
                params["ffm_w"] = _read_rows(fh, n, saved.ffm_spec, device)
            if has_state:
                if immutable:
                    fh.seek(4 * n, os.SEEK_CUR)
                else:
                    params["ffm_acc"] = _read_rows(fh, n, saved.ffm_spec, device)

        if saved.has_nn:
            def lift(layer):
                return {k: torch.from_numpy(v).to(device) for k, v in layer.items()}

            layers = []
            d = saved.joined_width
            for spec in saved.nn_layers:
                layers.append(lift(_nn_layer_from_bytes(
                    fh, d, spec.width, has_state, not immutable)))
                d = spec.width
            params["nn"] = layers
            final_in = d + (saved.joined_width if saved.topology != "two" else 0)
            params["final"] = lift(_nn_layer_from_bytes(
                fh, final_in, 1, has_state, not immutable))

    if immutable:
        mi.optimizer = Optimizer.SGD
    model = FwModel(
        mi,
        batch_mean_mode=(getattr(args, "fwt_batch_mean", None) or "auto"),
        batch_cap=float(getattr(args, "fwt_batch_cap", None) or 8.0),
    ).load_params(params)
    return mi, vw, model


# the fields of a configuration that fix how a line is translated and
# where its ids land in the tables; the rest (rates, power_t, the optimizer,
# the quantization mark) do not change a prediction's layout
_SERVING_FIELDS = ("bit_precision", "add_constant_feature",
                   "feature_combo_descs", "ffm_fields", "ffm_k",
                   "ffm_bit_precision", "nn_config", "transform_namespaces")


def serving_layout(mi: ModelInstance, vw: VwNamespaceMap) -> tuple:
    """What a server built for ``(mi, vw)`` assumes of a model it serves:
    the namespace map and the configuration's table and translation
    fields."""
    d = json.loads(mi.to_json())
    return (vw.to_source_json(),) + tuple(
        json.dumps(d[k], sort_keys=True) for k in _SERVING_FIELDS)


def hogwild_load(path: str | Path, layout: tuple, device=None) -> FwModel:
    """Load a model file's weights for a hot swap into a running server
    (reference: src/persistence.rs:176-186): a new immutable model.

    A file whose :func:`serving_layout` is not ``layout`` (the running
    model's) raises ValueError before any weight is read: the server's
    translator would hash into tables of another size (the JAX server
    swaps such a file in and gathers past its tables)."""
    mi, vw = read_header(path)
    if serving_layout(mi, vw) != layout:
        raise ValueError(f"{path} was written for another configuration "
                         "than the model being served")
    _mi, _vw, model = load_model(path, immutable=True, device=device)
    return model
