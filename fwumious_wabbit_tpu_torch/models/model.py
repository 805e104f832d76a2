"""The model's predict path: hashed LR ⊕ field-aware FM (triangle) →
optional dense tower → clamped sigmoid — the predict half of
fwumious_wabbit_tpu/models/model.py, as an ``nn.Module``.

The module holds its weights as buffers in the JAX package's layout, so
model files and parameters carry across unchanged:

* ``lr_w [R_lr, 128]`` and ``ffm_w [R_ffm, 128]`` row tables
  (ops/tables.py), with ``lr_acc``/``ffm_acc`` when optimizer state was
  loaded;
* ``layers[i].w [in, out]``, ``layers[i].b [out]`` (plus ``w_acc``/``b_acc``)
  and ``final`` (the one-neuron readout) when a tower is configured.

Training is ported, with or without a tower: the three scope optimizers
(``opt_lr``, ``opt_ffm``, ``opt_nn``) with the batch-mean cap, and
:meth:`FwModel.init_params`, whose tower weights equal the JAX package's
bit for bit (the reference's Xoshiro256++ draws, seeded from its tape
offsets: ops/xoshiro.py, models/ref_offsets.py). The train step
(train/step.py) updates the buffers in place, the tower's through its
manual backward and :meth:`ScopedOptimizer.apply_dense`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..config.model_instance import ModelInstance, Optimizer
from ..ops import tables
from ..ops.adagrad import OPT_ADAGRAD_FLEX, OPT_ADAGRAD_LUT, OPT_SGD, ScopedOptimizer
from ..ops.ffm import FfmFused, triangle_indices

_OPT_KIND = {
    Optimizer.SGD: OPT_SGD,
    Optimizer.ADAGRAD_FLEX: OPT_ADAGRAD_FLEX,
    Optimizer.ADAGRAD_LUT: OPT_ADAGRAD_LUT,
}


def predict_prob(logit: torch.Tensor) -> torch.Tensor:
    """sigmoid(clamp(logit, ±50)); NaN → 0.5
    (reference: src/block_loss_functions.rs:59-72)."""
    p = torch.sigmoid(torch.clamp(logit, -50.0, 50.0))
    return torch.where(torch.isnan(logit), torch.full_like(p, 0.5), p)


_NORM_EPS = 1e-2  # reference: src/block_normalize.rs:15


def norm_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean, σ)`` over the last axis with the reference's quirky
    variance: mean over (mean² − x)², EPS added before the division
    (reference: src/block_normalize.rs:77-92)."""
    n = x.shape[-1]
    mean = x.mean(-1, keepdim=True)
    w = mean * mean - x
    var = ((w * w).sum(-1, keepdim=True) + _NORM_EPS) / n
    return mean, torch.sqrt(var)


def normalize_predict(x: torch.Tensor) -> torch.Tensor:
    """The prediction path normalizes without mean subtraction
    (reference: src/block_normalize.rs:130-163)."""
    return x / norm_stats(x)[1]


def normalize_train(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The training path's ``((x − mean)/σ, σ)``. Its backward is the
    reference's g/σ, mean and σ held constant (src/block_normalize.rs:99-105;
    fwumious_wabbit_tpu/models/model.py:111-128): train/step.py applies
    that rule in the tower's manual backward."""
    mean, sigma = norm_stats(x)
    return (x - mean) / sigma, sigma


@dataclass(frozen=True)
class NNLayerSpec:
    width: int
    activation: str  # 'none' | 'relu'
    layernorm: str  # 'none' | 'before' | 'after'
    maxnorm: float
    init: str  # 'xavier' | 'hu' | 'one' | 'zero'


def parse_nn_layers(mi: ModelInstance) -> list[NNLayerSpec]:
    specs = []
    for layer_num, layer in enumerate(mi.nn_config.layers):
        layer = dict(layer)
        activation = layer.pop("activation", "none")
        layernorm = layer.pop("layernorm", "none")
        width = int(layer.pop("width", "20"))
        maxnorm = float(layer.pop("maxnorm", "0.0"))
        dropout = float(layer.pop("dropout", "0.0"))
        init = layer.pop("init", "hu")
        if layer:
            raise ValueError(f"Unknown --nn parameter for layer number {layer_num}: {layer}")
        if dropout != 0.0:
            # reference: src/block_neural.rs:82-84 — dropout is hard-disabled
            raise ValueError("Dropout is not supported (disabled in the reference as well)")
        if activation not in ("none", "relu"):
            raise ValueError(f'unknown nn activation type: "{activation}"')
        if layernorm not in ("none", "before", "after"):
            raise ValueError(f'unknown nn layer norm: "{layernorm}"')
        if init not in ("xavier", "hu", "one", "zero"):
            raise ValueError(f'unknown nn initialization type: "{init}"')
        specs.append(NNLayerSpec(width, activation, layernorm, maxnorm, init))
    return specs


class DenseLayer(nn.Module):
    """One tower layer's weights ``w [in, out]``, ``b [out]`` (and optional
    optimizer state), as buffers."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t)

    def tensors(self) -> dict:
        return dict(self.named_buffers())


class FwModel(nn.Module):
    """Static model structure plus its weights. Build it from a
    ``ModelInstance``, then :meth:`load_params` a params dict (JAX layout,
    torch tensors — see convert.py and persistence/model_file.py) or the
    output of :meth:`init_params`.

    ``batch_mean_mode`` (``--fwt_batch_mean``: off, on or auto) caps each
    weight's per-batch multiplicity at ``batch_cap``
    (ops/adagrad.batch_mean_grads); auto enables it for the AdaGrad scopes
    whose power_t is 0, whose rate is a constant with no accumulator
    feedback (fwumious_wabbit_tpu/models/model.py:236-251)."""

    def __init__(self, mi: ModelInstance, batch_mean_mode: str = "auto",
                 batch_cap: float = 8.0):
        super().__init__()
        self.mi = mi
        self.num_combos = mi.num_combos
        self.num_fields = mi.num_ffm_fields
        self.ffm_k = mi.ffm_k
        self.has_ffm = mi.ffm_k > 0 and self.num_fields > 0
        self.lr_size = 1 << mi.bit_precision
        self.ffm_size = mi.ffm_weights_len
        self.lr_spec = tables.make_spec(self.lr_size, 1)
        self.ffm_spec = (
            tables.make_spec(self.ffm_size, self.num_fields * self.ffm_k)
            if self.has_ffm else None
        )
        self.nn_layers = parse_nn_layers(mi)
        self.has_nn = len(self.nn_layers) > 0
        self.topology = mi.nn_config.topology
        if self.topology not in ("one", "two", "four", "five"):
            raise ValueError(f'unknown nn topology: "{self.topology}"')
        kind = _OPT_KIND[mi.optimizer]

        def bm(power_t: float) -> bool:
            if batch_mean_mode == "on":
                return True
            return (batch_mean_mode == "auto" and kind != OPT_SGD
                    and float(power_t) == 0.0)

        self.opt_lr = ScopedOptimizer(kind, mi.learning_rate, mi.power_t,
                                      mi.init_acc_gradient,
                                      batch_mean=bm(mi.power_t),
                                      batch_cap=batch_cap)
        self.opt_ffm = ScopedOptimizer(
            kind, mi.ffm_learning_rate, mi.ffm_power_t, mi.ffm_init_acc_gradient,
            batch_mean=bm(mi.ffm_power_t), batch_cap=batch_cap)
        self.opt_nn = ScopedOptimizer(kind, mi.nn_learning_rate, mi.nn_power_t,
                                      mi.nn_init_acc_gradient)
        # every scope shares the optimizer kind: state exists unless SGD
        self.has_state = self.opt_lr.has_state
        self.tri_width = len(triangle_indices(self.num_fields)[0])
        # width of the vector entering the tower / terminal sum
        self.joined_width = self.num_combos + (self.tri_width if self.has_ffm else 0)
        self.layers = nn.ModuleList()
        self.final = None
        self._ones = {}  # (shape, device) → the FFM values when left out

    # -- weights ---------------------------------------------------------------

    def load_params(self, params: dict) -> "FwModel":
        """Take the tensors of a params dict (``lr_w``, ``lr_acc``?,
        ``ffm_w``?, ``ffm_acc``?, ``nn`` list and ``final`` dicts) as this
        model's buffers. Shapes are checked against the model's geometry."""
        want = {"lr_w": (self.lr_spec.num_rows, tables.LANE)}
        if self.has_ffm:
            want["ffm_w"] = (self.ffm_spec.num_rows, tables.LANE)
        for key, shape in want.items():
            if tuple(params[key].shape) != shape:
                raise ValueError(f"{key}: expected {shape}, got "
                                 f"{tuple(params[key].shape)}")
        for key in ("lr_w", "lr_acc", "ffm_w", "ffm_acc"):
            if key in params:
                self.register_buffer(key, params[key])
        if self.has_nn:
            self.layers = nn.ModuleList(DenseLayer(l) for l in params["nn"])
            self.final = DenseLayer(params["final"])
        return self

    def init_params(self, device=None) -> dict:
        """Fresh weights (fwumious_wabbit_tpu/models/model.py:276-375): LR
        weights 0, accumulators at ``initial_acc()``, FFM weights from
        merand48 (ops/init.py), the tower's layers from :meth:`_init_layer`
        and its one-neuron readout at ones, all on ``device``."""
        from ..ops import init as ffm_init

        mi = self.mi
        rows = (self.lr_spec.num_rows, tables.LANE)
        params = {"lr_w": torch.zeros(rows, dtype=torch.float32, device=device)}
        if self.opt_lr.has_state:
            params["lr_acc"] = torch.full(rows, self.opt_lr.initial_acc(),
                                          dtype=torch.float32, device=device)
        if self.has_ffm:
            if mi.ffm_initialization_type != "default":
                raise ValueError("Please select a valid activation function.")
            n, padded = self.ffm_size, self.ffm_spec.padded_size
            if mi.ffm_init_width == 0.0:
                w = ffm_init.ffm_init_default(n, self.ffm_k, padded, device)
            else:
                w = ffm_init.ffm_init_band(n, padded, mi.ffm_init_width,
                                           mi.ffm_init_zero_band,
                                           mi.ffm_init_center, device)
            rows = (self.ffm_spec.num_rows, tables.LANE)
            params["ffm_w"] = w.reshape(rows)
            if self.opt_ffm.has_state:
                params["ffm_acc"] = torch.full(rows, self.opt_ffm.initial_acc(),
                                               dtype=torch.float32, device=device)
        if self.has_nn:
            from . import ref_offsets

            offs = ref_offsets.reference_nn_offsets(
                self.num_combos, self.num_fields if self.has_ffm else 0,
                self.topology,
                [(s.width, s.layernorm, s.activation) for s in self.nn_layers])
            layers, d = [], self.joined_width
            for spec, off in zip(self.nn_layers, offs[:-1]):
                layers.append(self._init_layer(off, d, spec.width, spec.init,
                                               device))
                d = spec.width
            params["nn"] = layers
            final_in = d + (self.joined_width if self.topology != "two" else 0)
            params["final"] = self._init_layer(offs[-1], final_in, 1, "one",
                                               device)
        return params

    def _init_layer(self, off, fan_in: int, fan_out: int, init: str,
                    device) -> dict:
        """One layer's ``w [fan_in, fan_out]``, zero ``b`` and, unless SGD,
        accumulators at ``opt_nn.initial_acc()``: the reference's init
        (src/block_neural.rs:382-418). Xavier draws uniform in
        ±√6/√(fan_in·fan_out), Hu normal with σ = √(2/fan_in) through the
        ziggurat, from a Xoshiro256++ seeded by the layer's tape offsets;
        the draws are neuron-major, as the reference stores them."""
        import numpy as np

        from ..ops import xoshiro
        from . import ref_offsets

        in_off, out_off, num_inputs, num_neurons = off
        if (num_inputs, num_neurons) != (fan_in, fan_out):
            raise ValueError(f"ref_offsets layer shape {off} drifted from the "
                             f"model's ({fan_in}, {fan_out})")
        if init in ("xavier", "hu"):
            rng = xoshiro.Xoshiro256PlusPlus(
                ref_offsets.layer_seed(in_off, out_off, fan_in, fan_out))
            n = fan_in * fan_out
            if init == "xavier":
                bound = float(np.sqrt(6.0)) / float(np.sqrt(n))
                seq = [rng.uniform(-bound, bound) for _ in range(n)]
            else:
                std = float(np.sqrt(2.0 / fan_in))
                seq = [xoshiro.normal(rng, 0.0, std) for _ in range(n)]
            w = np.array(seq, np.float32).reshape(fan_out, fan_in).T
        elif init == "one":
            w = np.ones((fan_in, fan_out), np.float32)
        else:  # zero
            w = np.zeros((fan_in, fan_out), np.float32)
        layer = {"w": torch.from_numpy(np.ascontiguousarray(w)).to(device),
                 "b": torch.zeros(fan_out, dtype=torch.float32, device=device)}
        if self.opt_nn.has_state:
            a0 = self.opt_nn.initial_acc()
            layer["w_acc"] = torch.full((fan_in, fan_out), a0,
                                        dtype=torch.float32, device=device)
            layer["b_acc"] = torch.full((fan_out,), a0, dtype=torch.float32,
                                        device=device)
        return layer

    def params(self) -> dict:
        """The weights as a params dict (the inverse of :meth:`load_params`)."""
        out = {k: getattr(self, k) for k in ("lr_w", "lr_acc", "ffm_w", "ffm_acc")
               if k in self._buffers}
        if self.has_nn:
            out["nn"] = [l.tensors() for l in self.layers]
            out["final"] = self.final.tensors()
        return out

    # -- forward pieces --------------------------------------------------------

    def lr_ids_combos(self, batch: dict):
        """``(ids, combos)`` of the LR features. The host may pack
        ``combo+1`` into the id bits above ``bit_precision`` and leave the
        combos array out (train/producer.py; padding packs as 0 → combo
        −1); the ids are then non-negative, so the arithmetic shift is
        logical (fwumious_wabbit_tpu/models/model.py:379-390)."""
        ids = batch["lr_ids"]
        if "lr_combos" in batch:
            return ids, batch["lr_combos"]
        combos = (ids >> self.mi.bit_precision) - 1
        return ids & self.mi.lr_hash_mask, combos

    def gather_lr(self, batch: dict) -> torch.Tensor:
        """Scalar weights w[h] for the LR ids → [B, L]."""
        return tables.gather_scalars(self.lr_w, self.lr_ids_combos(batch)[0])

    def lr_outputs(self, lr_wg: torch.Tensor, batch: dict) -> torch.Tensor:
        """[B, C]: per-combo sums of w[hash]·value
        (reference: src/block_lr.rs:28-47), as a masked scatter-add. A combo
        outside ``[0, C)`` (−1 padding) adds nothing. ``lr_vals`` may be
        left out when all ones."""
        vals = batch.get("lr_vals")
        contrib = lr_wg if vals is None else lr_wg * vals  # [B, L]
        combos = self.lr_ids_combos(batch)[1].long()
        valid = (combos >= 0) & (combos < self.num_combos)
        contrib = torch.where(valid, contrib, torch.zeros_like(contrib))
        out = contrib.new_zeros((contrib.shape[0], self.num_combos))
        return out.scatter_add_(1, torch.where(valid, combos, 0), contrib)

    def ffm_outputs(self, batch: dict, emb_leaf: torch.Tensor | None = None,
                    rows: tuple | None = None) -> torch.Tensor:
        """[B, F(F+1)/2] interaction triangle through ops/ffm.FfmFused: the
        slabs of the FFM ids are read from ``ffm_w`` inside the kernel (the
        kernel pair on the card). With ``emb_leaf`` (ops/ffm.slab_leaf) the
        gradient with respect to the gathered slabs flows to it.
        ``ffm_vals`` may be left out when all ones: the kernels then read a
        ones tensor, made once per shape. ``rows`` = ``(table, ids, spec)``
        reads the slabs from another table (the rows a sharded step
        exchanged, parallel/sharded.py) by other ids of the same shape."""
        table, spec = self.ffm_w, self.ffm_spec
        if rows is None:
            ids = batch["ffm_ids"].to(torch.int32).contiguous()
        else:
            table, ids, spec = rows
        vals = batch.get("ffm_vals")
        if vals is None:
            key = (tuple(ids.shape), ids.device)
            vals = self._ones.get(key)
            if vals is None:
                vals = self._ones[key] = torch.ones(ids.shape, device=ids.device)
        return FfmFused.apply(emb_leaf, table, ids, vals.contiguous(),
                              batch["ffm_fields"].to(torch.int32).contiguous(),
                              self.num_fields, self.ffm_k, spec)

    def tower(self, x: torch.Tensor) -> torch.Tensor:
        """Dense tower + final readout → [B] logits (predict path)."""
        topo = self.topology
        if topo == "two":
            t, joined = x, None
        elif topo == "four":
            t, joined = normalize_predict(x), x
        else:  # one, five (five stops the gradient, which predict has none of)
            t, joined = x, x
        for spec, layer in zip(self.nn_layers, self.layers):
            t = torch.matmul(t, layer.w) + layer.b
            if spec.layernorm == "before":
                t = normalize_predict(t)
            if spec.activation == "relu":
                t = torch.where(t > 0.0, t, torch.zeros_like(t))
            if spec.layernorm == "after":
                t = normalize_predict(t)
        if joined is not None:
            t = torch.cat([t, joined], dim=-1)
        return (torch.matmul(t, self.final.w) + self.final.b)[:, 0]

    # -- full forward -----------------------------------------------------------

    def forward(self, batch: dict) -> torch.Tensor:
        """Logits [B] for a batch dict of tensors on the model's device."""
        parts = [self.lr_outputs(self.gather_lr(batch), batch)]
        if self.has_ffm:
            parts.append(self.ffm_outputs(batch))
        x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        if self.has_nn:
            return self.tower(x)
        return x.sum(-1)

    def predict(self, batch: dict) -> torch.Tensor:
        """Probabilities [B]."""
        return predict_prob(self(batch))
