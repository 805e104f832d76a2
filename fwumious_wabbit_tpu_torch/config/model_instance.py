"""ModelInstance — the serializable model configuration.

Re-creates the reference's config object and CLI resolution rules
(reference: src/model_instance.rs:47-495): learning rate / power_t /
init_acc_gradient in three scopes (lr, ffm, nn) with cascading defaults,
feature combos from --keep/--interactions/--linear, FFM fields, the NN layer
config map, and the optimizer resolution --adaptive + fastmath → AdagradLUT.

The JSON layout matches the reference's serde output so model files can be
exchanged for parity testing.

The port's own copy of fwumious_wabbit_tpu/config/model_instance.py, the
same in behaviour; it imports nothing of that package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import IntEnum

from .vwmap import (
    NamespaceDescriptor,
    NamespaceFormat,
    NamespaceType,
    VwNamespaceMap,
)

FFM_MAX_K = 128  # reference: src/model_instance.rs:15


class Optimizer(IntEnum):
    SGD = 100
    ADAGRAD_FLEX = 200
    ADAGRAD_LUT = 300


_OPT_TO_JSON = {
    Optimizer.SGD: "SGD",
    Optimizer.ADAGRAD_FLEX: "AdagradFlex",
    Optimizer.ADAGRAD_LUT: "AdagradLUT",
}
_JSON_TO_OPT = {v: k for k, v in _OPT_TO_JSON.items()}


@dataclass
class FeatureComboDesc:
    namespace_descriptors: list[NamespaceDescriptor]
    weight: float = 1.0


@dataclass
class NNConfig:
    layers: list[dict[str, str]] = field(default_factory=list)
    topology: str = "one"


def _resolve_namespace_descriptor(
    transform_namespaces, vw: VwNamespaceMap, char: str
) -> NamespaceDescriptor:
    """Resolve a one-char namespace name. Char lookup does NOT resolve
    transformed namespaces, matching the reference
    (reference: src/feature_transform_parser.rs:240-257)."""
    key = char.encode()
    if key not in vw.vwname_to_descriptor:
        raise ValueError(f"Unknown namespace char: {char}")
    return vw.vwname_to_descriptor[key]


def _resolve_namespace_descriptor_verbose(
    transform_namespaces, vw: VwNamespaceMap, verbose: str
) -> NamespaceDescriptor:
    if transform_namespaces is not None:
        desc = transform_namespaces.descriptor_for_name(verbose)
        if desc is not None:
            return desc
    if verbose not in vw.verbose_to_descriptor:
        raise ValueError(f"Unknown verbose namespace name: {verbose}")
    return vw.verbose_to_descriptor[verbose]


@dataclass
class ModelInstance:
    # defaults mirror ModelInstance::new_empty (reference:
    # src/model_instance.rs:120-150)
    learning_rate: float = 0.5
    minimum_learning_rate: float = 0.0
    power_t: float = 0.5
    bit_precision: int = 18
    add_constant_feature: bool = True
    feature_combo_descs: list[FeatureComboDesc] = field(default_factory=list)
    ffm_fields: list[list[NamespaceDescriptor]] = field(default_factory=list)
    ffm_k: int = 0
    ffm_bit_precision: int = 18
    fastmath: bool = True
    ffm_initialization_type: str = "default"
    ffm_k_threshold: float = 0.0
    ffm_init_center: float = 0.0
    ffm_init_width: float = 0.0
    ffm_init_zero_band: float = 0.0
    ffm_init_acc_gradient: float = 0.0
    init_acc_gradient: float = 1.0
    ffm_learning_rate: float = 0.5
    ffm_power_t: float = 0.5
    nn_init_acc_gradient: float = 0.0
    nn_learning_rate: float = 0.02
    nn_power_t: float = 0.45
    nn_config: NNConfig = field(default_factory=NNConfig)
    optimizer: Optimizer = Optimizer.SGD
    transform_namespaces: object = None  # NamespaceTransforms | None
    dequantize_weights: bool | None = False

    # ------------------------------------------------------------------
    # combo / field parsing (reference: src/model_instance.rs:152-263)
    # ------------------------------------------------------------------

    def create_feature_combo_desc(self, vw: VwNamespaceMap, s: str) -> FeatureComboDesc:
        parts = s.split(":")
        if len(parts) > 2:
            raise ValueError(f'only one value parameter allowed (denoted with ":"): "{s}"')
        weight = float(parts[1]) if len(parts) == 2 else 1.0
        descs = [
            _resolve_namespace_descriptor(self.transform_namespaces, vw, ch)
            for ch in parts[0]
        ]
        return FeatureComboDesc(namespace_descriptors=descs, weight=weight)

    def create_feature_combo_desc_from_verbose(
        self, vw: VwNamespaceMap, s: str
    ) -> FeatureComboDesc:
        parts = s.split(":")
        weight = 1.0
        if len(parts) == 2:
            weight = float(parts[1])
        elif len(parts) > 2:
            raise ValueError(f'Verbose features cannot have ":" as part of their names: "{s}"')
        descs = [
            _resolve_namespace_descriptor_verbose(self.transform_namespaces, vw, v)
            for v in parts[0].split(",")
        ]
        return FeatureComboDesc(namespace_descriptors=descs, weight=weight)

    def create_field_desc_from_verbose(
        self, vw: VwNamespaceMap, s: str
    ) -> list[NamespaceDescriptor]:
        if ":" in s:
            raise ValueError(f"Fields currently do not support passing a value via : {s!r}")
        return [
            _resolve_namespace_descriptor_verbose(self.transform_namespaces, vw, v)
            for v in s.split(",")
        ]

    def parse_nn(self, s: str) -> None:
        parts = s.split(":")
        if len(parts) != 3:
            raise ValueError(
                "--nn parameters have to be of form layer:parameter_name:parameter_value: "
                + s
            )
        layer_number = int(parts[0])
        if layer_number >= len(self.nn_config.layers):
            raise ValueError(
                f"--nn parameter addressing layer {layer_number}, but we have only "
                f"{len(self.nn_config.layers)} layers"
            )
        self.nn_config.layers[layer_number][parts[1]] = parts[2]

    # ------------------------------------------------------------------
    # CLI resolution (reference: src/model_instance.rs:296-495)
    # ------------------------------------------------------------------

    @classmethod
    def from_cmdline(cls, args, vw: VwNamespaceMap) -> "ModelInstance":
        """``args`` is an argparse.Namespace produced by cmdline.build_parser()."""
        mi = cls()
        vwcompat = bool(getattr(args, "vwcompat", False))
        if vwcompat:
            mi.fastmath = False
            mi.init_acc_gradient = 0.0
            if not args.keep:
                raise ValueError(
                    "--vwcompat requires at least one --keep parameter, we do not implicitly"
                    " take all features available"
                )
            if getattr(args, "hash", None) != "all":
                raise ValueError("--vwcompat requires use of --hash all")
            if not args.sgd:
                raise ValueError("--vwcompat requires use of --sgd")

        if getattr(args, "transform", None):
            from ..ingest.transforms import NamespaceTransformsParser

            tparser = NamespaceTransformsParser()
            for value_str in args.transform:
                tparser.add_transform_namespace(vw, value_str)
            mi.transform_namespaces = tparser.resolve(vw)

        for value_str in args.keep or []:
            mi.feature_combo_descs.append(mi.create_feature_combo_desc(vw, value_str))
        for value_str in args.interactions or []:
            mi.feature_combo_descs.append(mi.create_feature_combo_desc(vw, value_str))
        for value_str in args.linear or []:
            mi.feature_combo_descs.append(
                mi.create_feature_combo_desc_from_verbose(vw, value_str)
            )

        if args.ffm_k is not None:
            mi.ffm_k = int(args.ffm_k)
            if mi.ffm_k > FFM_MAX_K:
                raise ValueError(f"Maximum ffm_k is: {FFM_MAX_K}, passed: {mi.ffm_k}")
        if args.ffm_initialization_type is not None:
            mi.ffm_initialization_type = args.ffm_initialization_type
        if args.ffm_init_center is not None:
            mi.ffm_init_center = float(args.ffm_init_center)
        if args.ffm_init_width is not None:
            mi.ffm_init_width = float(args.ffm_init_width)
        if args.ffm_init_zero_band is not None:
            mi.ffm_init_zero_band = float(args.ffm_init_zero_band)

        for namespaces_str in args.ffm_field or []:
            mi.ffm_fields.append(
                [
                    _resolve_namespace_descriptor(mi.transform_namespaces, vw, ch)
                    for ch in namespaces_str
                ]
            )
        for value_str in args.ffm_field_verbose or []:
            mi.ffm_fields.append(mi.create_field_desc_from_verbose(vw, value_str))

        if args.ffm_bit_precision is not None:
            mi.ffm_bit_precision = int(args.ffm_bit_precision)
        if args.bit_precision is not None:
            mi.bit_precision = int(args.bit_precision)

        def pf(name, default):
            v = getattr(args, name, None)
            return float(v) if v is not None else default

        # cascading scope defaults (reference: src/model_instance.rs:418-428)
        mi.learning_rate = pf("learning_rate", mi.learning_rate)
        mi.init_acc_gradient = pf("init_acc_gradient", mi.init_acc_gradient)
        mi.power_t = pf("power_t", mi.power_t)

        mi.ffm_learning_rate = pf("ffm_learning_rate", mi.learning_rate)
        mi.ffm_init_acc_gradient = pf("ffm_init_acc_gradient", mi.init_acc_gradient)
        mi.ffm_power_t = pf("ffm_power_t", mi.power_t)

        mi.nn_learning_rate = pf("nn_learning_rate", mi.ffm_learning_rate)
        mi.nn_init_acc_gradient = pf("nn_init_acc_gradient", mi.ffm_init_acc_gradient)
        mi.nn_power_t = pf("nn_power_t", mi.ffm_power_t)

        if args.nn_layers is not None:
            for _ in range(int(args.nn_layers)):
                mi.nn_config.layers.append({})
        if args.nn_topology is not None:
            mi.nn_config.topology = args.nn_topology
        for value_str in args.nn or []:
            mi.parse_nn(value_str)

        if args.minimum_learning_rate is not None:
            mi.minimum_learning_rate = float(args.minimum_learning_rate)

        if args.link is not None and args.link != "logistic":
            raise ValueError("--link only supports 'logistic'")
        if args.loss_function is not None and args.loss_function != "logistic":
            raise ValueError("--loss_function only supports 'logistic'")
        if args.l2 is not None and abs(float(args.l2)) > 1e-8:
            raise ValueError("--l2 can only be 0.0")

        if args.noconstant:
            mi.add_constant_feature = False

        if args.sgd:
            mi.optimizer = Optimizer.SGD
        if args.adaptive:
            mi.optimizer = Optimizer.ADAGRAD_FLEX
        if mi.optimizer == Optimizer.ADAGRAD_FLEX and mi.fastmath:
            mi.optimizer = Optimizer.ADAGRAD_LUT

        return mi

    def update_hyperparameters_from_cmd(self, args) -> None:
        """Whitelist of hyperparameters overridable on model load
        (reference: src/model_instance.rs:497-550)."""
        for name in ("learning_rate", "ffm_learning_rate", "power_t", "ffm_power_t"):
            v = getattr(args, name, None)
            if v is not None:
                setattr(self, name, float(v))

    # ------------------------------------------------------------------
    # derived quantities used by the translator / model builder
    # ------------------------------------------------------------------

    @property
    def num_combos(self) -> int:
        """LR output width: one per combo, +1 for the constant feature
        (reference: src/block_lr.rs:53-56)."""
        return len(self.feature_combo_descs) + (1 if self.add_constant_feature else 0)

    @property
    def num_ffm_fields(self) -> int:
        return len(self.ffm_fields)

    @property
    def lr_hash_mask(self) -> int:
        return (1 << self.bit_precision) - 1

    @property
    def ffm_bits_for_dimensions(self) -> int:
        b = 0
        while self.ffm_k > (1 << b):
            b += 1
        return b

    @property
    def ffm_hash_mask(self) -> int:
        """Low ceil(log2 k) bits freed for the embedding lanes
        (reference: src/feature_buffer.rs:141-148)."""
        dimensions_mask = (1 << self.ffm_bits_for_dimensions) - 1
        return ((1 << self.ffm_bit_precision) - 1) ^ dimensions_mask

    @property
    def ffm_weights_len(self) -> int:
        """Table length incl. the spillover guard band
        (reference: src/block_ffm.rs:92-95)."""
        if self.ffm_k == 0:
            return 0
        return (1 << self.ffm_bit_precision) + len(self.ffm_fields) * self.ffm_k

    # ------------------------------------------------------------------
    # JSON (layout compatible with the reference's serde ModelInstance)
    # ------------------------------------------------------------------

    def _ns_desc_to_json(self, d: NamespaceDescriptor) -> dict:
        return {
            "namespace_index": d.namespace_index,
            "namespace_type": "Primitive"
            if d.namespace_type == NamespaceType.PRIMITIVE
            else "Transformed",
            "namespace_format": "Categorical"
            if d.namespace_format == NamespaceFormat.CATEGORICAL
            else "F32",
        }

    def to_json(self) -> str:
        tn = self.transform_namespaces
        d = {
            "learning_rate": self.learning_rate,
            "minimum_learning_rate": self.minimum_learning_rate,
            "power_t": self.power_t,
            "bit_precision": self.bit_precision,
            "add_constant_feature": self.add_constant_feature,
            "feature_combo_descs": [
                {
                    "namespace_descriptors": [
                        self._ns_desc_to_json(nd) for nd in c.namespace_descriptors
                    ],
                    "weight": c.weight,
                }
                for c in self.feature_combo_descs
            ],
            "ffm_fields": [
                [self._ns_desc_to_json(nd) for nd in f] for f in self.ffm_fields
            ],
            "ffm_k": self.ffm_k,
            "ffm_bit_precision": self.ffm_bit_precision,
            "fastmath": self.fastmath,
            "ffm_initialization_type": self.ffm_initialization_type,
            "ffm_k_threshold": self.ffm_k_threshold,
            "ffm_init_center": self.ffm_init_center,
            "ffm_init_width": self.ffm_init_width,
            "ffm_init_zero_band": self.ffm_init_zero_band,
            "ffm_init_acc_gradient": self.ffm_init_acc_gradient,
            "init_acc_gradient": self.init_acc_gradient,
            "ffm_learning_rate": self.ffm_learning_rate,
            "ffm_power_t": self.ffm_power_t,
            "nn_init_acc_gradient": self.nn_init_acc_gradient,
            "nn_learning_rate": self.nn_learning_rate,
            "nn_power_t": self.nn_power_t,
            "nn_config": {
                "layers": self.nn_config.layers,
                "topology": self.nn_config.topology,
            },
            "optimizer": _OPT_TO_JSON[self.optimizer],
            "transform_namespaces": tn.to_json_obj() if tn is not None else {"v": []},
            "dequantize_weights": self.dequantize_weights,
        }
        return json.dumps(d, separators=(",", ":"))

    @classmethod
    def from_json(cls, data: str) -> "ModelInstance":
        d = json.loads(data)

        def ns_desc(j):
            return NamespaceDescriptor(
                namespace_index=j["namespace_index"],
                namespace_type=NamespaceType.PRIMITIVE
                if j["namespace_type"] == "Primitive"
                else NamespaceType.TRANSFORMED,
                namespace_format=NamespaceFormat.CATEGORICAL
                if j["namespace_format"] == "Categorical"
                else NamespaceFormat.F32,
            )

        mi = cls()
        mi.learning_rate = d["learning_rate"]
        mi.minimum_learning_rate = d.get("minimum_learning_rate", 0.0)
        mi.power_t = d["power_t"]
        mi.bit_precision = d["bit_precision"]
        mi.add_constant_feature = d["add_constant_feature"]
        mi.feature_combo_descs = [
            FeatureComboDesc(
                namespace_descriptors=[ns_desc(nd) for nd in c["namespace_descriptors"]],
                weight=c["weight"],
            )
            for c in d["feature_combo_descs"]
        ]
        mi.ffm_fields = [[ns_desc(nd) for nd in f] for f in d["ffm_fields"]]
        mi.ffm_k = d.get("ffm_k", 0)
        mi.ffm_bit_precision = d.get("ffm_bit_precision", 0)
        mi.fastmath = d.get("fastmath", False)
        mi.ffm_initialization_type = d.get("ffm_initialization_type", "default")
        mi.ffm_k_threshold = d.get("ffm_k_threshold", 0.0)
        mi.ffm_init_center = d.get("ffm_init_center", 0.0)
        mi.ffm_init_width = d.get("ffm_init_width", 0.0)
        mi.ffm_init_zero_band = d.get("ffm_init_zero_band", 0.0)
        mi.ffm_init_acc_gradient = d.get("ffm_init_acc_gradient", 0.0)
        mi.init_acc_gradient = d.get("init_acc_gradient", 0.0)
        mi.ffm_learning_rate = d.get("ffm_learning_rate", 0.0)
        mi.ffm_power_t = d.get("ffm_power_t", 0.0)
        mi.nn_init_acc_gradient = d.get("nn_init_acc_gradient", 0.0)
        mi.nn_learning_rate = d.get("nn_learning_rate", 0.0)
        mi.nn_power_t = d.get("nn_power_t", 0.0)
        nc = d.get("nn_config", {"layers": [], "topology": "one"})
        mi.nn_config = NNConfig(layers=nc["layers"], topology=nc["topology"])
        mi.optimizer = _JSON_TO_OPT[d.get("optimizer", "AdagradFlex")]
        tn = d.get("transform_namespaces")
        if tn and tn.get("v"):
            from ..ingest.transforms import NamespaceTransforms

            mi.transform_namespaces = NamespaceTransforms.from_json_obj(tn)
        mi.dequantize_weights = d.get("dequantize_weights")
        return mi
