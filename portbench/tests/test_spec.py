"""BENCHMARK.json against its contract, and every name it gives found as
a file."""

import json
import re

import pytest

from portbench import spec

B = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"] and len(B["command"]) <= 32
    assert 1 <= B["run_seconds"] <= 51
    cells = len(B["workloads"])
    budget = 2 + 14 * 24
    assert budget * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and sum(w["chips"] == 4 for w in B["workloads"]) <= max(1, cells // 4)
    assert len(json.dumps(B)) <= 64 * 1024


def test_names_units_and_text():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            for key in ("why", "layer"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
            if group == "configs":
                assert 1 <= len(e["source"]) <= 200
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_per_layer_entries():
    e2e = {m["name"] for m in B["end_to_end"]}
    layers = {}
    for m in B["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("workload", [w["name"] for w in B["workloads"]])
def test_cells_are_found_by_name(workload):
    cell = spec.cell(workload, B)
    assert cell.chips == 1
    assert {"lines", "batch", "superbatch", "argv"} <= set(cell.traffic)
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert [m["name"] for m in cell.end_to_end] == ["train_examples_per_s", "setup_s"]
    # every per-layer metric, but the FFM kernels' where the model has no FFM
    ffm = bool(cell.config["model"]["ffm_fields"])
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in B["per_layer"] if ffm or not m["name"].startswith("ffm_")]


@pytest.mark.parametrize("workload", ["lrffm_k8.multipass_b1024", "deep_ffm.multipass_b1024",
                                      "lrffm_k8.multipass_b32k"])
def test_a_configuration_naming_no_module_takes_the_defaults(workload):
    from portbench import eatrate, reference

    cell = spec.cell(workload, B)
    assert "reference" not in cell.config and "data" not in cell.config
    assert cell.reference is reference and cell.data is eatrate


def test_a_configuration_names_its_own_reference():
    from portbench import eatrate, reference_lr

    cell = spec.cell("eatrate_lr.multipass_b32k", B)
    assert cell.reference is reference_lr and cell.data is eatrate


@pytest.mark.parametrize("key", ["reference", "data"])
def test_a_missing_module_is_named(tmp_path, key):
    config = json.loads((spec.HERE / "configs" / "lrffm_k8.json").read_text())
    config[key] = "nothing_here.py"
    (tmp_path / "broken.json").write_text(json.dumps(config))
    bench = json.loads(json.dumps(B))
    bench["configs"].append({"name": "broken", "file": str(tmp_path / "broken.json")})
    w = next(w for w in bench["workloads"] if w["name"] == "lrffm_k8.multipass_b1024")
    w["config"] = "broken"
    with pytest.raises(FileNotFoundError, match="nothing_here.py"):
        spec.cell(w["name"], bench)


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_metrics_are_found_by_name(metric):
    assert callable(spec.metric_reader(metric))


def test_a_missing_workload_is_named():
    with pytest.raises(KeyError, match="no workload"):
        spec.cell("nothing.here", B)


@pytest.mark.parametrize("config", B["configs"])
def test_config_files_match_the_program_flags(config, tmp_path):
    from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
    from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
    from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap

    data = json.loads((spec.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and config["reduced"] == []
    m = data["model"]

    # the namespace map of the configuration's data schema, from a cell of it
    cell = spec.cell(next(w["name"] for w in B["workloads"] if w["config"] == config["name"]), B)
    cell.data.write_text(cell.traffic, cell.data.columns({**cell.traffic, "lines": 10}, 1),
                         tmp_path / "x.vw")
    vw = VwNamespaceMap.from_dataset_dir(str(tmp_path / "x.vw"))
    mi = ModelInstance.from_cmdline(build_parser().parse_args(data["argv"]), vw)
    assert mi.bit_precision == m["bit_precision"] and mi.ffm_k == m["ffm_k"]
    assert mi.num_ffm_fields == len(m["ffm_fields"])
    assert mi.num_combos == len(m["lr_combos"]) + int(m["constant"])
    assert (mi.learning_rate, mi.power_t, mi.init_acc_gradient) == (
        m["learning_rate"], m["power_t"], m["init_acc_gradient"])
    if m["ffm_fields"]:
        assert mi.ffm_bit_precision == m["ffm_bit_precision"]
        assert (mi.ffm_learning_rate, mi.ffm_power_t, mi.ffm_init_acc_gradient) == (
            m["ffm_learning_rate"], m["ffm_power_t"], m["ffm_init_acc_gradient"])
    assert mi.optimizer.name.lower() == m["optimizer"]
    if m["nn"]:
        nn = m["nn"]
        assert (mi.nn_learning_rate, mi.nn_power_t, mi.nn_init_acc_gradient) == (
            nn["learning_rate"], nn["power_t"], nn["init_acc_gradient"])
        assert mi.nn_config.topology == nn["topology"]
        assert [int(l["width"]) for l in mi.nn_config.layers] == [l["width"] for l in nn["layers"]]
    else:
        assert not mi.nn_config.layers
