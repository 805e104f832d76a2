"""The reader of ``ffm_update_bytes_per_example.train``
(``metrics/ffm_update_bytes_per_example.train.py``): on made-up contexts
it reads the loop's ``ffm_update_bytes`` per ``ffm_update_examples`` over
the untraced passes, and nothing where the program keeps no such counter;
on the card, the counter of replayed CUDA graphs."""

import json

import pytest

from portbench import spec

NAME = "ffm_update_bytes_per_example.train"


def ctx(**counters):
    return {"window_s": 2.0, "passes": 4, "superbatches": 60,
            "counters": counters, "trace": {}, "least": {}}


@pytest.mark.parametrize("counters, want", [
    ({"ffm_update_bytes": 4 * 4_000_000 * 39_936, "ffm_update_examples": 4 * 4_000_000},
     39_936.0),
    ({"ffm_update_bytes": 3 * 2048 * 1024, "ffm_update_examples": 3 * 1024}, 2048.0),
])
def test_the_reader_reads_the_counters(counters, want):
    assert spec.metric_reader(NAME)(ctx(**counters)) == pytest.approx(want)


@pytest.mark.parametrize("context", [
    ctx(dispatch_s=1.6, graph_captures=0),
    ctx(ffm_update_bytes=0, ffm_update_examples=0),
], ids=["no_counter", "no_ffm"])
def test_the_reader_reads_nothing_without_the_counters(context):
    """A program without the counters (the parent of the change that added
    them) or without FFM gives no reading, and the reader does not
    raise."""
    assert spec.metric_reader(NAME)(context) is None


def test_the_entry_lists_the_ffm_cells():
    bench = spec.load_benchmark()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    ffm = [w["name"] for w in bench["workloads"]
           if spec.cell(w["name"], bench).config["model"]["ffm_fields"]]
    assert entry["workloads"] == ffm
    assert entry["source"] == "program_counter" and entry["better"] == "lower"


@pytest.mark.cuda
def test_the_counter_counts_replayed_graphs_on_the_card(cuda_device, tmp_path):
    """The criteo configuration with its tables cut to 2^20 floats, three
    passes on the card through ``run_train_loop``, the last two replaying
    the pack cache's superbatches as CUDA graphs: each pass's counters read
    39·2·512 B an example, and the graphs' replays count as dispatches."""
    from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
    from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
    from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
    from fwumious_wabbit_tpu_torch.models.model import FwModel
    from fwumious_wabbit_tpu_torch.train.loop import run_train_loop
    from portbench import cell as cellmod
    from portbench import criteo, reference_ffm

    cfg = json.loads((spec.HERE / "configs" / "criteo_ffm39.json").read_text())
    argv = list(cfg["argv"])
    for flag in ("-b", "--ffm_bit_precision"):
        argv[argv.index(flag) + 1] = "20"
    model_cfg = dict(cfg["model"], bit_precision=20, ffm_bit_precision=20)
    B, lines = 4096, 9 * 4096 + 300
    criteo.write_text({}, criteo.columns({"lines": lines}, 21), tmp_path / "t.vw")
    flags = [*argv, "--fwt_batch_size", str(B), "--fwt_superbatch", "4",
             "--fwt_pack_cache", "on", "--data", str(tmp_path / "t.vw")]
    args = build_parser().parse_args(flags)
    vw = VwNamespaceMap.from_dataset_dir(str(tmp_path / "t.vw"))
    mi = ModelInstance.from_cmdline(args, vw)
    model = FwModel(mi, batch_mean_mode="on")
    st = reference_ffm.initial_weights(model_cfg, 21, cuda_device)
    model.load_params(cellmod.to_params(st, reference_ffm, model_cfg))
    read = spec.metric_reader(NAME)
    for i in range(3):
        r = run_train_loop(args, mi, vw, model)
        c = r["counters"]
        assert r["examples"] == lines
        assert read(ctx(**c)) == 39 * 2 * 512
        assert c["ffm_update_examples"] >= lines
    assert c["graph_replays"] > 0
