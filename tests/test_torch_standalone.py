"""The port stands alone: no module of fwumious_wabbit_tpu_torch (nor
chip_smoke.py) imports the JAX package, and the port's copies of its host
modules behave as the originals on the same inputs — the CLI parser, the
model configuration, parse + translate + batch (the port's synthetic
Eat-Rate lines and hand-written lines of every parser form, with a
``--transform`` case), the model-file header in both directions, the C++
reply formatter and the embedded C++ engine's predictions. The training
path's copies (the ingest bindings of ``native/``, the host half of
``train/packed.py``, ``train/producer.py``, ``train/pack_cache.py``) are held
to theirs by tests/test_torch_native_ingest.py, test_torch_packed.py and
test_torch_producer.py; here, the pack cache's layout records cross between
the packages."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from fwumious_wabbit_tpu import native as jax_native
from fwumious_wabbit_tpu.config import cmdline as jcmd
from fwumious_wabbit_tpu.config import model_instance as jmi
from fwumious_wabbit_tpu.config import vwmap as jvwmap
from fwumious_wabbit_tpu.ingest import parser as jparser
from fwumious_wabbit_tpu.ingest import translator as jtranslator
from fwumious_wabbit_tpu.models.model import FwModel as JaxModel
from fwumious_wabbit_tpu.persistence import model_file as jmf
from fwumious_wabbit_tpu_torch import native, synthetic
from fwumious_wabbit_tpu_torch.config import cmdline as pcmd
from fwumious_wabbit_tpu_torch.config import model_instance as pmi_mod
from fwumious_wabbit_tpu_torch.config import vwmap as pvwmap
from fwumious_wabbit_tpu_torch.ingest import parser as pparser
from fwumious_wabbit_tpu_torch.ingest import translator as ptranslator
from fwumious_wabbit_tpu_torch.persistence import model_file as pmf

from torch_parity import (  # noqa: F401 (jax_native_loaded: an autouse fixture)
    FFM_ARGV,
    config_fields,
    jax_native_loaded,
    jax_params,
    make_mi,
    make_vw,
    port_config,
    port_model,
    vw_lines,
)


REPO = Path(__file__).resolve().parents[1]
JAX_PACKAGE = "fwumious_wabbit_tpu"


def port_sources() -> list[Path]:
    return sorted((REPO / "fwumious_wabbit_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def jax_package_imports(path: Path) -> list[str]:
    """``file:line name`` of every import of the JAX package in ``path``,
    at any depth of the module (lazy imports inside functions included)."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
            names += [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        found += [f"{path.name}:{node.lineno} {n}" for n in names
                  if n.split(".")[0] == JAX_PACKAGE]
    return found


def test_no_module_of_the_port_imports_the_jax_package():
    files = port_sources()
    assert len(files) > 30
    bad = [hit for f in files for hit in jax_package_imports(f)]
    assert not bad, bad


def test_the_import_scan_sees_lazy_and_aliased_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from fwumious_wabbit_tpu.config import vwmap\n"
                     "import fwumious_wabbit_tpu as f\n"
                     "from fwumious_wabbit_tpu_torch import ops\n")
    assert jax_package_imports(probe) == [
        "probe.py:3 fwumious_wabbit_tpu",
        "probe.py:2 fwumious_wabbit_tpu.config",
        "probe.py:2 fwumious_wabbit_tpu.config.vwmap"]


# -- the CLI parser and the model configuration --------------------------------------


def parser_table(parser) -> list[tuple]:
    return [(tuple(a.option_strings), a.dest, repr(a.default), repr(a.nargs),
             repr(a.choices), repr(a.const), type(a).__name__)
            for a in parser._actions]


def test_build_parser_matches_jax():
    want, got = parser_table(jcmd.build_parser()), parser_table(pcmd.build_parser())
    assert len(got) > 60
    assert got == want


ARGVS = {
    "lr": [],
    "ffm": FFM_ARGV,
    "ffm_sgd_p0": FFM_ARGV + ["--sgd", "--power_t", "0", "--ffm_power_t", "0.25"],
    "nn": FFM_ARGV + ["--nn_layers", "2", "--nn", "0:width:6", "--nn",
                      "0:activation:relu", "--nn", "1:width:3",
                      "--nn_topology", "four"],
    "transform": ["--transform", "w2=Weight(animal)(3.0)", "--linear", "w2",
                  "--noconstant"],
    "init_band": FFM_ARGV + ["--ffm_init_width", "0.5",
                             "--ffm_init_zero_band", "0.1"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_model_instance_matches_jax(tmp_path, name):
    vw = make_vw(tmp_path)
    mi = make_mi(vw, ARGVS[name])
    pvw, pmi = port_config(tmp_path, ARGVS[name])
    assert type(pmi) is pmi_mod.ModelInstance
    assert config_fields(pmi) == config_fields(mi)
    assert pmi.to_json() == mi.to_json()
    assert pvw.to_source_json() == vw.to_source_json()
    assert config_fields(pvw) == config_fields(vw)


# -- parse + translate + batch --------------------------------------------------------

CSV = "A,animal\nB,food\nC,color\n"
HAND_LINES = [
    b"1 |A a b c |B x\n",
    b"-1 |A a:2.5 b:-0.5 |B x:0\n",  # feature values
    b"1 |A:0.5 a b |B:2 y\n",  # namespace weights
    b"1 2.0 |A a |C red\n",  # a label with an importance
    b"-1 0.25 |A:3 a:2 |B y:1.5 z |C blue:NONE\n",
    b"|A unlabeled |B z\n",
    b"1 |C c1 c2 c3 c4 c5 c6 c7 c8 c9\n",
]


def translate_both(csv: str, argv: list[str], lines: list[bytes]):
    """The JAX and the port pipelines on the same lines: lists of (record,
    translated example) per package."""
    out = []
    for vwmap, cmd, mi_mod, parser, translator in (
            (jvwmap, jcmd, jmi, jparser, jtranslator),
            (pvwmap, pcmd, pmi_mod, pparser, ptranslator)):
        vw = vwmap.VwNamespaceMap.from_string(csv)
        mi = mi_mod.ModelInstance.from_cmdline(cmd.build_parser().parse_args(argv), vw)
        p, t = parser.VowpalParser(vw), translator.FeatureTranslator(mi)
        recs = [p.parse_line(line) for line in lines]
        tes = [t.translate(r) for r in recs]
        out.append((recs, tes, translator.Batcher(len(tes) + 3).make_batch(
            tes, pad_to_batch=True)))
    return out


def assert_same_pipeline(jax_side, port_side):
    (jrecs, jtes, jbatch), (precs, ptes, pbatch) = jax_side, port_side
    assert len(jrecs) == len(precs)
    for a, b in zip(jrecs, precs):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jtes, ptes):  # NONE values are NaN: compared as arrays
        ja, pa = dataclasses.asdict(a), dataclasses.asdict(b)
        assert sorted(pa) == sorted(ja)
        for key in ja:
            np.testing.assert_array_equal(np.asarray(pa[key]), np.asarray(ja[key]),
                                          err_msg=key)
    for f in dataclasses.fields(jbatch):
        np.testing.assert_array_equal(getattr(pbatch, f.name),
                                      getattr(jbatch, f.name), err_msg=f.name)


PIPELINES = {
    "hand_lr_ffm": (["--keep", "A", "--keep", "B", "--keep", "C",
                     "--interactions", "AB", "-b", "12"] + FFM_ARGV, HAND_LINES),
    "hand_transform": (["--transform", "w2=Weight(animal)(3.0)", "--linear", "w2",
                        "--keep", "B", "--ffm_k", "2", "--ffm_field", "A",
                        "--ffm_field", "BC"], HAND_LINES),
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_parse_translate_matches_jax(name):
    argv, lines = PIPELINES[name]
    assert_same_pipeline(*translate_both(CSV, argv, lines))


def test_parse_translate_matches_jax_on_synthetic_lines(tmp_path):
    data = synthetic.ensure_dataset(tmp_path, 40)
    csv = (tmp_path / synthetic.NAMESPACE_MAP).read_text()
    lines = data.read_bytes().splitlines(keepends=True)
    assert_same_pipeline(*translate_both(csv, synthetic.serving_argv(), lines))


@pytest.mark.parametrize("line,exc", [
    (b"flush\n", "FlushCommand"), (b"hogwild_load /m.fwt\n", "HogwildLoadCommand"),
    (b"1 |Z nope\n", "ParseError"), (b"x |A a\n", "ParseError")])
def test_in_band_commands_and_errors_match_jax(line, exc):
    raised = []
    for vwmap, parser in ((jvwmap, jparser), (pvwmap, pparser)):
        p = parser.VowpalParser(vwmap.VwNamespaceMap.from_string(CSV))
        with pytest.raises(getattr(parser, exc)) as e:
            p.parse_line(line)
        raised.append(str(e.value))
    assert raised[0] == raised[1]


# -- model-file header, the reply formatter, the embedded engine -------------------


def jax_model_file(tmp_path, name="m.fwt", quantize=False) -> Path:
    vw = make_vw(tmp_path)
    mi = make_mi(vw, FFM_ARGV)
    jmodel = JaxModel(mi)
    params = jax_params(jmodel, seed=31, train_lines=vw_lines(16, seed=32), vw=vw)
    path = tmp_path / name
    jmf.save_model(path, mi, vw, jmodel, params, quantize_weights=quantize)
    return path


def test_header_written_by_jax_reads_equal_in_the_port(tmp_path):
    path = jax_model_file(tmp_path)
    jm, jv = jmf.read_header(path)
    pm, pv = pmf.read_header(path)
    assert config_fields(pm) == config_fields(jm)
    assert config_fields(pv) == config_fields(jv)


def test_header_written_by_the_port_reads_equal_in_jax(tmp_path):
    make_vw(tmp_path)
    pvw, pmi = port_config(tmp_path, FFM_ARGV, optimizer="SGD")
    model = port_model(pmi, {"lr_w": np.zeros(1 << 12, np.float32),
                             "ffm_w": np.zeros(pmi.ffm_weights_len, np.float32)})
    path = tmp_path / "port.fwt"
    pmf.save_model(path, pmi, pvw, model)
    jm, jv = jmf.read_header(path)
    assert config_fields(jm) == config_fields(pmi)
    assert config_fields(jv) == config_fields(pvw)
    head = path.read_bytes()[:64]
    assert head[:8] == jmf.MAGIC + jmf.VERSION.to_bytes(4, "little")
    assert (pmf.MAGIC, pmf.VERSION) == (jmf.MAGIC, jmf.VERSION)


def test_port_builds_its_own_engine():
    lib = native.require()
    path = native.library_path()
    assert path.parent == REPO / "fwumious_wabbit_tpu_torch" / "build"
    assert path.exists() and lib._name == str(path)


def test_format_preds_matches_jax():
    preds = np.concatenate([
        np.random.default_rng(0).random(500).astype(np.float32),
        np.array([0.0, 1.0, 0.5, 1e-7, 0.9999995, 0.0000005, 0.1234565],
                 np.float32)])
    got = native.format_preds(preds)
    assert got is not None and got.count(b"\n") == preds.size
    assert got == jax_native.format_preds(preds)
    assert got == ("\n".join("%.6f" % p for p in preds) + "\n").encode()


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "f16"])
def test_embedded_predictor_matches_jax(tmp_path, quantize):
    path = jax_model_file(tmp_path, quantize=quantize)
    lines = b"".join(vw_lines(200, seed=33))
    got = native.EmbeddedPredictor(f"-i {path}")
    want = jax_native.EmbeddedPredictor(f"-i {path}")
    gp, gc, gs = got.predict_block_mt(lines)
    wp, wc, ws = want.predict_block_mt(lines)
    assert (gc, gs) == (wc, ws) == (len(lines), native.EmbeddedPredictor.BLOCK_OK)
    assert gp.size == 200 and np.abs(gp - 0.5).max() > 1e-3
    np.testing.assert_array_equal(gp, wp)
    line = vw_lines(1, seed=34)[0]
    assert got.predict(line) == want.predict(line)
    got.close()
    want.close()


def test_native_engine_fails_with_the_compiler_message(monkeypatch, tmp_path):
    """Asked for and unbuildable, the engine raises with g++'s message: it
    never falls back to another engine."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ["-DFWT_NO_SUCH",
                                                               "-include", "no_such.h"])
    with pytest.raises(RuntimeError, match="no_such.h"):
        native.EmbeddedPredictor("-i /nonexistent.fwt")
    assert native.format_preds(np.zeros(2, np.float32)) is None
    assert not list((tmp_path / "build").glob("*.so"))


def test_port_builds_its_own_weight_patcher(monkeypatch, tmp_path):
    """The model-diff tool is built from the port's copy of
    weight_patcher.cpp (the JAX package's source, byte for byte) into the
    port's build directory; a build that fails raises with g++'s message
    and leaves no executable."""
    assert ((REPO / "fwumious_wabbit_tpu_torch/native/weight_patcher.cpp").read_bytes()
            == (REPO / "fwumious_wabbit_tpu/native/weight_patcher.cpp").read_bytes())
    exe = native.weight_patcher()
    assert exe.parent == REPO / "fwumious_wabbit_tpu_torch" / "build" and exe.exists()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "PATCHER_FLAGS", native.PATCHER_FLAGS + [
        "-include", "no_such.h"])
    with pytest.raises(RuntimeError, match="no_such.h"):
        native.weight_patcher()
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["weight_patcher.lock"]


@pytest.mark.parametrize("n_table", [2, 4, 8])
def test_mesh_padding_matches_jax(n_table):
    """parallel/mesh.padded_rows is the rule of the JAX package's
    pad_params_for_mesh, at small and large tables."""
    import jax
    import jax.numpy as jnp

    from fwumious_wabbit_tpu.parallel import mesh as jmesh
    from fwumious_wabbit_tpu_torch.parallel import mesh as pmesh

    mesh = jmesh.make_mesh(n_data=8 // n_table, n_table=n_table,
                           devices=jax.devices()[:8])
    for rows in (1, 5, 33, 2048, 4095, 2048 * n_table, 2048 * n_table + 1, 40000):
        padded = jmesh.pad_params_for_mesh(
            None, {"lr_w": jnp.zeros((rows, 128), jnp.float32)}, mesh)
        assert pmesh.padded_rows(rows, n_table) == padded["lr_w"].shape[0], rows


def test_pack_cache_layout_records_cross_packages():
    """A packed layout written by one package's pack cache reads back in
    the other's with the same signature, under the same file format."""
    from fwumious_wabbit_tpu.train import pack_cache as jpc
    from fwumious_wabbit_tpu.train import packed as jpacked
    from fwumious_wabbit_tpu_torch.train import pack_cache as ppc
    from fwumious_wabbit_tpu_torch.train import packed as ppacked

    assert (ppc.PACK_MAGIC, ppc.PACK_VERSION, ppc.PACK_TRAILER) == (
        jpc.PACK_MAGIC, jpc.PACK_VERSION, jpc.PACK_TRAILER)
    bd = {"label": np.zeros(8, np.uint8), "lr_ids": np.zeros((8, 3), np.int32)}
    spec = dict(appends=(("lr_vals", 1.0),), bitpacks=(("lr_ids", 25, 2),),
                row_broadcasts=(("lr_combos", "|i1", (0, 1, -1), 8),),
                vocabs=(("lr_ids", (6, 25, 4), (0, -1, 64), 2),),
                count_tabs=(("lr_counts", "lr_ids", (0, -1, 64)),),
                bit_cols=(("label", 8),))
    jlay, play = jpacked.layout_of(bd, **spec), ppacked.layout_of(bd, **spec)
    assert ppc._layout_to_json(play) == jpc._layout_to_json(jlay)
    assert jpc._layout_from_json(ppc._layout_to_json(play)).signature == play.signature
    assert ppc._layout_from_json(jpc._layout_to_json(jlay)) == play
