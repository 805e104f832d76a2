"""The Criteo-like schema (criteo.py) and the reference of any width
(reference_ffm.py): the text as the program reads it, the ids as the
program hashes them, and the roofline's slabs of two rows."""

import numpy as np
import pytest

from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu_torch.ingest import FeatureTranslator, VowpalParser
from portbench import criteo, reference_ffm, roofline, spec

CELL = "criteo_ffm39.multipass_b32k"


def test_every_line_has_all_39_fields_once(tmp_path):
    cols = criteo.columns({"lines": 2000}, 2 ** 31 + 9)
    criteo.write_text({}, cols, tmp_path / "c.vw")
    lines = (tmp_path / "c.vw").read_text().splitlines()
    assert len(lines) == 2000
    for i in (0, 1, 999, 1999):
        parts = lines[i].split()
        assert parts[0] == ("1" if cols["label"][i] > 0 else "-1")
        assert parts[1::2] == [f"|{ns}" for ns in criteo.NAMESPACES]
        want = [criteo.hex_tokens(cols["tok"][f][cols["idx"][f, i:i + 1]])[0].tobytes().decode()
                for f in range(criteo.FIELDS)]
        assert parts[2::2] == want
    assert (tmp_path / "vw_namespace_map.csv").read_text().splitlines()[13] == "A,C1"


def test_the_draws_follow_the_schema():
    cols = criteo.columns({"lines": 200_000}, 5)
    assert abs((cols["label"] > 0).mean() - criteo.POSITIVE_SHARE) < 0.01
    for f, card in enumerate(criteo.CARD):
        values = cols["tok"][f]
        assert len(np.unique(values)) == len(values) <= card
        assert cols["idx"][f].max() < len(values)
    # a rank's token is the same in every run; the draws are the seed's
    again = criteo.columns({"lines": 200_000}, 5)
    assert all((a == b).all() for a, b in zip(again["tok"], cols["tok"]))
    assert (again["idx"] == cols["idx"]).all()
    other = criteo.columns({"lines": 200_000}, 6)
    assert not (other["idx"] == cols["idx"]).all()


def test_ids_match_the_program_translation(tmp_path):
    cfg = spec.cell(CELL).config
    cols = criteo.columns({"lines": 300}, 7)
    criteo.write_text({}, cols, tmp_path / "d.vw")
    vw = VwNamespaceMap.from_dataset_dir(str(tmp_path / "d.vw"))
    mi = ModelInstance.from_cmdline(build_parser().parse_args(cfg["argv"]), vw)
    parser, tr = VowpalParser(vw), FeatureTranslator(mi)
    ids = criteo.ids(cfg["model"], {})
    lr, ffm = ids.lr(cols), ids.ffm(cols)
    assert lr.shape == (300, 40) and ffm.shape == (300, 39)
    for i, line in enumerate((tmp_path / "d.vw").read_bytes().splitlines()):
        te = tr.translate(parser.parse_line(line))
        assert te.lr_hashes == list(lr[i]) and te.lr_combos == list(range(40))
        assert te.ffm_hashes == list(ffm[i])
        assert te.ffm_fields == list(range(39))


def test_the_roofline_counts_a_slab_of_two_rows_by_its_base():
    """156-float slabs keyed by their base row: two ids in one row are one
    slab, the next row another; 624 B a slab."""
    model = spec.cell(CELL).config["model"]
    F, k = 39, 4
    lr = np.zeros((2, 40), np.int64)
    ffm = np.zeros((2, F), np.int64)
    ffm[0] = 128 * 5 + 4 * np.arange(F) % 128  # row 5
    ffm[1] = 128 * 6  # row 6
    rows = reference_ffm.Rows(model, lr, ffm, np.ones(2, np.int64), 1024, "cpu")
    assert rows.ffm_slab.tolist() == [[5] * F, [6] * F]
    got = roofline.least_per_pass(rows, model, reference_ffm)
    HB = roofline.PEAKS["hbm_bytes_s"]
    E, slab = 2 * F, F * k * 4
    ffm_t = max((E * (4 + slab) + 2 * slab * 4) / HB, E * F * k * 4 / roofline.PEAKS["f32_flops"])
    lr_t = (80 * 8 + 32 * 4) / HB
    assert got["sparse_update"] == pytest.approx(lr_t + ffm_t)
