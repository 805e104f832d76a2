"""The reference's ids against the program's own translation of the same
lines (the port's parser and translator, on the CPU)."""

import numpy as np
import pytest

from fwumious_wabbit_tpu_torch import hashing
from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu_torch.ingest import FeatureTranslator, VowpalParser
from portbench import eatrate, features, spec


def test_murmur3_matches():
    rng = np.random.default_rng(0)
    strs = [bytes(rng.integers(32, 127, rng.integers(0, 23)).astype(np.uint8))
            for _ in range(500)]
    for seed in (0, 77, 0xFFFFFFFF):
        assert (features.murmur3_32(strs, seed)
                == np.array([hashing.murmur3_32(s, seed) for s in strs])).all()


@pytest.mark.parametrize("workload", ["lrffm_k8.multipass_b1024", "eatrate_lr.multipass_b32k"])
def test_ids_match_the_program_translation(tmp_path, workload):
    cfg = spec.cell(workload).config
    eatrate.write_dataset(tmp_path / "d.vw", 300, 5)
    cols = eatrate.draw(300, 5)
    vw = VwNamespaceMap.from_dataset_dir(str(tmp_path / "d.vw"))
    mi = ModelInstance.from_cmdline(build_parser().parse_args(cfg["argv"]), vw)
    parser, tr = VowpalParser(vw), FeatureTranslator(mi)
    ids = features.Ids(cfg["model"], 1000, 10)
    lr, ffm = ids.lr(cols), ids.ffm(cols)
    for i, line in enumerate((tmp_path / "d.vw").read_bytes().splitlines()):
        te = tr.translate(parser.parse_line(line))
        assert te.lr_hashes == list(lr[i]) and te.lr_combos == list(range(lr.shape[1]))
        assert te.ffm_hashes == list(ffm[i])
        assert te.ffm_fields == list(range(len(cfg["model"]["ffm_fields"])))
        assert set(te.lr_values) == {1.0} and set(te.ffm_values) <= {1.0}
