import numpy as np
import pytest

from fwumious_wabbit_tpu_torch import synthetic
from portbench import eatrate


@pytest.mark.parametrize("seed,rows", [(1, 1000), (2 ** 31 + 11, 200_123)])
def test_matches_the_port_generator_byte_for_byte(tmp_path, seed, rows):
    synthetic.generate_dataset(tmp_path / "a.vw", rows, seed=seed)
    eatrate.write_dataset(tmp_path / "b.vw", rows, seed)
    assert (tmp_path / "a.vw").read_bytes() == (tmp_path / "b.vw").read_bytes()


def test_columns_render_the_text(tmp_path):
    cols = eatrate.draw(500, 3)
    toks = eatrate.tokens()
    eatrate.write_dataset(tmp_path / "c.vw", 500, 3)
    lines = (tmp_path / "c.vw").read_text().splitlines()
    for i in (0, 17, 499):
        parts = lines[i].split()
        assert parts[0] == str(cols["label"][i])
        assert parts[2] == toks["A"][cols["a"][i]]
        assert parts[4] == toks["B"][cols["b"][i]]
        assert parts[6::2] == [toks[ns][v] for ns, v in
                               zip(eatrate.random_namespaces(10), cols["rand"][i])]
    assert set(np.unique(cols["label"])) <= {-1, 1}
