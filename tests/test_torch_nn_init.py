"""The port's tower init against the JAX package's: its copies of
``ops/xoshiro.py`` and ``models/ref_offsets.py`` on the golden vectors of
tests/test_nn_init.py and on the originals' outputs, and
``FwModel.init_params`` with a tower bit-equal to JAX's for topologies
one/two/four/five × inits xavier/hu/one/zero, with and without FFM
(tolerance: none, every weight and accumulator equal bit for bit)."""

import numpy as np
import pytest

from fwumious_wabbit_tpu.models import ref_offsets as jax_offsets
from fwumious_wabbit_tpu.models.model import FwModel as JaxModel
from fwumious_wabbit_tpu.ops import xoshiro as jax_xoshiro
from fwumious_wabbit_tpu_torch.models import ref_offsets
from fwumious_wabbit_tpu_torch.models.model import FwModel
from fwumious_wabbit_tpu_torch.ops import xoshiro

from torch_parity import FFM_ARGV, config_fields, make_mi, make_vw, port_config


def test_xoshiro_golden_vectors():
    """tests/test_nn_init.py's anchors: the canonical xoshiro256++ output,
    SplitMix64 seeding and the ziggurat table's head."""
    r = xoshiro.Xoshiro256PlusPlus(0)
    assert r.s[0] == 0xE220A8397B1DCDAF and r.s[1] == 0x6E789E6AA1B965F4
    r.s = [1, 2, 3, 4]
    assert (r.next_u64(), r.next_u64()) == (41943041, 58720359)
    assert abs(xoshiro.ZIG_NORM_X[0] - 3.910757959537090045) < 1e-14
    assert xoshiro.ZIG_NORM_X[1] == xoshiro.ZIG_NORM_R
    assert xoshiro.ZIG_NORM_X == jax_xoshiro.ZIG_NORM_X
    assert xoshiro.ZIG_NORM_F == jax_xoshiro.ZIG_NORM_F


@pytest.mark.parametrize("seed", [0, 100, 2**63 + 5])
def test_xoshiro_draws_match_jax(seed):
    """Raw words, uniform and normal draws: the same numbers as the
    original's from the same seed."""
    a, b = xoshiro.Xoshiro256PlusPlus(seed), jax_xoshiro.Xoshiro256PlusPlus(seed)
    assert [a.next_u64() for _ in range(8)] == [b.next_u64() for _ in range(8)]
    assert ([a.uniform(-0.3, 0.3) for _ in range(64)]
            == [b.uniform(-0.3, 0.3) for _ in range(64)])
    assert ([xoshiro.normal(a, 0.0, 0.7) for _ in range(2000)]
            == [jax_xoshiro.normal(b, 0.0, 0.7) for _ in range(2000)])


@pytest.mark.parametrize("F", [0, 2, 3])
@pytest.mark.parametrize("topology", ["one", "two", "four", "five"])
def test_reference_offsets_match_jax(topology, F):
    layers = [(6, "before", "relu"), (4, "after", "none"), (3, "none", "relu")]
    assert (ref_offsets.reference_nn_offsets(5, F, topology, layers)
            == jax_offsets.reference_nn_offsets(5, F, topology, layers))
    assert ref_offsets.layer_seed(4, 12, 7, 5) == 4 * 12 + 7 + (7 * 5 + 5)


def tower_argv(topology: str, init: str) -> list[str]:
    return ["--nn_layers", "2", "--nn_topology", topology,
            "--nn", "0:width:6", "--nn", f"0:init:{init}",
            "--nn", "0:activation:relu", "--nn", "0:layernorm:before",
            "--nn", "1:width:3", "--nn", f"1:init:{init}"]


@pytest.mark.parametrize("ffm", [True, False], ids=["ffm", "no_ffm"])
@pytest.mark.parametrize("init", ["xavier", "hu", "one", "zero"])
@pytest.mark.parametrize("topology", ["one", "two", "four", "five"])
def test_init_params_bit_equal_to_jax(tmp_path, topology, init, ffm):
    extra = (FFM_ARGV if ffm else []) + tower_argv(topology, init)
    mi = make_mi(make_vw(tmp_path), extra)
    _, pmi = port_config(tmp_path, extra)
    assert config_fields(pmi) == config_fields(mi)
    want = JaxModel(mi).init_params()
    got = FwModel(pmi).init_params("cpu")
    assert set(got) == set(want)
    assert len(got["nn"]) == len(want["nn"]) == 2
    pairs = [(f"nn[{i}]", g, w) for i, (g, w) in enumerate(zip(got["nn"], want["nn"]))]
    pairs.append(("final", got["final"], want["final"]))
    for where, g, w in pairs:
        assert set(g) == set(w) == {"w", "b", "w_acc", "b_acc"}, where
        for key in g:
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]),
                                          err_msg=f"{where}.{key}")
            assert g[key].dtype == g["w"].dtype and g[key].is_contiguous()
    for key in set(got) - {"nn", "final"}:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    if init in ("xavier", "hu"):
        assert np.unique(got["nn"][0]["w"].numpy()).size == got["nn"][0]["w"].numel()
