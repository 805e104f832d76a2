"""The port's sharded train step (fwumious_wabbit_tpu_torch/parallel/) on
gloo groups of 2, 4 and 8 ranks against the JAX sharded step on the 8
virtual CPU devices of tests/conftest.py, at the same meshes: the cases of
tests/test_sharded.py (the three optimizers, with and without the tower,
psum and a2a, a four-step trajectory, the 1×8 table axis, multi-row slabs,
the a2a overflow masking and its counter, the table blocks equal across
the data axis, the padded rows staying zero, the collectives' volume and
estimate_comm_bytes), with the batch-mean cap and the sharded predict step
besides. Tolerances are tests/test_sharded.py's: predictions rtol 1e-6 /
atol 1e-7, tables rtol 1e-5 / atol 1e-7 (assert_case). Without a tower
and outside AdagradFlex, the port's single-device step equals JAX's bit
for bit (test_single_device_step_is_bit_equal_to_jax).

Each world size starts its ranks once per module (a module-scoped fixture,
one process per rank, ``torch.set_num_threads(1)``, every launch with its
own timeout): the ranks run every case of that world in one order, from the
inputs this process writes (the JAX model's own init and numpy batches),
and write back their predictions, stats and table blocks. Each case is
then a test of its own. Run as a script, this file is a rank:
``python tests/test_torch_sharded.py SPEC RANK``."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240
PRED_TOL = {"rtol": 1e-6, "atol": 1e-7}
TABLE_TOL = {"rtol": 1e-5, "atol": 1e-7}
TABLES = ("lr_w", "lr_acc", "ffm_w", "ffm_acc")


# -- the cases: name → (world, mesh, exchange, model, batch, steps, capacity) -------------


def case(world, mesh, exchange, opt="ADAGRAD_LUT", nn=False, k=4, fields=3,
         bits=12, power_t=0.5, B=32, steps=1, capacity=2.0):
    return {"world": world, "mesh": list(mesh), "exchange": exchange,
            "opt": opt, "nn": nn, "k": k, "fields": fields, "bits": bits,
            "power_t": power_t, "B": B, "steps": steps, "capacity": capacity}


CASES = {}
for _ex in ("psum", "a2a"):
    for _opt, _nn in (("ADAGRAD_FLEX", False), ("ADAGRAD_LUT", False),
                      ("SGD", False), ("ADAGRAD_LUT", True)):
        CASES[f"single_{_opt}_{_nn}_{_ex}"] = case(8, (4, 2), _ex, _opt, _nn)
    CASES[f"trajectory_{_ex}"] = case(8, (4, 2), _ex, steps=4)
    CASES[f"multirow_{_ex}"] = case(8, (4, 2), _ex, k=64, bits=16, B=16,
                                    capacity=8.0)
    CASES[f"batch_mean_{_ex}"] = case(8, (4, 2), _ex, power_t=0.0)
    for _mesh in ((4, 2), (2, 4)):
        CASES[f"volume_{_mesh[0]}x{_mesh[1]}_{_ex}"] = case(8, _mesh, _ex, B=64)
    CASES[f"world2_2x1_{_ex}"] = case(2, (2, 1), _ex, nn=True)
    CASES[f"world4_2x2_{_ex}"] = case(4, (2, 2), _ex, nn=True, capacity=8.0)
    CASES[f"world4_2x2_multirow_{_ex}"] = case(4, (2, 2), _ex, k=64, bits=16,
                                               B=16, capacity=8.0)
CASES["deep_1x8"] = case(8, (1, 8), "a2a", B=16, capacity=8.0)
CASES["overflow_0.02"] = case(8, (4, 2), "a2a", B=16, capacity=0.02)
CASES["overflow_8.0"] = case(8, (4, 2), "a2a", B=16, capacity=8.0)
CASES["world2_1x2_a2a"] = case(2, (1, 2), "a2a", nn=True, capacity=8.0)


# -- the JAX side ------------------------------------------------------------------------


def jax_model(c):
    from fwumious_wabbit_tpu.config.model_instance import (
        FeatureComboDesc, ModelInstance, Optimizer)
    from fwumious_wabbit_tpu.config.vwmap import NamespaceDescriptor
    from fwumious_wabbit_tpu.models.model import FwModel

    mi = ModelInstance()  # tests/test_sharded.py build_model
    mi.optimizer = Optimizer[c["opt"]]
    mi.learning_rate = mi.ffm_learning_rate = mi.nn_learning_rate = 0.1
    mi.power_t = mi.ffm_power_t = c["power_t"]
    mi.nn_power_t = 0.5
    mi.bit_precision = mi.ffm_bit_precision = c["bits"]
    mi.ffm_k = c["k"]
    mi.init_acc_gradient = mi.ffm_init_acc_gradient = 0.0
    mi.nn_init_acc_gradient = 0.0
    descs = [NamespaceDescriptor(i) for i in range(c["fields"])]
    mi.feature_combo_descs = [FeatureComboDesc(namespace_descriptors=[d])
                              for d in descs]
    mi.ffm_fields = [[d] for d in descs]
    if c["nn"]:
        mi.nn_config.layers = [{"width": "8", "activation": "relu"}]
        mi.nn_config.topology = "one"
    return FwModel(mi)


def make_batch(model, B=32, L=6, N=6, seed=3) -> dict:
    """tests/test_sharded.py make_batch."""
    rng = np.random.default_rng(seed)
    mi = model.mi
    return {
        "label": rng.integers(0, 2, B).astype(np.float32),
        "importance": np.ones(B, np.float32),
        "lr_ids": (rng.integers(0, 1 << 30, (B, L)) & mi.lr_hash_mask).astype(np.int32),
        "lr_vals": np.ones((B, L), np.float32),
        "lr_combos": rng.integers(0, model.num_combos, (B, L)).astype(np.int32),
        "ffm_ids": (rng.integers(0, 1 << 30, (B, N)) & mi.ffm_hash_mask).astype(np.int32),
        "ffm_vals": np.ones((B, N), np.float32),
        "ffm_fields": rng.integers(0, model.num_fields, (B, N)).astype(np.int32),
    }


def case_batches(model, c) -> list:
    if c["steps"] == 1:
        return [make_batch(model, B=c["B"])]
    return [make_batch(model, B=c["B"], seed=s) for s in range(c["steps"])]


def jax_sharded(name: str) -> dict:
    """The JAX sharded step's predictions per step, final tables (rows of
    the unpadded table), tower weights and drop count for case ``name``."""
    import jax

    from fwumious_wabbit_tpu.parallel import mesh as pmesh
    from fwumious_wabbit_tpu.parallel.sharded import make_sharded_train_step

    c = CASES[name]
    model = jax_model(c)
    n_d, n_t = c["mesh"]
    mesh = pmesh.make_mesh(n_data=n_d, n_table=n_t,
                           devices=jax.devices()[:n_d * n_t])
    params = pmesh.pad_params_for_mesh(model, model.init_params(), mesh)
    params = pmesh.shard_params(params, pmesh.param_sharding(mesh, params))
    step = make_sharded_train_step(model, mesh, exchange=c["exchange"],
                                   capacity_factor=c["capacity"],
                                   with_stats=True)
    preds, dropped = [], 0
    both = c["exchange"] == "a2a"
    for batch in case_batches(model, c):
        params, p, stats = step(params, pmesh.shard_batch(batch, mesh, both_axes=both))
        preds.append(np.asarray(p))
        dropped += int(stats["a2a_dropped"])
    out = {"preds": np.stack(preds), "dropped": dropped}
    init = model.init_params()
    for key in TABLES:
        if key in params:
            out[key] = np.asarray(params[key])[: np.asarray(init[key]).shape[0]]
    if c["nn"]:
        out["nn0_w"] = np.asarray(params["nn"][0]["w"])
        out["final_w"] = np.asarray(params["final"]["w"])
    return out


def port_single(name: str) -> dict:
    """The port's own single-device step (train/step.make_train_step, on
    the CPU) over case ``name``'s batches, from the JAX model's init."""
    import jax

    from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
    from fwumious_wabbit_tpu_torch.convert import params_from_numpy
    from fwumious_wabbit_tpu_torch.models.model import FwModel
    from fwumious_wabbit_tpu_torch.train.step import make_train_step

    c = CASES[name]
    jmodel = jax_model(c)
    model = FwModel(ModelInstance.from_json(jmodel.mi.to_json()))
    model.load_params(params_from_numpy(
        jax.tree.map(np.asarray, jmodel.init_params()), model, "cpu"))
    step = make_train_step(model)
    preds = [step(b).numpy() for b in case_batches(jmodel, c)]
    out = {"preds": np.stack(preds)}
    out.update({k: getattr(model, k).numpy() for k in TABLES
                if k in model._buffers})
    if c["nn"]:
        out["nn0_w"] = model.layers[0].w.numpy()
        out["final_w"] = model.final.w.numpy()
    return out


# -- the port's ranks --------------------------------------------------------------------


def run_world(world: int, tmp: Path) -> dict:
    """Write every case's inputs for ``world`` ranks, run the ranks, and
    return ``{case: {rank: {name: array}}}``."""
    from torch_parity import free_port

    names = [n for n, c in CASES.items() if c["world"] == world]
    for name in names:
        c = CASES[name]
        model = jax_model(c)
        params = {k: np.asarray(v) for k, v in model.init_params().items()
                  if k in TABLES}
        init = model.init_params()
        if c["nn"]:
            params["nn0_w"] = np.asarray(init["nn"][0]["w"])
            params["final_w"] = np.asarray(init["final"]["w"])
        batches = {f"batch{s}_{k}": v
                   for s, b in enumerate(case_batches(model, c))
                   for k, v in b.items()}
        np.savez(tmp / f"{name}.in.npz", **params, **batches)
        (tmp / f"{name}.mi.json").write_text(model.mi.to_json())
    spec = tmp / f"world{world}.json"
    spec.write_text(json.dumps({"cases": {n: CASES[n] for n in names},
                                "dir": str(tmp), "world": world,
                                "port": free_port()}))
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
           "HOME": str(tmp)}
    procs = [subprocess.Popen([sys.executable, __file__, str(spec), str(r)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{out[-4000:]}"
    results = {}
    for r in range(world):
        with np.load(tmp / f"world{world}_rank{r}.npz") as z:
            for key in z.files:
                name, field = key.split("/")
                results.setdefault(name, {}).setdefault(r, {})[field] = z[key]
    return results


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return run_world(8, tmp_path_factory.mktemp("world8"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(4, tmp_path_factory.mktemp("world4"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(2, tmp_path_factory.mktemp("world2"))


@pytest.fixture
def worlds(request):
    return lambda world: request.getfixturevalue(f"world{world}")


def global_table(ranks: dict, key: str, mesh) -> np.ndarray:
    """The whole (padded) table from the blocks of the ranks at data index
    0, in table order."""
    n_d, n_t = mesh
    return np.concatenate([ranks[t][key] for t in range(n_t)])


def assert_case(name: str, ranks: dict) -> None:
    """Every rank's gathered predictions equal; they match the JAX sharded
    step's at PRED_TOL. The tables (padded rows still zero) and the tower
    match the port's own single-device step at TABLE_TOL — the claim of
    tests/test_sharded.py, that sharding changes nothing — and the JAX
    sharded step's at TABLE_TOL."""
    c = CASES[name]
    js, p1 = jax_sharded(name), port_single(name)
    got_preds = ranks[0]["preds"]
    for r in ranks:  # every rank gathered the same global predictions
        np.testing.assert_array_equal(ranks[r]["preds"], got_preds)
    np.testing.assert_allclose(got_preds, js["preds"], **PRED_TOL)
    np.testing.assert_allclose(got_preds, p1["preds"], **PRED_TOL)
    for key in (*TABLES, "nn0_w", "final_w"):
        if key not in js:
            continue
        if key in TABLES:
            got = global_table(ranks, key, c["mesh"])
            n = js[key].shape[0]
            assert np.all(got[n:] == 0.0), f"{key}: a padded row was written"
            got = got[:n]
        else:
            got = ranks[0][key]
        np.testing.assert_allclose(got, p1[key], **TABLE_TOL, err_msg=key)
        np.testing.assert_allclose(got, js[key], **TABLE_TOL, err_msg=key)


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith(
    ("single_", "trajectory_", "multirow_", "batch_mean_", "world"))]
    + ["deep_1x8"])
def test_sharded_step_matches_jax(name, worlds):
    """Predictions of every step, the four tables and the tower against the
    JAX sharded step and the port's single-device step (assert_case)."""
    assert_case(name, worlds(CASES[name]["world"])[name])


@pytest.mark.parametrize("name", ["single_ADAGRAD_LUT_False_psum",
                                  "single_SGD_False_psum", "trajectory_psum",
                                  "multirow_psum", "batch_mean_psum"])
def test_single_device_step_is_bit_equal_to_jax(name):
    """The port's single-device step on the CPU against the JAX package's
    jitted ``make_train_step`` (one device), bit for bit: predictions of
    every step and the four tables. An AdaGrad LUT weight once differed by a
    bucket's rate step (1.10e-6 after one step, 7.42e-6 after four), because
    the plain FFM triangle summed each field's slabs in feature order where
    XLA's dot does not (ops/ffm.field_sums). AdagradFlex (XLA's ``pow``)
    and the tower (XLA's ``dot``) still differ in last bits, within
    TABLE_TOL (ROADMAP §3)."""
    import jax.numpy as jnp

    from fwumious_wabbit_tpu.train.step import make_train_step

    c = CASES[name]
    model = jax_model(c)
    params, preds = model.init_params(), []
    step = make_train_step(model)
    for batch in case_batches(model, c):
        params, p = step(params, {k: jnp.asarray(v) for k, v in batch.items()})
        preds.append(np.asarray(p))
    got = port_single(name)
    np.testing.assert_array_equal(got["preds"], np.stack(preds))
    for key in TABLES:
        if key in params:
            np.testing.assert_array_equal(got[key], np.asarray(params[key]),
                                          err_msg=key)


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
def test_table_blocks_equal_across_the_data_axis(exchange, world8):
    """Every data replica of a table block holds the same bytes after a step
    (tests/test_sharded.py::test_table_shards_replicated_across_data_axis)."""
    name = f"single_ADAGRAD_LUT_False_{exchange}"
    n_d, n_t = CASES[name]["mesh"]
    ranks = world8[name]
    for key in TABLES:
        for t in range(n_t):
            blocks = [ranks[d * n_t + t][key].tobytes() for d in range(n_d)]
            assert all(b == blocks[0] for b in blocks[1:]), (key, t)


def test_a2a_capacity_overflow_is_masked(world8):
    """A capacity of one slot per owner overflows heavily: predictions stay
    probabilities and the tables finite."""
    ranks = world8["overflow_0.02"]
    for r, res in ranks.items():
        p = res["preds"]
        assert np.isfinite(p).all() and ((p > 0) & (p < 1)).all(), r
        for key in TABLES:
            assert np.isfinite(res[key]).all(), (r, key)


def test_a2a_overflow_counter_matches_jax(world8):
    """The drop counter fires on an undersized capacity, with the JAX
    step's count, and reads 0 at 8× slack."""
    tight = world8["overflow_0.02"]
    assert int(tight[0]["dropped"]) > 0
    assert int(tight[0]["dropped"]) == jax_sharded("overflow_0.02")["dropped"]
    assert all(int(res["dropped"]) == int(tight[0]["dropped"]) for res in tight.values())
    assert int(world8["overflow_8.0"][0]["dropped"]) == 0


def test_a2a_volume_shrinks_with_the_table_axis(world8):
    """The collectives' output bytes per rank and step
    (tests/test_sharded.py::test_a2a_comm_volume_shrinks_with_table_axis,
    which reads them off the compiled HLO): a2a's shrink as the table axis
    grows, psum's do not, and at n_table 4 a2a moves less than psum."""
    vol = {name: int(world8[name][0]["collective_bytes"])
           for name in CASES if name.startswith("volume_")}
    a2a_2, a2a_4 = vol["volume_4x2_a2a"], vol["volume_2x4_a2a"]
    psum_2, psum_4 = vol["volume_4x2_psum"], vol["volume_2x4_psum"]
    assert a2a_4 < a2a_2, (a2a_2, a2a_4)
    assert psum_4 >= psum_2 * 0.9, (psum_2, psum_4)
    assert a2a_4 < psum_4, (a2a_4, psum_4)


def test_estimate_comm_bytes_matches_jax():
    from fwumious_wabbit_tpu.parallel import sharded as jsharded
    from fwumious_wabbit_tpu_torch.parallel import sharded as psharded

    for B in (64, 256, 1024):
        for width in (1, 6, 25):
            for mesh in ((4, 2), (2, 4), (1, 8), (8, 1), (2, 2)):
                for ex in ("psum", "a2a"):
                    for cf in (1.0, 2.0, 8.0):
                        assert (psharded.estimate_comm_bytes(B, width, mesh, ex, cf)
                                == jsharded.estimate_comm_bytes(B, width, mesh, ex, cf))
    assert psharded.a2a_capacity(12, 8, 8.0) == jsharded.a2a_capacity(12, 8, 8.0)


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
def test_sharded_predict_matches_jax_predict(exchange, world8):
    """The sharded predict step (``-t`` under a mesh) against the JAX
    package's single-device predict of the same params, before the step."""
    from fwumious_wabbit_tpu.train.step import make_predict_step

    name = f"single_ADAGRAD_LUT_True_{exchange}"
    c = CASES[name]
    model = jax_model(c)
    batch = case_batches(model, c)[0]
    want = np.asarray(make_predict_step(model)(model.init_params(), batch))
    for r, res in world8[name].items():
        np.testing.assert_allclose(res["predict"], want, **PRED_TOL, err_msg=str(r))


@pytest.mark.parametrize("F,k,N,B", [(4, 4, 6, 8), (3, 2, 5, 4), (40, 8, 48, 8)])
def test_exchanged_rows_address_the_same_slabs(F, k, N, B):
    """The slabs the FFM kernels read from an exchange's rows
    (sharded.exchanged_slabs) are the table's own, at one-row and at
    three-row slabs: the forward and backward of the plain versions on the
    rows equal those on the table bit for bit (tests/ffm_cases.py inputs;
    the card's kernels: tests/test_torch_sharded_cuda.py)."""
    import torch

    from ffm_cases import ffm_case
    from fwumious_wabbit_tpu_torch.ops import ffm
    from fwumious_wabbit_tpu_torch.parallel import sharded

    table, ids, vals, fields, spec = ffm_case(F, k, N, B, "both", seed=2)
    t, i, v, f = (torch.from_numpy(a) for a in (table, ids, vals, fields))
    assert (spec.rows_per_slab > 1) == (F * k > 128)
    buf, local_ids, row_spec = sharded.exchanged_slabs(
        t[sharded.slab_rows(i, spec).long()], i, spec)
    assert row_spec.num_rows == B * N * spec.rows_per_slab
    want = ffm.ffm_fused(t, i, v, f, F, k, spec)
    assert torch.equal(ffm.ffm_fused(buf, local_ids, v, f, F, k, row_spec), want)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(ffm.ffm_fused_bwd(g, buf, local_ids, v, f, F, k, row_spec),
                       ffm.ffm_fused_bwd(g, t, i, v, f, F, k, spec))


# -- a rank ------------------------------------------------------------------------------


def _rank_main(spec_path: str, rank: int) -> None:
    import torch

    torch.set_num_threads(1)
    from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
    from fwumious_wabbit_tpu_torch.convert import params_from_numpy
    from fwumious_wabbit_tpu_torch.models.model import FwModel
    from fwumious_wabbit_tpu_torch.parallel import distributed, sharded
    from fwumious_wabbit_tpu_torch.parallel import mesh as pmesh

    spec = json.loads(Path(spec_path).read_text())
    tmp = Path(spec["dir"])
    distributed.initialize(f"127.0.0.1:{spec['port']}", spec["world"], rank, "cpu")
    meshes: dict = {}
    out = {}
    for name, c in spec["cases"].items():
        shape = tuple(c["mesh"])
        if shape not in meshes:  # every rank builds the meshes in one order
            meshes[shape] = pmesh.Mesh(*shape)
        mesh = meshes[shape]
        both = c["exchange"] == "a2a"
        mi = ModelInstance.from_json((tmp / f"{name}.mi.json").read_text())
        with np.load(tmp / f"{name}.in.npz") as z:
            inputs = {k: z[k] for k in z.files}
        model = FwModel(mi)
        init = {k: inputs[k] for k in TABLES if k in inputs}
        if c["nn"]:
            nn = model.init_params("cpu")
            init["nn"] = [{k: v.numpy() for k, v in layer.items()}
                          for layer in nn["nn"]]
            init["final"] = {k: v.numpy() for k, v in nn["final"].items()}
            assert np.array_equal(init["nn"][0]["w"], inputs["nn0_w"])
        model.load_params(params_from_numpy(init, model, "cpu"))
        pmesh.shard_model(model, mesh)
        batches = [{k.split("_", 1)[1]: v for k, v in inputs.items()
                    if k.startswith(f"batch{s}_")} for s in range(c["steps"])]
        if name.startswith("single_ADAGRAD_LUT_True"):
            predict = sharded.make_sharded_predict_step(model, mesh, c["exchange"])
            p = predict(pmesh.shard_batch(batches[0], mesh, both))
            out[f"{name}/predict"] = pmesh.gather_batch(p, mesh, both).numpy()
        step = sharded.make_sharded_train_step(
            model, mesh, c["exchange"], c["capacity"], with_stats=True)
        preds, dropped = [], 0
        sharded.COLLECTIVE_BYTES = 0
        for batch in batches:
            p, stats = step(pmesh.shard_batch(batch, mesh, both))
            preds.append(pmesh.gather_batch(p, mesh, both).numpy())
            dropped += int(stats["a2a_dropped"])
        out[f"{name}/collective_bytes"] = np.array(sharded.COLLECTIVE_BYTES)
        out[f"{name}/preds"] = np.stack(preds)
        out[f"{name}/dropped"] = np.array(dropped)
        for key in TABLES:
            if key in model._buffers:
                out[f"{name}/{key}"] = getattr(model, key).numpy()
        if c["nn"]:
            out[f"{name}/nn0_w"] = model.layers[0].w.numpy()
            out[f"{name}/final_w"] = model.final.w.numpy()
    np.savez(tmp / f"world{spec['world']}_rank{rank}.npz", **out)
    distributed.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    _rank_main(sys.argv[1], int(sys.argv[2]))
