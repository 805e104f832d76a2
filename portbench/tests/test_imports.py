"""Nothing the benchmark runs imports JAX, the JAX package or bench.py:
top-level module names compared whole (the port's own name begins with
the JAX package's)."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "fwumious_wabbit_tpu", "bench"}


def test_sources_import_nothing_forbidden():
    for path in spec.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_a_cpu_run_loads_nothing_forbidden():
    """A whole tiny run in a fresh interpreter, the blocker on: then
    sys.modules is read as the harness reads it."""
    code = (
        "import sys, torch\n"
        "from portbench import run\n"
        "run.environment()\n"
        "from portbench.tests import helpers\n"
        "c, out = helpers.execute('deep_ffm.multipass_b1024')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_loaded())\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=spec.ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    tops, found = r.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "fwumious_wabbit_tpu_torch" in tops
    assert not FORBIDDEN & set(eval(tops))


REFERENCES = sorted({json.loads((spec.ROOT / c["file"]).read_text()).get(
    "reference", spec.DEFAULT_MODULES["reference"]) for c in spec.load_benchmark()["configs"]})


@pytest.mark.parametrize("rel", REFERENCES)
def test_a_reference_imports_nothing_of_the_program(rel):
    """Each configuration's plain reference, imported alone in a fresh
    interpreter, loads neither the program nor anything forbidden."""
    code = ("import sys\n"
            "from portbench import spec\n"
            f"spec.module({rel!r})\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=spec.ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    tops = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not (FORBIDDEN | {"fwumious_wabbit_tpu_torch"}) & tops


def test_the_blocker_refuses_whole_names_only():
    b = run._Blocker()
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen", "fwumious_wabbit_tpu.ops", "bench"):
        try:
            b.find_spec(name)
        except ImportError:
            continue
        raise AssertionError(name)
    for name in ("fwumious_wabbit_tpu_torch", "fwumious_wabbit_tpu_torch.ops", "benchmark", "jaxtyping"):
        assert b.find_spec(name) is None
