"""A/B of the port's FFM kernels against an earlier generation of them, on
one CUDA card, in one process: each generation's forward and backward
timed through its own wrapper and through a bare ctypes call, in turns
(earlier, current, current, earlier; four repeats each), at the main path's
shapes with chip_smoke.py's random inputs: serving (F=2 k=8 N=8 B=256),
the default step (N=4 B=1024), B=32,768 (N=4; ids over the whole 2^25
table, and drawn from 3,000 of them as a real file's first lines name few
slabs) and the FFM gate (F=2 k=10 N=2 B=256). Device µs per call from
torch.profiler, wall µs from CUDA events; every output checked against the
current kernels (earlier ones within 1e-5·(1+max|current|)).

The earlier generation is a kernel source with the first C interface of
the fused kernels (``fwt_ffm_fused(table, ids, vals, fields, out, B, N, F,
k, mask, vec16, stream)``) and the ``ops/ffm.py`` that drove it, e.g. from
commit c7c0867:

    mkdir -p .chip_proof/old
    git show c7c0867:fwumious_wabbit_tpu_torch/csrc/ffm_triangle.cu > .chip_proof/old/ffm_triangle.cu
    git show c7c0867:fwumious_wabbit_tpu_torch/ops/ffm.py > .chip_proof/old/ffm.py
    python3 scripts/ffm_kernels_ab.py .chip_proof/old/ffm_triangle.cu .chip_proof/old/ffm.py

Writes chiprun_out/ffm_kernels_ab.json.
"""
import ctypes
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SHAPES = {"serving": ((2, 8, 8, 256), 1 << 25), "default_step": ((2, 8, 4, 1024), 1 << 25),
          "b32768": ((2, 8, 4, 32768), 1 << 25), "ffm_gate": ((2, 10, 2, 256), 1 << 20)}


def earlier(source: Path, wrapper: Path):
    """The earlier kernels built with the port's nvcc flags, and their
    wrapper module driving them."""
    from fwumious_wabbit_tpu_torch.ops.kernels import build

    so = build.BUILD_DIR / "libffm_ab_earlier.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(source)],
                          capture_output=True, text=True)
    cs.check(proc.returncode == 0, f"{source} did not build:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fwt_ffm_fused.argtypes = [P] * 5 + [I] * 6 + [P]
    lib.fwt_ffm_fused_bwd.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.fwt_cuda_error_string.argtypes = [I]
    lib.fwt_cuda_error_string.restype = ctypes.c_char_p
    src = wrapper.read_text()
    src = src.replace("from . import tables", "from fwumious_wabbit_tpu_torch.ops import tables")
    src = src.replace("from .kernels import build", "build = _build")
    mod = types.ModuleType("ffm_earlier")
    mod._build = types.SimpleNamespace(load=lambda name: lib, check=build.check)
    exec(compile(src, str(wrapper), "exec"), mod.__dict__)
    return lib, mod


def bare(lib, args, g, current: bool):
    """A call of the kernel through ctypes alone: every argument but the
    output computed once."""
    import torch

    from fwumious_wabbit_tpu_torch.ops import ffm

    table, ids, vals, fields, F, k, spec = args
    B, N = ids.shape
    stream = torch.cuda.current_stream().cuda_stream
    if current:
        geo = ffm.launch_geometry(table, B, N, F, k, g is not None)
        tail = (geo.tile, geo.chunk, int(geo.staged), geo.vec, geo.smem, stream)
    else:
        tail = (int(table.data_ptr() % 16 == 0), stream)
    head = (table.data_ptr(), ids.data_ptr(), vals.data_ptr(), fields.data_ptr())
    shape = (B, N, F * k) if g is not None else (B, F * (F + 1) // 2)
    fn = lib.fwt_ffm_fused_bwd if g is not None else lib.fwt_ffm_fused
    pre = (g.data_ptr(),) if g is not None else ()
    mask = ffm.slab_mask(spec)

    def call():
        out = torch.empty(shape, device=table.device)
        rc = fn(*pre, *head, out.data_ptr(), B, N, F, k, mask, *tail)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return out
    return call


def main() -> int:
    cs.check(len(sys.argv) == 3, "usage: python3 scripts/ffm_kernels_ab.py "
                                 "EARLIER_SOURCE.cu EARLIER_FFM.py")
    cs.block_jax_package()
    import numpy as np
    import torch

    from fwumious_wabbit_tpu_torch.ops import ffm
    from fwumious_wabbit_tpu_torch.ops.kernels import build
    from fwumious_wabbit_tpu_torch.utils.device import nvidia_smi_line

    card = nvidia_smi_line()
    print(f"device: {card}", flush=True)
    current = build.load("ffm_triangle")
    old_lib, old_ffm = earlier(Path(sys.argv[1]), Path(sys.argv[2]))
    dev = torch.device("cuda:0")
    shapes = {}
    for name, ((F, k, N, B), logical) in SHAPES.items():
        *tensors, spec = cs.kernel_inputs(F, k, N, B, dev, "minus1", True, logical)
        shapes[name] = (*tensors, F, k, spec)
    table, ids, vals, fields, F, k, spec = shapes["b32768"]
    rng = np.random.default_rng(cs.SEED)
    pool = torch.from_numpy(rng.choice(ids.cpu().numpy().ravel(), 3000)).to(dev)
    few = pool[torch.from_numpy(rng.integers(0, 3000, ids.shape)).to(dev)]
    shapes["b32768_few_slabs"] = (table, few.contiguous(), vals, fields, F, k, spec)

    results = {"device": card}
    order = ("earlier_wrapper", "current_wrapper", "current_bare", "earlier_bare")
    for name, args in shapes.items():
        B, F = args[1].shape[0], args[4]
        g = torch.from_numpy(np.random.default_rng(cs.SEED).normal(
            size=(B, F * (F + 1) // 2)).astype(np.float32)).to(dev)
        for direction in ("fwd", "bwd"):
            gb = g if direction == "bwd" else None
            calls = {
                "earlier_wrapper": (lambda: old_ffm.ffm_fused_bwd(g, *args)) if gb is not None
                else (lambda: old_ffm.ffm_fused(*args)),
                "current_wrapper": (lambda: ffm.ffm_fused_bwd(g, *args)) if gb is not None
                else (lambda: ffm.ffm_fused(*args)),
                "current_bare": bare(current, args, gb, True),
                "earlier_bare": bare(old_lib, args, gb, False),
            }
            ref = calls["current_wrapper"]()
            for who, call in calls.items():
                out = call()
                if who.startswith("current"):
                    cs.check(torch.equal(out, ref), f"{who} differs at {name} {direction}")
                else:
                    ok, err, limit = cs.agrees(out, ref)
                    cs.check(ok, f"{who} at {name} {direction}: {err} > {limit}")
            row = {who: {"device_us": [], "wall_us": []} for who in calls}
            for who in (order + order[::-1]) * 2:
                row[who]["device_us"].append(
                    cs.device_us(calls[who], f"{who} {name}", reps=50)["device_us"])
                row[who]["wall_us"].append(
                    cs.time_ms(calls[who], reps=1000 if B <= 1024 else 200) * 1e3)
            results[f"{name} {direction}"] = row
            print(f"{name} {direction}: " + json.dumps(
                {who: {key: min(v) for key, v in r.items()} for who, r in row.items()}),
                flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ffm_kernels_ab.json").write_text(json.dumps(results, indent=1))
    print(f"  on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
