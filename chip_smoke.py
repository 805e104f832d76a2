#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (fwumious_wabbit_tpu_torch) on one
CUDA card: the quickest proof that the port builds, serves and trains on the
GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases, each raising on failure (exit code 1, and no result line):

0. an import hook refuses jax, jaxlib and the JAX package
   fwumious_wabbit_tpu before the port is imported; the daemon and every
   CLI run below run in this process, under it, and the run fails if any
   of them was imported;
1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from csrc/ with nvcc (sm_90a), one nvcc per
   source, all started together, and beside them the port's C++ host
   engine (g++, native/);
3. and 4. the fused FFM kernels (the slab gather inside the forward and the
   backward) against their plain PyTorch versions — tables.gather, then
   the triangle and torch autograd of it — at KERNEL_SHAPES and BWD_SHAPES:
   F=2 k=8 over a table of the main path's full width, the others over
   2^16-float tables, one-row slabs and F=40 k=8's three-row slabs, both
   padding forms, duplicate ids, 16-byte and 4-byte loads, and the FFM
   gate's F=2 k=10 N=2 B=256 over its own table's width (the shared-memory
   path, 4-byte loads whatever the alignment); tolerance
   max|kernel−plain| ≤ 1e-5·(1+max|plain|) in f32 with TF32 off, padded
   positions of the gradient exactly 0, reruns bit-identical;
5. the sparse AdaGrad update kernel against the plain version
   (ops/adagrad.apply_rows_plain) on the card: LUT, flex and SGD; power_t
   0, 0.5 and 0.25; uniform and duplicate-heavy ids; empty stretches between
   occupied rows; padding ids = R; and one full-width case (the LR table's
   262,144 rows, 15,360 Zipf-drawn ids); then at the inputs the train step
   gives it: one full-width B=1024 step's LR and FFM (rid, grows) on clones
   of the model's own tables; acc within rtol 1e-5, atol 1e-6 (at the
   step's shapes also within 1e-4 relative), w within atol 1e-6 plus rtol
   1e-5 of the magnitudes summed into it (update_agrees); the kernel's tile
   schedule: runs of T−1, T, T+1, 2T and 2T+1 positions at every offset of
   a tile, and a 6,144-position run whose two runs must be bit-identical;
   distinct ids, where LUT (power_t 0, 0.5, 0.25) and SGD must equal plain
   bit for bit; the plain LUT rate on the card against build_lut's table
   over all 2048 buckets, bit for bit; both versions timed at the Zipf case
   and at the step's two shapes (wall per call from CUDA events, and the
   device time of the update kernels and of the sort from torch.profiler;
   the kernel table's ms and plain_ms are per step, LR + FFM);
6. the serving path at full width — the LR+FFM k=8 configuration of
   fwumious_wabbit_tpu_torch/synthetic.py (-b 25, --ffm_bit_precision 25,
   keep A..L, --interactions AB, fields A and B) over its 10k-line synthetic
   dataset, random weights from a seed, written with the port's save_model:
   the daemon (the port's CLI, on a thread of this process) answers 64
   request/response lines, a further 1000 timed ones, a 4096-line pipelined
   burst, then hot-swaps a second model (hogwild_load) and answers again;
   then ``-t -i`` predict through the CLI over the 10k-line file. Every
   reply and prediction must equal the port's plain path — ``-t -i``
   through the same CLI with ``--fwt_platform cpu``, from the same model
   file — within 2e-6;
7. training at full width through the CLI: the same configuration with its
   AdaGrad state (``synthetic.training_config``: AdagradLUT, power_t 0, the
   batch-mean cap), the 10k-line file at ``--fwt_batch_size 1024`` (10
   steps), with ``-p`` and ``-f --save_resume``. First the Python-ingest
   path (``--fwt_no_native``) on the card and again with ``--fwt_platform
   cpu``: the predictions within 1e-5 per line, the four tables of the two
   model files within 1e-5·(1+max|cpu|). Then the default path (the C++
   ingest, K=8 packed superbatches, bitpack and vocab auto, the pinned
   transfer stage) on the card: against the ``--fwt_no_native`` card run,
   predictions within one unit of the -p file's sixth decimal and tables
   within 1e-5·(1+max|·|), with whether both are bit-identical; and against
   itself with ``--fwt_platform cpu`` within the bounds above;
7b. bench.py's "text-train 1M" row: the 1,000,000-line Eat-Rate file
   (``synthetic.ensure_dataset``, seed 1, written by a child process that
   starts after phase 2 and runs beside phases 3–7; its wait timed) trained
   through the CLI with ``-p`` on the default path; then its first 200,000
   lines (the same lines) five times — ``--fwt_vocab off``,
   ``--fwt_bitpack off --fwt_vocab off``, as is, then with
   ``--fwt_pack_cache on`` twice, recording the producer's stream and
   replaying it, each of these two within one unit of the -p file's sixth
   decimal of the 1M run's first 200,000 predictions — each with the ex/s
   of the CLI's Elapsed line, the in-run counters (FWT_COUNTERS_OUT:
   producer busy/stall, transfer busy/starve, consumer starve, dispatch,
   fetch wait, CPU per thread) and the kernels' launches per step; then a
   torch.profiler window of 8 packed superbatches (64 steps) of the
   default layout on a fresh model: wall, device busy, device kernels and
   the idle share per step, and unpack_row's device kernels per
   superbatch; then the three kernels against their plain versions at one
   packed step's own inputs (B=1024, the C++ ingest's widths, combos in
   the LR ids, the cached ones for the FFM values) within the bounds of
   phases 4 and 5, each timed beside plain, with its bytes and bound;
7c. tower training at full width: the same tables with BASELINE config
   3's tower (``synthetic.tower_training_config``: one ReLU layer of 16,
   topology one), TF32 asserted off first; the 10k-line file at B=1024
   with ``-p`` and ``-f --save_resume`` on ``--fwt_no_native`` and on the
   default path, each on the card against the same CLI with
   ``--fwt_platform cpu`` (predictions within 1e-5 per line; the four
   tables and every tower w, b, w_acc, b_acc within 1e-5·(1+max|cpu|)),
   and the default path against ``--fwt_no_native`` on the card (within one
   unit of the -p file's sixth decimal, with whether both are
   bit-identical); all three kernels launched on each; then ``-t -i`` of
   the saved tower model on the card against the CPU, and the daemon
   serving it answering 64 lines, within 2e-6; and the fused FFM backward
   against its plain version at one tower step's own cotangent (the
   ``g_x[:, C:]`` slice, which differs across the row);
7d. the tower's rate: one 1M-line default-path run of the tower model
   (ex/s, in-run counters, launches per step), and a profiler window of 64
   packed tower steps (device busy, device kernels and the idle share per
   step; the tower's kernels per step against 7b's window);
7e. the record cache over the 1M file: a recording run (``-c
   --fwt_pack_cache off``) and a reading run of the same flags, their
   predictions bit-identical and within one unit of the -p file's sixth
   decimal of 7b's 1M run; the codec, the cache's bytes and both runs' ex/s;
   then ``--build_cache_without_training`` on the 10k file, whose cache
   equals the one a recording run writes for that file;
7f. ``--convert_inference_regressor`` of phase 7's default-path model
   (538,968,064 bytes of tables with their AdaGrad state), as is and with
   ``--weight_quantization``, on the card and with ``--fwt_platform cpu``:
   the two files byte-equal; each converted file's ``-t -i`` on the card
   and on the embedded C++ engine (``--fwt_serve_engine native``) over the
   10k file within 2e-6 of the unconverted model's plain predictions
   (quantized: within 5e-3, the JAX package's quantization tests' bound)
   and of each other; then the weight patcher's C++ tool, built at first
   use, between phase 7's two default-path model files (card and CPU):
   ``recreate`` rebuilds the second byte for byte; its time and the diff's
   size; and the Python path on two small models, its payload equal to
   the C++ tool's;
7g. the sharded step (parallel/sharded.py) on an NCCL group of one rank,
   mesh 1×1: psum and a2a over 10 full-width B=1024 steps of the LR+FFM
   training configuration, and a2a with the tower, each against
   ``make_train_step`` on the card over the same batches: predictions
   within 1e-6, every table and tower tensor within 1e-5·(1+max|·|), with
   whether they are bit-identical, the kernels' launches per step and the
   wall time per step beside the plain step's;
8. the fused FFM kernels at the main path's inputs (the serving model's
   table, the data's first 256 and 1024 lines as the CLI batches them):
   wall time per call from CUDA events and device time per call from
   torch.profiler, for the forward at B=256 and B=1024 and the backward at
   B=1024, beside their plain versions and tables.gather alone, with each
   call's bound (the bytes its inputs need at 3.35 TB/s);
9. a layer breakdown of the serving path (with the device kernels per
   256-line batch) and of one full-width train step (with the kernels'
   launches per step);
10. the learning-quality gates of ``python -m fwumious_wabbit_tpu_torch.gates
   short`` on the card (their data written by 7b's child process after
   the 1M file): the FFM gate (LR + FFM k=10, SGD, B=256, 30,000 train
   lines, convert, ``-t`` on test-hard.vw from both files; balanced
   accuracy > 0.80, inference == full on every line) and gate 3 (the
   Eat-Rate LR model at B=16,384, 200k/50k lines; test logloss in (0.5,
   0.7491 + 0.02)); each again with ``--fwt_platform cpu``, the card's
   predictions within 1e-5 per line of the CPU's and its model file's
   tables within 1e-5·(1+max|cpu|), the FFM gate's inference file
   byte-equal to the CPU's convert of the card's own model; the kernels'
   launches on each gate run; and the update kernel against plain at one
   gate-3 step's own LR inputs (K = 229,376), timed, with its bytes and
   bound;
11. the one-command mesh (parallel/launch.py): a mesh that does not cover
   the host's cards (``--fwt_table_axis 4`` on fewer than four cards, else
   one more than their count) exits 1, names the flags and the card count,
   and writes nothing; on a host of four or more cards, ``python -m
   fwumious_wabbit_tpu_torch.multicard``'s runs a (``--fwt_data_axis 4``,
   psum, and its explicit four-rank form), b (``--fwt_table_axis 4``, a2a)
   over 7b's 1M-line file and f (Eat-Rate gate 4 on four cards, 10M/10M at
   B=32,768) through the one-command CLI, each against the same CLI on one
   card within multicard's bounds, and h (the deployment chain of phase 12
   with v1 and v2 trained on a 2×2 a2a mesh, each held to one card's, and
   served by one daemon on card 0), each rank's launches read from its
   counters (a rank process starts with every count at 0) and every kernel
   of its path launched on every rank; on fewer cards one line says that
   the four-card phase needs four;
12. the deployment chain (fwumious_wabbit_tpu_torch/deployment.py) at the
   full width of the LR+FFM k=8 configuration: v1 trained on the first
   500,000 lines of 7b's 1M file and v2 on the last 500,000 from ``-i v1
   --save_resume`` (the default path, the kernels' launches over both);
   both converted with ``--weight_quantization``, the patcher's diff
   v1q→v2q and ``recreate``, byte-equal to v2q, with sizes and seconds; a
   daemon started without ``--foreground`` on v1q (its own double fork,
   found by its port; on no answer within 60 s the same command runs 30 s
   with ``--foreground`` and its stderr is printed); a run of 8
   request/response and 4 pipelined clients with no swap, then the same
   clients while a swapper alternates ``hogwild_load`` of v1q and the
   recreated v2q 20 times: every reply well-formed, one per line in order,
   within 2e-6 of the CPU plain prediction of its line under v1q or v2q
   (the share of probe lines on which they differ printed); after the last
   swap 64 replies on a fresh connection within 2e-6 of ``-t -i`` of the
   recreated v2q on the device engine and the native engine and of the
   CPU; SIGTERM ends the daemon, which writes its launches (the FFM
   forward must have launched beyond its warm-up) and the card's bytes
   allocated in it after each swap (read once no prediction holds an
   earlier model): those after swap 4 and swap 20 within one model's
   table bytes, its peak beside three models'.

Each main path (6, the two training paths of 7, each run of 7b, the two
tower paths of 7c, the 1M run of 7d, both runs of 7e, the three sharded
runs of 7g, every CLI run of the gates in 10, and 12's training pair, its
daemon — a process that starts with every count at 0 — and its ``-t -i``)
runs with the
kernels' launch counters set to 0 just before it and read just after: the
FFM forward must have launched in serving, all three kernels in each
training path. Each phase prints its seconds. The dataset's child process
is ended before the script exits, whatever the outcome. The script prints the kernel table as JSON
(each kernel's launches, error, times, bound, launches per serving batch;
per train step from the 10k --fwt_no_native run and per packed train
step from the first 1M default run, both main paths; its launches on the
10k default path; and its error, times, bytes and bound at the default
path's step, ``default_path_step``; its launches per tower step and per
sharded step of each 7g run; its launches on the gates' runs and per
gate training step, and the update's error, times, bytes and bound at
the gate-3 step; on four cards, its launches per four-card step of
phase 11's runs; no single
PyTorch call computes any of the three, so library_ms is null), the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. It needs
one card and no network.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016
# the FFM gate's F, k, N, B (gates.py): F·F·k = 40 floats per example take
# the kernels' shared-memory path, with 4-byte loads (k % 4 != 0)
GATE_SHAPE = (2, 10, 2, 256)
KERNEL_SHAPES = [(2, 8, 8, 256), (4, 4, 6, 8), (16, 8, 12, 16), (3, 2, 5, 4),
                 GATE_SHAPE]
REPLY_ATOL = 2e-6  # tests/test_serving.py:176
# the FFM backward's shapes: the forward's, the training shape, and a model
# whose contra tensor needs more than 48 KB of shared memory
BWD_SHAPES = KERNEL_SHAPES + [(2, 8, 8, 1024), (40, 8, 48, 8)]
TRAIN_BATCH = 1024
TRAIN_ATOL = 1e-5  # card vs CPU: f32 sums in other orders (PERF.md)
# one unit of the -p file's sixth decimal, and the float error of reading it
PRED_UNIT = 1e-6 * (1 + 1e-6)


class SmokeError(RuntimeError):
    pass


PHASE_SECONDS: dict = {}
CHILDREN: list = []  # processes this script started; ended before it exits


@contextlib.contextmanager
def phase(name: str):
    """Times one phase and prints its seconds when it ends."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0
        print(f"phase {name}: {PHASE_SECONDS[name]:.2f} s", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# -- the import blocker -----------------------------------------------------------

BLOCKED = ("jax", "jaxlib", "fwumious_wabbit_tpu")  # top-level names, exactly


class BlockJaxPackage:
    """An import hook that refuses jax, jaxlib and the JAX package: the
    port must run without them. Installed before the port is imported;
    the daemon and every CLI run of this script run in this process."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"chip_smoke.py blocks {name}: the port imports "
                              f"nothing of jax or of the JAX package")
        return None


def block_jax_package() -> None:
    sys.meta_path.insert(0, BlockJaxPackage())
    check(not [m for m in sys.modules if m.split(".")[0] in BLOCKED],
          "jax or the JAX package was imported before the blocker")


# -- phases 3 and 4: the fused FFM kernels against their plain versions -----------


def kernel_inputs(F, k, N, B, device, padding, aligned=True, logical=1 << 16):
    """``(table, ids, vals, fields, spec)`` on the card: a table of
    ``logical`` floats in the layout of F·k-float slabs (one row up to 128
    floats, whole rows above), random weights at a trained model's scale;
    ids spread over the table, each example's second id a repeat of its
    first and every other example starting with example 0's first id;
    ``padding`` "minus1" (field −1) or "val0" (Batcher's: field 0, value 0);
    ``aligned=False`` puts the table 4 bytes off a 16-byte boundary, so the
    kernels take 4-byte loads."""
    import numpy as np
    import torch

    from fwumious_wabbit_tpu_torch.ops import tables

    rng = np.random.default_rng(SEED + F * 1000 + k * 100 + N)
    spec = tables.make_spec(logical, F * k)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + F * 1000 + k)
    table = torch.randn((spec.num_rows, tables.LANE), generator=gen,
                        device=device) * 0.1
    if not aligned:
        buf = torch.empty(table.numel() + 1, device=device)
        buf[1:] = table.reshape(-1)
        table = buf[1:].view(table.shape)
    top = (spec.padded_size if spec.rows_per_slab == 1
           else (spec.num_rows - spec.rows_per_slab + 1) * tables.LANE)
    ids = rng.integers(0, top, (B, N)).astype(np.int32)
    if N > 1:
        ids[:, 1] = ids[:, 0]
    ids[1::2, 0] = ids[0, 0]
    vals = rng.uniform(0.5, 2.0, (B, N)).astype(np.float32)
    fields = rng.integers(0, F, (B, N)).astype(np.int32)
    pad = rng.random((B, N)) < 0.3
    if padding == "minus1":
        fields[pad] = -1
    else:
        fields[pad] = 0
        vals[pad] = 0.0
    rest = tuple(torch.from_numpy(a).to(device) for a in (ids, vals, fields))
    return (table, *rest, spec)


def time_ms(fn, reps: int = 2000) -> float:
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_PAD_S = 0.05  # idle host time at each end of a profiler window
PROFILE_TRIES = 3


def device_rows(run, what: str) -> tuple:
    """``(rows, out)``: ``out`` what ``run()`` returned, and ``rows`` the
    device kernels torch.profiler saw while it ran, as ``(key, device µs
    in all, count)``; device-side events only, since the aten ops that
    launched them carry the same time again. The profiler keeps a device
    record only when its timestamp, converted to the host's clock, falls
    inside the window, so each window is padded with PROFILE_PAD_S of idle
    host time at both ends: a window of a few hundred µs is otherwise lost
    whole to a small offset between the clocks. A window that still holds
    no device time is run again, up to PROFILE_TRIES windows, each
    printed; then the phase fails."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(PROFILE_PAD_S)
            out = run()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        rows = [(e.key, float(getattr(e, "self_device_time_total", 0.0) or 0.0), e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(dt for _, dt, _ in rows) > 0:
            return rows, out
        print(f"profiler: no device time in {what} (window {attempt} of "
              f"{PROFILE_TRIES})", flush=True)
    raise SmokeError(f"the profiler saw no device time in {what} in "
                     f"{PROFILE_TRIES} windows")


def device_us(call, what: str, reps: int = 50) -> dict:
    """Device time per call of ``call`` from torch.profiler, with the
    device kernels it launches per call and its three largest kernels."""
    import torch

    call()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            call()

    rows, _ = device_rows(run, what)
    return {"device_us": sum(dt for _, dt, _ in rows) / reps,
            "kernels_per_call": sum(n for _, _, n in rows) / reps,
            "largest": sorted(((round(dt / reps, 3), key[:50]) for key, dt, _ in rows),
                              reverse=True)[:3]}


def agrees(got, ref) -> tuple:
    """``(ok, max_abs_err, bound)``: within 1e-5·(1+max|plain|), finite and
    of plain's shape."""
    import torch

    err = (got - ref).abs().max().item() if got.numel() else 0.0
    bound = 1e-5 * (1.0 + (ref.abs().max().item() if ref.numel() else 0.0))
    ok = (got.shape == ref.shape and bool(torch.isfinite(got).all())
          and err <= bound)
    return ok, err, bound


def kernel_phase(device, ffm_sizes: dict) -> dict:
    """The fused forward and backward against their plain versions (the
    gather, then the triangle and torch autograd of it) at every shape of
    BWD_SHAPES: real tables of both layouts (F=2 k=8 at the main path's
    full-width FFM table and F=2 k=10 at the FFM gate's, ``ffm_sizes[(F,
    k)]`` floats; F=40 k=8 slabs of three rows),
    both padding forms, duplicate ids, 16-byte and 4-byte loads; padded
    positions of the gradient exactly 0; a rerun bit-identical."""
    import numpy as np
    import torch

    from fwumious_wabbit_tpu_torch.ops import ffm

    worst = {"fwd": 0.0, "bwd": 0.0}
    for F, k, N, B in BWD_SHAPES:
        logical = ffm_sizes.get((F, k), 1 << 16)
        errs = {"fwd": 0.0, "bwd": 0.0}
        for padding in ("minus1", "val0"):
            for aligned in (True, False):
                table, ids, vals, fields, spec = kernel_inputs(
                    F, k, N, B, device, padding, aligned, logical)
                what = f"F={F} k={k} N={N} B={B} {padding} aligned={aligned}"
                got = ffm.ffm_fused(table, ids, vals, fields, F, k, spec)
                torch.cuda.synchronize()
                ref = ffm.ffm_fused_reference(table, ids, vals, fields, F, k, spec)
                ok, err, bound = agrees(got, ref)
                check(ok, f"fused forward disagrees with plain at {what}: "
                          f"{err} > {bound}")
                again = ffm.ffm_fused(table, ids, vals, fields, F, k, spec)
                check(torch.equal(got, again), f"fused forward reruns differ at {what}")
                errs["fwd"] = max(errs["fwd"], err)
                rng = np.random.default_rng(SEED + B + N)
                g = torch.from_numpy(rng.normal(size=(B, F * (F + 1) // 2))
                                     .astype(np.float32)).to(device)
                dgot = ffm.ffm_fused_bwd(g, table, ids, vals, fields, F, k, spec)
                torch.cuda.synchronize()
                dref = ffm.ffm_fused_bwd_reference(g, table, ids, vals, fields,
                                                   F, k, spec)
                ok, err, bound = agrees(dgot, dref)
                check(ok, f"fused backward disagrees with plain at {what}: "
                          f"{err} > {bound}")
                pad = (fields < 0) | (fields >= F) | (vals == 0)
                check(int(torch.count_nonzero(dgot[pad])) == 0,
                      f"fused backward moves padded positions at {what}")
                dagain = ffm.ffm_fused_bwd(g, table, ids, vals, fields, F, k, spec)
                check(torch.equal(dgot, dagain), f"fused backward reruns differ at {what}")
                errs["bwd"] = max(errs["bwd"], err)
                del table
        print(f"kernel ffm_fused F={F} k={k} N={N} B={B} ({logical} floats, "
              f"rows per slab {spec.rows_per_slab}; both paddings, 16- and "
              f"4-byte loads): max_abs_err forward {errs['fwd']!r}, backward "
              f"{errs['bwd']!r} (bound 1e-5·(1+max|plain|)); reruns "
              f"bit-identical", flush=True)
        worst = {key: max(worst[key], errs[key]) for key in worst}
    torch.cuda.empty_cache()
    return worst


H100_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over its memory rate or
    f32 operations over its peak, the larger."""
    t_bytes, t_ops = nbytes / H100_BYTES_S, ops / H100_F32_FLOPS
    return {"bytes": int(nbytes), "ops": int(ops),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ffm_work(ids, vals, fields, F, k, spec, backward: bool) -> dict:
    """The bound of one fused call on these inputs: ids, values and fields
    read once; each distinct slab that a position needs (field in [0, F),
    value ≠ 0) read once; the triangle (or g_out) once; d emb written once
    (backward). Operations: the contra sums (2·F·k per needed position),
    the self terms or the gradient, and the triangle's dot products."""
    import torch

    from fwumious_wabbit_tpu_torch.ops import ffm

    B, N = ids.shape
    T = F * (F + 1) // 2
    need = (fields >= 0) & (fields < F) & (vals != 0)
    slabs = int(torch.unique((ids.long() & ffm.slab_mask(spec))[need]).numel())
    used = int(need.sum())
    nbytes = B * N * 12 + slabs * F * k * 4 + B * T * 4
    ops = used * 2 * F * k + B * T * 2 * k
    if backward:
        nbytes += B * N * F * k * 4
        ops += B * N * F * k * 3
    else:
        ops += used * 3 * k
    return bound(nbytes, ops)


def ffm_timing(path: Path, data: Path, device) -> dict:
    """The fused kernels at the main path's inputs: the serving model's
    full-width FFM table and the first 256 and 1024 lines of the data as the
    CLI batches them. Per call, wall time from CUDA events (plain, kernel,
    kernel, plain) and device time from torch.profiler, for the fused
    forward at B=256 and B=1024 and the fused backward at B=1024; beside
    them tables.gather alone at the same inputs (the first half of the plain
    version, which the unfused kernels needed before them)."""
    import numpy as np
    import torch

    from fwumious_wabbit_tpu_torch.ingest import Batcher, FeatureTranslator, VowpalParser
    from fwumious_wabbit_tpu_torch.ops import ffm, tables
    from fwumious_wabbit_tpu_torch.persistence.model_file import load_model

    mi, vw, model = load_model(path, immutable=True, device=device)
    parser, ft = VowpalParser(vw), FeatureTranslator(mi)
    tes = [ft.translate(parser.parse_line(line))
           for line in data.read_bytes().splitlines(True)[:TRAIN_BATCH]]
    table, spec, F, k = model.ffm_w, model.ffm_spec, model.num_fields, model.ffm_k
    out = {}
    for B in (256, TRAIN_BATCH):
        b = Batcher(B).make_batch(tes[:B], pad_to_batch=True)
        ids, vals, fields = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                             for a in (b.ffm_ids.astype(np.int32), b.ffm_vals,
                                       b.ffm_fields.astype(np.int32)))
        args = (table, ids, vals, fields, F, k, spec)
        ok, _, _ = agrees(ffm.ffm_fused(*args), ffm.ffm_fused_reference(*args))
        check(ok, f"fused forward disagrees with plain at the main path's B={B}")
        calls = {"fwd": lambda: ffm.ffm_fused(*args),
                 "fwd_plain": lambda: ffm.ffm_fused_reference(*args),
                 "gather": lambda: tables.gather(table, ids, spec)}
        if B == TRAIN_BATCH:
            g = torch.from_numpy(np.random.default_rng(SEED).normal(
                size=(B, F * (F + 1) // 2)).astype(np.float32)).to(device)
            ok, _, _ = agrees(ffm.ffm_fused_bwd(g, *args),
                                 ffm.ffm_fused_bwd_reference(g, *args))
            check(ok, f"fused backward disagrees with plain at the main path's B={B}")
            calls["bwd"] = lambda: ffm.ffm_fused_bwd(g, *args)
            calls["bwd_plain"] = lambda: ffm.ffm_fused_bwd_reference(g, *args)
        wall = {name: [] for name in calls}
        for order in ("plain", "kernel", "kernel", "plain"):
            for name, call in calls.items():
                if ("plain" in name) == (order == "plain"):
                    wall[name].append(time_ms(call, reps=100 if "plain" in name else 1000))
        res = {"N": int(ids.shape[1]),
               "wall_us": {name: min(v) * 1e3 for name, v in wall.items()},
               "device": {name: device_us(call, f"{name} at B={B}")
                          for name, call in calls.items()},
               "fwd_bound": ffm_work(ids, vals, fields, F, k, spec, False)}
        if B == TRAIN_BATCH:
            res["bwd_bound"] = ffm_work(ids, vals, fields, F, k, spec, True)
        out[B] = res
        print(f"timing: ffm_fused at the main path's B={B} N={res['N']} F={F} "
              f"k={k}: " + json.dumps(res), flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def update_case(R, K, seed, device, dup_heavy=False, pad=0, zipf=False):
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + seed)
    if zipf:
        rid = (rng.zipf(1.3, K) - 1) % R
    else:
        rid = rng.integers(0, 8 if dup_heavy else R, K)
    rid = rid.astype(np.int32)
    rid[K - pad:] = R  # padding ids
    g = (rng.normal(size=(K, 128)) * 0.1).astype(np.float32)
    w = rng.normal(size=(R, 128)).astype(np.float32)
    acc = rng.uniform(0, 2, size=(R, 128)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (w, acc, rid, g))


def run_both(w, acc, rid, g, kind, *rate_args) -> tuple:
    """``((w, acc) of the kernel, (w, acc) of the plain version)``, each
    updated in place from its own copy of ``(w, acc)``; ``rate_args`` are
    lr, power_t and the initial acc gradient. acc is None for SGD."""
    import torch

    from fwumious_wabbit_tpu_torch.ops import adagrad, sparse_update

    has_acc = kind != adagrad.OPT_SGD
    w1, a1 = w.clone(), acc.clone() if has_acc else None
    sparse_update.sparse_adagrad_update(w1, a1, rid, g, *rate_args, kind)
    torch.cuda.synchronize()
    w2, a2 = w.clone(), acc.clone() if has_acc else None
    adagrad.apply_rows_plain(w2, a2, rid, g, kind, *rate_args)
    return (w1, a1), (w2, a2)


def update_agrees(w0, acc0, rid, g, kernel, plain, kind, *rate_args) -> tuple:
    """``(ok, max_abs_err, n)`` of the kernel's ``(w, acc)`` against the plain
    version's, both updated from ``(w0, acc0)``. acc: rtol 1e-5, atol 1e-6
    (its terms g² are all positive, so the sum is as well conditioned as
    acc itself). w: atol 1e-6 plus rtol 1e-5 of the magnitudes summed into
    the weight, |w0| + rate·Σ|g|: a long run's update can cancel w to near 0,
    and then both f32 sums, taken in other orders, keep an error of the
    order of their terms, not of the result. Where nothing cancels this is
    rtol 1e-5 of |w|; a dropped or doubled term still exceeds it. ``n``
    counts the weights that only this wider bound admits."""
    import torch

    from fwumious_wabbit_tpu_torch.ops import adagrad

    (w1, a1), (w2, a2) = kernel, plain
    mass = torch.zeros_like(w0)  # −rate·Σ|g| per weight: the plain update of |g|
    adagrad.apply_rows_plain(mass, None if acc0 is None else acc0.clone(), rid,
                             g.abs(), kind, *rate_args)
    ok = bool(((w1 - w2).abs() <= 1e-6 + 1e-5 * (w0.abs() + mass.abs())).all())
    n = int((~torch.isclose(w1, w2, rtol=1e-5, atol=1e-6)).sum())
    err = (w1 - w2).abs().max().item()
    if a1 is not None:
        ok = ok and bool(torch.isclose(a1, a2, rtol=1e-5, atol=1e-6).all())
        err = max(err, (a1 - a2).abs().max().item())
    return ok, err, n


def update_phase(device) -> dict:
    """The sparse update kernel against ops/adagrad.apply_rows_plain on
    the card, on copies of the same tables."""
    import torch

    from fwumious_wabbit_tpu_torch.ops import adagrad, sparse_update

    kinds = {"lut": adagrad.OPT_ADAGRAD_LUT, "flex": adagrad.OPT_ADAGRAD_FLEX,
             "sgd": adagrad.OPT_SGD}
    full = {"R": 262144, "K": TRAIN_BATCH * 15, "seed": 2, "zipf": True}
    cases = []  # (what, kind, power_t, update_case arguments or None)
    for name, kind in kinds.items():
        for power_t in (0.0, 0.5, 0.25):
            for dup in (False, True):
                cases.append((f"{name} p={power_t} dup_heavy={dup} pad=5",
                              kind, power_t, {"R": 512, "K": 300, "seed": 1,
                                              "dup_heavy": dup, "pad": 5}))
    cases.append(("lut p=0.5 runs with empty stretches between them",
                  adagrad.OPT_ADAGRAD_LUT, 0.5, None))
    cases.append(("full width: lut p=0 R=262144 K=15360 zipf",
                  adagrad.OPT_ADAGRAD_LUT, 0.0, full))
    max_err = 0.0
    for what, kind, power_t, args in cases:
        if args is None:
            w, acc, _, _ = update_case(4096, 1, 3, device)
            rid = torch.tensor([0] * 333 + [3 * 1024 + 5] * 77 + [4096] * 3,
                               dtype=torch.int32, device=device)
            g = update_case(1, len(rid), 4, device)[3]
        else:
            w, acc, rid, g = update_case(device=device, **args)
        kernel, plain = run_both(w, acc, rid, g, kind, 0.1, power_t, 0.5)
        ok, err, n = update_agrees(w, None if kind == adagrad.OPT_SGD else acc,
                                   rid, g, kernel, plain, kind, 0.1, power_t, 0.5)
        if args is None:
            untouched = torch.ones(w.shape[0], dtype=torch.bool, device=device)
            untouched[[0, 3 * 1024 + 5]] = False
            ok = ok and torch.equal(kernel[0][untouched], w[untouched])
        print(f"kernel sparse_adagrad_update {what}: max_abs_err={err!r} "
              f"(rtol 1e-5, atol 1e-6; {n} weights of cancelled sums within "
              f"rtol 1e-5 of their terms)", flush=True)
        check(ok, f"sparse update kernel disagrees with plain: {what}")
        max_err = max(max_err, err)
    max_err = max(max_err, schedule_cases(device))
    distinct_id_cases(device)
    lut_table_check(device)
    w, acc, rid, g = update_case(device=device, **full)
    lut = adagrad.OPT_ADAGRAD_LUT
    call = lambda: sparse_update.sparse_adagrad_update(  # noqa: E731
        w, acc, rid, g, 0.1, 0.0, 1.0, lut)
    ms, plain_ms = [], []
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            ms.append(time_ms(call, reps=500))
        else:
            plain_ms.append(time_ms(lambda: adagrad.apply_rows_plain(
                w, acc, rid, g, lut, 0.1, 0.0, 1.0), reps=200))
    return {"max_abs_err": max_err, "ms": min(ms), "plain_ms": min(plain_ms),
            "unique_rows": int(torch.unique(rid).numel()),
            "device": update_device_us(call, "the full-width Zipf update")}


def schedule_cases(device) -> float:
    """The kernel's tile schedule against plain: runs of T−1, T, T+1, 2T and
    2T+1 positions starting at every offset of a tile (T =
    sparse_update.TILE), ``off`` distinct ids sorting before the run (flex
    rate); then a run of 6,144 of K = 8,192 positions with real gradients
    (LUT rate), run twice, the two results bit-identical. Bounds of
    :func:`update_agrees`."""
    import numpy as np
    import torch

    from fwumious_wabbit_tpu_torch.ops import adagrad, sparse_update

    # the flex rate: the LUT rate steps at each bucket edge, and a sum in
    # another order lands acc one ulp across an edge about once in 10^6
    # weights; these cases are of the sums (the 6,144-run is LUT)
    T, flex, lut = sparse_update.TILE, adagrad.OPT_ADAGRAD_FLEX, adagrad.OPT_ADAGRAD_LUT
    args = (0.1, 0.5, 0.5)
    max_err = 0.0
    for L in (T - 1, T, T + 1, 2 * T, 2 * T + 1):
        worst = 0.0
        for off in range(T):
            rid = np.concatenate([np.arange(off), np.full(L, 500),
                                  np.arange(1000, 1000 + T + 3)]).astype(np.int32)
            rid = torch.from_numpy(np.random.default_rng(off).permutation(rid)).to(device)
            w, acc, _, _ = update_case(1200, 1, 5 + off, device)
            g = update_case(1, len(rid), 6 + off, device)[3]
            ok, err, _ = update_agrees(w, acc, rid, g,
                                       *run_both(w, acc, rid, g, flex, *args),
                                       flex, *args)
            check(ok, f"sparse update kernel disagrees with plain: a run of "
                      f"{L} positions at offset {off} of a {T}-position tile")
            worst = max(worst, err)
        print(f"kernel sparse_adagrad_update: a run of {L} positions at each "
              f"of the {T} offsets of a tile: max_abs_err={worst!r} (rtol "
              f"1e-5, atol 1e-6)", flush=True)
        max_err = max(max_err, worst)
    rng = np.random.default_rng(SEED + 7)
    rid = rng.integers(1, 32768, 8192).astype(np.int32)
    rid[rng.permutation(8192)[:6144]] = 0
    rid = torch.from_numpy(rid).to(device)
    w, acc, _, g = update_case(32768, 8192, 8, device)
    outs = []
    for _ in range(2):
        w1, a1 = w.clone(), acc.clone()
        sparse_update.sparse_adagrad_update(w1, a1, rid, g, *args, lut)
        outs.append((w1, a1))
    w2, a2 = w.clone(), acc.clone()
    adagrad.apply_rows_plain(w2, a2, rid, g, lut, *args)
    ok, err, n = update_agrees(w, acc, rid, g, outs[0], (w2, a2), lut, *args)
    same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(outs[0], outs[1]))
    print(f"kernel sparse_adagrad_update: a 6,144-position run in K=8192: "
          f"max_abs_err={err!r} (rtol 1e-5, atol 1e-6; {n} weights of "
          f"cancelled sums within rtol 1e-5 of their terms); two runs "
          f"bit-identical: {same}", flush=True)
    check(ok, "sparse update kernel disagrees with plain on a 6,144-run")
    check(same, "two runs of the sparse update kernel differ")
    return max(max_err, err)


def distinct_id_cases(device) -> None:
    """Every id once (16,384 of 40,000 rows): the kernel equals
    apply_rows_plain bit for bit, for LUT at power_t 0, 0.5 and 0.25 and
    for SGD."""
    import numpy as np
    import torch

    from fwumious_wabbit_tpu_torch.ops import adagrad

    rid = torch.from_numpy(np.random.default_rng(SEED + 9).permutation(40000)[:16384]
                           .astype(np.int32)).to(device)
    w, acc, _, g = update_case(40000, 16384, 10, device)
    for kind, power_t in ((adagrad.OPT_ADAGRAD_LUT, 0.0), (adagrad.OPT_ADAGRAD_LUT, 0.5),
                          (adagrad.OPT_ADAGRAD_LUT, 0.25), (adagrad.OPT_SGD, 0.0)):
        kernel, plain = run_both(w, acc, rid, g, kind, 0.1, power_t, 0.5)
        differ = sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                     for x, y in zip(kernel, plain) if x is not None)
        print(f"kernel sparse_adagrad_update, distinct ids, kind {kind} "
              f"power_t {power_t}: {differ} weights differ from plain in any "
              f"bit", flush=True)
        check(differ == 0, f"the kernel is not plain bit for bit on distinct "
                           f"ids (kind {kind}, power_t {power_t})")


def lut_table_check(device) -> None:
    """On the card, the plain lut_rate_compute equals build_lut's table
    over all 2048 buckets (at each bucket's lower edge and middle), bit for
    bit: the plain version and the kernel's table are one rate."""
    import numpy as np
    import torch

    from fwumious_wabbit_tpu_torch.ops import adagrad

    keys = np.arange(adagrad.FASTMATH_LR_LUT_SIZE, dtype=np.uint32) << np.uint32(20)
    accs = np.concatenate([keys, keys | np.uint32(1 << 19)]).view(np.float32)
    for lr, power_t, iag in ((0.1, 0.0, 1.0), (0.1, 0.5, 0.0), (0.1, 0.5, 0.5),
                             (0.1, 0.25, 0.5), (0.5, 0.3, 0.5)):
        got = adagrad.lut_rate_compute(torch.from_numpy(accs).to(device), lr,
                                       power_t, iag).cpu().numpy()
        want = adagrad.build_lut(lr, power_t, iag)[accs.view(np.uint32) >> 20]
        differ = int((got.view(np.uint32) != want.view(np.uint32)).sum())
        print(f"plain lut_rate_compute on the card vs build_lut, lr {lr} "
              f"power_t {power_t} iag {iag}: {differ} of {len(accs)} differ",
              flush=True)
        check(differ == 0, "the plain LUT rate on the card is not the table")


def update_device_us(call, what: str, reps: int = 20) -> dict:
    """Device time per call of ``call`` (one sparse_adagrad_update) from
    torch.profiler: the kernel's two passes, and the rest of what the
    wrapper launches, which is the stable sort; and the sort's share of the
    call's device time."""
    import torch

    call()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            call()

    rows, _ = device_rows(run, what)
    pass1 = pass2 = sort = 0.0
    for key, dt, _ in rows:
        if "tile_kernel" in key:
            pass1 += dt
        elif "crossing_kernel" in key:
            pass2 += dt
        else:
            sort += dt
    total = pass1 + pass2 + sort
    check(pass1 > 0 and pass2 > 0, "the profiler saw no device time for the "
                                   f"sparse update kernels in {what}")
    return {"device_us": total / reps, "kernel_us": (pass1 + pass2) / reps,
            "pass1_us": pass1 / reps, "pass2_us": pass2 / reps,
            "sort_us": sort / reps, "sort_share": sort / total}


def update_timing_line(what: str, ms: float, plain_ms: float, dev: dict) -> str:
    return (f"timing: sparse_adagrad_update {what}: kernel {ms * 1e3:.2f} us "
            f"wall per call (sort included) vs plain index_add_ path "
            f"{plain_ms * 1e3:.2f} us; device {dev['device_us']:.2f} us per "
            f"call = update kernels {dev['kernel_us']:.2f} (pass 1 "
            f"{dev['pass1_us']:.2f}, pass 2 {dev['pass2_us']:.2f}) + sort "
            f"{dev['sort_us']:.2f} (sort share {dev['sort_share']:.3f})")


# -- phase 4/5: the serving path ----------------------------------------------------


def write_model(path: Path, mi, vw, seed: int) -> None:
    """A model file with random weights from ``seed`` (LR ≠ 0, so the
    predictions are not all 0.5), written by the port's save_model."""
    import numpy as np

    from fwumious_wabbit_tpu_torch.convert import params_from_numpy
    from fwumious_wabbit_tpu_torch.models.model import FwModel
    from fwumious_wabbit_tpu_torch.persistence.model_file import save_model

    rng = np.random.default_rng(seed)
    model = FwModel(mi)
    params = {"lr_w": rng.standard_normal(model.lr_size, np.float32) * 0.2}
    if model.has_ffm:
        params["ffm_w"] = rng.standard_normal(model.ffm_size, np.float32) * 0.1
    model.load_params(params_from_numpy(params, model, "cpu"))
    save_model(path, mi, vw, model)


def plain_predictions(model_path: Path, data: Path):
    """The port's plain path on the CPU — ``-t -i`` through the CLI with
    ``--fwt_platform cpu`` — over ``data``: the reference for every reply."""
    import numpy as np

    from fwumious_wabbit_tpu_torch.train.loop import main

    out = data.with_suffix(".plain.out")
    rc = main(["-t", "-i", str(model_path), "--data", str(data), "-p", str(out),
               "--fwt_platform", "cpu"])
    check(rc == 0, f"plain CPU -t -i predict exited {rc}")
    return np.array([float(x) for x in out.read_text().split()])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_daemon(model_path: Path, port: int, extra_argv=()):
    """The port's CLI daemon on a thread of this process (so the kernel's
    launch counter can be read); returns once it accepts connections."""
    from fwumious_wabbit_tpu_torch.train.loop import main

    result: list = []

    def run():
        try:
            result.append(main(["--daemon", "--foreground", "-i", str(model_path),
                                "--port", str(port), *extra_argv]))
        except BaseException as e:  # noqa: BLE001 — reported by the poller
            result.append(e)

    t = threading.Thread(target=run, daemon=True, name="chip-smoke-daemon")
    t.start()
    deadline = time.time() + 600
    while time.time() < deadline:
        check(not result, f"daemon exited: {result!r}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return t
        except OSError:
            time.sleep(0.2)
    raise SmokeError("daemon did not start listening within 600 s")


class Client:
    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        self.fh = self.sock.makefile("rwb")

    def send(self, line: bytes) -> bytes:
        self.fh.write(line)
        self.fh.flush()
        return self.fh.readline()

    def burst(self, lines: list[bytes]) -> list[bytes]:
        self.sock.sendall(b"".join(lines))
        return [self.fh.readline() for _ in lines]

    def close(self) -> None:
        self.fh.close()
        self.sock.close()


def compare(what: str, replies: list[bytes], want) -> float:
    import numpy as np

    check(len(replies) == len(want), f"{what}: {len(replies)} replies for "
                                     f"{len(want)} lines")
    bad = [r for r in replies if not r.endswith(b"\n") or r.startswith(b"ERR")]
    check(not bad, f"{what}: malformed replies, first {bad[:1]!r}")
    got = np.array([float(r) for r in replies])
    err = float(np.abs(got - want).max())
    check(bool(np.isfinite(got).all()) and err <= REPLY_ATOL,
          f"{what}: max |reply − plain| = {err} > {REPLY_ATOL}")
    check(bool((np.abs(want - 0.5) > 1e-3).any()),
          f"{what}: every prediction is 0.5: the check would show nothing")
    print(f"{what}: {len(replies)} replies, max |reply − plain CPU| = {err!r}",
          flush=True)
    return err


def serving_phase(data: Path, paths: tuple[Path, Path], extra_argv=()) -> dict:
    """Daemon request/response, burst and hot swap; then -t -i predict."""
    import numpy as np

    from fwumious_wabbit_tpu_torch.train.loop import main

    lines = data.read_bytes().splitlines(keepends=True)
    head = data.with_name("chip_smoke_64.vw")
    head.write_bytes(b"".join(lines[:64]))
    want1 = plain_predictions(paths[0], data)
    want2 = plain_predictions(paths[1], head)
    check(len(want1) == len(lines) and len(want2) == 64,
          "the plain CPU path did not predict every line")

    port = free_port()
    start_daemon(paths[0], port, extra_argv)
    c = Client(port)
    compare("daemon request/response (64 lines)",
            [c.send(line) for line in lines[:64]], want1[:64])
    lat, replies = [], []
    for line in lines[64:1064]:
        t0 = time.perf_counter()
        replies.append(c.send(line))
        lat.append(time.perf_counter() - t0)
    compare("daemon request/response (1000 timed lines)", replies, want1[64:1064])
    c.close()

    c = Client(port)
    t0 = time.perf_counter()
    replies = c.burst(lines[:4096])
    burst_s = time.perf_counter() - t0
    compare("daemon pipelined burst (4096 lines)", replies, want1[:4096])
    c.close()

    c = Client(port)
    reply = c.send(f"hogwild_load {paths[1]}\n".encode())
    check(reply == b"hogwild_load success\n", f"hogwild_load replied {reply!r}")
    compare("daemon after hogwild_load (64 lines)",
            [c.send(line) for line in lines[:64]], want2)
    c.close()

    out = paths[0].with_name("chip_smoke_preds.out")
    rc = main(["-t", "-i", str(paths[0]), "--data", str(data), "-p", str(out),
               *extra_argv])
    check(rc == 0, f"-t -i predict exited {rc}")
    preds = out.read_bytes().splitlines(keepends=True)
    compare(f"-t -i predict ({len(lines)} lines)", preds, want1)

    lat_us = np.sort(np.array(lat)) * 1e6
    return {"p50_us": float(np.percentile(lat_us, 50)),
            "p99_us": float(np.percentile(lat_us, 99)),
            "n_rr": len(lat_us), "burst_lines_s": 4096 / burst_s}


def layer_breakdown(path: Path, lines: list[bytes], device) -> dict:
    """The serving path's layers timed one after another on 16 batches of
    256 lines (host clock, the card synchronized after each device layer),
    and the forward's device time by kernel from torch.profiler."""
    import numpy as np
    import torch

    from fwumious_wabbit_tpu_torch.ingest import Batcher, FeatureTranslator, VowpalParser
    from fwumious_wabbit_tpu_torch.ops import ffm
    from fwumious_wabbit_tpu_torch.persistence.model_file import load_model
    from fwumious_wabbit_tpu_torch.serve.server import _format_preds
    from fwumious_wabbit_tpu_torch.train.step import batch_dict

    mi, vw, model = load_model(path, immutable=True, device=device)
    parser, ft, batcher = VowpalParser(vw), FeatureTranslator(mi), Batcher(256)
    n_b = 16
    lines = lines[: 256 * n_b]
    t = {}
    t0 = time.perf_counter()
    tes = [ft.translate(parser.parse_line(line)) for line in lines]
    t["parse_translate_us_per_line"] = (time.perf_counter() - t0) / len(lines) * 1e6
    t0 = time.perf_counter()
    hb = [batch_dict(batcher.make_batch(tes[i:i + 256])) for i in range(0, len(tes), 256)]
    t["make_batch_us"] = (time.perf_counter() - t0) / n_b * 1e6

    def h2d(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in b.items()}

    with torch.inference_mode():
        for b in hb[:2]:  # warm
            model.predict(h2d(b)).cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        db = [h2d(b) for b in hb]
        torch.cuda.synchronize()
        t["h2d_us"] = (time.perf_counter() - t0) / n_b * 1e6
        t0 = time.perf_counter()
        outs = [model.predict(b) for b in db]
        torch.cuda.synchronize()
        t["forward_us"] = (time.perf_counter() - t0) / n_b * 1e6
        t0 = time.perf_counter()
        arrs = [o.cpu().numpy() for o in outs]
        t["d2h_us"] = (time.perf_counter() - t0) / n_b * 1e6
        t0 = time.perf_counter()
        for a in arrs:
            _format_preds(bytearray(), a)
        t["format_us"] = (time.perf_counter() - t0) / n_b * 1e6
        # one request's shape: one line padded to the 256-row batch
        t0 = time.perf_counter()
        for _ in range(100):
            model.predict(h2d(batch_dict(batcher.make_batch(tes[:1])))).cpu()
        t["one_line_batch_h2d_forward_d2h_us"] = (time.perf_counter() - t0) / 100 * 1e6

        def run():
            launches0 = ffm.LAUNCHES
            t0 = time.perf_counter()
            for b in db:
                model.predict(b)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, ffm.LAUNCHES - launches0

        rows, (wall, launches) = device_rows(run, "the serving batches")
        t["ffm_fused_launches_per_batch"] = launches / n_b
        prof_rows = sorted(((dt, key[:60], n) for key, dt, n in rows), reverse=True)
        dev_total = sum(dt for _, dt, _ in rows)
        n_kernels = sum(n for _, _, n in rows)
        t["profiled_wall_us_per_batch"] = wall / n_b * 1e6
        t["device_busy_us_per_batch"] = dev_total / n_b
        t["device_kernels_per_batch"] = n_kernels / n_b
        t["device_kernels"] = [(name, count, round(dt / n_b, 2))
                               for dt, name, count in prof_rows[:10]]
    return t


# -- phase 7: training at full width --------------------------------------------------


class ElapsedLog:
    """Captures the port's log records: the CLI's ``Elapsed: … (N ex/s)``,
    and what the loop and the producer say of the caches they use."""

    def __init__(self):
        import logging

        self.records: list[str] = []
        self.logger = logging.getLogger("fwumious_wabbit_tpu_torch")
        self.handler = logging.Handler()
        self.handler.emit = lambda r: self.records.append(r.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)

    def ex_per_s(self) -> float:
        import re

        for msg in reversed(self.records):
            m = re.search(r"Elapsed: .*\((\d+) ex/s\)", msg)
            if m:
                return float(m.group(1))
        raise SmokeError("the CLI logged no Elapsed line")


def train_cli(data: Path, tag: str, extra=(), save: bool = True,
              base=None) -> tuple:
    """One training run through the port's CLI with the model flags
    ``base`` (the LR+FFM k=8 ones by default): (predictions, model path or
    None, ex/s from the CLI's log)."""
    import numpy as np

    from fwumious_wabbit_tpu_torch import synthetic
    from fwumious_wabbit_tpu_torch.train.loop import main

    out = data.with_name(f"chip_smoke_train_{tag}.out")
    fwt = data.with_name(f"chip_smoke_train_{tag}.fwt") if save else None
    argv = list(base or synthetic.serving_argv()) + [
        "--data", str(data), "--fwt_batch_size", str(TRAIN_BATCH),
        "-p", str(out), *extra]
    if save:
        argv += ["-f", str(fwt), "--save_resume"]
    with ElapsedLog() as el:
        rc = main(argv)
    check(rc == 0, f"training ({tag}) exited {rc}")
    return np.array(out.read_bytes().split(), np.float64), fwt, el.ex_per_s()


def logloss(preds, data: Path) -> float:
    import numpy as np

    y = np.array([float(line.split(b" ", 1)[0]) > 0
                  for line in data.read_bytes().splitlines()])
    p = np.clip(preds, 1e-7, 1 - 1e-7)
    return float(-np.mean(np.where(y, np.log(p), np.log(1 - p))))


def launch_counts() -> dict:
    from fwumious_wabbit_tpu_torch.ops import ffm, sparse_update

    return {"ffm_triangle": ffm.LAUNCHES, "ffm_triangle_bwd": ffm.BWD_LAUNCHES,
            "sparse_adagrad_update": sparse_update.LAUNCHES}


def reset_launch_counts() -> None:
    from fwumious_wabbit_tpu_torch.ops import ffm, sparse_update

    ffm.LAUNCHES = ffm.BWD_LAUNCHES = sparse_update.LAUNCHES = 0


def trained_path(data: Path, tag: str, extra=(), base=None) -> dict:
    """One full-width training run through the CLI on the card, a main path:
    the launch counts set to 0 just before it and read just after, each
    kernel launched at least once."""
    reset_launch_counts()
    preds, fwt, ex_s = train_cli(data, tag, extra, base=base)
    launches = launch_counts()
    print(f"kernel launches on the training path ({tag}): "
          f"{json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"the training path ({tag}) never launched the {name} kernel")
    n_lines = len(data.read_bytes().splitlines())
    check(preds.shape == (n_lines,) and bool(valid_preds(preds)),
          f"training ({tag}) wrote {preds.shape} predictions for {n_lines} lines")
    return {"preds": preds, "fwt": fwt, "ex_s": ex_s, "launches": launches}


def valid_preds(a) -> bool:
    """Finite probabilities (as the -p file rounds them, 0 and 1 included)."""
    import numpy as np

    return bool(np.isfinite(a).all() and ((a >= 0) & (a <= 1)).all())


def model_tensors(model) -> dict:
    """The tables (the four, or the two weights of an SGD model) and, with
    a tower, every layer's and the readout's w, b, w_acc and b_acc, by
    name."""
    out = {k: getattr(model, k) for k in ("lr_w", "lr_acc", "ffm_w", "ffm_acc")
           if k in model._buffers}  # an SGD model holds no accumulator
    if model.has_nn:
        for i, layer in enumerate([*model.layers, model.final]):
            where = "final" if i == len(model.layers) else f"nn[{i}]"
            out.update({f"{where}.{k}": v for k, v in layer.tensors().items()})
    return out


def compare_runs(what: str, got: dict, want: dict, pred_bound: float) -> dict:
    """Predictions within ``pred_bound`` per line and the four tables (and
    every tower tensor) of the two model files within 1e-5·(1+max|want|);
    whether both are bit for bit equal."""
    from fwumious_wabbit_tpu_torch.persistence.model_file import load_model

    pred_err = float(abs(got["preds"] - want["preds"]).max())
    check(pred_err <= pred_bound, f"{what}: predictions differ by {pred_err} "
                                  f"> {pred_bound}")
    identical = got["fwt"].read_bytes() == want["fwt"].read_bytes()
    _, _, b_model = load_model(want["fwt"], device="cpu")
    b_tensors = model_tensors(b_model)
    # equal files hold equal tensors: only a file that differs is read twice
    a_tensors = (b_tensors if identical else
                 model_tensors(load_model(got["fwt"], device="cpu")[2]))
    check(set(a_tensors) == set(b_tensors), f"{what}: the model files hold "
                                            f"other tensors")
    table_err = {}
    for key, b in b_tensors.items():
        a = a_tensors[key]
        err = (a - b).abs().max().item()
        bound = TRAIN_ATOL * (1.0 + b.abs().max().item())
        table_err[key] = err
        check(err <= bound, f"{what}: table {key} differs by {err} > {bound}")
    identical = identical and bool((got["preds"] == want["preds"]).all())
    print(f"{what}: {got['preds'].size} predictions, max |diff| = {pred_err!r} "
          f"(bound {pred_bound!r}); tables max |diff| {json.dumps(table_err)} "
          f"(bound 1e-5·(1+max|·|)); predictions and model files bit-identical: "
          f"{identical}", flush=True)
    return {"pred_err": pred_err, "table_err": table_err, "identical": identical}


def training_phase(data: Path) -> dict:
    """The Python-ingest training path (--fwt_no_native) on the card, then
    the same with --fwt_platform cpu; predictions and the four tables
    compared."""
    gpu = trained_path(data, "python_gpu", ["--fwt_no_native"])
    cpu_preds, cpu_fwt, cpu_ex_s = train_cli(
        data, "python_cpu", ["--fwt_no_native", "--fwt_platform", "cpu"])
    cmp = compare_runs("training --fwt_no_native, card vs CPU", gpu,
                       {"preds": cpu_preds, "fwt": cpu_fwt}, TRAIN_ATOL)
    ll = logloss(gpu["preds"], data)
    print(f"training progressive logloss over {gpu['preds'].size} lines: "
          f"card {ll!r}, CPU {logloss(cpu_preds, data)!r}", flush=True)
    return {**gpu, "cpu_ex_s": cpu_ex_s, "logloss": ll, **cmp}


def native_training_phase(data: Path, python_gpu: dict) -> dict:
    """The default training path — C++ ingest, K=8 packed superbatches,
    bitpack and vocab auto, the pinned transfer stage — on the card (a main
    path), against the --fwt_no_native run on the card (predictions within
    one unit of the -p file's sixth decimal, tables within
    1e-5·(1+max|·|)) and against itself with --fwt_platform cpu (the
    Python-ingest phase's bounds)."""
    gpu = trained_path(data, "native_gpu")
    vs_python = compare_runs("training, default path vs --fwt_no_native on the card",
                             gpu, python_gpu, PRED_UNIT)
    cpu_preds, cpu_fwt, cpu_ex_s = train_cli(data, "native_cpu",
                                             ["--fwt_platform", "cpu"])
    vs_cpu = compare_runs("training, default path, card vs CPU", gpu,
                          {"preds": cpu_preds, "fwt": cpu_fwt}, TRAIN_ATOL)
    return {**gpu, "cpu_ex_s": cpu_ex_s, "vs_python": vs_python,
            "vs_cpu": vs_cpu, "logloss": logloss(gpu["preds"], data)}


# the settings and the pack cache, each over the 1M file's first 200,000
# lines; the pack cache recorded (no file before it), then replayed
SETTINGS_RUNS = {"vocab_off": ["--fwt_vocab", "off"],
                 "bitpack_off_vocab_off": ["--fwt_bitpack", "off", "--fwt_vocab", "off"],
                 "default_again": [],
                 "pack_cache_record": ["--fwt_pack_cache", "on"],
                 "pack_cache_replay": ["--fwt_pack_cache", "on"]}
SETTINGS_LINES = 200_000


def million_run(path: Path, name: str, n_lines: int, extra=(), base=None) -> tuple:
    """One default-path run through the CLI over ``path`` with -p, a main
    path: the launch counts set to 0 just before it and read just after,
    each kernel launched; its ex/s from the CLI's Elapsed line, its in-run
    counters (FWT_COUNTERS_OUT) and the launches per step. Returns
    ``(predictions, run, the CLI's log messages)``."""
    counters_path = path.parent / "chip_smoke_counters.json"
    os.environ["FWT_COUNTERS_OUT"] = str(counters_path)
    reset_launch_counts()
    try:
        with ElapsedLog() as el:
            preds, _, ex_s = train_cli(path, name, extra, save=False, base=base)
    finally:
        del os.environ["FWT_COUNTERS_OUT"]
    launches = launch_counts()
    for kernel, n in launches.items():
        check(n > 0, f"run {name} never launched the {kernel} kernel")
    res = json.loads(counters_path.read_text())
    check(res["examples"] == n_lines and preds.shape == (n_lines,)
          and valid_preds(preds), f"run {name}: {res['examples']} examples, "
                                  f"{preds.shape} predictions for {n_lines} lines")
    steps = -(-n_lines // TRAIN_BATCH)
    run = {"ex_s": ex_s, "elapsed_s": res["elapsed"], "lines": n_lines,
           "logloss": logloss(preds, path),
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "counters": res["counters"]}
    print(f"timing: train {n_lines:,} lines ({name}: {' '.join(extra) or 'the default'}) "
          f"at B={TRAIN_BATCH}: {ex_s:.0f} ex/s (CLI Elapsed line), "
          f"logloss {run['logloss']:.6f}; kernel launches per step "
          f"{json.dumps(run['launches_per_step'])}; in-run counters "
          f"{json.dumps(res['counters'])}", flush=True)
    return preds, run, el.records


def start_dataset(directory: Path, n_lines: int):
    """Writes the ``n_lines`` Eat-Rate file (synthetic.ensure_dataset, seed
    1) in a child process, so that its generation (pure Python, ~12 s for
    1M lines) runs beside the phases before 7b; then the data of phase
    10's gates (gates.prepare: the FFM gate's and gate 3's). Started after
    the 10k file and its namespace map exist, which the child then leaves
    alone. It prints the seconds of the 1M file, then of the gates' data."""
    import subprocess

    code = ("import sys, time\n"
            "t0 = time.perf_counter()\n"
            "from fwumious_wabbit_tpu_torch import gates, synthetic\n"
            f"synthetic.ensure_dataset({str(directory)!r}, {n_lines})\n"
            "t1 = time.perf_counter()\n"
            "print(t1 - t0, flush=True)\n"
            f"gates.prepare({SMOKE_GATES!r}, gates.WORK)\n"
            "print(time.perf_counter() - t1)\n")
    child = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    CHILDREN.append(child)
    return child


def million_phase(directory: Path, n_lines: int = 1_000_000,
                  dataset=None) -> dict:
    """bench.py's "text-train 1M" row on the default path: the 1,000,000-line
    Eat-Rate file (synthetic.ensure_dataset, seed 1; its generation timed,
    in the child ``dataset`` of :func:`start_dataset` when given) trained
    through the CLI with -p on the card; then its first 200,000
    lines with --fwt_vocab off, --fwt_bitpack off --fwt_vocab off, the
    default again, and --fwt_pack_cache on twice: the first run records the
    producer's stream (no cache file before it), the second replays it (its
    log says so); each a main path (:func:`million_run`). The two
    pack-cache runs' predictions within one unit of the -p file's sixth
    decimal of the 1M run's first 200,000, with whether they are
    bit-identical."""
    from fwumious_wabbit_tpu_torch import synthetic
    from fwumious_wabbit_tpu_torch.train import pack_cache

    t0 = time.perf_counter()
    where = "here"
    if dataset is not None:
        out, err = dataset.communicate(timeout=600)
        check(dataset.returncode == 0, f"the dataset's child process exited "
                                       f"{dataset.returncode}: {err[-2000:]}")
        big_s, gates_s = (float(x) for x in out.split())
        where = (f"in a child process beside the earlier phases, "
                 f"{big_s:.2f} s of its time, then {gates_s:.2f} s for the "
                 f"gates' data; waited for it")
    big = synthetic.ensure_dataset(directory, n_lines)
    gen_s = time.perf_counter() - t0
    print(f"dataset: {n_lines:,} Eat-Rate lines ({big.stat().st_size} bytes) "
          f"ready in {gen_s:.2f} s ({where})", flush=True)
    mid = directory / f"chip_smoke_head_{SETTINGS_LINES}.vw"
    with open(big, "rb") as fh:
        mid.write_bytes(b"".join(fh.readline() for _ in range(SETTINGS_LINES)))
    default_preds, run, _ = million_run(big, "1m_default", n_lines)
    out = {"gen_s": gen_s, "path": big, "preds": default_preds,
           "runs": {"default": run}}
    head_preds = default_preds[:SETTINGS_LINES]
    fwpack = Path(pack_cache.pack_cache_path_for(mid))
    fwpack.unlink(missing_ok=True)
    for name, extra in SETTINGS_RUNS.items():
        preds, run, records = million_run(mid, f"200k_{name}", SETTINGS_LINES, extra)
        replayed = any("using pack cache" in r for r in records)
        check(replayed == (name == "pack_cache_replay"),
              f"200k run {name}: replayed a pack cache: {replayed}")
        err = float(abs(preds - head_preds).max())
        same = bool((preds == head_preds).all())
        if name.startswith("pack_cache"):
            check(fwpack.is_file(), f"200k run {name}: no pack cache at {fwpack}")
            check(err <= PRED_UNIT, f"200k run {name}: predictions differ from "
                                    f"the 1M run's first 200,000 by {err}")
        print(f"200k run {name}: predictions max |diff| from the 1M run's "
              f"first 200,000 {err!r}, bit-identical: {same}", flush=True)
        run.update(pred_err_vs_1m=err, bit_identical_to_1m=same)
        out["runs"][name] = run
    return out


def last_layout_groups(items: list, K: int, n: int) -> tuple:
    """``(layout, groups, snapshot)`` of a producer's stream: the layout of
    its last full superbatch, the last ``n`` full superbatches of that
    layout, and the vocabulary snapshot in force for them — the last one
    before the last of them (one layout's dictionaries only grow; a later
    snapshot may belong to another layout)."""
    full = [j for j, i in enumerate(items) if i[0] == "p" and i[1].shape[0] == K]
    lay = items[full[-1]][2]
    groups = [items[j] for j in full if items[j][2].signature == lay.signature]
    snaps = [i[1] for i in items[:full[-1]] if i[0] == "v"]
    return lay, groups[-n:], snaps[-1] if snaps else None


def packed_step_profile(big: Path, device, n_groups: int = 8) -> tuple:
    """A torch.profiler window of packed train steps at full width: the
    producer packs the first 16·8·1024 lines of ``big`` as the CLI does
    (K=8, B=1024, bitpack and vocab on), the superbatches of the last layout
    go to the card through the transfer stage, and ``n_groups`` of them run
    through make_packed_train_step (each 8 steps) on a fresh model
    (:func:`profile_window`); and unpack_row alone per superbatch (its
    device kernels: the count a fused unpack kernel would replace). The
    kernels' launches per step are the 1M default run's, not this
    window's. Then the three kernels against their plain versions at one
    packed step's own inputs (:func:`ffm_step_check`,
    :func:`step_update_check`). Returns ``(profile, kernels, packed)``,
    ``packed`` the layout, superbatches and vocabulary snapshot on the card,
    which the tower's window (7d) runs again: the tower leaves the
    producer's stream as it is."""
    import torch

    from fwumious_wabbit_tpu_torch import synthetic
    from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
    from fwumious_wabbit_tpu_torch.models.model import FwModel
    from fwumious_wabbit_tpu_torch.train import packed
    from fwumious_wabbit_tpu_torch.train.producer import (
        SuperbatchProducer, Transferrer, arrived)

    K = 8
    head = big.with_name("chip_smoke_head.vw")
    with open(big, "rb") as fh:
        head.write_bytes(b"".join(fh.readline() for _ in range(16 * K * TRAIN_BATCH)))
    mi, vw = synthetic.training_config(head)
    model = FwModel(mi)
    model.load_params(model.init_params(device))
    keys = {"lr": 0, "ffm": (model.ffm_spec.align - 1).bit_length()}

    class Sink(list):
        put = list.append

    sink, state = Sink(), packed.VocabTransferState()
    SuperbatchProducer(
        build_parser().parse_args(synthetic.serving_argv() + ["--data", str(head)]),
        mi, vw, batch_size=TRAIN_BATCH, K=K, can_pack=True, count_keys=keys,
        cut_at=None, holdout_after=None, out_queue=sink,
        ctr={"producer_stall_s": 0.0},
        xfer_stats={"starve_s": 0.0, "xfer_s": 0.0, "put_s": 0.0, "bytes": 0},
        vocab_state=state).run()
    state.close()
    check(isinstance(sink[-1], type(None)), f"the producer failed: {sink[-1]!r}")
    lay, groups, snap = last_layout_groups(sink[:-1], K, n_groups)
    check(len(groups) >= 2, f"only {len(groups)} full superbatches of one layout")
    tr = Transferrer(device)
    (vocab,), ev = tr.stage([snap])
    vocab = arrived(vocab, ev)
    bufs = []
    for g in groups:
        (b,), ev = tr.stage([g[1]])
        bufs.append(arrived(b, ev))
    res = profile_window(model, lay, bufs, vocab, K)
    plan = packed._Plan(lay, device)
    unpack = device_us(lambda: packed.unpack_row(bufs[0], lay, vocab, plan),
                       "unpack_row")
    res.update(unpack_device_us_per_superbatch=unpack["device_us"],
               unpack_kernels_per_superbatch=unpack["kernels_per_call"])
    # the kernels at the default path's own inputs: the first step of the
    # last superbatch, unpacked as the packed step unpacks it, on the model
    # these superbatches trained
    bd = {key: v[0] for key, v in packed.unpack_row(bufs[-1], lay, vocab, plan).items()}
    what = "the default path's train step"
    kernels = {"ffm": ffm_step_check(model, bd, what),
               "update": step_update_check(model, bd, what)}
    del model, bd
    torch.cuda.empty_cache()
    return res, kernels, (lay, bufs, vocab)


def profile_window(model, lay, bufs: list, vocab, K: int) -> dict:
    """The packed superbatches ``bufs`` through make_packed_train_step on
    ``model``, per step: wall (host clock, the card synchronized at the
    end; once without and once under the profiler), device busy, device
    kernels and the idle share in the profiled window."""
    import torch

    from fwumious_wabbit_tpu_torch.train import packed

    step = packed.make_packed_train_step(model, lay, K)
    step(bufs[0], vocab).cpu()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in bufs:  # alone in the process: no producer or writer thread
        step(b, vocab)
    torch.cuda.synchronize()
    quiet = time.perf_counter() - t0

    def run():
        t0 = time.perf_counter()
        for b in bufs:
            step(b, vocab)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prof_rows, wall = device_rows(run, "the packed steps")
    n_steps = len(bufs) * K
    dev_total = sum(dt for _, dt, _ in prof_rows)
    n_kernels = sum(n for _, _, n in prof_rows)
    rows = [(round(dt / n_steps, 2), key[:60], n) for key, dt, n in prof_rows]
    return {"K": K, "superbatches": len(bufs), "words": lay.words,
            "bytes_per_example": lay.words * 4 / TRAIN_BATCH,
            "wall_us_per_step": quiet / n_steps * 1e6,
            "profiled_wall_us_per_step": wall / n_steps * 1e6,
            "device_busy_us_per_step": dev_total / n_steps,
            "device_kernels_per_step": n_kernels / n_steps,
            "device_idle_share": 1.0 - dev_total / (wall * 1e6),
            "largest": sorted(rows, reverse=True)[:8]}


def train_batches(data: Path, device, n_b: int, config=None) -> tuple:
    """``(model, host batches, host timings)``: a fresh full-width training
    model on ``device`` (``config``, synthetic.training_config by default)
    and the first n_b 1024-line batches of ``data`` as the CLI makes them,
    host counts included."""
    from fwumious_wabbit_tpu_torch import synthetic
    from fwumious_wabbit_tpu_torch.ingest import Batcher, FeatureTranslator, VowpalParser
    from fwumious_wabbit_tpu_torch.models.model import FwModel
    from fwumious_wabbit_tpu_torch.train import step as st
    from fwumious_wabbit_tpu_torch.train.loop import np_counts

    mi, vw = (config or synthetic.training_config)(data)
    model = FwModel(mi)
    model.load_params(model.init_params(device))
    parser, ft, batcher = VowpalParser(vw), FeatureTranslator(mi), Batcher(TRAIN_BATCH)
    lines = data.read_bytes().splitlines(True)[: TRAIN_BATCH * n_b]
    shift = (model.ffm_spec.align - 1).bit_length()
    t = {}
    t0 = time.perf_counter()
    tes = [ft.translate(parser.parse_line(line)) for line in lines]
    t["parse_translate_us_per_line"] = (time.perf_counter() - t0) / len(lines) * 1e6
    t0 = time.perf_counter()
    hb = []
    for i in range(0, len(tes), TRAIN_BATCH):
        b = batcher.make_batch(tes[i:i + TRAIN_BATCH])
        bd = st.train_batch_dict(b)
        bd["lr_counts"] = np_counts(b.lr_ids, b.lr_vals, 0)
        bd["ffm_counts"] = np_counts(b.ffm_ids, b.ffm_vals, shift)
        hb.append(bd)
    t["make_batch_and_counts_us"] = (time.perf_counter() - t0) / n_b * 1e6
    return model, hb, t


def step_update_phase(data: Path, device) -> dict:
    """The sparse update kernel against apply_rows_plain at exactly the
    inputs the Python-ingest train step gives it: after two full-width
    B=1024 steps, the third step's (:func:`step_update_check`)."""
    from fwumious_wabbit_tpu_torch.train import step as st

    model, hb, _ = train_batches(data, device, 3)
    step = st.make_train_step(model)
    for b in hb[:2]:
        step(b)
    out = step_update_check(model, st.to_device(hb[2], st.TRAIN_KEYS, device),
                            "the Python path's train step")
    del model
    return out


def step_update_check(model, bd: dict, what: str) -> dict:
    """The sparse update kernel against apply_rows_plain at exactly the
    inputs one train step gives it: the step's LR and FFM ``(rid, grows)``
    (lr_update_rows, ffm_update_rows) from the batch ``bd`` on the card,
    applied to clones of the model's own tables. w and acc within
    :func:`update_agrees`' bounds; acc besides within 1e-4 of plain
    relative to each element (a sum of squares in another order), so a
    wrong acc on small values cannot hide under the atol. Both versions
    timed at those two shapes, each with its bound."""
    import torch

    from fwumious_wabbit_tpu_torch.ops import adagrad, sparse_update
    from fwumious_wabbit_tpu_torch.train import step as st

    leaves = st.gather(model, bd)
    x, _, dlogit, residuals = st.forward(model, bd, leaves)
    grads, _ = st.backward(model, x, leaves, dlogit, residuals)
    calls = {"lr": (model.opt_lr, model.lr_w, model.lr_acc,
                    st.lr_update_rows(model, bd, grads[0]))}
    if model.has_ffm:
        calls["ffm"] = (model.opt_ffm, model.ffm_w, model.ffm_acc,
                        st.ffm_update_rows(model, bd, grads[1]))
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for name, (opt, w, acc, (rid, grows, pre_scaled)) in calls.items():
        check(pre_scaled and opt.kind == adagrad.OPT_ADAGRAD_LUT,
              f"the {name} update is not the pre-scaled LUT update of the "
              f"training configuration")
        rid, grows = rid.to(torch.int32), grows.contiguous()
        args = (opt.learning_rate, opt.power_t, opt.initial_acc_gradient, opt.kind)
        w1, a1 = w.clone(), acc.clone()
        sparse_update.sparse_adagrad_update(w1, a1, rid, grows, *args)
        torch.cuda.synchronize()
        w2, a2 = w.clone(), acc.clone()
        adagrad.apply_rows_plain(w2, a2, rid, grows, opt.kind, *args[:3])
        ok, _, n = update_agrees(w, acc, rid, grows, (w1, a1), (w2, a2),
                                 opt.kind, *args[:3])
        w_err = (w1 - w2).abs().max().item()
        a_err = (a1 - a2).abs().max().item()
        a_rel = ((a1 - a2).abs() / a2.abs()).nan_to_num(0.0).max().item()
        touched = int(torch.unique(rid[rid < w.shape[0]]).numel())
        changed = int((a2 != acc).any(dim=1).sum())
        print(f"kernel sparse_adagrad_update at {what}'s {name} "
              f"shape R={w.shape[0]} K={rid.shape[0]} ({touched} distinct "
              f"rows, {changed} with a non-zero gradient): max_abs_err w "
              f"{w_err!r}, acc {a_err!r}; max relative err acc {a_rel!r} "
              f"(rtol 1e-5, atol 1e-6; acc relative 1e-4; {n} weights of "
              f"cancelled sums within rtol 1e-5 of their terms)", flush=True)
        check(changed > 0, f"the {name} update of {what} changes no row: "
                           f"the check would show nothing")
        ok = ok and bool(((a1 - a2).abs() <= 1e-4 * a2.abs()).all())
        check(ok, f"sparse update kernel disagrees with plain at {what}'s "
                  f"{name} shape")
        out["max_abs_err"] = max(out["max_abs_err"], w_err, a_err)
        # rid and the gradient rows read once, each touched row's w and acc
        # read and written once, the LUT read once; a sum and ~6 operations
        # of the rate and update per weight
        K = rid.shape[0]
        out[f"{name}_bound"] = bound(K * 4 + K * 512 + touched * 512 * 4 + 8192,
                                     K * 128 + touched * 128 * 6)
        call = lambda: sparse_update.sparse_adagrad_update(  # noqa: E731
            w1, a1, rid, grows, *args)
        ms, plain_ms = [], []
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                ms.append(time_ms(call, reps=500))
            else:
                plain_ms.append(time_ms(lambda: adagrad.apply_rows_plain(
                    w2, a2, rid, grows, opt.kind, *args[:3]), reps=200))
        out[f"{name}_ms"], out[f"{name}_plain_ms"] = min(ms), min(plain_ms)
        out[f"{name}_device"] = update_device_us(call, f"the {name} update at {what}")
        out[f"{name}_K"] = rid.shape[0]
        out["ms"] += min(ms)
        out["plain_ms"] += min(plain_ms)
        del w1, a1, w2, a2
    torch.cuda.empty_cache()
    return out


def ffm_step_check(model, bd: dict, what: str) -> dict:
    """The fused FFM forward and backward against their plain versions at
    the inputs one train step hands FfmFused (FwModel.ffm_outputs: the ids,
    the values or the step's cached ones, the fields) over the model's own
    table, with a gradient from a seed; bounds of :func:`agrees`, padded
    positions of the gradient exactly 0. Per call: wall time from CUDA
    events (plain, kernel, kernel, plain), device time from torch.profiler,
    and the bound (:func:`ffm_work`)."""
    import numpy as np
    import torch

    from fwumious_wabbit_tpu_torch.ops import ffm

    ids = bd["ffm_ids"].to(torch.int32).contiguous()
    vals = bd.get("ffm_vals")
    vals = (torch.ones(ids.shape, device=ids.device) if vals is None
            else vals).contiguous()
    fields = bd["ffm_fields"].to(torch.int32).contiguous()
    F, k, spec = model.num_fields, model.ffm_k, model.ffm_spec
    args = (model.ffm_w, ids, vals, fields, F, k, spec)
    B, N = ids.shape
    g = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(B, F * (F + 1) // 2)).astype(np.float32)).to(ids.device)
    calls = {"fwd": (lambda: ffm.ffm_fused(*args),
                     lambda: ffm.ffm_fused_reference(*args)),
             "bwd": (lambda: ffm.ffm_fused_bwd(g, *args),
                     lambda: ffm.ffm_fused_bwd_reference(g, *args))}
    out = {"B": int(B), "N": int(N)}
    for name, (kernel, plain) in calls.items():
        got = kernel()
        torch.cuda.synchronize()
        ok, err, limit = agrees(got, plain())
        check(ok, f"fused {name} disagrees with plain at {what}: {err} > {limit}")
        if name == "bwd":
            pad = (fields < 0) | (fields >= F) | (vals == 0)
            check(int(torch.count_nonzero(got[pad])) == 0,
                  f"fused backward moves padded positions at {what}")
        ms, plain_ms = [], []
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                ms.append(time_ms(kernel, reps=1000))
            else:
                plain_ms.append(time_ms(plain, reps=100))
        out[name] = {"max_abs_err": err, "ms": min(ms), "plain_ms": min(plain_ms),
                     "device_us": device_us(kernel, f"fused {name} at {what}")["device_us"],
                     "plain_device_us": device_us(
                         plain, f"plain {name} at {what}")["device_us"],
                     "work": ffm_work(ids, vals, fields, F, k, spec, name == "bwd")}
    print(f"kernel ffm_fused at {what} (B={B} N={N} F={F} k={k}, the model's "
          f"own table): " + json.dumps(out), flush=True)
    return out


def train_breakdown(data: Path, device, n_b: int = 8) -> dict:
    """One full-width train step's layers, timed one after another on n_b
    batches of 1024 lines (host clock, the card synchronized after each
    device layer), and the steps' device time by kernel from
    torch.profiler."""
    import torch

    from fwumious_wabbit_tpu_torch.train import step as st

    model, hb, t = train_batches(data, device, n_b)

    stages = ("h2d", "gather", "forward", "backward", "count_scaling_and_dedup",
              "update_lr", "update_ffm")
    acc = dict.fromkeys(stages, 0.0)

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        acc[name] += time.perf_counter() - t0
        return out

    def layered(bd_host):
        bd = timed("h2d", lambda: st.to_device(bd_host, st.TRAIN_KEYS, device))
        leaves = timed("gather", lambda: st.gather(model, bd))
        x, p, dlogit, res = timed("forward", lambda: st.forward(model, bd, leaves))
        grads, _ = timed("backward", lambda: st.backward(model, x, leaves, dlogit, res))
        (lr_rid, lr_g, _), (ffm_rid, ffm_g, _) = timed(
            "count_scaling_and_dedup",
            lambda: (st.lr_update_rows(model, bd, grads[0]),
                     st.ffm_update_rows(model, bd, grads[1])))
        timed("update_lr", lambda: model.opt_lr.apply_rows(
            model.lr_w, model.lr_acc, lr_rid, lr_g, pre_scaled=True))
        timed("update_ffm", lambda: model.opt_ffm.apply_rows(
            model.ffm_w, model.ffm_acc, ffm_rid, ffm_g, pre_scaled=True))
        return p

    step = st.make_train_step(model)
    for b in hb[:2]:  # warm
        step(b).cpu()
    for b in hb:
        layered(b)
    for name in stages:
        t[f"{name}_us"] = acc[name] / n_b * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in hb:
        step(b)
    torch.cuda.synchronize()
    t["train_step_wall_us"] = (time.perf_counter() - t0) / n_b * 1e6

    def run():
        t0 = time.perf_counter()
        for b in hb:
            step(b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    rows, wall = device_rows(run, "the train steps")
    prof_rows = sorted(((dt, key[:60], n) for key, dt, n in rows), reverse=True)
    dev_total = sum(dt for _, dt, _ in rows)
    n_kernels = sum(n for _, _, n in rows)
    t["profiled_wall_us_per_step"] = wall / n_b * 1e6
    t["device_busy_us_per_step"] = dev_total / n_b
    t["device_kernels_per_step"] = n_kernels / n_b
    t["device_idle_share"] = 1.0 - dev_total / (wall * 1e6)
    t["device_kernels"] = [(name, count, round(dt / n_b, 2))
                           for dt, name, count in prof_rows[:12]]
    return t


def tf32_off() -> None:
    """f32 products at full precision, as the JAX model's Precision.HIGHEST:
    no TF32 in torch.matmul on the card."""
    import torch

    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32,
          f"TF32 is allowed (float32 matmul precision "
          f"{torch.get_float32_matmul_precision()!r}, cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32})")
    print("TF32: off (float32 matmul precision 'highest', "
          "cuda.matmul.allow_tf32 False, cudnn.allow_tf32 False)", flush=True)


def tower_phase(data: Path, device) -> dict:
    """7c: tower training at full width through the CLI (the tower model's
    flags, synthetic.tower_argv), on --fwt_no_native and on the default
    path, each a main path on the card against the same CLI on the CPU, and
    against each other; ``-t -i`` and the daemon on the saved model; the
    FFM backward at a tower step's own cotangent."""
    from fwumious_wabbit_tpu_torch import synthetic
    from fwumious_wabbit_tpu_torch.train.loop import main

    tf32_off()
    base = synthetic.tower_argv()
    py = trained_path(data, "tower_python_gpu", ["--fwt_no_native"], base)
    cpu_preds, cpu_fwt, py_cpu_ex_s = train_cli(
        data, "tower_python_cpu", ["--fwt_no_native", "--fwt_platform", "cpu"],
        base=base)
    py_vs_cpu = compare_runs("tower training --fwt_no_native, card vs CPU", py,
                             {"preds": cpu_preds, "fwt": cpu_fwt}, TRAIN_ATOL)
    nat = trained_path(data, "tower_native_gpu", [], base)
    vs_python = compare_runs("tower training, default path vs --fwt_no_native on "
                             "the card", nat, py, PRED_UNIT)
    cpu_preds, cpu_fwt, nat_cpu_ex_s = train_cli(
        data, "tower_native_cpu", ["--fwt_platform", "cpu"], base=base)
    vs_cpu = compare_runs("tower training, default path, card vs CPU", nat,
                          {"preds": cpu_preds, "fwt": cpu_fwt}, TRAIN_ATOL)
    ll = logloss(nat["preds"], data)
    print(f"tower training progressive logloss over {nat['preds'].size} lines: "
          f"card {ll!r}, CPU {logloss(cpu_preds, data)!r}", flush=True)

    lines = data.read_bytes().splitlines(keepends=True)
    want = plain_predictions(nat["fwt"], data)
    out = data.with_name("chip_smoke_tower_preds.out")
    rc = main(["-t", "-i", str(nat["fwt"]), "--data", str(data), "-p", str(out)])
    check(rc == 0, f"-t -i predict of the tower model exited {rc}")
    compare(f"tower model -t -i predict ({len(lines)} lines)",
            out.read_bytes().splitlines(keepends=True), want)
    port = free_port()
    start_daemon(nat["fwt"], port)
    c = Client(port)
    compare("tower model daemon request/response (64 lines)",
            [c.send(line) for line in lines[:64]], want[:64])
    c.close()
    return {"python": {**py, "cpu_ex_s": py_cpu_ex_s, **py_vs_cpu},
            "native": {**nat, "cpu_ex_s": nat_cpu_ex_s, "vs_python": vs_python,
                       "vs_cpu": vs_cpu, "logloss": ll},
            "cotangent": tower_cotangent_check(data, device)}


def tower_cotangent_check(data: Path, device) -> dict:
    """The fused FFM backward against its plain version at the cotangent a
    tower step gives it: after one full-width tower step, the next batch's
    ``g_x[:, C:]`` from the manual tower backward (train/step.py
    tower_backward), which differs across the row, unlike the tower-less
    step's repeated dlogit. Bounds of :func:`agrees`; padded positions of
    the gradient exactly 0."""
    import torch

    from fwumious_wabbit_tpu_torch import synthetic
    from fwumious_wabbit_tpu_torch.ops import ffm
    from fwumious_wabbit_tpu_torch.train import step as st

    model, hb, _ = train_batches(data, device, 2, synthetic.tower_training_config)
    st.make_train_step(model)(hb[0])
    bd = st.to_device(hb[1], st.TRAIN_KEYS, device)
    leaves = st.gather(model, bd)
    _, _, dlogit, residuals = st.forward(model, bd, leaves)
    g_x = st.tower_backward(model, residuals, dlogit)[0]
    g = g_x[:, model.num_combos:].contiguous()
    varies = int(((g.max(dim=1).values - g.min(dim=1).values) > 0).sum())
    check(varies > 0, "the tower's cotangent of the FFM outputs is the same "
                      "across every row: the check would show nothing new")
    ids = bd["ffm_ids"].to(torch.int32).contiguous()
    vals = bd["ffm_vals"].contiguous()
    fields = bd["ffm_fields"].to(torch.int32).contiguous()
    args = (model.ffm_w, ids, vals, fields, model.num_fields, model.ffm_k,
            model.ffm_spec)
    got = ffm.ffm_fused_bwd(g, *args)
    torch.cuda.synchronize()
    ok, err, limit = agrees(got, ffm.ffm_fused_bwd_reference(g, *args))
    check(ok, f"fused backward disagrees with plain at the tower's cotangent: "
              f"{err} > {limit}")
    pad = (fields < 0) | (fields >= model.num_fields) | (vals == 0)
    check(int(torch.count_nonzero(got[pad])) == 0,
          "fused backward moves padded positions at the tower's cotangent")
    res = {"B": int(ids.shape[0]), "N": int(ids.shape[1]), "max_abs_err": err,
           "bound": limit, "rows_that_vary": varies}
    print(f"kernel ffm_fused_bwd at a tower step's own cotangent g_x[:, C:] "
          f"(B={res['B']} N={res['N']}, {varies} of {res['B']} rows vary "
          f"across the row): max_abs_err {err!r} (bound 1e-5·(1+max|plain|)); "
          f"padded positions 0", flush=True)
    del model
    torch.cuda.empty_cache()
    return res


def tower_rate_phase(big: Path, device, n_lines: int, packed: tuple) -> dict:
    """7d: one default-path run of the tower model over the ``n_lines``
    lines of ``big`` (a main path), and a profiler window of 64 packed tower
    steps over 7b's superbatches (``packed``) on a fresh tower model."""
    import torch

    from fwumious_wabbit_tpu_torch import synthetic
    from fwumious_wabbit_tpu_torch.models.model import FwModel

    _, run, _ = million_run(big, "1m_tower", n_lines, base=synthetic.tower_argv())
    mi, _ = synthetic.tower_training_config(big)
    model = FwModel(mi)
    model.load_params(model.init_params(device))
    prof = profile_window(model, *packed, K=8)
    del model
    torch.cuda.empty_cache()
    return {"run": run, "profile": prof}


def cache_phase(data: Path, big: Path, default_preds) -> dict:
    """7e: the record cache over the 1M file: a recording run (-c
    --fwt_pack_cache off) and a reading run, each a main path; their
    predictions bit-identical and within one unit of the -p file's sixth
    decimal of 7b's 1M run. Then --build_cache_without_training on the
    10k file against the cache a recording run writes for it."""
    from fwumious_wabbit_tpu_torch import synthetic
    from fwumious_wabbit_tpu_torch.ingest import cache
    from fwumious_wabbit_tpu_torch.train.loop import main

    flags = ["-c", "--fwt_pack_cache", "off"]
    fwcache = Path(cache.cache_path_for(big))
    fwcache.unlink(missing_ok=True)
    n_lines = len(default_preds)
    out = {}
    for name in ("record", "read"):
        preds, run, records = million_run(big, f"1m_cache_{name}", n_lines, flags)
        used = any("using cache file" in r for r in records)
        check(used == (name == "read"), f"1M -c run {name}: read a record "
                                        f"cache: {used}")
        check(fwcache.is_file(), f"1M -c run {name}: no record cache at {fwcache}")
        err = float(abs(preds - default_preds).max())
        check(err <= PRED_UNIT, f"1M -c run {name}: predictions differ from "
                                f"7b's 1M run by {err}")
        out[name] = {**run, "preds": preds, "pred_err_vs_1m": err,
                     "bit_identical_to_1m": bool((preds == default_preds).all())}
    same = bool((out["record"]["preds"] == out["read"]["preds"]).all())
    check(same, "the -c reading run's predictions differ from the recording run's")
    header = fwcache.read_bytes()[:16]
    codec = int.from_bytes(header[8:12], "little")
    nbytes = fwcache.stat().st_size

    small = Path(cache.cache_path_for(data))
    small.unlink(missing_ok=True)
    train_cli(data, "cache_record_10k", flags, save=False)
    recorded = small.read_bytes()
    small.unlink()
    rc = main(synthetic.serving_argv() + ["--data", str(data), "-c",
                                          "--build_cache_without_training"])
    check(rc == 0, f"--build_cache_without_training exited {rc}")
    check(small.read_bytes() == recorded, "--build_cache_without_training wrote "
                                          "another cache than the recording run")
    print(f"record cache: codec {cache.CODEC_NAMES.get(codec, codec)} "
          f"({codec}), {nbytes} bytes for {n_lines:,} lines; recording run "
          f"{out['record']['ex_s']:.0f} ex/s, reading run "
          f"{out['read']['ex_s']:.0f} ex/s; their predictions bit-identical: "
          f"{same}; within {max(out['record']['pred_err_vs_1m'], out['read']['pred_err_vs_1m'])!r} "
          f"of 7b's 1M run (bit-identical: "
          f"{out['read']['bit_identical_to_1m']}); --build_cache_without_training "
          f"on the 10k file: {len(recorded)} bytes, equal to the recording "
          f"run's", flush=True)
    for name in ("record", "read"):
        del out[name]["preds"]
    fwcache.unlink()
    return {**out, "codec": codec, "bytes": nbytes}


# -- phase 7f: convert and the weight patcher; 7g: the sharded step ----------------

# the bound of the JAX package's quantization tests on the predictions of a
# quantized model (tests/test_ffi.py:121, tests/test_inputs_and_config.py:113)
QUANT_ATOL = 5e-3
SHARDED_STEPS = 10


def convert_phase(data: Path, trained: Path) -> dict:
    """7f: --convert_inference_regressor of phase 7's trained model (the
    default path's, with its AdaGrad state) on the card and with
    --fwt_platform cpu, as is and with --weight_quantization: the two
    files byte-equal; each converted file's -t -i on the card and on the
    embedded C++ engine over the 10k file, against the unconverted
    model's plain predictions (within 2e-6, or QUANT_ATOL quantized) and
    against each other (within 2e-6)."""
    import numpy as np

    from fwumious_wabbit_tpu_torch.train.loop import main

    want = plain_predictions(trained, data)
    out = {"input_bytes": trained.stat().st_size}
    for quant in (False, True):
        tag = "quantized" if quant else "plain"
        q = ["--weight_quantization"] if quant else []
        files, secs = {}, {}
        for where, extra in (("card", []), ("cpu", ["--fwt_platform", "cpu"])):
            path = data.with_name(f"chip_smoke_convert_{tag}_{where}.fwt")
            t0 = time.perf_counter()
            rc = main(["--convert_inference_regressor", str(path), "-i",
                       str(trained), *q, *extra])
            secs[where] = time.perf_counter() - t0
            check(rc == 0, f"convert ({tag}, {where}) exited {rc}")
            files[where] = path
        check(files["card"].read_bytes() == files["cpu"].read_bytes(),
              f"convert ({tag}): the card's file differs from the CPU's")
        files["cpu"].unlink()
        preds = {}
        for engine, extra in (("device", []),
                              ("native", ["--fwt_serve_engine", "native"])):
            p = data.with_name(f"chip_smoke_convert_{tag}_{engine}.out")
            rc = main(["-t", "-i", str(files["card"]), "--data", str(data),
                       "-p", str(p), *extra])
            check(rc == 0, f"-t -i of the {tag} converted model ({engine}) "
                           f"exited {rc}")
            preds[engine] = np.array([float(x) for x in p.read_text().split()])
            check(preds[engine].shape == want.shape and valid_preds(preds[engine]),
                  f"{tag} converted model ({engine}): bad predictions")
        bound = QUANT_ATOL if quant else REPLY_ATOL
        err = {e: float(np.abs(v - want).max()) for e, v in preds.items()}
        engines = float(np.abs(preds["device"] - preds["native"]).max())
        check(max(err.values()) <= bound, f"{tag} converted model: max |pred − "
                                          f"unconverted plain| {err} > {bound}")
        check(engines <= REPLY_ATOL, f"{tag} converted model: the engines differ "
                                     f"by {engines}")
        size = files["card"].stat().st_size
        print(f"convert ({tag}): {size} bytes from {out['input_bytes']}, "
              f"{secs['card']:.2f} s on the card, {secs['cpu']:.2f} s with "
              f"--fwt_platform cpu, the two files byte-equal; -t -i over "
              f"{want.size} lines: card max |pred − unconverted plain| = "
              f"{err['device']!r}, embedded C++ engine {err['native']!r} (bound "
              f"{bound!r}), engines within {engines!r}", flush=True)
        out[tag] = {"bytes": size, "seconds": secs, "max_abs_err": err,
                    "engines_max_abs_diff": engines}
        files["card"].unlink()
    return out


def patcher_phase(a: Path, b: Path, data: Path) -> dict:
    """7f: the weight patcher's C++ tool, built at first use from the port's
    sources, between two full-width model files of phase 7 (the default
    path's, trained on the card and on the CPU): ``recreate`` rebuilds the
    second byte for byte; then the Python path on two small models, whose
    diff payload equals the C++ tool's."""
    import gzip

    from fwumious_wabbit_tpu_torch import native, synthetic
    from fwumious_wabbit_tpu_torch.tools import weight_patcher as wp

    t0 = time.perf_counter()
    exe = native.weight_patcher()
    build_s = time.perf_counter() - t0
    diff, rebuilt = data.with_name("chip_smoke_patch.gz"), data.with_name("chip_smoke_rebuilt.fwt")
    t0 = time.perf_counter()
    wp.create_diff(a, b, diff)
    create_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wp.recreate(a, diff, rebuilt)
    recreate_s = time.perf_counter() - t0
    check(rebuilt.read_bytes() == b.read_bytes(),
          "weight patcher: recreate did not rebuild the second model file")
    diff_bytes = diff.stat().st_size
    changed = len(gzip.decompress(diff.read_bytes()))
    rebuilt.unlink()

    mi, vw = synthetic.serving_config(data)
    mi.bit_precision = mi.ffm_bit_precision = 12
    small = [data.with_name(f"chip_smoke_small_{i}.fwt") for i in (0, 1)]
    for path, seed in zip(small, (SEED, SEED + 1)):
        write_model(path, mi, vw, seed)
    pd, cd = data.with_name("chip_smoke_small.py.gz"), data.with_name("chip_smoke_small.cc.gz")
    t0 = time.perf_counter()
    wp.create_diff(small[0], small[1], pd, use_native=False)
    wp.recreate(small[0], pd, rebuilt, use_native=False)
    py_s = time.perf_counter() - t0
    wp.create_diff(small[0], small[1], cd, use_native=True)
    check(rebuilt.read_bytes() == small[1].read_bytes(),
          "weight patcher: the Python path did not rebuild the small model")
    check(gzip.decompress(pd.read_bytes()) == gzip.decompress(cd.read_bytes()),
          "weight patcher: the Python and C++ diffs differ")
    print(f"weight patcher: C++ tool {exe.name} built in {build_s:.2f} s; "
          f"create_diff of two {b.stat().st_size}-byte model files "
          f"{create_s:.2f} s, diff {diff_bytes} bytes gzipped ({changed} bytes "
          f"of entries), recreate {recreate_s:.2f} s, byte for byte; the Python "
          f"path on {small[1].stat().st_size}-byte models {py_s:.2f} s, its "
          f"payload equal to the C++ tool's", flush=True)
    for path in (diff, rebuilt, pd, cd, *small):
        path.unlink()
    return {"build_s": build_s, "create_s": create_s, "recreate_s": recreate_s,
            "diff_bytes": diff_bytes, "entry_bytes": changed,
            "model_bytes": b.stat().st_size, "python_s": py_s}


def sharded_phase(data: Path, device) -> dict:
    """7g: the sharded step (parallel/sharded.py) on an NCCL group of one
    rank, mesh 1×1: ``make_sharded_train_step`` with psum and with a2a for
    SHARDED_STEPS full-width B=1024 steps of the LR+FFM training
    configuration, and a2a once with the tower; each a main path (the
    launch counts set to 0 just before it), held against
    ``train/step.make_train_step`` on the card over the same batches (the
    host counts read by both, as in the CLI): predictions within 1e-6, every table and
    tower tensor within 1e-5·(1+max|·|), with whether they are
    bit-identical, and each step's wall time beside the plain step's."""
    import numpy as np
    import torch

    from fwumious_wabbit_tpu_torch import synthetic
    from fwumious_wabbit_tpu_torch.models.model import FwModel
    from fwumious_wabbit_tpu_torch.parallel import distributed, sharded
    from fwumious_wabbit_tpu_torch.parallel import mesh as pmesh
    from fwumious_wabbit_tpu_torch.train import step as st

    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, None)
    import torch.distributed as dist

    check(dist.get_backend() == "nccl", f"the group's backend is {dist.get_backend()}")
    mesh = pmesh.Mesh(1, 1)
    # a group's first collective creates its NCCL communicator: once here,
    # outside the timed steps
    x = torch.zeros(2, device=device)
    dist.all_reduce(x)
    dist.all_to_all_single(torch.empty_like(x), x)
    pmesh.all_gather(x, mesh.world_group, 1)
    torch.cuda.synchronize()
    out = {}
    for cfg, config, exchanges in (("lr_ffm", None, ("psum", "a2a")),
                                   ("tower", synthetic.tower_training_config, ("a2a",))):
        ref, hb, _ = train_batches(data, device, SHARDED_STEPS, config)
        batches = [st.to_device(b, st.TRAIN_KEYS, device) for b in hb]
        step = st.make_train_step(ref)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = torch.stack([step(b) for b in batches]).cpu().numpy()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) / len(batches) * 1e3
        want_t = model_tensors(ref)
        for ex in exchanges:
            model = FwModel(ref.mi)
            model.load_params(model.init_params(device))
            pmesh.shard_model(model, mesh)
            sstep = sharded.make_sharded_train_step(model, mesh, ex, with_stats=True)
            reset_launch_counts()  # a main path starts here
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = [sstep(b) for b in batches]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / len(batches) * 1e3
            launches = launch_counts()
            what = f"sharded step ({cfg}, {ex}, mesh 1x1, NCCL)"
            for name, n in launches.items():
                check(n > 0, f"{what} never launched the {name} kernel")
            got = torch.stack([p for p, _ in res]).cpu().numpy()
            dropped = int(sum(int(s["a2a_dropped"]) for _, s in res))
            check(dropped == 0, f"{what}: {dropped} a2a occurrences dropped")
            pred_err = float(np.abs(got - want).max())
            check(valid_preds(got) and pred_err <= 1e-6,
                  f"{what}: predictions differ from make_train_step by {pred_err}")
            got_t, errs, identical = model_tensors(model), {}, bool((got == want).all())
            for key, w in want_t.items():
                g = got_t[key]
                errs[key] = (g - w).abs().max().item()
                bound = TRAIN_ATOL * (1.0 + w.abs().max().item())
                check(errs[key] <= bound, f"{what}: {key} differs by {errs[key]} > {bound}")
                identical = identical and bool(torch.equal(g, w))
            per_step = {k: v / len(batches) for k, v in launches.items()}
            print(f"{what}: {len(batches)} steps of B={TRAIN_BATCH}, predictions "
                  f"max |diff| vs make_train_step {pred_err!r} (bound 1e-6), "
                  f"tensors max |diff| {json.dumps(errs)} (bound "
                  f"1e-5·(1+max|·|)), bit-identical: {identical}; launches per "
                  f"step {json.dumps(per_step)}; {ms:.3f} ms per step wall, "
                  f"make_train_step {plain_ms:.3f} ms", flush=True)
            out[f"{cfg}_{ex}"] = {"pred_err": pred_err, "tensor_err": errs,
                                  "identical": identical, "launches": launches,
                                  "launches_per_step": per_step, "ms": ms,
                                  "plain_ms": plain_ms}
            del model, sstep, res
        del ref, step
        torch.cuda.empty_cache()
    distributed.shutdown()
    return out


# -- phase 11: the one-command mesh ---------------------------------------------

FOUR_CARD_RUNS = ("a", "b", "f", "h")


def refusal_check(data: Path, count: int) -> dict:
    """A mesh that does not cover the host's ``count`` cards: the CLI exits
    1, names the flags and the count, and writes nothing."""
    from fwumious_wabbit_tpu_torch import synthetic
    from fwumious_wabbit_tpu_torch.train.loop import main

    n_table = 4 if count < 4 else count + 1
    out = data.with_name("chip_smoke_refused.out")
    fwt = data.with_name("chip_smoke_refused.fwt")
    flags = ["--fwt_table_axis", str(n_table)]
    with ElapsedLog() as el:
        rc = main(synthetic.serving_argv() + ["--data", str(data), *flags,
                                              "-p", str(out), "-f", str(fwt),
                                              "--save_resume"])
    said = "\n".join(el.records)
    check(rc == 1, f"{' '.join(flags)} on {count} card(s) exited {rc}, not 1")
    check(" ".join(flags) in said and f"the {count} device(s)" in said,
          f"the refusal does not name the flags and the count: {said!r}")
    check(not out.exists() and not fwt.exists(), "the refused run wrote a file")
    print(f"launcher: {' '.join(flags)} on {count} card(s) refused, exit 1: "
          f"{said.splitlines()[-1]}", flush=True)
    return {"flags": flags, "cards": count, "rc": rc}


def four_card_phase(big: Path) -> dict | None:
    """Phase 11's four-card runs (multicard.run_all), or None on fewer
    cards, said in one line."""
    import torch

    from fwumious_wabbit_tpu_torch import multicard

    count = torch.cuda.device_count()
    if count < multicard.CARDS:
        print(f"four-card phase: not run: it needs {multicard.CARDS} cards and "
              f"this host has {count}", flush=True)
        return None
    torch.cuda.empty_cache()
    res = multicard.run_all(list(FOUR_CARD_RUNS), train_data=big)
    for name, run in res["runs"].items():
        for mesh in run["meshes"]:
            print(multicard.summary(name, mesh, res["device"]), flush=True)
    return res


def four_card_launches(res: dict, kernel: str) -> dict:
    """A kernel's launches per four-card step on rank 0 of each run, and
    on every rank in total."""
    out = {}
    for name, run in res["runs"].items():
        for mesh in run["meshes"]:
            key = f"{name} {' '.join(mesh['flags'])}"
            ranks = mesh["numbers"]["ranks"]
            out[key] = {"per_step_rank0": ranks[0]["launches_per_step"][kernel],
                        "per_step_each_rank": [r["launches_per_step"][kernel]
                                               for r in ranks]}
    return out


# -- phase 12: the deployment chain ------------------------------------------------


def deployment_phase(big: Path, data: Path, card: str) -> dict:
    """Phase 12: deployment.run over ``big``, its probe lines from ``data``,
    its numbers printed beside the card."""
    import torch

    from fwumious_wabbit_tpu_torch import deployment

    torch.cuda.empty_cache()
    out = deployment.run(big, data, data.parent / "deployment")
    print(f"deployment chain on {card}", flush=True)
    deployment.report(out)
    print(f"  on {card}", flush=True)
    return out


# -- phase 10: the learning-quality gates ---------------------------------------

SMOKE_GATES = ("ffm", "er200k")  # gates.py "short"; "full" runs apart (README)
GATE3_BATCH = 16384


def gate_config(argv: list, data: Path):
    """``(mi, vw)`` of a gate's flags over the namespace map beside
    ``data``."""
    from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
    from fwumious_wabbit_tpu_torch.config.model_instance import ModelInstance
    from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap

    vw = VwNamespaceMap.from_dataset_dir(str(data))
    return ModelInstance.from_cmdline(build_parser().parse_args(argv), vw), vw


def gate_files(gate: str, platform: str) -> dict:
    """The prediction files and the model file of a gate's run."""
    from fwumious_wabbit_tpu_torch import gates

    d = gates.WORK / platform / gate
    if gate == "ffm":
        return {"preds": [d / "training.txt", d / "hard_full.txt", d / "hard_inf.txt"],
                "fwt": d / "full.fwt", "inference": d / "inference.fwt"}
    return {"preds": [d / "er200k_test.out"], "fwt": d / "er200k.fwt"}


def gate_vs_cpu(gate: str) -> dict:
    """A gate's card run against its run with --fwt_platform cpu: every
    prediction within TRAIN_ATOL, the model files' tables within
    1e-5·(1+max|cpu|) (compare_runs); for the FFM gate, the card's
    inference file byte-equal to the CPU's convert of the card's own full
    model, and whether it equals the CPU run's inference file too (the two
    runs' models differ in last bits: their sums run in other orders)."""
    import numpy as np

    from fwumious_wabbit_tpu_torch import gates
    from fwumious_wabbit_tpu_torch.train.loop import main

    card, cpu = gate_files(gate, "cuda"), gate_files(gate, "cpu")
    got, want = ({"preds": np.concatenate([gates.read_preds(p) for p in f["preds"]]),
                  "fwt": f["fwt"]} for f in (card, cpu))
    out = compare_runs(f"gate {gate}, card vs CPU", got, want, TRAIN_ATOL)
    if gate == "ffm":
        again = card["inference"].with_name("inference_by_cpu.fwt")
        rc = main(gates.FFM_ARGV + ["-i", str(card["fwt"]), "--fwt_platform", "cpu",
                                    "--convert_inference_regressor", str(again)])
        check(rc == 0, f"convert of the card's FFM gate model on the CPU exited {rc}")
        raw = card["inference"].read_bytes()
        check(raw == again.read_bytes(), "the FFM gate's inference file differs "
              "from the CPU's convert of the same model")
        out["inference_equals_cpu_run"] = raw == cpu["inference"].read_bytes()
        print(f"gate ffm: the card's inference file ({len(raw)} bytes) is "
              f"byte-equal to the CPU's convert of the card's model; to the CPU "
              f"run's inference file: {out['inference_equals_cpu_run']}", flush=True)
    return out


def gate_launches(gate: str, res: dict) -> dict:
    """The kernels' launches on a gate's card runs (each run's counts set
    to 0 just before it): every kernel of the model on its training run,
    the FFM forward on its -t runs."""
    train = res["train"]["launches"]
    needed = (("ffm_triangle", "ffm_triangle_bwd", "sparse_adagrad_update")
              if gate == "ffm" else ("sparse_adagrad_update",))
    for kernel in needed:
        check(train[kernel] > 0, f"gate {gate}'s training never launched the "
                                 f"{kernel} kernel")
    tests = ("test_full", "test_inference") if gate == "ffm" else ("test",)
    if gate == "ffm":
        for t in tests:
            check(res[t]["launches"]["ffm_triangle"] > 0,
                  f"gate ffm's {t} run never launched the fused FFM forward")
    return {"train": train, "per_train_step": res["launches_per_train_step"],
            **{t: res[t]["launches"] for t in tests}}


def gate3_step_check(device) -> dict:
    """The sparse update kernel against apply_rows_plain at one gate-3
    train step's own LR inputs, as the CLI's default path makes them: the
    producer packs the gate's first 2·16,384 train lines (the C++ ingest,
    host counts, bitpack and vocab on; one superbatch of K=2), the transfer
    stage takes it to the card, unpack_row splits it; the Eat-Rate LR model
    of gates.ER_ARGV trains the first step, and the second step's (rid,
    grows) go to step_update_check (bounds, times, bytes and bound)."""
    import torch

    from fwumious_wabbit_tpu_torch import gates
    from fwumious_wabbit_tpu_torch.config.cmdline import build_parser
    from fwumious_wabbit_tpu_torch.models.model import FwModel
    from fwumious_wabbit_tpu_torch.train import packed
    from fwumious_wabbit_tpu_torch.train import step as st
    from fwumious_wabbit_tpu_torch.train.producer import (
        SuperbatchProducer, Transferrer, arrived)

    K = 2
    head = gates.data_path("er200k_train", gates.WORK).with_name("er200k_head.vw")
    with open(gates.data_path("er200k_train", gates.WORK), "rb") as fh:
        head.write_bytes(b"".join(fh.readline() for _ in range(K * GATE3_BATCH)))
    mi, vw = gate_config(gates.ER_ARGV, head)
    model = FwModel(mi)
    model.load_params(model.init_params(device))

    class Sink(list):
        put = list.append

    sink, state = Sink(), packed.VocabTransferState()
    SuperbatchProducer(
        build_parser().parse_args(gates.ER_ARGV + ["--data", str(head)]),
        mi, vw, batch_size=GATE3_BATCH, K=K, can_pack=True,
        count_keys={"lr": 0}, cut_at=None, holdout_after=None, out_queue=sink,
        ctr={"producer_stall_s": 0.0},
        xfer_stats={"starve_s": 0.0, "xfer_s": 0.0, "put_s": 0.0, "bytes": 0},
        vocab_state=state).run()
    state.close()
    check(isinstance(sink[-1], type(None)), f"the producer failed: {sink[-1]!r}")
    # the steps in stream order; a layout change (the vocabulary grows)
    # closes a superbatch early, and a snapshot holds for what follows it
    tr, vocab, steps = Transferrer(device), None, []
    for item in sink[:-1]:
        (dev,), ev = tr.stage([item[1]])
        if item[0] == "v":
            vocab = arrived(dev, ev)
            continue
        lay = item[2]
        rows = packed.unpack_row(arrived(dev, ev), lay, vocab,
                                 packed._Plan(lay, device))
        steps += [{key: v[i] for key, v in rows.items()}
                  for i in range(item[1].shape[0])]
    check(len(steps) == K, f"the producer made {len(steps)} steps of "
                           f"{K * GATE3_BATCH} lines")
    st.make_train_step(model)(steps[0])
    out = step_update_check(model, steps[1],
                            f"a gate-3 train step (B={GATE3_BATCH})")
    del model, steps
    torch.cuda.empty_cache()
    return out


def gates_phase(device) -> dict:
    """Phase 10: gates.py's ``short`` gates on the card, each a main path
    (gates.cli sets the launch counts to 0 before each run), within its
    bound; each again with --fwt_platform cpu, the card held to it
    (:func:`gate_vs_cpu`); then the update kernel at a gate-3 step's own
    inputs (:func:`gate3_step_check`)."""
    from fwumious_wabbit_tpu_torch import gates

    out = {}
    for gate in SMOKE_GATES:
        card = gates.run(gate)
        print(gates.summary(card), flush=True)
        check(card["passed"], f"gate {gate} on the card missed its bound")
        cpu = gates.run(gate, cpu=True)
        print(gates.summary(cpu), flush=True)
        out[gate] = {"card": card, "cpu": cpu, "vs_cpu": gate_vs_cpu(gate),
                     "launches": gate_launches(gate, card)}
        print(f"kernel launches on gate {gate}'s card runs: "
              f"{json.dumps(out[gate]['launches'])}", flush=True)
    out["step"] = gate3_step_check(device)
    return out


def step_bound(step_upd: dict) -> dict:
    """The sparse update's bound per train step: its LR and FFM calls."""
    lr, fm = step_upd["lr_bound"], step_upd["ffm_bound"]
    return {"bytes": lr["bytes"] + fm["bytes"], "ops": lr["ops"] + fm["ops"],
            "bound_ms": lr["bound_ms"] + fm["bound_ms"],
            "bound_by": lr["bound_by"] if lr["bound_by"] == fm["bound_by"] else "bytes"}


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, work,
               device_us_per_call, per_batch, per_step, per_packed_step,
               default_path_launches, default_path, tower: dict) -> dict:
    """One kernel's entry of the kernels line. ``ms``, ``plain_ms``,
    ``bound_ms`` and ``device_us`` are at the shapes of the serving batch
    (forward) or the --fwt_no_native train step; ``default_path`` holds the
    same at one default-path train step's own inputs; ``tower`` its
    launches on the tower's paths (7c, 7d)."""
    work_d = default_path.pop("work")
    return {"name": name, "route": "cuda",
            "source": "fwumious_wabbit_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": work["bound_ms"],
            "bound_by": work["bound_by"], "library_ms": None,
            "bound_us": work["bound_ms"] * 1e3, "bytes": work["bytes"],
            "device_us": device_us_per_call,
            "launches_per_serving_batch": per_batch,
            "launches_per_train_step": per_step,
            "launches_per_packed_train_step": per_packed_step,
            "launches_on_the_default_training_path": default_path_launches,
            "default_path_step": {**default_path, "bytes": work_d["bytes"],
                                  "bound_ms": work_d["bound_ms"],
                                  "bound_by": work_d["bound_by"]},
            **tower}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is False: this smoke "
                         "test needs a CUDA card")
    check((ROOT / "fwumious_wabbit_tpu_torch").is_dir(),
          "run chip_smoke.py from the root of a checkout of the repository")
    block_jax_package()
    sys.path.insert(0, str(ROOT))

    from fwumious_wabbit_tpu_torch import gates, native, synthetic
    from fwumious_wabbit_tpu_torch.ops import ffm
    from fwumious_wabbit_tpu_torch.ops.kernels import build
    from fwumious_wabbit_tpu_torch.persistence.model_file import load_model
    from fwumious_wabbit_tpu_torch.utils.device import nvidia_smi_line, resolve_device

    t_start = time.time()
    card = nvidia_smi_line()
    print(f"device: {card}", flush=True)
    device = resolve_device()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    # the C++ host engine (g++, the -p reply formatter) builds beside nvcc
    host_engine = threading.Thread(target=native.load, daemon=True)
    host_engine.start()
    for src in build.sources():  # the first load builds every source at once
        build.load(src.stem)
    host_engine.join()
    PHASE_SECONDS["build"] = time.perf_counter() - t0
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds:.2f} s; host engine "
          f"{'built' if native.load() is not None else 'unavailable: ' + native.load_error})",
          flush=True)
    print(f"  on {card}", flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "smem" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    data = synthetic.ensure_dataset(ROOT / ".bench_cache" / "chip_smoke", 10_000)
    dataset = start_dataset(data.parent, 1_000_000)
    mi, vw = synthetic.serving_config(data)
    gate_mi, _ = gate_config(gates.FFM_ARGV, data)
    with phase("3-4 ffm kernels"):
        kern = kernel_phase(device, {(2, 8): mi.ffm_weights_len,
                                     (2, 10): gate_mi.ffm_weights_len})
    with phase("5 sparse update kernel"):
        upd = update_phase(device)
        step_upd = step_update_phase(data, device)

    paths = (data.with_name("chip_smoke_a.fwt"), data.with_name("chip_smoke_b.fwt"))
    for path, seed in zip(paths, (SEED, SEED + 1)):
        write_model(path, mi, vw, seed)
    mem0 = torch.cuda.memory_allocated()
    _, _, probe = load_model(paths[0], immutable=True, device=device)
    table_bytes = sum(b.numel() * b.element_size() for b in probe.buffers())
    print(f"model: -b {mi.bit_precision} --ffm_bit_precision "
          f"{mi.ffm_bit_precision} F={mi.num_ffm_fields} k={mi.ffm_k} "
          f"combos={mi.num_combos}; tables hold {table_bytes} bytes on the "
          f"device ({torch.cuda.memory_allocated() - mem0} bytes allocated)",
          flush=True)
    del probe
    torch.cuda.empty_cache()

    with phase("6 serving"):
        ffm.LAUNCHES = 0  # the serving path starts here
        srv = serving_phase(data, paths)
        launches = ffm.LAUNCHES
    print(f"ffm_fused kernel launches on the serving path: {launches}", flush=True)
    check(launches > 0, "the serving path never launched the fused FFM forward")

    with phase("7 training 10k"):
        trn = training_phase(data)  # the Python-ingest training path
        nat = native_training_phase(data, trn)  # the default training path
    with phase("7b training 1M and 200k"):
        big = million_phase(data.parent, dataset=dataset)
        prof, nkern, packed = packed_step_profile(big["path"], device)
    with phase("7c tower training 10k"):
        twr = tower_phase(data, device)
    with phase("7d tower rate"):
        trate = tower_rate_phase(big["path"], device, len(big["preds"]), packed)
        del packed
    with phase("7e record cache"):
        rc_cache = cache_phase(data, big["path"], big["preds"])
    with phase("7f convert and weight patcher"):
        conv = convert_phase(data, nat["fwt"])
        patch = patcher_phase(data.with_name("chip_smoke_train_native_cpu.fwt"),
                              nat["fwt"], data)
    with phase("7g sharded step"):
        shd = sharded_phase(data, device)
    with phase("10 gates"):
        gts = gates_phase(device)
    with phase("11 one-command mesh"):
        refused = refusal_check(data, torch.cuda.device_count())
        four = four_card_phase(big["path"])
    with phase("12 deployment chain"):
        dep = deployment_phase(big["path"], data, card)
    tower_kernels = (trate["profile"]["device_kernels_per_step"]
                     - prof["device_kernels_per_step"])
    print(f"timing: packed tower train steps at full width (K=8, B=1024), per "
          f"step: {json.dumps(trate['profile'])}; the tower adds "
          f"{tower_kernels!r} device kernels and "
          f"{trate['profile']['device_busy_us_per_step'] - prof['device_busy_us_per_step']!r} "
          f"us of device busy per step to 7b's window", flush=True)
    print(f"  on {card}", flush=True)
    print(f"timing: tower training through the CLI at B={TRAIN_BATCH}, 10k "
          f"lines: --fwt_no_native {twr['python']['ex_s']:.0f} ex/s on the card, "
          f"{twr['python']['cpu_ex_s']:.0f} with --fwt_platform cpu; the default "
          f"path {twr['native']['ex_s']:.0f} ex/s on the card, "
          f"{twr['native']['cpu_ex_s']:.0f} with --fwt_platform cpu; 1M lines on "
          f"the default path {trate['run']['ex_s']:.0f} ex/s", flush=True)
    print(f"  on {card}", flush=True)

    t0 = time.perf_counter()
    timing = ffm_timing(paths[0], data, device)
    fwd256, t1024 = timing[256], timing[TRAIN_BATCH]
    for B, res in timing.items():
        w, d = res["wall_us"], res["device"]
        line = (f"timing: at the main path's B={B} N={res['N']} F=2 k=8, per "
                f"call: fused forward {w['fwd']:.2f} us wall, "
                f"{d['fwd']['device_us']:.3f} us device (bound "
                f"{res['fwd_bound']['bound_ms'] * 1e3:.4f} us); plain (gather "
                f"+ triangle) {w['fwd_plain']:.2f} us wall, "
                f"{d['fwd_plain']['device_us']:.3f} us device in "
                f"{d['fwd_plain']['kernels_per_call']:.0f} kernels; "
                f"tables.gather alone {w['gather']:.2f} us wall, "
                f"{d['gather']['device_us']:.3f} us device in "
                f"{d['gather']['kernels_per_call']:.0f} kernels")
        if "bwd" in w:
            line += (f"; fused backward {w['bwd']:.2f} us wall, "
                     f"{d['bwd']['device_us']:.3f} us device (bound "
                     f"{res['bwd_bound']['bound_ms'] * 1e3:.4f} us); plain "
                     f"backward {w['bwd_plain']:.2f} us wall, "
                     f"{d['bwd_plain']['device_us']:.3f} us device")
        print(line, flush=True)
        print(f"  on {card}", flush=True)
    print(f"timing: daemon request/response p50 {srv['p50_us']:.1f} us, p99 "
          f"{srv['p99_us']:.1f} us over {srv['n_rr']} lines", flush=True)
    print(f"  on {card}", flush=True)
    print(f"timing: daemon pipelined burst {srv['burst_lines_s']:.0f} lines/s "
          f"(4096 lines)", flush=True)
    print(f"  on {card}", flush=True)
    print(update_timing_line(
        f"at R=262144 K={TRAIN_BATCH * 15} Zipf ids ({upd['unique_rows']} "
        f"distinct rows)", upd["ms"], upd["plain_ms"], upd["device"]),
        flush=True)
    print(f"  on {card}", flush=True)
    for name in ("lr", "ffm"):
        print(update_timing_line(
            f"at the --fwt_no_native train step's {name.upper()} shape, B={TRAIN_BATCH} "
            f"K={step_upd[name + '_K']}", step_upd[name + "_ms"],
            step_upd[name + "_plain_ms"], step_upd[name + "_device"])
            + f"; bound {json.dumps(step_upd[name + '_bound'])}", flush=True)
        print(f"  on {card}", flush=True)
    print(f"timing: sparse_adagrad_update per train step (LR + FFM): kernel "
          f"{step_upd['ms'] * 1e3:.2f} us vs plain "
          f"{step_upd['plain_ms'] * 1e3:.2f} us", flush=True)
    print(f"  on {card}", flush=True)
    print(f"timing: training through the CLI at B={TRAIN_BATCH}, 10k lines: "
          f"--fwt_no_native {trn['ex_s']:.0f} ex/s on the card, "
          f"{trn['cpu_ex_s']:.0f} ex/s with --fwt_platform cpu; the default "
          f"path {nat['ex_s']:.0f} ex/s on the card, {nat['cpu_ex_s']:.0f} "
          f"ex/s with --fwt_platform cpu (CLI log, ingest included)", flush=True)
    print(f"  on {card}", flush=True)
    for name, run in big["runs"].items():
        print(f"timing: train {run['lines']:,} lines, {name}: {run['ex_s']:.0f} "
              f"ex/s", flush=True)
        print(f"  on {card}", flush=True)
    for name in ("record", "read"):
        print(f"timing: train 1,000,000 lines with -c ({name}): "
              f"{rc_cache[name]['ex_s']:.0f} ex/s", flush=True)
        print(f"  on {card}", flush=True)
    print("timing: packed train steps at full width (K=8, B=1024, the default "
          "path's layout), per step: " + json.dumps(prof), flush=True)
    print(f"  on {card}", flush=True)
    for name in ("fwd", "bwd"):
        r = nkern["ffm"][name]
        print(f"timing: fused FFM {name} at the default path's step (B="
              f"{nkern['ffm']['B']} N={nkern['ffm']['N']}), per call: "
              f"{r['ms'] * 1e3:.2f} us wall, {r['device_us']:.3f} us device "
              f"(bound {r['work']['bound_ms'] * 1e3:.4f} us, "
              f"{r['work']['bytes']} bytes); plain {r['plain_ms'] * 1e3:.2f} "
              f"us wall, {r['plain_device_us']:.3f} us device", flush=True)
        print(f"  on {card}", flush=True)
    for name in ("lr", "ffm"):
        print(update_timing_line(
            f"at the default path's {name.upper()} shape, B={TRAIN_BATCH} "
            f"K={nkern['update'][name + '_K']}", nkern["update"][name + "_ms"],
            nkern["update"][name + "_plain_ms"], nkern["update"][name + "_device"])
            + f"; bound {json.dumps(nkern['update'][name + '_bound'])}", flush=True)
        print(f"  on {card}", flush=True)
    for name, r in shd.items():
        print(f"timing: sharded step ({name}, mesh 1x1, NCCL) {r['ms']:.3f} ms "
              f"per B={TRAIN_BATCH} step wall, make_train_step "
              f"{r['plain_ms']:.3f} ms", flush=True)
        print(f"  on {card}", flush=True)
    print(f"timing: convert of a {conv['input_bytes']}-byte model: plain "
          f"{conv['plain']['seconds']['card']:.2f} s, quantized "
          f"{conv['quantized']['seconds']['card']:.2f} s on the card; weight "
          f"patcher create_diff {patch['create_s']:.2f} s, recreate "
          f"{patch['recreate_s']:.2f} s, diff {patch['diff_bytes']} bytes",
          flush=True)
    print(f"  on {card}", flush=True)
    for gate in SMOKE_GATES:
        for where in ("card", "cpu"):
            r = gts[gate][where]
            tests = ([r["test_full"], r["test_inference"]] if gate == "ffm"
                     else [r["test"]])
            print(f"timing: gate {gate} on the {where}: train "
                  f"{r['train']['rows']:,} lines at {r['train']['ex_s']:.0f} ex/s "
                  f"(CLI Elapsed line), -t {tests[0]['rows']:,} lines at "
                  f"{tests[0]['ex_s']:.0f} lines/s; the gate {r['seconds']:.1f} s",
                  flush=True)
            print(f"  on {card if where == 'card' else 'the host CPU'}", flush=True)
    g3 = gts["step"]
    print(update_timing_line(
        f"at a gate-3 train step's LR shape, B={GATE3_BATCH} K={g3['lr_K']}",
        g3["lr_ms"], g3["lr_plain_ms"], g3["lr_device"])
        + f"; bound {json.dumps(g3['lr_bound'])}", flush=True)
    print(f"  on {card}", flush=True)
    PHASE_SECONDS["8 ffm timing"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    layers = layer_breakdown(paths[0], data.read_bytes().splitlines(True), device)
    print("timing: layers per 256-line batch: " + json.dumps(layers), flush=True)
    print(f"  on {card}", flush=True)
    tlayers = train_breakdown(data, device)
    print(f"timing: layers per {TRAIN_BATCH}-line train step: "
          + json.dumps(tlayers), flush=True)
    print(f"  on {card}", flush=True)
    PHASE_SECONDS["9 layer breakdowns"] = time.perf_counter() - t0
    check(not [m for m in sys.modules if m.split(".")[0] in BLOCKED],
          "jax or the JAX package was imported")
    print("phase seconds: " + json.dumps(PHASE_SECONDS), flush=True)
    print(f"total {time.time() - t_start:.1f} s", flush=True)

    # launches per step from the main paths' own runs, counts set to 0
    # just before each: the 10k --fwt_no_native run, the 1M default run
    steps_10k = -(-len(trn["preds"]) // TRAIN_BATCH)
    per_step = {k: v / steps_10k for k, v in trn["launches"].items()}
    packed_step = big["runs"]["default"]["launches_per_step"]
    nat_launches = nat["launches"]
    upd_dev = step_upd["lr_device"]["device_us"] + step_upd["ffm_device"]["device_us"]
    nf, nu = nkern["ffm"], nkern["update"]
    nat_upd = {"max_abs_err": nu["max_abs_err"], "ms": nu["ms"],
               "plain_ms": nu["plain_ms"], "work": step_bound(nu),
               "device_us": nu["lr_device"]["device_us"] + nu["ffm_device"]["device_us"],
               "K": {"lr": nu["lr_K"], "ffm": nu["ffm_K"]}}
    nat_fwd = {**nf["fwd"], "B": nf["B"], "N": nf["N"]}
    nat_bwd = {**nf["bwd"], "B": nf["B"], "N": nf["N"]}
    tower_steps_10k = -(-len(twr["native"]["preds"]) // TRAIN_BATCH)

    def tower(kernel: str) -> dict:
        return {"launches_on_the_tower_training_path": twr["native"]["launches"][kernel],
                "launches_per_tower_step": twr["python"]["launches"][kernel]
                / tower_steps_10k,
                "launches_per_packed_tower_step":
                    trate["run"]["launches_per_step"][kernel],
                "launches_on_the_sharded_path": {
                    k: v["launches"][kernel] for k, v in shd.items()},
                "launches_per_sharded_step": {
                    k: v["launches_per_step"][kernel] for k, v in shd.items()}}
    rows = [
        kernel_row("ffm_triangle", "ffm_triangle.cu",
                   "fwumious_wabbit_tpu/ops/pallas/ffm.py:131 (with the slab "
                   "gather of ops/tables.py)", launches,
                   max(kern["fwd"], nat_fwd["max_abs_err"]),
                   fwd256["wall_us"]["fwd"] / 1e3,
                   fwd256["wall_us"]["fwd_plain"] / 1e3, fwd256["fwd_bound"],
                   fwd256["device"]["fwd"]["device_us"],
                   layers["ffm_fused_launches_per_batch"],
                   per_step["ffm_triangle"], packed_step["ffm_triangle"],
                   nat_launches["ffm_triangle"], nat_fwd, tower("ffm_triangle")),
        kernel_row("ffm_triangle_bwd", "ffm_triangle.cu",
                   "jax.vjp of models/model.py:418-443 (no Pallas kernel)",
                   trn["launches"]["ffm_triangle_bwd"],
                   max(kern["bwd"], nat_bwd["max_abs_err"]),
                   t1024["wall_us"]["bwd"] / 1e3,
                   t1024["wall_us"]["bwd_plain"] / 1e3, t1024["bwd_bound"],
                   t1024["device"]["bwd"]["device_us"], 0,
                   per_step["ffm_triangle_bwd"], packed_step["ffm_triangle_bwd"],
                   nat_launches["ffm_triangle_bwd"], nat_bwd,
                   {**tower("ffm_triangle_bwd"),
                    "tower_cotangent_max_abs_err": twr["cotangent"]["max_abs_err"]}),
        kernel_row("sparse_adagrad_update", "sparse_update.cu",
                   "fwumious_wabbit_tpu/ops/pallas/sparse_update.py:315",
                   trn["launches"]["sparse_adagrad_update"],
                   max(upd["max_abs_err"], step_upd["max_abs_err"],
                       nat_upd["max_abs_err"]),
                   step_upd["ms"], step_upd["plain_ms"], step_bound(step_upd),
                   upd_dev, 0, per_step["sparse_adagrad_update"],
                   packed_step["sparse_adagrad_update"],
                   nat_launches["sparse_adagrad_update"], nat_upd,
                   tower("sparse_adagrad_update"))]
    for row in rows:  # launches on phase 10's gate paths
        row["launches_on_the_gate_paths"] = {
            gate: {run: v[row["name"]] for run, v in gts[gate]["launches"].items()
                   if run != "per_train_step"} for gate in SMOKE_GATES}
        row["launches_per_gate_train_step"] = {
            gate: gts[gate]["launches"]["per_train_step"][row["name"]]
            for gate in SMOKE_GATES}
    rows[2]["gate3_step"] = {
        "K": g3["lr_K"], "max_abs_err": g3["max_abs_err"], "ms": g3["lr_ms"],
        "plain_ms": g3["lr_plain_ms"], "device_us": g3["lr_device"]["device_us"],
        "bytes": g3["lr_bound"]["bytes"], "bound_ms": g3["lr_bound"]["bound_ms"],
        "bound_by": g3["lr_bound"]["bound_by"]}
    rows[2]["max_abs_err"] = max(rows[2]["max_abs_err"], g3["max_abs_err"])
    for row in rows:  # phase 11
        row["launcher_refusal"] = refused
        if four is not None:
            row["launches_per_four_card_step"] = four_card_launches(four, row["name"])
    for row in rows:  # phase 12
        row["launches_on_the_deployment_chain"] = {
            "train_v1_v2": dep["train"]["launches"][row["name"]],
            "daemon": dep["daemon"]["launches"][row["name"]],
            "testonly": (dep["settle"]["testonly_ffm_launches"]
                         if row["name"] == "ffm_triangle" else 0)}
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # noqa: BLE001 — any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
    sys.stdout.flush()
    sys.stderr.flush()
    # the daemon's threads block in accept/recv; leave without joining them
    os._exit(rc)
