"""The command line — the counterpart of ``main`` in
fwumious_wabbit_tpu/train/loop.py, for the modes ported so far:

* ``--daemon -i model.fwt``: the TCP line server (serve/server.py);
* training: ``--data x.vw <model flags> [-p preds] [-f model.fwt
  --save_resume] [-i start.fwt]`` — read VW text, parse, translate, batch,
  then forward, backward and the sparse AdaGrad update on the device; the
  training-path predictions (the forward values before each update) are
  written ``%.6f`` per example after ``--predictions_after``, and the final
  model to ``-f``. ``--holdout_after``, ``--prediction_model_delay``,
  ``--fwt_exact`` (batch 1) and ``--fwt_batch_size`` keep their meaning;
* ``-t`` (with or without ``-i``): the same loop without updates.

Any other mode exits non-zero with "not yet ported": training a dense
tower (``--nn``), the record cache (``-c``), convert, sharding. The flag
vocabulary is the JAX package's (the port's copy in config/cmdline.py).
Every mode runs on the CUDA card; the CPU only with ``--fwt_platform cpu``.
``--fwt_serve_engine`` keeps its meaning, except that ``auto`` means the
device engine here: ``native`` (the port's copy of the embedded C++ engine,
native/) must be asked for, and fails rather than falls back when it
cannot be built. The trainer reads
text through the Python parser, the JAX loop's ``--fwt_no_native`` path;
``--fwt_pallas_update`` is accepted and ignored (on a CUDA tensor the
sparse update kernel always runs).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from ..config.cmdline import build_parser
from ..config.model_instance import ModelInstance
from ..config.vwmap import VwNamespaceMap
from ..ingest import (
    Batcher,
    FeatureTranslator,
    FlushCommand,
    HogwildLoadCommand,
    VowpalParser,
    create_buffered_input,
)
from ..utils.device import NoDeviceError, resolve_device
from ..utils.logging import get_logger
from .predict import PredictionWriter

log = get_logger(__name__)


def _daemonize() -> None:
    """Classic double fork (the reference daemonizes unless --foreground,
    src/serving.rs:215-225); runs before CUDA is initialized. A copy of the
    JAX loop's: that module imports the training pipeline and its record
    cache, which needs ``zstandard``, a package the serving path must not
    require."""
    if os.fork() > 0:
        os._exit(0)
    os.setsid()
    if os.fork() > 0:
        os._exit(0)
    devnull = os.open(os.devnull, os.O_RDWR)
    for fd in (0, 1, 2):
        os.dup2(devnull, fd)
    os.close(devnull)


def _not_ported(args) -> str | None:
    """Why ``args`` asks for a mode this package does not run yet, or None.
    (A dense tower is refused once the model is known, in :func:`main`.)"""
    if args.convert_inference_regressor:
        return "--convert_inference_regressor"
    if args.build_cache_without_training:
        return "--build_cache_without_training"
    if int(args.fwt_table_axis or 1) > 1 or (args.fwt_data_axis or 1) > 1 \
            or args.fwt_hosts:
        return "multi-device sharding (--fwt_table_axis/--fwt_data_axis/--fwt_hosts)"
    if args.daemon:
        return None
    if args.cache:
        return "the record cache (-c)"
    return None


def np_counts(ids: np.ndarray, vals: np.ndarray, shift: int) -> np.ndarray:
    """Multiplicity counts of the keys ``ids >> shift`` over one batch, as
    u8 codes (ops/adagrad.encode_counts) — a copy of the JAX loop's
    Python-ingest ``np_counts``. Entries with value 0 (padding included)
    are not counted: their gradient is 0."""
    from ..ops.adagrad import encode_counts

    keys = ids.astype(np.uint32) >> shift
    real = (vals != 0.0).reshape(-1)
    flat = keys.reshape(-1)
    c = np.zeros(flat.shape, np.int64)
    if real.any():
        _, inv, cnt = np.unique(flat[real], return_inverse=True,
                                return_counts=True)
        c[real] = cnt[inv]
    return encode_counts(c).reshape(ids.shape)


def run_train_loop(args, mi, vw, model) -> None:
    """Train (or, with ``-t``, only predict) over ``args.data``, updating
    the model's tables in place, and log the rate
    (fwumious_wabbit_tpu/train/loop.py ``run_train_loop``, its Python-ingest
    branch)."""
    from .step import make_predict_step, make_train_step, train_batch_dict

    testonly = bool(args.testonly)
    batch_size = 1 if args.fwt_exact else max(1, int(args.fwt_batch_size or 1024))
    predictions_after = int(args.predictions_after or 0)
    holdout_after = (int(args.holdout_after)
                     if args.holdout_after is not None else None)
    delay = int(args.prediction_model_delay or 0)

    parser = VowpalParser(vw)
    translator = FeatureTranslator(mi)
    batcher = Batcher(batch_size)
    writer = PredictionWriter(args.predictions, bool(args.predictions_stdout))
    train_step = None if testonly else make_train_step(model)
    predict_step = make_predict_step(model)

    # host multiplicity counts for the scopes with the batch-mean cap, keyed
    # per weight for LR (id) and per window for FFM (id >> log2 align)
    count_keys = {}
    if model.opt_lr.batch_mean:
        count_keys["lr"] = 0
    if (model.has_ffm and model.opt_ffm.batch_mean
            and model.ffm_spec.rows_per_slab == 1):
        count_keys["ffm"] = (model.ffm_spec.align - 1).bit_length()

    # batches end at the train/holdout boundary
    cut_at = holdout_after - 1 if holdout_after is not None else None
    delayed: list = []  # (batch dict, n) awaiting training under the delay
    delayed_examples = 0
    example_num = 0
    pending: list = []

    def process(bd: dict, n: int) -> None:
        nonlocal example_num, delayed_examples
        first_num = example_num + 1
        example_num += n
        update = not testonly and (holdout_after is None
                                   or first_num < holdout_after)
        if delay == 0:
            preds = train_step(bd) if update else predict_step(bd)
        else:
            # predict with the lagging model, then train what left the
            # queue; the reference's delay path trains every delayed
            # example, holdout or not (src/main.rs:249-258)
            preds = predict_step(bd)
            delayed.append((bd, n))
            delayed_examples += n
            while delayed and delayed_examples - delayed[0][1] >= delay:
                old_bd, old_n = delayed.pop(0)
                delayed_examples -= old_n
                if train_step is not None:
                    train_step(old_bd)
        if writer.active:
            skip = max(0, predictions_after - first_num + 1)
            writer.write_block(preds.cpu().numpy()[:n][skip:])

    def flush() -> None:
        if not pending:
            return
        batch = batcher.make_batch(pending)
        bd = train_batch_dict(batch)
        if "lr" in count_keys:
            bd["lr_counts"] = np_counts(batch.lr_ids, batch.lr_vals,
                                        count_keys["lr"])
        if "ffm" in count_keys and batch.ffm_ids.size:
            bd["ffm_counts"] = np_counts(batch.ffm_ids, batch.ffm_vals,
                                         count_keys["ffm"])
        process(bd, batch.num_examples)
        pending.clear()

    stream = create_buffered_input(args.data)
    t0 = time.time()
    try:
        seen = 0
        while True:
            rec = parser.next_vowpal(stream)
            if rec.size == 0:  # end of file or an empty line
                break
            seen += 1
            pending.append(translator.translate(rec))
            if len(pending) >= batch_size or (cut_at is not None
                                              and seen == cut_at):
                flush()
        flush()
        if delay > 0 and train_step is not None:
            for bd, _n in delayed:
                train_step(bd)
    finally:
        writer.close()
        stream.close()
    elapsed = time.time() - t0
    log.info("Elapsed: %.2fs rows: %d (%.0f ex/s)", elapsed, example_num,
             example_num / max(elapsed, 1e-9))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.quiet:
        logging.getLogger().setLevel(logging.WARNING)

    why = _not_ported(args)
    if why is not None:
        log.error("not yet ported: %s", why)
        return 2
    if args.final_regressor and not args.save_resume:
        log.error("You need to use --save_resume with --final_regressor,"
                  " for vowpal wabbit compatibility")
        return 1
    engine = args.fwt_serve_engine or "auto"

    if args.daemon:
        if not args.initial_regressor:
            log.error("Daemon mode only supports serving from --initial_regressor")
            return 1
        if not args.foreground:
            _daemonize()
    elif engine == "native" and args.testonly and args.initial_regressor:
        # -t -i on the embedded C++ engine, asked for explicitly
        from .predict import run_native_predict

        try:
            run_native_predict(args)
        except (FlushCommand, HogwildLoadCommand, RuntimeError) as e:
            log.error("Global error: %s", e)
            return 1
        return 0

    from ..models.model import FwModel
    from ..persistence import model_file
    from ..serve.server import Serving

    if args.daemon and engine == "native":
        mi, vw = model_file.read_header(args.initial_regressor)
        Serving(args, mi, vw, None, model_path=args.initial_regressor).serve()
        return 0

    try:
        device = resolve_device(args.fwt_platform)
    except (NoDeviceError, ValueError) as e:
        log.error("%s", e)
        return 1
    if args.daemon:
        mi, vw, model = model_file.load_model(
            args.initial_regressor, immutable=True, args=args, device=device)
        Serving(args, mi, vw, model, model_path=args.initial_regressor).serve()
        return 0

    if args.initial_regressor:
        mi, vw, model = model_file.load_model(
            args.initial_regressor, immutable=args.testonly, args=args,
            device=device)
        if model.has_nn and not args.testonly:
            log.error("not yet ported: training a dense tower (--nn)")
            return 2
    else:
        if not args.data:
            log.error("--data expected")
            return 1
        vw = VwNamespaceMap.from_dataset_dir(args.data)
        mi = ModelInstance.from_cmdline(args, vw)
        model = FwModel(mi, batch_mean_mode=args.fwt_batch_mean or "auto",
                        batch_cap=float(args.fwt_batch_cap or 8.0))
        if model.has_nn:
            log.error("not yet ported: initializing and training a dense "
                      "tower (--nn)")
            return 2
        model.load_params(model.init_params(device))
    try:
        run_train_loop(args, mi, vw, model)
    except (FlushCommand, HogwildLoadCommand) as e:
        # reference: in-band commands in an input FILE abort the run
        # (src/main.rs:44-47,218-221)
        log.error("Global error: %s", e)
        return 1
    if args.final_regressor:
        model_file.save_model(args.final_regressor, mi, vw, model,
                              quantize_weights=bool(args.weight_quantization))
    return 0
