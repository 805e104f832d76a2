"""Prediction output + the embedded-engine predict mode.

The port's own copy of part of fwumious_wabbit_tpu/train/predict.py:
``PredictionWriter`` writes '{:.6f}' lines the reference's way (reference:
src/main.rs:260-269); ``run_native_predict`` is the ``-t -i model`` CLI mode
routed through the embedded C++ engine (native/fw_ffi.cpp, the port's copy),
a host-side per-line forward loop as in the reference (src/main.rs:213-270
with update=false); ``native_predict_eligible`` says which ``-t`` runs it
may take. The port runs the embedded engine only when ``--fwt_serve_engine
native`` asks for it, and then only for the runs that function admits.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..ingest.parser import FlushCommand, HogwildLoadCommand
from ..ingest.reader import create_buffered_input
from ..utils.logging import get_logger

log = get_logger(__name__)


class PredictionWriter:
    """Writes '{:.6f}' lines to a file and/or stdout
    (reference: src/main.rs:260-269). The file is written in binary so the
    C-formatted byte blocks go straight through."""

    def __init__(self, path: str | None, to_stdout: bool):
        self._fh = open(path, "wb") if path else None
        self._stdout = to_stdout

    @property
    def active(self) -> bool:
        return self._fh is not None or self._stdout

    def write(self, p: float) -> None:
        line = f"{p:.6f}\n".encode()
        if self._fh:
            self._fh.write(line)
        if self._stdout:
            sys.stdout.buffer.write(line)

    def write_block(self, preds: np.ndarray) -> None:
        """Vectorized block write (C-side %.6f formatting)."""
        if not self.active or preds.size == 0:
            return
        from .. import native as fw_native

        raw = fw_native.format_preds(preds)
        if raw is None:
            raw = ("\n".join(np.char.mod("%.6f", preds)) + "\n").encode()
        if self._fh:
            self._fh.write(raw)
        if self._stdout:
            sys.stdout.buffer.write(raw)
            sys.stdout.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()


def native_predict_eligible(args) -> bool:
    """True when a ``-t`` run may take the embedded C++ engine. It needs a
    model file (``-i``), since the engine loads the weights itself, and
    data. The device path takes cache-driven runs (``-c`` keeps the
    reference's cache read and write), runs that write a model
    (``-f``), multi-device meshes, ``--fwt_serve_engine device``,
    ``--fwt_no_native`` and ``--prediction_model_delay``
    (fwumious_wabbit_tpu/train/predict.py:70-87)."""
    return bool(
        getattr(args, "testonly", False)
        and getattr(args, "initial_regressor", None)
        and getattr(args, "data", None)
        and not getattr(args, "cache", False)
        and not getattr(args, "final_regressor", None)
        and not getattr(args, "fwt_no_native", False)
        and (getattr(args, "fwt_serve_engine", "auto") or "auto") != "device"
        and int(getattr(args, "fwt_table_axis", 1) or 1) <= 1
        and (getattr(args, "fwt_data_axis", None) in (None, 1))
        and not getattr(args, "prediction_model_delay", None)
    )


def run_native_predict(args, pred=None) -> dict:
    """--testonly via the embedded C++ engine.

    Streams the input file in chunks through fw_predict_block; behavior
    matches the device loop: predictions '{:.6f}' after --predictions_after,
    empty line ends the stream, in-band commands abort the run like the
    reference (src/main.rs:218-221)."""
    from .. import native as fw_native

    if pred is None:
        pred = fw_native.EmbeddedPredictor(f"-i {args.initial_regressor}")
    writer = PredictionWriter(
        getattr(args, "predictions", None),
        bool(getattr(args, "predictions_stdout", False)),
    )
    predictions_after = int(getattr(args, "predictions_after", None) or 0)
    stream = create_buffered_input(args.data)
    t0 = time.time()
    n_done = 0
    CHUNK = 16 << 20
    tail = b""
    try:
        while True:
            raw = stream.read(CHUNK)
            if not raw:
                if not tail:
                    break
                # un-terminated final line
                buf, at_eof = tail + b"\n", True
            else:
                buf, at_eof = tail + raw, False
            preds, consumed, status = pred.predict_block_mt(buf)
            tail = buf[consumed:]
            if preds.size:
                first_num = n_done + 1
                n_done += preds.size
                skip = max(0, predictions_after - first_num + 1)
                writer.write_block(preds[skip:])
            if status == fw_native.EmbeddedPredictor.BLOCK_EOF:
                break
            if status == fw_native.EmbeddedPredictor.BLOCK_FLUSH:
                raise FlushCommand("flush")
            if status == fw_native.EmbeddedPredictor.BLOCK_HOGWILD:
                raise HogwildLoadCommand("hogwild_load")
            if status == fw_native.EmbeddedPredictor.BLOCK_ERROR:
                raise ValueError(pred.last_error())
            if at_eof:
                break
    finally:
        writer.close()
        pred.close()
    elapsed = time.time() - t0
    log.info("Elapsed: %.2fs rows: %d (%.0f ex/s) [native predict engine]",
             elapsed, n_done, n_done / max(elapsed, 1e-9))
    return {"params": None, "examples": n_done, "elapsed": elapsed}
