"""Logging: level from the LOG_LEVEL env var.

The port's own copy of part of fwumious_wabbit_tpu/utils/logging.py:
``initialize_logging`` and ``get_logger``. ``log_device_topology``, which
imports jax, is left out."""

from __future__ import annotations

import logging
import os

_initialized = False


def initialize_logging() -> None:
    global _initialized
    if _initialized:
        return
    level = os.environ.get("LOG_LEVEL", "INFO").upper()
    logging.basicConfig(
        level=getattr(logging, level, logging.INFO),
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    _initialized = True


def get_logger(name: str) -> logging.Logger:
    initialize_logging()
    return logging.getLogger(name)
