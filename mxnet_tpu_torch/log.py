"""`mx.log` — logging helpers (ref: python/mxnet/log.py — get_logger with
the reference's level names and one-time handler setup)."""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "DEBUG", "INFO", "WARNING", "ERROR", "NOTSET"]

DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
NOTSET = logging.NOTSET

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name=None, filename=None, filemode="a", level=WARNING):
    """ref: log.get_logger — idempotent handler attachment."""
    logger = logging.getLogger(name)
    if getattr(logger, "_mxtpu_init", False):
        return logger
    if filename:
        handler = logging.FileHandler(filename, filemode)
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.setLevel(level)
    if name:  # named loggers own their output (ref: log.py propagate=False)
        logger.propagate = False
    logger._mxtpu_init = True
    return logger
