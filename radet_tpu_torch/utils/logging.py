"""Root logger named 'radet_tpu_torch' (port of ``radet_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
import os.path as osp

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_root_logger(log_file: str | None = None, log_level: int = logging.INFO) -> logging.Logger:
    """The package logger, with one stream handler and, per distinct
    ``log_file``, one file handler."""
    logger = logging.getLogger("radet_tpu_torch")
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(sh)
        logger.setLevel(log_level)
        logger.propagate = False
    if log_file is not None and not any(
        isinstance(h, logging.FileHandler) and h.baseFilename == osp.abspath(log_file)
        for h in logger.handlers
    ):
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger
