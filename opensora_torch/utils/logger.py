"""The trainer's logger (counterpart of opensora_tpu/utils/logger.py): one
process, to stdout and ``<exp_dir>/log.txt``."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

LOGGER_NAME = "opensora_torch"


def create_logger(exp_dir: Optional[str] = None, name: str = LOGGER_NAME) -> logging.Logger:
    """The named logger; its handlers are set up at the first call."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s] %(levelname)s %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    handlers = [logging.StreamHandler(sys.stdout)]
    if exp_dir is not None:
        os.makedirs(exp_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(exp_dir, "log.txt")))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.propagate = False
    return logger


def close_logger(name: str = LOGGER_NAME) -> None:
    """Remove and close the logger's handlers (a later create_logger sets
    them up anew, e.g. for another experiment directory)."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
