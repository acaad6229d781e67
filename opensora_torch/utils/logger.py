"""The trainer's logger (counterpart of opensora_tpu/utils/logger.py): to
stdout and ``<exp_dir>/log.txt`` from process 0 of a multi-process run (or
the only process); the other processes' logger holds a ``NullHandler``,
as the JAX package's process-0 logger does."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

from opensora_torch.parallel import distributed

LOGGER_NAME = "opensora_torch"


def create_logger(exp_dir: Optional[str] = None, name: str = LOGGER_NAME) -> logging.Logger:
    """The named logger: stdout from the first call on and, once a call
    names ``exp_dir``, ``<exp_dir>/log.txt``. A call with another
    ``exp_dir`` moves the file handler there; a call without one keeps the
    handlers as they are."""
    logger = logging.getLogger(name)
    if not distributed.is_main_process():
        if not logger.handlers:
            logger.addHandler(logging.NullHandler())
            logger.propagate = False
        return logger
    fmt = logging.Formatter("[%(asctime)s] %(levelname)s %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        stream = logging.StreamHandler(sys.stdout)
        stream.setFormatter(fmt)
        logger.addHandler(stream)
        logger.propagate = False
    if exp_dir is not None:
        path = os.path.abspath(os.path.join(exp_dir, "log.txt"))
        files = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
        if [h.baseFilename for h in files] != [path]:
            for h in files:
                logger.removeHandler(h)
                h.close()
            os.makedirs(exp_dir, exist_ok=True)
            handler = logging.FileHandler(path)
            handler.setFormatter(fmt)
            logger.addHandler(handler)
    return logger


def close_logger(name: str = LOGGER_NAME) -> None:
    """Remove and close the logger's handlers (a later create_logger sets
    them up anew, e.g. for another experiment directory)."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
