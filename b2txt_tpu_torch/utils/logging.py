"""Logger setup: file + stdout handlers (parity: rnn_trainer.py:66-82)."""

from __future__ import annotations

import logging
import pathlib
import sys
from typing import Optional


def make_logger(name: str = "b2txt_tpu", log_file: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    for handler in logger.handlers[:]:
        logger.removeHandler(handler)
    logger.setLevel(logging.INFO)
    formatter = logging.Formatter(fmt="%(asctime)s: %(message)s")

    if log_file is not None:
        pathlib.Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(formatter)
        logger.addHandler(fh)

    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(formatter)
    logger.addHandler(sh)
    return logger
