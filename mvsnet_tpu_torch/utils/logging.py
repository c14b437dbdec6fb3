"""Logging with LOG_LEVEL env control (a copy of
mvsnet_tpu/utils/logging.py; reference: mvsnet/utils.py:11-29)."""

from __future__ import annotations

import logging
import os


def setup_logger(name: str) -> logging.Logger:
    logging.basicConfig()
    logger = logging.getLogger(name)
    level = os.environ.get("LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    return logger
