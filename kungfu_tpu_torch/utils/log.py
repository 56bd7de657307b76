"""Leveled colored logger (counterpart of kungfu_tpu.utils.log).

Level selected by KFT_CONFIG_LOG_LEVEL (debug|info|warn|error), colored when
attached to a tty.
"""
from __future__ import annotations

import logging
import os
import sys

_COLORS = {"DEBUG": "\x1b[36m", "INFO": "\x1b[32m", "WARNING": "\x1b[33m", "ERROR": "\x1b[31m"}
_RESET = "\x1b[0m"


class _Formatter(logging.Formatter):
    def __init__(self, color: bool):
        super().__init__("[%(name)s] %(asctime)s %(levelname)s %(message)s", "%H:%M:%S")
        self._color = color

    def format(self, record):
        s = super().format(record)
        if self._color:
            c = _COLORS.get(record.levelname)
            if c:
                s = c + s + _RESET
        return s


def get_logger(name: str = "kungfu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_Formatter(sys.stderr.isatty()))
        logger.addHandler(h)
        level = os.environ.get("KFT_CONFIG_LOG_LEVEL", "info").upper()
        level = {"WARN": "WARNING"}.get(level, level)
        if level not in ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"):
            logger.setLevel("INFO")
            logger.warning("unknown KFT_CONFIG_LOG_LEVEL %r; using INFO", level)
        else:
            logger.setLevel(level)
        logger.propagate = False
    return logger
