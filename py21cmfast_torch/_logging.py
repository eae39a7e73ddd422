"""Logging configuration (reference _logging.py:12-37): PID-prefixed formatter
so multi-process runs (e.g. MCMC drivers spawning many instances) interleave
readably."""

from __future__ import annotations

import logging
import os


class PIDFormatter(logging.Formatter):
    def format(self, record):
        record.pid = os.getpid()
        return super().format(record)


def configure_logging(level=logging.INFO):
    handler = logging.StreamHandler()
    handler.setFormatter(
        PIDFormatter("%(asctime)s | pid %(pid)d | %(name)s | %(levelname)s | %(message)s")
    )
    logger = logging.getLogger("py21cmfast_torch")
    if not logger.handlers:
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger


logger = configure_logging()
