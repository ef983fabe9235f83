"""Scoped logging helpers. Port of pocket_tts_tpu/core/logging_utils.py, for
the port's own loggers ("pocket_tts_tpu_torch.*")."""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

PACKAGE = "pocket_tts_tpu_torch"


class PocketTTSFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        return record.name.startswith(PACKAGE)


@contextmanager
def enable_logging(level: int = logging.INFO):
    """Install a scoped stream handler for the package and restore on exit."""
    logger = logging.getLogger(PACKAGE)
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
    handler.addFilter(PocketTTSFilter())
    old_level = logger.level
    logger.addHandler(handler)
    logger.setLevel(level)
    try:
        yield logger
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)


class display_execution_time:
    """Context manager logging elapsed ms."""

    def __init__(self, task_name: str, print_output: bool = True):
        self.task_name = task_name
        self.print_output = print_output
        self.elapsed_time_ms: int | None = None
        self.logger = logging.getLogger(__name__)

    def __enter__(self):
        self.start_time = time.monotonic()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.elapsed_time_ms = int((time.monotonic() - self.start_time) * 1000)
        if self.print_output:
            self.logger.info("%s took %d ms", self.task_name, self.elapsed_time_ms)
        return False
