"""Structured metrics and logging (port of
volumetricrenderer_tpu/utils/metrics.py): stdlib logging, with an optional
timestamped log file, and a JSON-lines metrics sink."""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

__all__ = ["get_logger", "MetricsWriter", "init_logs"]

_LOGGER_NAME = "volumetricrenderer_tpu_torch"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def init_logs(log_dir: Optional[str] = None, level=logging.INFO):
    """Configure logging to stderr; with log_dir, also to
    <log_dir>/latest.log, after renaming an existing latest.log to a
    timestamped backup. Returns the logger."""
    logger = get_logger()
    logger.setLevel(level)
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        latest = os.path.join(log_dir, "latest.log")
        if os.path.exists(latest):
            stamp = time.strftime("%Y%m%d-%H%M%S",
                                  time.localtime(os.path.getmtime(latest)))
            os.replace(latest, os.path.join(log_dir, f"{stamp}.log"))
        fh = logging.FileHandler(latest)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s: %(message)s"))
        logger.addHandler(fh)
    return logger


class MetricsWriter:
    """Append-only JSON-lines metrics sink."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None

    def write(self, **metrics):
        metrics.setdefault("ts", time.time())
        line = json.dumps(metrics)
        get_logger().info("metrics %s", line)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
