"""Structured logging (the JAX package's utils/logging.py): a JSONL metric
writer and a leveled logger with one format across the entry points."""

from __future__ import annotations

import json
import logging
import sys
import time


def get_logger(name: str = "jegal_torch", level: int = logging.INFO):
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class MetricWriter:
    """Append-only JSONL metric ledger, one object per event; to stdout
    when no path is given."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._fh = open(path, "a") if path else None

    def write(self, event: str, **fields):
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        else:
            print(line)

    def close(self):
        if self._fh:
            self._fh.close()
