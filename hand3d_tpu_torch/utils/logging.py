"""Structured metrics logging (JSONL); a copy of hand3d_tpu/utils/logging.py,
so that the port never imports the JAX package."""

import json
import os
import sys
import time


class MetricsLogger:
    """Appends one JSON object per event to ``path`` (and optionally stdout).

    Usage: logger.log(step=100, loss=0.12, lr=1e-4)
    """

    def __init__(self, path=None, echo=True, fresh=False):
        """``fresh=True`` truncates an existing log instead of appending: a
        fresh (not resumed) training run must not append its curve to an
        earlier run's, whose first loss a reader would take for its own.
        Resumed runs append, so the curve stays contiguous across the
        restart."""
        self.path = path
        self.echo = echo
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "w" if fresh else "a")

    def log(self, **kwargs):
        record = {"ts": time.time(), **{
            k: (float(v) if hasattr(v, "item") else v)
            for k, v in kwargs.items()}}
        line = json.dumps(record)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line)
            sys.stdout.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
