"""Structured metrics logging and profiling hooks (counterpart of
``blindno/utils/logging.py``).

Metrics go to a JSONL file and are echoed to stderr, by rank 0 alone among several
ranks; :func:`trace` wraps
``torch.profiler`` and writes one Chrome trace (host and, on a card, device activity)
into the directory it is given.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

from blindno_torch.parallel.mesh import is_main_process


class MetricsLogger:
    def __init__(self, path: str | None = None, echo: bool = True):
        if not is_main_process():
            path, echo = None, False
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
        else:
            self._fh = None

    def log(self, record: dict):
        record = {"t": time.time(), **record}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.echo:
            short = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in record.items() if k != "t"}
            print(json.dumps(short), file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace of the block, written as ``trace_<pid>_<ns>.json`` under
    ``log_dir`` when the block ends; no-op when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    def write(prof):
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))

    with profile(activities=activities, on_trace_ready=write):
        yield
