"""Profiling (`aigv_assessor_tpu/utils/profiling.py`) on `torch.profiler`.

- `trace(logdir)`: a context that profiles the host and, where there is a
  card, the device, and writes a Chrome trace (`trace.json`, for
  chrome://tracing or Perfetto) into `logdir`.
- `annotate(name)`: a named region in that trace (`record_function`).
- `StepTimer`: wall-clock time per step with a sync before each reading;
  by default `torch.cuda.synchronize` where there is a card, nothing on a
  machine without one.

JAX's `start_server` (a live profiling endpoint for TensorBoard) has no
counterpart: torch's profiler writes its trace to a file.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (the host, and the device where there is a card)
    into `<logdir>/trace.json`; -> the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=False) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region that shows in the trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step timing with a percentile summary. `sync_fn` runs before each
    reading of the clock; by default `torch.cuda.synchronize` where there is
    a card."""

    def __init__(self, sync_fn: Optional[Callable] = None):
        if sync_fn is None and torch.cuda.is_available():
            sync_fn = torch.cuda.synchronize
        self.sync_fn = sync_fn
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        if self.sync_fn:
            self.sync_fn()
        self._t0 = time.perf_counter()

    def stop(self):
        if self.sync_fn:
            self.sync_fn()
        assert self._t0 is not None
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[int(n * 0.9)],
            "max_s": ts[-1],
        }

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"times_s": self.times, **self.summary()}, f, indent=2)
