"""Tracing and profiling helpers.

Counterpart of ``flash_cosine_sim_attention_tpu/utils/profiling.py``:
``trace`` wraps ``torch.profiler`` (CPU and, where a card is present,
CUDA activity) and writes a Chrome trace, viewable in Perfetto or
``chrome://tracing``; ``StepTimer`` is JAX's rolling step timer as it is.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile a block and write its Chrome trace into ``log_dir``:

        with trace("traces/step"):
            step(...)
        # then open traces/step/trace.json in Perfetto
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling tokens/sec + step-time tracker for training loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_step_s(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    def tokens_per_sec(self, tokens_per_step: int) -> float:
        s = self.mean_step_s
        return tokens_per_step / s if s else 0.0
