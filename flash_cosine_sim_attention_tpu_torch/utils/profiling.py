"""Tracing and profiling helpers.

Counterpart of ``flash_cosine_sim_attention_tpu/utils/profiling.py``:
``trace`` wraps ``torch.profiler`` (CPU and, where a card is present,
CUDA activity) and writes a Chrome trace, viewable in Perfetto or
``chrome://tracing``; ``StepTimer`` is JAX's rolling step timer as it is.

The port marks its own layer boundaries with ``span``: the engine's
``add_request``, ``step``, sampling and its one device-to-host copy, the
model's ``prefill`` and ``decode_step``, the attention op's forward and
backward, the decode attention, the KV append, each int8 dense product
(K7) and the trainer's step, microbatches and update.  A span is on
exactly while a ``torch.profiler`` session records (``trace`` below, or
any other profiler), and needs no flag.  On, it opens a
``record_function`` range named ``fcsa.<name>``, which the profiler
stamps on its own clock beside the kernels launched inside it, and keeps
a ``SpanRecord`` (its parent, host-clock times and counts such as rows
or slots) until ``take_spans`` hands it over.  Off, a span costs one
check of ``torch.autograd._profiler_enabled()``.

Reading a trace of the port: a device operation belongs to the innermost
``fcsa.*`` range around the host call that launched it, and an idle
stretch of the device to the innermost range the host was in.  The
ranges' names carry no index, so a viewer's or ``key_averages()``'s sums
by name are sums by layer; ``take_spans()`` pairs one to one, in order of
their starts, with the ``fcsa.*`` ranges of the trace, and gives each its
counts.  The backward's ranges lie on autograd's own thread when it has
one (a CUDA device): their records have no parent there.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import torch

recording = torch.autograd._profiler_enabled


@dataclass
class SpanRecord:
    """One span, kept while a profiler recorded: ``parent`` is the id of
    the innermost span open on the same thread, ``start`` and ``end``
    are ``time.perf_counter()`` seconds."""
    id: int
    parent: Optional[int]
    name: str
    start: float
    end: float = 0.0
    attrs: dict = field(default_factory=dict)


_records: List[SpanRecord] = []
_ids = itertools.count()
_open = threading.local()        # per thread: the stack of open spans
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def _recorded(name: str, attrs: dict) -> Iterator[SpanRecord]:
    stack = _open.__dict__.setdefault("stack", [])
    rec = SpanRecord(next(_ids), stack[-1].id if stack else None, name,
                     0.0, attrs=attrs)
    _records.append(rec)
    stack.append(rec)
    try:
        with torch.profiler.record_function(f"fcsa.{name}"):
            rec.start = time.perf_counter()
            try:
                yield rec
            finally:
                rec.end = time.perf_counter()
    finally:
        stack.pop()


def span(name: str, **attrs):
    """A context manager around one of the port's layer boundaries.
    While a profiler records it opens the range ``fcsa.<name>`` and keeps
    a ``SpanRecord`` with ``attrs`` (counts known on the host: rows,
    width, slots); otherwise it is a shared no-op context that records
    nothing and reads no clock."""
    if not recording():
        return _OFF
    return _recorded(name, attrs)


def take_spans() -> List[SpanRecord]:
    """The spans recorded so far, in the order they opened; clears them."""
    out = _records[:]
    del _records[:len(out)]
    return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile a block and write its Chrome trace into ``log_dir``:

        with trace("traces/step"):
            step(...)
        # then open traces/step/trace.json in Perfetto

    The trace holds the port's ``fcsa.*`` ranges (see the module's
    docstring): the kernels of a decode step sit under
    ``fcsa.engine.step`` > ``fcsa.decode_step`` > ``fcsa.qmm``,
    ``fcsa.kv_append`` or ``fcsa.decode_attention``, and
    ``prof.key_averages()`` sums each range's host time under its name.
    The block's ``SpanRecord``s stay for ``take_spans``.
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
