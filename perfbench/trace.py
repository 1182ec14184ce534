"""The traced window: a short stretch of the cell's own loop under
``torch.profiler``, its Chrome trace read back into device operations and
the harness's ranges, checked against the program's launch counters.

The profiler has dropped the records of a window's first kernels on the
H100 (as the port's ``chip_smoke.py`` found).  So a spin kernel
opens the window and a short one marks it; a window whose marker is
missing, or that holds fewer records of a counted kernel than the
program's counters say it launched, is profiled once more, and if it
falls short again its device numbers are not measured.

``device_busy`` is the other use of the profiler: a stretch of the
measured window under a profiler that records the device alone, read
back in memory as the seconds in which some device operation ran.
"""

from __future__ import annotations

import functools
import json
import os
import re
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPIN = "spin_kernel"
OPEN_SPIN = 1 << 24            # cycles, about 10 ms on the H100
WINDOW = "bench.window"
_RANGE = re.compile(r"^bench\.(.+)#(\d+)$")

# the program's launch counters and the kernels each counts: the
# function names of its CUDA sources; a model family adds its own
# (``archs/<family>.py``'s ``COUNTED``, merged by ``families``)
COUNTED = {
    "K1": (("ops.fwd_kernel", "flash_attention_forward"),
           ("fwd_mma_kernel", "fwd_tf32_kernel", "fwd_wide_mma_kernel",
            "fwd_wide_tf32_kernel")),
    "K2+K3b": (("ops.bwd_kernel", "fused_bwd_kernel", "dkdv_kernel"),
               ("dkdv_mma_kernel", "dkdv_tf32_kernel", "dkdv_wide_mma_kernel",
                "dkdv_wide_tf32_kernel")),
    "K3a": (("ops.bwd_kernel", "dq_kernel"),
            ("dq_mma_kernel", "dq_tf32_kernel", "dq_wide_mma_kernel",
             "dq_wide_tf32_kernel")),
    "K4": (("quant.decode_kernel", "quantized_decode_attention"),
           ("decode_kernel", "decode_cols_kernel")),
    "K7": (("quant.weights", "quantized_matmul"), ("qmm_mma_kernel",)),
}


@functools.lru_cache(maxsize=4096)
def kernel_function(name: str) -> str:
    """A kernel's function name without return type, namespace,
    template arguments or parameters."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.rsplit("::", 1)[-1].strip()


@dataclass
class Op:
    name: str
    start: float     # seconds, the trace's host-aligned clock
    dur: float

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclass
class Range:
    name: str        # the span's name
    idx: int         # the span's index in the run's Spans
    start: float
    dur: float

    @property
    def end(self) -> float:
        return self.start + self.dur


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """One profiled window: its device operations (the spins left out),
    the harness's ranges and the host's operations."""

    def __init__(self, events: List[dict]):
        self.ops: List[Op] = []
        self.ranges: List[Range] = []
        self.host: List[Op] = []
        self.window: Optional[Tuple[float, float]] = None
        self.marked = False
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0)) * 1e-6
            if cat in DEVICE_CATS:
                if SPIN in name:
                    self.marked = True
                else:
                    self.ops.append(Op(name, ts, dur))
            elif cat == "user_annotation":
                if name == WINDOW:
                    self.window = (ts, ts + dur)
                else:
                    m = _RANGE.match(name)
                    if m:
                        self.ranges.append(Range(m.group(1), int(m.group(2)),
                                                 ts, dur))
                    self.host.append(Op(name, ts, dur))
            elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
                self.host.append(Op(name, ts, dur))
        self.ops.sort(key=lambda o: o.start)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self, t0: Optional[float] = None,
             t1: Optional[float] = None) -> List[List[float]]:
        """Merged intervals in which some device operation ran, clipped
        to [t0, t1] (default the window)."""
        t0 = self.window[0] if t0 is None else t0
        t1 = self.window[1] if t1 is None else t1
        return _merge((max(o.start, t0), min(o.end, t1)) for o in self.ops
                      if o.end > t0 and o.start < t1)

    def busy_s(self, t0=None, t1=None) -> float:
        return sum(e - s for s, e in self.busy(t0, t1))

    def ops_in(self, r: Range) -> List[Op]:
        """Device operations that started inside a harness range (the
        harness synchronizes before it closes a range in the window)."""
        return [o for o in self.ops if r.start <= o.start < r.end]

    def named(self, ops: List[Op], functions) -> List[Op]:
        functions = set(functions)
        return [o for o in ops if kernel_function(o.name) in functions]

    def count(self, functions) -> int:
        return len(self.named(self.ops, functions))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by function), and
        the idle stretches summed by what the host was doing: the
        innermost host operation under way at each one's midpoint."""
        import numpy as np

        by_op: Dict[str, float] = {}
        for o in self.ops:
            if self.window[0] <= o.start < self.window[1]:
                k = kernel_function(o.name) or o.name
                by_op[k] = by_op.get(k, 0.0) + o.dur
        lengths, mids, edge = [], [], self.window[0]
        for s, e in self.busy() + [[self.window[1], self.window[1]]]:
            if s > edge:
                lengths.append(s - edge)
                mids.append((edge + s) / 2)
            edge = max(edge, e)
        order = np.argsort(mids)
        mids, lengths = np.asarray(mids)[order], np.asarray(lengths)[order]
        under = np.full(len(mids), -1)
        # paint the longest host operations first, so the innermost wins
        for i in sorted(range(len(self.host)), key=lambda i: -self.host[i].dur):
            h = self.host[i]
            under[np.searchsorted(mids, h.start):
                  np.searchsorted(mids, h.end)] = i
        gaps: Dict[str, float] = {}
        for i, length in zip(under.tolist(), lengths.tolist()):
            label = (_RANGE.sub(r"bench.\1", self.host[i].name) if i >= 0
                     else "host: between operations")
            gaps[label] = gaps.get(label, 0.0) + length

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    ][:top]
        return {"device_ops": ranked(by_op), "idle_gaps": ranked(gaps)}


def families(added: Dict[str, tuple]) -> Dict[str, tuple]:
    """``COUNTED`` with a model family's own kernel families added; a
    family may not count one of the fixed table's again."""
    again = sorted(set(added) & set(COUNTED))
    if again:
        raise ValueError(f"kernel families counted twice: {again}")
    return {**COUNTED, **added}


def counters(table: Dict[str, tuple]) -> Dict[str, int]:
    """The program's launch counters, by kernel family of ``table``."""
    import importlib
    out = {}
    for family, ((module, *fns), _) in table.items():
        mod = importlib.import_module(
            f"flash_cosine_sim_attention_tpu_torch.{module}")
        out[family] = sum(getattr(mod, fn).launches for fn in fns)
    return out


def short_families(trace: Trace, launched: Dict[str, int],
                   table: Dict[str, tuple] = COUNTED) -> List[str]:
    """Kernel families of ``table`` of which the trace holds fewer records
    than the program launched."""
    return [f for f, n in launched.items()
            if n and trace.count(table[f][1]) < n]


def _profile_once(work: Callable[[], None], table: Dict[str, tuple]
                  ) -> Tuple[Trace, Dict[str, int]]:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    before = counters(table)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(OPEN_SPIN)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            work()
            torch.cuda.synchronize()
    after = counters(table)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events), {k: after[k] - before[k] for k in after}


def merged_seconds(starts, ends) -> float:
    """The length of the union of the intervals [starts[i], ends[i]]."""
    import numpy as np

    s, e = np.asarray(starts, np.float64), np.asarray(ends, np.float64)
    if not len(s):
        return 0.0
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    first = np.flatnonzero(np.r_[True, s[1:] > reach[:-1]])
    return float((np.maximum.reduceat(e, first) - s[first]).sum())


@dataclass
class Busy:
    """One profiled stretch: the seconds in which some device operation
    ran, the count of device operations, and by kernel family of the
    record check what the program launched and what the profiler
    recorded; ``short`` lists the families it lost records of."""
    seconds: float
    ops: int
    launched: Dict[str, int]
    found: Dict[str, int]

    @property
    def short(self) -> List[str]:
        return [f for f, n in self.launched.items() if n > self.found[f]]


def _device_only_config():
    """The profiler's settings for ``device_busy``: no correlation of host
    operations with device ones, which nothing reads there and which
    costs the host time at every operation, where this torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(disable_external_correlation=True)
    except (ImportError, TypeError):
        return None


def device_busy(work: Callable[[], None], counted: Dict[str, tuple]) -> Busy:
    """Run ``work`` under a profiler that records the device alone (no
    host operations, no trace file) and read back, in memory, the
    seconds in which some device operation (kernel, copy or set) ran,
    the opening spin left out, checked against the program's launch
    counters for ``COUNTED`` and ``counted``.  A stretch stays short
    (some tens of thousands of operations): longer ones lost records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    table = families(counted)
    torch.cuda.synchronize()
    before = counters(table)
    with profile(activities=[ProfilerActivity.CUDA],
                 experimental_config=_device_only_config()) as prof:
        torch.cuda._sleep(OPEN_SPIN)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        work()
        torch.cuda.synchronize()
    after = counters(table)
    starts, ends, names = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or getattr(
                e, "is_user_annotation", bool)():
            continue
        name = e.name()
        if SPIN in name:
            continue
        starts.append(e.start_ns())
        ends.append(e.start_ns() + e.duration_ns())
        names.append(name)
    found = {f: sum(1 for n in names if kernel_function(n) in fns)
             for f, (_, fns) in table.items()}
    return Busy(1e-9 * merged_seconds(starts, ends), len(names),
                {f: after[f] - before[f] for f in table}, found)


def profile_window(work: Callable[[], None], counted: Dict[str, tuple],
                   log=print) -> Tuple[Trace, bool]:
    """Profile ``work`` (a stretch of the cell's loop that can be run
    again), checking its records against ``COUNTED`` and the model
    family's ``counted``.  Returns the trace and whether it is whole:
    False where two windows in a row lost records, and the kernels'
    numbers are then not measured."""
    table = families(counted)
    for attempt in range(2):
        trace, launched = _profile_once(work, table)
        short = short_families(trace, launched, table)
        if trace.window is not None and trace.marked and not short:
            return trace, True
        log(f"traced window {attempt + 1}: marker "
            f"{'kept' if trace.marked else 'lost'}, short of records of "
            f"{short} (launched {launched})")
    return trace, False
