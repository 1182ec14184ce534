"""Device work attributed to the program's own ranges.

The program opens a ``record_function`` range ``fcsa.<name>`` at each of
its layer boundaries while a profiler records
(``flash_cosine_sim_attention_tpu_torch.utils.profiling.span``), and
keeps a record of each with its counts (rows, width, slots), which
``take_spans()`` hands over.  The trace does not say which range a device
operation was launched from, and ``trace.Trace`` keeps no correlation
ids.  So the host's launch calls in the traced window are paired one to
one and in order with its device operations, kind by kind (kernel
launches with kernels, ``cudaMemcpy*`` with ``Memcpy``, ``cudaMemset*``
with ``Memset``; a driver call nested in a runtime call is one launch):
on one stream the device runs them in launch order, and the window
opens and closes on a synchronize.  The pairing is by order and not by
time, since the device's timestamps drift from the host's: in one
traced decode window on the H100 an operation's start moved from 0.34
ms before its launch call to 0.55 ms after it over 2.6 s.  A device
operation belongs to the innermost ``fcsa.*`` range around its launch
call (host clock on both sides).  Where the counts of one kind differ,
nothing is attributed (``None``), and the counts of launch calls in each
harness range (``bench.step``, ``bench.admit``, ``bench.train_step``)
are logged.

The records pair one to one, in order of their starts and by name, with
the trace's ``fcsa.*`` ranges (the last records taken, since a window
profiled twice recorded twice).  The harness's ``bench.<name>#i`` range
and its ``Spans`` entry ``i`` give the offset between the two clocks in
each harness range, and the records must sit on their ranges by it (the
median gap within 1 ms: a pause of the host between a range's opening
and its record's clock read moves one record, a misaligned pairing moves
them all).  A program without these ranges (one older than them) gives
``None`` everywhere, and raises nothing.
"""

from __future__ import annotations

import bisect
import re
import statistics
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

from perfbench.trace import Op

HARNESS = ("step", "admit", "train_step")
PREFIX = "fcsa."
KINDS = ("kernel", "memcpy", "memset")
_LAUNCH = re.compile(r"^cu(da)?Launch(Cooperative)?Kernel")
CLOCK_TOLERANCE_S = 1e-3


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def call_kind(name: str) -> Optional[str]:
    """The kind of device operation a host call enqueues, or None."""
    if _LAUNCH.match(name):
        return "kernel"
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return "memcpy"
    if name.startswith(("cudaMemset", "cuMemset")):
        return "memset"
    return None


def op_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _outermost(calls: List[Op]) -> List[Op]:
    """Launch calls not nested in another (a driver call the runtime
    made for a runtime call is one launch)."""
    out: List[Op] = []
    for c in sorted(calls, key=lambda c: (c.start, -c.dur)):
        if out and c.end <= out[-1].end:
            continue
        out.append(c)
    return out


@dataclass
class Attributed:
    op: Op
    holders: Tuple[Op, ...]     # fcsa ranges around its launch, outermost first

    def held_by(self, name: str) -> Optional[Op]:
        """The innermost of its ranges called ``fcsa.<name>``."""
        return next((r for r in reversed(self.holders)
                     if r.name == PREFIX + name), None)

    @property
    def innermost(self) -> Optional[str]:
        return self.holders[-1].name[len(PREFIX):] if self.holders else None


def port_ranges(trace) -> List[Op]:
    """The trace's ``fcsa.*`` ranges, in order of their starts (an outer
    range before the inner one that starts with it)."""
    return sorted((h for h in trace.host if h.name.startswith(PREFIX)),
                  key=lambda h: (h.start, -h.dur))


def attribute(trace, log=log) -> Optional[List[Attributed]]:
    """Every device operation of the window with the ``fcsa.*`` ranges
    around its launch; None where the window's launch calls and
    operations of one kind differ in number."""
    w0, w1 = trace.window
    calls = _outermost([h for h in trace.host
                        if call_kind(h.name) and w0 <= h.start < w1])
    paired = []
    for kind in KINDS:
        c = [x for x in calls if call_kind(x.name) == kind]
        o = [x for x in trace.ops if op_kind(x.name) == kind]
        if len(c) != len(o):
            log(f"launches: {len(c)} {kind} launch calls in the window, "
                f"{len(o)} device {kind} operations"
                + "".join(f"; bench.{r.name}#{r.idx} {n}"
                          for r, n in _calls_by_range(trace, c)))
            return None
        paired += zip(c, o)
    paired.sort(key=lambda co: co[0].start)
    # sweep the launch calls in order, keeping the fcsa ranges open at each
    ports = port_ranges(trace)
    out: List[Attributed] = []
    open_, j = [], 0
    for call, op in paired:
        while j < len(ports) and ports[j].start <= call.start:
            open_.append(ports[j])
            j += 1
        open_ = [p for p in open_ if p.end >= call.start]
        out.append(Attributed(op, tuple(p for p in open_
                                        if p.end >= call.end)))
    return out


def _calls_by_range(trace, calls):
    """(harness range, launch calls in it), to say where counts differ."""
    for r in trace.ranges:
        if r.name in HARNESS:
            yield r, sum(1 for c in calls if r.start <= c.start < r.end)


def program_spans() -> list:
    """The program's span records, taken from it (they are cleared
    there); empty where the program keeps none."""
    from flash_cosine_sim_attention_tpu_torch.utils import profiling
    take = getattr(profiling, "take_spans", None)
    return take() if take else []


def pair_records(trace, spans, records, log=log):
    """``[(range, record)]``: the trace's ``fcsa.*`` ranges with the
    program's records, or None where they do not pair."""
    ranges = port_ranges(trace)
    if not ranges or len(records) < len(ranges):
        if ranges or records:
            log(f"launches: {len(ranges)} fcsa ranges, {len(records)} "
                f"records")
        return None
    records = records[-len(ranges):]
    if [r.name for r in ranges] != [PREFIX + s.name for s in records]:
        log("launches: the fcsa ranges and the records differ by name")
        return None
    # each record goes onto the trace's clock by the offset of the
    # harness range it starts in
    harness = sorted(trace.ranges, key=lambda h: h.start)
    starts = [h.start for h in harness]
    gaps = []
    for r, s in zip(ranges, records):
        i = max(bisect.bisect_right(starts, r.start) - 1, 0)
        if harness:
            h = harness[i]
            offset = h.start - spans.items[h.idx].start
            gaps.append(abs(s.start + offset - r.start))
    if gaps and statistics.median(gaps) > CLOCK_TOLERANCE_S:
        log(f"launches: records and ranges {statistics.median(gaps) * 1e3:.3f}"
            f" ms apart (median; widest {max(gaps) * 1e3:.3f} ms)")
        return None
    return list(zip(ranges, records))


@dataclass
class Attribution:
    """What the readers share: the trace's ``fcsa.*`` ranges, the
    attributed device operations and the paired ranges and records
    (either None where it could not be had)."""
    ranges: List[Op]
    ops: Optional[List[Attributed]]
    pairs: Optional[List[tuple]]

    def count(self, name: str) -> int:
        """The ranges called ``fcsa.<name>``."""
        return sum(1 for r in self.ranges if r.name == PREFIX + name)

    def records(self, name: str) -> List[tuple]:
        """``[(range, record)]`` of spans called ``name``."""
        return [(r, s) for r, s in self.pairs or [] if s.name == name]

    def record(self, span_id):
        """The paired record of id ``span_id``, or None."""
        return next((s for _, s in self.pairs or [] if s.id == span_id),
                    None)


def of(ctx) -> Attribution:
    """The traced window's attribution, worked out once a context (the
    program's records can be taken once)."""
    cached = ctx.__dict__.get("_launches")
    if cached is None:
        records = program_spans()
        if not ctx.whole:
            cached = Attribution([], None, None)
        else:
            cached = Attribution(port_ranges(ctx.trace), attribute(ctx.trace),
                                 pair_records(ctx.trace, ctx.spans, records))
        ctx.__dict__["_launches"] = cached
    return cached
