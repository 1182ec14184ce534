"""What every cell shares: finding its files by name, the host-clock
spans the harness opens around its calls into the program, and the
checks of the process it runs in."""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
# top-level modules that may not be loaded in a run: JAX and the JAX
# package (whose name the port's begins with, so names compare whole)
BANNED = ("jax", "jaxlib", "flax", "optax", "flash_cosine_sim_attention_tpu")
# where the model families are found (a test points it at families of its own)
ARCHS = HERE / "archs"
# what a model family's module exports (``perfbench/README.md``)
ARCH_EXPORTS = ("build", "reference_weights", "reference_logits",
                "reference_loss", "train_step_flops", "prefill_flops",
                "decode_flops", "attention_train_bound_s",
                "k1_prefill_bound_s", "decode_k4_bound_s", "dense_k7_bound_s",
                "tiny", "COUNTED")


def load_json(kind: str, name: str) -> dict:
    """``perfbench/<kind>/<name>.json``."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Optional[Path] = None):
    """``perfbench/<kind>/<name>.py`` (or ``<root>/<name>.py``) as a
    module (names may hold dots)."""
    path = (HERE / kind if root is None else root) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arch(cfg: dict):
    """The model family that configuration ``cfg`` names under ``arch``:
    ``perfbench/archs/<arch>.py``, the one part of the harness that knows
    the model's layout (its build, reference, work counts and bounds;
    ``ARCH_EXPORTS``)."""
    mod = load_module("archs", cfg["arch"], ARCHS)
    missing = [n for n in ARCH_EXPORTS if not hasattr(mod, n)]
    if missing:
        raise AttributeError(f"model family {cfg['arch']!r} lacks {missing}")
    return mod


def banned_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in BANNED)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""
    name: str
    config: dict
    traffic: dict
    chips: int
    check: dict                      # perfbench/workloads/<name>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def load(cls, bench: dict, name: str) -> "Cell":
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        e2e = [m for m in bench["end_to_end"]
               if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in bench["per_layer"]
                     if name in m.get("workloads", [name])
                     and m["moves"] in reported]
        return cls(name, load_json("configs", entry["config"]),
                   load_json("traffic", entry["traffic"]), entry["chips"],
                   load_json("workloads", name), e2e, per_layer)


@dataclass
class Span:
    name: str
    start: float
    end: float
    info: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Spans:
    """Host-clock spans around the harness's calls into the program.  In
    a profiled window each also opens a ``record_function`` range named
    ``bench.<name>#<index>``, so the trace's kernels can be attributed to
    it and its ``info`` (the call's shapes) found again."""

    def __init__(self):
        self.items: List[Span] = []
        self.profiling = False

    @contextmanager
    def span(self, name: str, **info):
        sp = Span(name, 0.0, 0.0, info)
        idx = len(self.items)
        self.items.append(sp)
        if self.profiling:
            import torch
            with torch.profiler.record_function(f"bench.{name}#{idx}"):
                sp.start = time.perf_counter()
                yield sp
                sp.end = time.perf_counter()
        else:
            sp.start = time.perf_counter()
            yield sp
            sp.end = time.perf_counter()

    def between(self, t0: float, t1: float, name: Optional[str] = None):
        return [s for s in self.items if s.start >= t0 and s.end <= t1
                and (name is None or s.name == name)]

    def info(self, idx: int) -> dict:
        return self.items[idx].info


def median_ms(spans: List[Span]) -> Optional[float]:
    if not spans:
        return None
    return 1e3 * statistics.median(s.seconds for s in spans)


@dataclass
class Context:
    """What a per-layer metric reads: the run's spans, the measured
    window (host clock), the work the driver counted in it, and the
    traced window (``whole`` False where it lost records: its kernels'
    numbers are then not measured)."""
    cell: Cell
    spans: Spans
    window: tuple
    work: dict
    trace: object
    whole: bool

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self, name: str) -> List[Span]:
        return self.spans.between(*self.window, name=name)

    def traced(self, name: str):
        """The traced window's ranges of spans called ``name``, each with
        its span's info."""
        if not self.whole:
            return []
        return [(r, self.spans.info(r.idx)) for r in self.trace.ranges
                if r.name == name]


@dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""
    metrics: Dict[str, float]               # end-to-end, host clock
    checks: Dict[str, tuple]                # name: (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    context: Optional[object] = None        # metrics.Context, --trace 1
