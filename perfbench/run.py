"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration and its traffic are found by name through
``BENCHMARK.json``.  The last line of standard output is the result: one
JSON object with ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``:
each number compared with its limit, which also close standard error.
Without as many CUDA devices as the cell asks for, or with JAX or the
JAX package loaded once the window has closed, it prints no result and
exits non-zero.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import core  # noqa: E402


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def pin_host() -> None:
    """Keep this process, and every thread it starts from here on, on two
    of its cores, the third and fourth.  The serving and short-sequence
    cells are bound by the host's speed.  On the H100 machine's host, six
    runs of the prefill cell left to move between cores spread by 11 %
    (IQR over the median) where six pinned runs between them, on the
    same seeds, spread by 3 %.  Called before torch is imported, so that
    its threads inherit it."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 4:
        os.sched_setaffinity(0, cores[2:4])
    log(f"set-up: on cores {sorted(os.sched_getaffinity(0))}")


def per_layer(cell: core.Cell, ctx: core.Context) -> dict:
    """The cell's per-layer metrics that their readers find something
    to read for."""
    out = {}
    for m in cell.per_layer:
        reader = core.load_module("metrics", m["name"])
        declared = (reader.UNIT, reader.LAYER, reader.MOVES)
        if declared != (m["unit"], m["layer"], m["moves"]):
            raise ValueError(f"{m['name']}: its reader declares {declared}, "
                             f"BENCHMARK.json says {m}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell: core.Cell, seed: int, seconds: float, trace: bool,
            device) -> dict:
    """Run the cell; the result's fields, ``checks`` last."""
    import torch

    log(f"set-up: torch imported at {time.perf_counter() - T_START:.1f} s")
    torch.set_num_threads(1)
    driver = core.load_module("drivers", cell.traffic["kind"])
    out = driver.run(cell, seed, seconds, trace, device, T_START, log)
    if trace:
        metrics = per_layer(cell, out.context)
    else:   # a name's part before its first dot names the quantity
        metrics = {m["name"]: {"value": out.metrics[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end
                   if m["name"].split(".")[0] in out.metrics}
    passed = [math.isfinite(v) and v <= limit
              for v, limit in out.checks.values()]
    complete = trace or len(metrics) == len(cell.end_to_end)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": bool(all(passed) and complete and out.failed == 0
                              and out.attempted > 0),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace:
        prof = out.context.trace
        dev["busy_s"] = prof.busy_s()
        dev["window_s"] = prof.window_s
        result["breakdown"] = prof.breakdown()
    result["checks"] = {k: {"value": v, "limit": limit}
                        for k, (v, limit) in out.checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    pin_host()
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" available")
        return 2
    device = torch.device("cuda", 0)
    result = execute(core.Cell.load(bench, args.workload), args.seed,
                     args.seconds, bool(args.trace), device)
    banned = core.banned_modules()
    if banned:
        log(f"JAX or the JAX package is loaded: {banned}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
