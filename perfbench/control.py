"""The readings a cell's correctness limits are set from, on the chip at
the cell's own size, all seeds in one process:

    python3 perfbench/control.py --workload <name> --seeds 11,12,... \
        [--faults 3] [--seconds S] [--out readings.jsonl]

For every seed, the program's numbers as a run computes them.  For the
first ``--faults`` seeds also the control's (the reference itself
computed with every product's operands rounded through float8 e4m3, the
precision below the configuration's bfloat16) and the planted faults'
that the cell can have: training half of each microbatch left out with
the mean taken over the rest (a state left unchanged reads 1 and needs
no run); serving one served token of each sampled request altered.
Each seed's readings are one JSON line.  The benchmark's runs do not run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import core, generator  # noqa: E402
from perfbench.reference import compare  # noqa: E402
from perfbench.reference import model as ref  # noqa: E402


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def train_readings(cell, seed, faults, device):
    drv = core.load_module("drivers", "train")
    cfg, mix = cell.config, cell.traffic
    model, opt = drv.build(cfg, mix, generator.derive_seed(seed, "weights"),
                           device)
    feed = generator.Batches(mix, seed, cfg["num_tokens"], device)
    prog = drv.first_steps(model, opt, feed, cfg)
    del model, opt
    exact = drv.reference(cfg, mix, seed, device)
    out = {"program": compare.train_numbers(prog, exact)}
    if faults:
        out["control"] = compare.train_numbers(
            drv.reference(cfg, mix, seed, device, rnd=ref.fp8), exact)
        out["half_batch"] = compare.train_numbers(
            drv.reference(cfg, mix, seed, device, half_batch=True), exact)
    return out


def serve_readings(cell, seed, faults, seconds, device):
    import numpy as np
    import torch

    drv = core.load_module("drivers", "serve")
    cfg = cell.config
    _, picked = drv.serve(cell, seed, seconds, False, device,
                          time.perf_counter(), log)
    rng = np.random.default_rng(generator.derive_seed(seed, "fault"))
    out = {"program": 0.0, "requests": len(picked),
           "tokens": sum(len(r.served) for r in picked)}
    if faults:
        out.update(control=0.0, altered_token=0.0)
    with ref.exact_matmuls():
        W = drv.reference_weights(cfg, generator.derive_seed(seed, "weights"),
                                  device)
        for req in picked:
            rows = drv.reference_rows(W, cfg, req, device)
            served = torch.tensor(req.served, device=device)
            out["program"] = max(out["program"], compare.served_gaps(
                rows, served).max().item())
            if not faults:
                continue
            low = drv.reference_rows(W, cfg, req, device, ref.fp8)
            out["control"] = max(out["control"], compare.served_gaps(
                rows, low.argmax(-1)).max().item())
            altered = served.clone()
            i = int(rng.integers(0, len(altered)))
            altered[i] = (altered[i] + 1) % cfg["num_tokens"]
            out["altered_token"] = max(out["altered_token"], compare.served_gaps(
                rows, altered).max().item())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=None,
                    help="a serving cell's window (default run_seconds)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("control.py reads the chip: no CUDA device")
        return 2
    device = torch.device("cuda", 0)
    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = core.Cell.load(bench, args.workload)
    seconds = bench["run_seconds"] if args.seconds is None else args.seconds
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if cell.traffic["kind"] == "train":
            r = train_readings(cell, seed, i < args.faults, device)
        else:
            r = serve_readings(cell, seed, i < args.faults, seconds, device)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "seconds": time.perf_counter() - t, **r})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
