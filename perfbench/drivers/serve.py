"""Serving cells: ``InferenceEngine`` under a closed loop of clients.

Set-up makes the weights on the card from the seed, quantizes them as the
configuration says, warms the prompt buckets the mix reaches and the
decode step, and fills every slot with a request already part-served, so
that the window opens in a steady state.  In the window each freed
slot's client sends its next request at once: it is admitted
(``add_request``, whose first token is the request's first), then one
``step()`` is taken.  After the window, a sample of the finished requests
is held against the reference.

A cell that reports ``serve_tokens_per_busy_s`` runs its measured window
(with ``--trace 0``) in stretches of loop turns, each under a profiler
that records the device alone: the tokens served over the seconds in
which the device was busy.  Its host-clock rate is read with
``--trace 1``, from an unprofiled window, as a per-layer metric.
"""

from __future__ import annotations

import gc
import time
from collections import deque

import numpy as np
import torch

from perfbench import core, generator
from perfbench import trace as tracing
from perfbench.reference import compare
from perfbench.reference import model as ref


class Loop:
    """The closed loop over one engine: one client per slot."""

    def __init__(self, engine, requests: generator.Requests, spans: core.Spans):
        self.engine, self.requests, self.spans = engine, requests, spans
        self.by_slot = {}
        self.finished = []
        self.waiting = deque()      # when each waiting client sent
        self.tokens = 0             # tokens served so far

    def admit(self, req: generator.Request, sent: float) -> None:
        with self.spans.span("admit", rows=len(req.prompt)) as sp:
            slot = self.engine.add_request(req.prompt)
        req.sent, req.admitted = sent, sp.end
        req.served.append(int(self.engine.last_token[slot]))
        req.times.append(sp.end)
        self.tokens += 1
        self.by_slot[slot] = req
        if len(req.served) >= req.out_len:
            self._finish(slot, sp.end)

    def step(self, admitted: bool) -> None:
        eng = self.engine
        live_slots = eng.active & ~eng.prefilling
        rows = int(live_slots.sum())
        live = int(eng.host_pos[live_slots].sum()) + rows
        lens = (eng.host_pos[live_slots] + 1).tolist()
        with self.spans.span("step", rows=rows, live=live, lens=lens,
                             admitted=admitted) as sp:
            toks = eng.step()
        self.tokens += len(toks)
        for slot, tok in toks.items():
            req = self.by_slot[slot]
            req.served.append(tok)
            req.times.append(sp.end)
            if len(req.served) >= req.out_len:
                self._finish(slot, sp.end)

    def _finish(self, slot: int, t: float) -> None:
        self.engine.finish(slot)
        self.finished.append(self.by_slot.pop(slot))
        self.waiting.append(t)

    def iterate(self) -> None:
        """Admit every waiting client's next request, then one step."""
        admitted = False
        while self.waiting and self.engine.free_slots():
            self.admit(self.requests.next(), self.waiting.popleft())
            admitted = True
        self.step(admitted)

    def fill(self) -> None:
        """Every slot holds a request already part-served."""
        while self.engine.free_slots():
            self.admit(self.requests.in_flight(), time.perf_counter())
        self.waiting.clear()


def buckets_reached(engine, mix: dict):
    """The prompt buckets that the mix's prompt lengths fall into."""
    first, last = (next(b for b in engine.buckets if b >= mix["prompt"][k])
                   for k in ("min", "max"))
    return [b for b in engine.buckets if first <= b <= last]


def warm_up(engine, mix: dict, vocab: int) -> None:
    """One prompt a bucket the mix reaches, each followed by two full
    decode steps; the slots are then freed."""
    rng = np.random.default_rng(0)
    for width in buckets_reached(engine, mix):
        slot = engine.add_request(rng.integers(0, vocab, width, dtype=np.int32))
        engine.step()
        engine.step()
        engine.finish(slot)


def sample(finished, seed: int, tokens: int, requests: int = 1):
    """The longest finished request, then others in an order drawn from
    the seed, until ``tokens`` served tokens and ``requests`` requests
    are held."""
    if not finished:
        return []
    order = sorted(finished, key=lambda r: -len(r.served))
    rest = order[1:]
    rng = np.random.default_rng(generator.derive_seed(seed, "check"))
    picked, total = [order[0]], len(order[0].served)
    for i in rng.permutation(len(rest)):
        if total >= tokens and len(picked) >= requests:
            break
        picked.append(rest[i])
        total += len(rest[i].served)
    return picked


BUSY = "serve_tokens_per_busy_s"


def busy_window(loop: Loop, seconds: float, turns: int, counted: dict,
                log) -> tuple:
    """The measured window as stretches of ``turns`` loop turns, each
    under ``trace.device_busy``, until the stretches' own time (the
    profiler's start and stop between them left out) reaches
    ``seconds``.  Returns the tokens served and the device's busy
    seconds over the stretches whose records are whole, and the count of
    stretches and of those left out."""
    from perfbench import launches

    ran, tokens, busy_s, stretches, left_out = 0.0, 0, 0.0, 0, 0
    while ran < seconds:
        n0, took = loop.tokens, []

        def stretch():
            start = time.perf_counter()
            for _ in range(turns):
                loop.iterate()
                if ran + loop.spans.items[-1].end - start >= seconds:
                    break
            took.append(loop.spans.items[-1].end - start)

        a = time.perf_counter()
        b = tracing.device_busy(stretch, counted)
        launches.program_spans()    # the port's span records, not kept
        ran += took[0]
        stretches += 1
        log(f"busy stretch {stretches}: {took[0]:.3f} s of loop in "
            f"{time.perf_counter() - a:.3f} s, {loop.tokens - n0} tokens, "
            f"{b.seconds:.4f} s busy, {b.ops} device operations, launched "
            f"{b.launched}, recorded {b.found}")
        if b.short:
            left_out += 1
            log(f"busy stretch {stretches}: short of records of {b.short}; "
                f"left out")
            continue
        tokens += loop.tokens - n0
        busy_s += b.seconds
    log(f"busy window: {stretches} stretches ({left_out} left out), "
        f"{ran:.2f} s of loop, {tokens} tokens, {busy_s:.4f} s busy")
    return tokens, busy_s, stretches, left_out


@torch.no_grad()
def reference_rows(W, cfg, req, device, rnd=ref.identity) -> torch.Tensor:
    """The reference's logits (m, vocab) at the positions that served the
    request's m tokens: the prompt's last and each served token's but
    the last."""
    n = len(req.prompt)
    seq = np.concatenate([req.prompt, np.asarray(req.served[:-1], np.int32)])
    toks = torch.from_numpy(seq.astype(np.int64)).to(device)[None]
    lg = core.arch(cfg).reference_logits(W, cfg, toks, rnd, prompt_len=n)[0]
    return lg[n - 1:]


def reference_weights(cfg: dict, seed: int, device):
    """What the family's reference takes for the served model."""
    return core.arch(cfg).reference_weights(cfg, cfg["max_seq_len"], seed,
                                            device, serving=True)


def held(cfg, wseed, picked, device, log) -> float:
    """The widest gap of a served token's reference logit below the
    reference's best, over the sampled requests."""
    with ref.exact_matmuls():
        W = reference_weights(cfg, wseed, device)
        widest = 0.0
        for req in picked:
            rows = reference_rows(W, cfg, req, device)
            gaps = compare.served_gaps(
                rows, torch.tensor(req.served, device=device))
            widest = max(widest, gaps.max().item())
    log(f"held {len(picked)} requests, "
        f"{sum(len(r.served) for r in picked)} served tokens")
    return widest


def serve(cell: core.Cell, seed: int, seconds: float, trace: bool, device,
          t_start: float, log=print):
    """Set up, run the window (and with ``trace`` the traced window
    after it), read the memory peak and free the program.  Returns the
    outcome with no checks yet and the sampled finished requests."""
    from flash_cosine_sim_attention_tpu_torch.serving import InferenceEngine

    cfg, mix = cell.config, cell.traffic
    arch = core.arch(cfg)
    wseed = generator.derive_seed(seed, "weights")
    log(f"set-up: program imported at {time.perf_counter() - t_start:.1f} s")
    model = arch.build(cfg, cfg["max_seq_len"], wseed, device, serving=True)
    kw = {"prompt_buckets": tuple(mix["prompt_buckets"])} if (
        "prompt_buckets" in mix) else {}
    engine = InferenceEngine(
        model, num_slots=mix["slots"], capacity=mix["capacity"],
        temperature=mix["temperature"], filter_thres=mix["filter_thres"],
        seed=generator.derive_seed(seed, "sampling"), device=device, **kw)
    log(f"set-up: model and engine at {time.perf_counter() - t_start:.1f} s")
    spans = core.Spans()
    loop = Loop(engine, generator.Requests(mix, seed, cfg["num_tokens"]), spans)
    warm_up(engine, mix, cfg["num_tokens"])
    log(f"set-up: warmed at {time.perf_counter() - t_start:.1f} s")
    loop.fill()
    for _ in range(2):
        loop.iterate()
    log(f"set-up: slots filled at {time.perf_counter() - t_start:.1f} s")
    busy = (not trace and device.type == "cuda"
            and BUSY in {m["name"] for m in cell.end_to_end})
    if busy:    # the profiler's first start sets up its device tracing
        tracing.device_busy(lambda: None, arch.COUNTED)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    if busy:
        tokens, busy_s, stretches, left_out = busy_window(
            loop, seconds, mix["busy_turns"], arch.COUNTED, log)
    else:
        while True:
            loop.iterate()
            if spans.items[-1].end >= t0 + seconds:
                break
    t1 = spans.items[-1].end
    finished = [r for r in loop.finished if t0 <= r.times[-1] <= t1]

    served = loop.finished + list(loop.by_slot.values())
    times = [t for r in served for t in r.times if t0 <= t <= t1]
    gaps = [r.times[i] - r.times[i - 1] for r in served
            for i in range(1, len(r.times)) if t0 <= r.times[i] <= t1]
    admitted = [r for r in served if t0 <= r.admitted <= t1]
    values = {"setup_s": setup_s}
    if not busy:
        values["serve_tokens_per_s"] = len(times) / (t1 - t0)
    elif busy_s > 0 and 4 * left_out <= stretches:
        values[BUSY] = tokens / busy_s

    log_fifths(spans, t0, t1, times, log)
    steps = spans.between(t0, t1, "step")
    admits = spans.between(t0, t1, "admit")
    work = {
        "model_flops": sum(arch.decode_flops(cfg, s.info["lens"]) for s in steps)
        + sum(arch.prefill_flops(cfg, s.info["rows"]) for s in admits),
        "prefill_flops": sum(arch.prefill_flops(cfg, s.info["rows"])
                             for s in admits),
        "steps": len(steps), "admits": len(admits),
    }
    if not busy:
        work["tokens_per_s"] = values["serve_tokens_per_s"]
    if gaps:
        work["itl_p95_ms"] = 1e3 * float(np.percentile(gaps, 95))
    if admitted:
        work["ttft_p95_ms"] = 1e3 * float(np.percentile(
            [r.admitted - r.sent for r in admitted], 95))
    context = None
    if trace:
        spans.profiling = True
        prof = tracing.profile_window(
            lambda: [loop.iterate() for _ in range(mix["profile_steps"])],
            arch.COUNTED, log=log)
        spans.profiling = False
        context = core.Context(cell, spans, (t0, t1), work, *prof)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    picked = sample(finished, seed, cell.check["sample_tokens"],
                    cell.check.get("sample_requests", 1))
    del loop, engine, model, served
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return core.Outcome(values, {}, len(admitted), 0, peak, context), picked


def log_fifths(spans, t0, t1, times, log) -> None:
    """Tokens a second, steps and admissions in each fifth of the window,
    to show whether it ran steadily."""
    edges = np.linspace(t0, t1, 6)
    parts = []
    for a, b in zip(edges[:-1], edges[1:]):
        steps = spans.between(a, b, "step")
        admits = spans.between(a, b, "admit")
        toks = sum(a <= t < b for t in times)
        parts.append(f"{toks / (b - a):.1f} tok/s, {len(steps)} steps "
                     f"{core.median_ms(steps) or 0:.2f} ms, {len(admits)} "
                     f"admits {core.median_ms(admits) or 0:.2f} ms")
    log("window fifths: " + " | ".join(parts))


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print) -> core.Outcome:
    out, picked = serve(cell, seed, seconds, trace, device, t_start, log)
    wseed = generator.derive_seed(seed, "weights")
    widest = (held(cell.config, wseed, picked, device, log) if picked
              else float("inf"))
    out.checks["logit_gap"] = (widest, cell.check["limits"]["logit_gap"])
    return out

