"""Serving cells: ``InferenceEngine`` under a closed loop of clients.

Set-up makes the weights on the card from the seed, quantizes them as the
configuration says, warms the prompt buckets the mix reaches and the
decode step, and fills every slot with a request already part-served, so
that the window opens in a steady state.  In the window each freed
slot's client sends its next request at once: it is admitted
(``add_request``, whose first token is the request's first), then one
``step()`` is taken.  After the window, a sample of the finished requests
is held against the reference.
"""

from __future__ import annotations

import gc
import time
from collections import deque

import numpy as np
import torch

from perfbench import core, generator, roofline
from perfbench import trace as tracing
from perfbench.reference import compare
from perfbench.reference import model as ref


def build_model(cfg: dict, seed: int, device):
    """The served model with the benchmark's weights, quantized and fused
    as the configuration says."""
    from flash_cosine_sim_attention_tpu_torch.models.decoding import (
        fuse_qkv_params, quantize_params)

    model = core.build_model(cfg, cfg["max_seq_len"], seed, device)
    if cfg.get("int8_weights"):
        quantize_params(model)
    if cfg.get("fused_qkv"):
        fuse_qkv_params(model)
    return model.eval()


class Loop:
    """The closed loop over one engine: one client per slot."""

    def __init__(self, engine, requests: generator.Requests, spans: core.Spans):
        self.engine, self.requests, self.spans = engine, requests, spans
        self.by_slot = {}
        self.finished = []
        self.waiting = deque()      # when each waiting client sent

    def admit(self, req: generator.Request, sent: float) -> None:
        with self.spans.span("admit", rows=len(req.prompt)) as sp:
            slot = self.engine.add_request(req.prompt)
        req.sent, req.admitted = sent, sp.end
        req.served.append(int(self.engine.last_token[slot]))
        req.times.append(sp.end)
        self.by_slot[slot] = req
        if len(req.served) >= req.out_len:
            self._finish(slot, sp.end)

    def step(self, admitted: bool) -> None:
        eng = self.engine
        live_slots = eng.active & ~eng.prefilling
        rows = int(live_slots.sum())
        live = int(eng.host_pos[live_slots].sum()) + rows
        with self.spans.span("step", rows=rows, live=live,
                             admitted=admitted) as sp:
            toks = eng.step()
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


@torch.no_grad()
def reference_rows(W, cfg, req, device, rnd=ref.identity) -> torch.Tensor:
    """The reference's logits (m, vocab) at the positions that served the
    request's m tokens: the prompt's last and each served token's but
    the last."""
    n = len(req.prompt)
    seq = np.concatenate([req.prompt, np.asarray(req.served[:-1], np.int32)])
    toks = torch.from_numpy(seq.astype(np.int64)).to(device)[None]
    lg = ref.logits(W, cfg, toks, rnd, prompt_len=n)[0]
    return lg[n - 1:]


def reference_weights(cfg: dict, seed: int, device) -> dict:
    raw = ref.make_weights(cfg, cfg["max_seq_len"], seed, device,
                           getattr(torch, cfg["param_dtype"]))
    return ref.served_weights(raw) if cfg.get("int8_weights") else {
        k: v.float() for k, v in raw.items()}


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
    wseed = generator.derive_seed(seed, "weights")
    log(f"set-up: program imported at {time.perf_counter() - t_start:.1f} s")
    model = build_model(cfg, wseed, device)
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
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
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
    values = {"serve_tokens_per_s": len(times) / (t1 - t0),
              "setup_s": setup_s}

    log_fifths(spans, t0, t1, times, log)
    steps = spans.between(t0, t1, "step")
    admits = spans.between(t0, t1, "admit")
    work = {
        "model_flops": sum(roofline.decode_flops(cfg, s.info["rows"],
                                                 s.info["live"]) for s in steps)
        + sum(roofline.prefill_flops(cfg, s.info["rows"]) for s in admits),
        "prefill_flops": sum(roofline.prefill_flops(cfg, s.info["rows"])
                             for s in admits),
        "steps": len(steps), "admits": len(admits),
    }
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
            log=log)
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

