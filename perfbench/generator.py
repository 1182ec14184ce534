"""The one traffic generator: reads a mix's parameters
(``perfbench/traffic/<name>.json``) and the run's seed, and yields the
training batches or the serving requests.

Sizes are stratified: every block of ``strata`` requests holds the same
quantiles of the mix's distributions, in an order the seed draws, so
every seed asks for the same set of sizes and windows of any seed see
nearly the same work.  The seed alone sets the tokens and the order.
So are the tokens left to the requests in flight when a window opens:
each takes the share of its length that a fixed pairing gives its
output quantile, so a block of them leaves the same set for every seed.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch


def derive_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of a run's randomness."""
    ss = np.random.SeedSequence([seed % 2**64, zlib.crc32(stream.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def quantile(dist: dict, u: float) -> int:
    """The u-quantile (0 < u < 1) of a length distribution:
    ``{"dist": "uniform" | "log_uniform", "min": a, "max": b}``, an
    integer in [a, b]."""
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "uniform":
        return lo + min(int(u * (hi - lo + 1)), hi - lo)
    if dist["dist"] == "log_uniform":
        x = math.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
        return min(max(int(x), lo), hi)
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # int32 token ids
    out_len: int                # tokens to serve, the first from prefill
    stratum: int = 0            # its output length's quantile in the block
    served: List[int] = field(default_factory=list)
    times: List[float] = field(default_factory=list)   # host clock a token
    sent: float = 0.0           # when its client sent it
    admitted: float = 0.0       # when add_request returned


class Requests:
    """The closed loop's requests, in the order clients send them."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.vocab = mix, vocab
        self.rng = np.random.default_rng(derive_seed(seed, "requests"))
        self.strata = int(mix.get("strata", 64))
        self._sizes: List[tuple] = []
        self._next = 0
        # the share left of an in-flight request of each output quantile:
        # one fixed pairing, the same for every seed
        self._left = np.random.default_rng(0).permutation(self.strata)

    def _refill(self) -> None:
        u = (np.arange(self.strata) + 0.5) / self.strata
        prompts = [quantile(self.mix["prompt"], x) for x in self.rng.permutation(u)]
        ranks = self.rng.permutation(self.strata)
        outs = [quantile(self.mix["output"], u[j]) for j in ranks]
        self._sizes.extend(zip(prompts, outs, ranks.tolist()))

    def next(self) -> Request:
        if not self._sizes:
            self._refill()
        n, m, j = self._sizes.pop(0)
        prompt = self.rng.integers(0, self.vocab, n, dtype=np.int32)
        self._next += 1
        return Request(self._next - 1, prompt, m, stratum=j)

    def in_flight(self) -> Request:
        """A request already part-served when the window opens: its
        remaining outputs a share of its length, one of the block's
        quantiles of a uniform share by a fixed pairing with its output
        quantile, so that the requests in flight finish at staggered
        times and a block of them leaves the same tokens for every
        seed."""
        r = self.next()
        share = (self._left[r.stratum] + 0.5) / self.strata
        r.out_len = 1 + int(share * r.out_len)
        return r


class Batches:
    """Training batches (micro, batch, seq_len + 1) of uniform token ids,
    drawn on ``device`` from the seed: every row differs."""

    def __init__(self, mix: dict, seed: int, vocab: int, device):
        self.shape = (mix["grad_accum"], mix["batch"], mix["seq_len"] + 1)
        self.vocab, self.device = vocab, device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(derive_seed(seed, "batches"))

    def next(self) -> torch.Tensor:
        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device)

    @property
    def tokens(self) -> int:
        """Tokens a step trains on."""
        a, b, n1 = self.shape
        return a * b * (n1 - 1)
