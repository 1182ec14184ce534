"""Paged quantized KV cache: a shared page pool + per-slot page tables.

Counterpart of ``flash_cosine_sim_attention_tpu/quant/paged.py``.  All
batch slots draw fixed-size pages from one pool per layer, so memory
scales with the tokens in flight rather than slots x capacity, and a
finished request's pages return to the free list at once.

The layout is the JAX pool's, unchanged, so pools compare byte for byte:

  * ``k8``/``v8``: (num_pages, kvh, d, page_size) int8 or e4m3, token-minor;
  * ``v_scale``: (num_pages, kvh, 1, page_size) f32 (all ones for e4m3);
  * ``page_table``: (num_slots, max_pages) int32 page ids; entries past a
    slot's allocation point at the null page 0, which is never attended;
  * ``length``: (num_slots,) int32 tokens written per slot.

Page allocation is host policy (``PageAllocator``, owned by the engine,
which writes the table before a step touches it).  ``append_paged``
writes the pool IN PLACE; only ``length`` is a new tensor.

Decode: a CUDA query goes to the hand-written Hopper kernel
``csrc/paged_decode_kernel.cu`` (it replaces ``_paged_decode_kernel``); a
CPU query goes to ``paged_decode_plain``, which gathers each slot's pages
and applies the contiguous decode's plain maths, as JAX's
``_xla_paged_decode`` does.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional

import torch

from .._build import check_launch, current_stream, load_kernel, resolve_device
from ..ops.blocks import EPS, PAGED_TILE
from ..ops.reference import l2norm_tensors
from .decode_kernel import check_decode_args, decode_queries, split_workspace
from .kv_cache import (
    FP8_DTYPE,
    as_bytes,
    check_kv_dtype,
    kdq,
    quantize_k,
    quantize_v,
)


class PagedKVCache(NamedTuple):
    k8: torch.Tensor          # (num_pages, kvh, d, page_size)
    v8: torch.Tensor          # (num_pages, kvh, d, page_size)
    v_scale: torch.Tensor     # (num_pages, kvh, 1, page_size) f32
    page_table: torch.Tensor  # (num_slots, max_pages) int32
    length: torch.Tensor      # (num_slots,) int32

    @property
    def page_size(self) -> int:
        return self.k8.shape[3]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]

    @property
    def is_fp8(self) -> bool:
        return self.k8.dtype == FP8_DTYPE

    @property
    def k_dequant_scale(self) -> float:
        return kdq(self.k8.dtype)


def init_paged_cache(num_pages: int, kv_heads: int, page_size: int,
                     dim_head: int, num_slots: int, max_pages_per_slot: int,
                     kv_dtype=torch.int8, device=None) -> PagedKVCache:
    """An empty pool on ``device`` (default ``cuda``; raises when no card
    is present and the CPU was not asked for), every table entry on the
    null page 0."""
    check_kv_dtype(kv_dtype)
    if page_size % PAGED_TILE:
        raise ValueError(f"page_size must be a multiple of {PAGED_TILE}, got "
                         f"{page_size}")
    device = resolve_device(device)
    shape = (num_pages, kv_heads, dim_head, page_size)
    fill = torch.zeros if kv_dtype == torch.int8 else torch.ones
    return PagedKVCache(
        k8=torch.zeros(shape, dtype=kv_dtype, device=device),
        v8=torch.zeros(shape, dtype=kv_dtype, device=device),
        v_scale=fill((num_pages, kv_heads, 1, page_size), dtype=torch.float32,
                     device=device),
        page_table=torch.zeros((num_slots, max_pages_per_slot),
                               dtype=torch.int32, device=device),
        length=torch.zeros((num_slots,), dtype=torch.int32, device=device),
    )


def append_paged(cache: PagedKVCache, k_norm: torch.Tensor, v: torch.Tensor,
                 active: Optional[torch.Tensor] = None) -> PagedKVCache:
    """Write a (b, kvh, t, d) chunk at each slot's length into the pool, in
    place (an ``index_put_`` of token columns), and return the cache with
    the advanced lengths.

    The page table must already hold the pages for the target positions.
    Positions past the table (bucket-pad tokens of a slot that holds
    ``max_pages`` pages) and every write of an inactive slot (``active``,
    (b,) bool; its length does not advance) go to the null page 0: a
    finished slot's row may point at pages released to another request.
    Such writes may land on the same null-page cells at once, which is
    harmless, since page 0 is never attended.
    """
    b, _, t, _ = k_norm.shape
    ps, mp = cache.page_size, cache.max_pages
    dev = cache.k8.device
    pos = cache.length.long()[:, None] + torch.arange(t, device=dev)  # (b, t)
    page = pos // ps
    pids = cache.page_table.long().gather(1, page.clamp(max=mp - 1))
    pids = torch.where(page < mp, pids, 0)
    if active is not None:
        pids = torch.where(active[:, None], pids, 0)
    offs = pos % ps
    kv_dtype = cache.k8.dtype
    v_q, vs = quantize_v(v, kv_dtype)
    # advanced indices at dims 0 and 3 put (b, t) in front: the values
    # arrive as (b, t, kvh, d) and (b, t, kvh, 1)
    for pool, new in ((cache.k8, quantize_k(k_norm, kv_dtype)),
                      (cache.v8, v_q), (cache.v_scale, vs)):
        as_bytes(pool)[pids, :, :, offs] = as_bytes(new).transpose(1, 2)
    step = t if active is None else t * active.to(torch.int32)
    return cache._replace(length=cache.length + step)


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """(P, kvh, x, ps) pool, (b, mp) table -> (b, kvh, x, mp * ps): each
    slot's pages in table order, a copy in the pool's dtype."""
    b, mp = page_table.shape
    _, kvh, x, ps = pool.shape
    got = as_bytes(pool)[page_table.long()]                  # (b, mp, kvh, x, ps)
    got = got.permute(0, 2, 3, 1, 4).reshape(b, kvh, x, mp * ps)
    return got.view(pool.dtype)


def paged_decode_plain(qg: torch.Tensor, cache: PagedKVCache,
                       scale: float) -> torch.Tensor:
    """Plain version of the paged decode kernel: qg (b, kvh, g, d)
    normalized queries -> (b, kvh, g, d) f32.  Tokens t < length of each
    slot's gathered pages are attended (all max_pages * page_size of them
    when a stale length runs past the table)."""
    k = gather_pages(cache.k8, cache.page_table).float()        # (b, kvh, d, T)
    v = gather_pages(cache.v8, cache.page_table).float()
    live = (torch.arange(k.shape[-1], device=k.device)[None, None, None, :]
            < cache.length[:, None, None, None])
    q = qg.to(torch.bfloat16).float()
    s = q @ k                                                    # (b, kvh, g, T)
    e = torch.exp(s * (scale * cache.k_dequant_scale) - scale)
    e = torch.where(live, e, torch.zeros((), device=e.device))
    lsum = e.sum(-1, keepdim=True)                       # unscaled weights
    if not cache.is_fp8:  # fold int8 V's per-token scale into the weights
        e = e * gather_pages(cache.v_scale, cache.page_table)
    o = e.to(torch.bfloat16).float() @ v.transpose(-1, -2)
    return o / lsum.clamp_min(EPS)


def _paged_decode_cuda(qg: torch.Tensor, cache: PagedKVCache,
                       scale: float) -> torch.Tensor:
    b, kvh, g, d = qg.shape
    num_pages, ps, mp = cache.k8.shape[0], cache.page_size, cache.max_pages
    check_decode_args(qg, cache.k8, cache.v8, "paged decode")
    if ps % PAGED_TILE:
        raise ValueError(f"page_size must be a multiple of {PAGED_TILE}")
    want = {"k8": (num_pages, kvh, d, ps), "v8": (num_pages, kvh, d, ps),
            "v_scale": (num_pages, kvh, 1, ps), "page_table": (b, mp),
            "length": (b,)}
    for name, shape in want.items():
        got = tuple(getattr(cache, name).shape)
        if got != shape:
            raise ValueError(f"{name} has shape {got}, queries "
                             f"{tuple(qg.shape)} need {shape}")
    if cache.v_scale.dtype != torch.float32:
        raise TypeError(f"v_scale must be float32, got {cache.v_scale.dtype}")
    if any(t.device != qg.device for t in cache):
        raise ValueError("queries and cache must lie on the same CUDA device")
    # the pool is used where it lies: a copy of it would cost more than
    # the decode, so a non-contiguous or misaligned pool is refused
    for name in ("k8", "v8", "v_scale"):
        pool = getattr(cache, name)
        if not pool.is_contiguous() or pool.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    q = decode_queries(qg)
    table = cache.page_table.to(torch.int32).contiguous()
    length = cache.length.to(torch.int32).contiguous()
    out = torch.empty((b, kvh, g, d), device=qg.device, dtype=torch.float32)
    tps, nsplit, ws_o, ws_l, tickets = split_workspace(q, mp * ps)
    lib = load_kernel("paged_decode_kernel")
    lib.fcsa_paged_decode.restype = ctypes.c_int
    lib.fcsa_paged_decode.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    code = lib.fcsa_paged_decode(
        q.data_ptr(), cache.k8.data_ptr(), cache.v8.data_ptr(),
        cache.v_scale.data_ptr(), table.data_ptr(), length.data_ptr(),
        out.data_ptr(), ws_o.data_ptr(), ws_l.data_ptr(), tickets.data_ptr(),
        b, kvh, g, d, num_pages, ps, mp, int(cache.is_fp8), tps, nsplit,
        float(scale * cache.k_dequant_scale), float(scale), current_stream())
    check_launch(code, "fcsa_paged_decode")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(
    q: torch.Tensor,            # (b, h, d) or (b, h, 1, d), one new token
    cache: PagedKVCache,
    scale: float = 8.0,
    groups: int = 1,
    l2norm_qk: bool = True,
) -> torch.Tensor:
    """One decode step of every slot against the paged cache (b = slots);
    returns q's shape and dtype.

    CUDA queries launch the Hopper kernel (counted in
    ``paged_decode_attention.launches``); CPU queries take the plain
    version.  Any other device raises.
    """
    squeeze = q.ndim == 4
    if squeeze:
        if q.shape[2] != 1:
            raise ValueError(f"one query token per slot, got {q.shape[2]}")
        q = q[:, :, 0]
    if l2norm_qk:
        q = l2norm_tensors(q, groups=groups)
    b, h, d = q.shape
    kvh = cache.k8.shape[1]
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    qg = q.reshape(b, kvh, h // kvh, d)
    if q.device.type == "cuda":
        out = _paged_decode_cuda(qg, cache, float(scale))
    elif q.device.type == "cpu":
        out = paged_decode_plain(qg, cache, float(scale))
    else:
        raise ValueError(f"no paged decode attention for device {q.device}")
    out = out.reshape(b, h, d).to(q.dtype)
    return out[:, :, None, :] if squeeze else out


paged_decode_attention.launches = 0


class PageAllocator:
    """Host-side page free list (engine policy, not device state).  Page 0
    is the reserved null page; pages are handed out in JAX's order."""

    def __init__(self, num_pages: int):
        self.free: List[int] = list(range(num_pages - 1, 0, -1))

    def alloc(self, n: int) -> List[int]:
        if len(self.free) < n:
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {len(self.free)}")
        return [self.free.pop() for _ in range(n)]

    def release(self, pages) -> None:
        for p in pages:
            if p != 0:
                self.free.append(int(p))
