"""Fused cosine-sim attention forward: (o, inv_l) from l2-normalized q/k.

Counterpart of ``flash_cosine_sim_attention_tpu/ops/fwd_kernel.py``.  A
CUDA tensor goes to the hand-written Hopper kernel ``csrc/fwd_kernel.cu``
(which replaces the TPU kernel ``_fwd_kernel_t``); a CPU tensor goes to
``flash_attention_forward_plain``, the same exp-weight sums in plain
PyTorch.  Both use the JAX forward's convention: e = exp(scale*q.k + bias)
with no row max and no ``- scale`` shift, o = sum(e v) / max(sum(e), EPS),
and inv_l = 1 / max(sum(e), EPS), so a row that sees no key returns o = 0
and inv_l = 1e10.

The int8 arm (JAX's int8 q/k path): q and k arrive as int8 codes, v in
float32 or bfloat16; the logits are scale * s_dequant * (exact integer
q.k), and o comes out in v's dtype.

Which instance runs: bfloat16 q/k/v, and int8 codes with bfloat16 v, on
the tensor cores at every width.  float32 q/k/v on the tensor cores at
every width (``fwd_tf32_kernel<D, float>`` up to 256, past it the wide
route's ``fwd_wide_tf32_kernel<float>``), every product as three TF32
products of a hi / lo split of each operand (``ops.mxu.dot_tf32x3`` is its
plain version; JAX's bfloat16 split, ``dot_f32x3``, misses the float32 bar
of 1e-4 at 8 l2norm groups and scale 8, TF32's does not); int8 codes with
float32 v on the int8 instances of the same kernels
(``fwd_tf32_kernel<D, int8_t>``, ``fwd_wide_tf32_kernel<int8_t>``): Q.K
exact on the int8 tensor cores, P.V as 3xTF32.  A call whose kernel fails
to build or launch raises: nothing falls back to another instance.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import check_launch, current_stream, load_kernel
from .blocks import EPS, kernel_head_dim
from .reference import causal_keep, pad_head_dim

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (q/k dtype, v/o dtype) -> the forward kernel's dtype code
_FWD_CODES = {**{(t, t): c for t, c in _DTYPE_CODES.items()},
              (torch.int8, torch.float32): 2,
              (torch.int8, torch.bfloat16): 3}


def _check_shapes(q, k, v, mask, bias, bias_batch_dim):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be (b, h, i, d) and k, v (b, kvh, j, d); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, seq_q, d = q.shape
    kvh, seq_k = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if mask is not None and tuple(mask.shape) != (b, seq_k):
        raise ValueError(f"mask must be {(b, seq_k)}, got {tuple(mask.shape)}")
    if bias is not None and tuple(bias.shape) != (
            b if bias_batch_dim else h, seq_q, seq_k):
        raise ValueError(f"bias shape {tuple(bias.shape)} does not fit")


def flash_attention_forward_plain(q, k, v, mask, bias, *, bias_batch_dim,
                                  scale, causal, s_dequant=1.0, mm=None):
    """Plain PyTorch version of the forward kernel (float32 sums; int8
    codes multiply exactly in f32, every partial sum being below 2^24).
    ``mm`` forms its two products (default ``torch.matmul``, exact float32;
    ``ops.mxu.dot_tf32x3`` is the float32 kernel's split)."""
    _check_shapes(q, k, v, mask, bias, bias_batch_dim)
    mm = torch.matmul if mm is None else mm
    h, kvh = q.shape[1], k.shape[1]
    kf, vf = k.float(), v.float()
    if kvh != h:
        kf = kf.repeat_interleave(h // kvh, dim=1)
        vf = vf.repeat_interleave(h // kvh, dim=1)
    s = mm(q.float(), kf.transpose(-1, -2)) * (scale * s_dequant)
    if bias is not None:
        s = s + (bias[:, None] if bias_batch_dim else bias[None]).float()
    e = torch.exp(s)
    keep = None
    if causal:
        keep = causal_keep(q.shape[2], k.shape[2], q.device)[None, None]
    if mask is not None:
        km = mask[:, None, None, :].bool()
        keep = km if keep is None else keep & km
    if keep is not None:
        e = torch.where(keep, e, torch.zeros((), device=e.device))
    inv_l = 1.0 / e.sum(-1, keepdim=True).clamp_min(EPS)
    o = mm(e, vf) * inv_l
    return o.to(v.dtype), inv_l


def _forward_cuda(q, k, v, mask, bias, *, bias_batch_dim, scale, causal,
                  s_dequant):
    _check_shapes(q, k, v, mask, bias, bias_batch_dim)
    dtype_code = _FWD_CODES.get((q.dtype, v.dtype))
    if dtype_code is None or k.dtype != q.dtype:
        raise TypeError(
            f"the CUDA forward takes float32 or bfloat16 q/k/v of one dtype, "
            f"or int8 q/k with float32 or bfloat16 v; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    b, h, seq_q, d = q.shape
    kvh, seq_k = k.shape[1], k.shape[2]
    width = kernel_head_dim(d, "forward")
    tensors = [q, k, v] + [t for t in (mask, bias) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must lie on the same CUDA device")
    q, k, v = (pad_head_dim(t, width).contiguous() for t in (q, k, v))
    mask_u8 = mask.to(torch.uint8).contiguous() if mask is not None else None
    bias_f = bias.float().contiguous() if bias is not None else None
    o = torch.empty(q.shape, device=q.device, dtype=v.dtype)
    inv_l = torch.empty((b, h, seq_q, 1), device=q.device,
                        dtype=torch.float32)
    lib = load_kernel("fwd_kernel")
    lib.fcsa_fwd.restype = ctypes.c_int
    lib.fcsa_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    code = lib.fcsa_fwd(
        ptr(q), ptr(k), ptr(v), ptr(mask_u8), ptr(bias_f), ptr(o),
        ptr(inv_l), dtype_code, b, h, kvh, seq_q, seq_k, width, int(causal),
        int(bias_batch_dim), float(scale), float(s_dequant),
        current_stream())
    check_launch(code, "fcsa_fwd")
    flash_attention_forward.launches += 1
    return (o if width == d else o[..., :d].contiguous()), inv_l


def flash_attention_forward(
    q: torch.Tensor,                 # (b, h, i, d), l2-normalized
    k: torch.Tensor,                 # (b, kvh, j, d), kvh dividing h
    v: torch.Tensor,                 # (b, kvh, j, d)
    mask: Optional[torch.Tensor],    # (b, j) bool or None
    bias: Optional[torch.Tensor],    # (b|h, i, j) or None
    *,
    bias_batch_dim: bool,
    scale: float,
    causal: bool,
    s_dequant: float = 1.0,
):
    """Fused forward; returns (o in v's dtype, inv_l (b, h, i, 1) f32).

    q and k are l2-normalized float32 / bfloat16 values of v's dtype, or
    int8 codes whose product ``s_dequant`` dequantizes (1/127^2 for the
    op's ``qk_int8``).  CUDA tensors launch the Hopper kernel (counted in
    ``flash_attention_forward.launches``), a head dim that is not one of
    its widths zero-padded to the next, and past 256 to the next multiple
    of 128 for the wide route (``kernel_head_dim``); CPU tensors take the
    plain version.  Any other device raises.
    """
    kw = dict(bias_batch_dim=bias_batch_dim, scale=scale, causal=causal,
              s_dequant=s_dequant)
    if q.device.type == "cuda":
        return _forward_cuda(q, k, v, mask, bias, **kw)
    if q.device.type == "cpu":
        return flash_attention_forward_plain(q, k, v, mask, bias, **kw)
    raise ValueError(f"no forward for device {q.device}")


flash_attention_forward.launches = 0
