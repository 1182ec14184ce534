"""Fused cosine-sim attention backward: (dq, dk, dv, db) from the forward's
residuals.

Counterpart of ``flash_cosine_sim_attention_tpu/ops/bwd_kernel.py``.  A
CUDA tensor goes to the hand-written Hopper kernels of
``csrc/bwd_kernel.cu``; a CPU tensor goes to
``flash_attention_backward_plain``, the same formulas in plain PyTorch.
The dispatch is the JAX one: without a bias (and seq_q up to
``ONEPASS_BWD_MAX_SEQ``) the one-pass kernel K2 (replaces
``_fused_bwd_kernel_t``), else the two-pass kernels K3a (dQ and dB,
replaces ``_dq_kernel_t``) and K3b (dK and dV, replaces
``_dkdv_kernel_t``).  The JAX gate that sends causal f32 past seq 4096 to
the two-pass kernels is a TPU tuning choice and is dropped here; both
routes compute the same gradients.

As in JAX, the host side around the kernels stays plain tensor code:
delta = rowsum(dO * O) in f32, then dO and delta pre-scaled by inv_l (dO
rounded back to its dtype), so the kernels never form P = e * inv_l.
A head dim that is not a kernel width runs zero-padded to the next one,
and past 256 to the next multiple of 128 for the wide route
(``kernel_head_dim``); its gradients are sliced back.
``_backward_onepass`` and ``_backward_twopass`` pin one route each on
CUDA tensors, as ``blocks_f`` / ``blocks_t`` pin them in the JAX tests.

Which instance runs: bfloat16 on the tensor cores for K2, K3a and K3b at
every width.  float32 K2, K3a and K3b on the tensor cores at every width
(up to 256 ``dkdv_tf32_kernel<D, true>``, ``dq_tf32_kernel<D>``,
``dkdv_tf32_kernel<D, false>``; past it the wide route's
``dkdv_wide_tf32_kernel<true>``, ``dq_wide_tf32_kernel``,
``dkdv_wide_tf32_kernel<false>``), every product as three TF32 products
of a hi / lo split of each operand: ``flash_attention_backward_plain``
with ``mm=ops.mxu.dot_tf32x3`` is their plain version, dB included (the
bias is added in float32 and never split).  A call whose kernel fails to
build or launch raises: nothing falls back to another instance.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import check_launch, current_stream, load_kernel
from .blocks import ONEPASS_BWD_MAX_SEQ, kernel_head_dim
from .fwd_kernel import _DTYPE_CODES, _check_shapes
from .reference import causal_keep, pad_head_dim

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _prescale(do, o, inv_l):
    """(dO * inv_l in dO's dtype, rowsum(dO * O) * inv_l in f32)."""
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return (do.float() * inv_l).to(do.dtype), delta * inv_l


def flash_attention_backward_plain(do, o, inv_l, q, k, v, mask, bias, *,
                                   bias_batch_dim, scale, causal, mm=None):
    """Plain PyTorch version of the backward kernels (float32 sums):
    recompute e, then dP', dS, the five products and dB.  ``mm`` forms
    the products (default ``torch.matmul``, exact float32;
    ``ops.mxu.dot_tf32x3`` is the split of the float32 K2, K3a and K3b)."""
    _check_shapes(q, k, v, mask, bias, bias_batch_dim)
    mm = torch.matmul if mm is None else mm
    b, h, seq_q, d = q.shape
    kvh, seq_k = k.shape[1], k.shape[2]
    group = h // kvh
    do_s, delta_s = _prescale(do, o, inv_l)
    do_s = do_s.float()
    qf, kf, vf = q.float(), k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    s = mm(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + (bias[:, None] if bias_batch_dim else bias[None]).float()
    e = torch.exp(s)
    ds = e * (mm(do_s, vf.transpose(-1, -2)) - delta_s)
    keep = None
    if causal:
        keep = causal_keep(seq_q, seq_k, q.device)[None, None]
    if mask is not None:
        km = mask[:, None, None, :].bool()
        keep = km if keep is None else keep & km
    if keep is not None:
        zero = torch.zeros((), device=e.device)
        e, ds = torch.where(keep, e, zero), torch.where(keep, ds, zero)
    dv = mm(e.transpose(-1, -2), do_s)
    dk = mm(ds.transpose(-1, -2), qf) * scale
    dq = mm(ds, kf) * scale
    if group > 1:
        dk = dk.view(b, kvh, group, seq_k, d).sum(2)
        dv = dv.view(b, kvh, group, seq_k, d).sum(2)
    db = None
    if bias is not None:
        db = ds.sum(1 if bias_batch_dim else 0).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), db


def _cuda_inputs(do, o, inv_l, q, k, v, mask, bias, bias_batch_dim):
    """Check what the kernels take; return their contiguous inputs, q, k,
    v and dO' zero-padded to the kernel's head width."""
    _check_shapes(q, k, v, mask, bias, bias_batch_dim)
    if q.dtype not in _DTYPE_CODES or any(
            t.dtype != q.dtype for t in (k, v, do)):
        raise TypeError(
            f"the CUDA backward takes float32 or bfloat16 q/k/v/dO of one "
            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    width = kernel_head_dim(q.shape[-1], "backward")
    if do.shape != q.shape or tuple(inv_l.shape) != (*q.shape[:3], 1):
        raise ValueError(f"dO {tuple(do.shape)} / inv_l {tuple(inv_l.shape)}"
                         f" do not fit q {tuple(q.shape)}")
    tensors = [do, o, inv_l, q, k, v] + [
        t for t in (mask, bias) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must lie on the same CUDA device")
    do_s, delta_s = _prescale(do, o, inv_l)
    q, k, v, do_s = (pad_head_dim(t, width).contiguous()
                     for t in (q, k, v, do_s))
    return dict(
        q=q, k=k, v=v, do=do_s, delta=delta_s[..., 0].contiguous(),
        mask=None if mask is None else mask.to(torch.uint8).contiguous(),
        bias=None if bias is None else bias.float().contiguous())


def _dims(x):
    b, h, seq_q, d = x["q"].shape
    kvh, seq_k = x["k"].shape[1], x["k"].shape[2]
    return [_DTYPE_CODES[x["q"].dtype], b, h, kvh, seq_q, seq_k, d]


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fused_bwd_kernel(x, *, scale, causal):
    """Launch K2 on ``_cuda_inputs``; returns (unscaled f32 sum of dS.k,
    dk, dv) at the kernel's head width.  Counted in
    ``fused_bwd_kernel.launches``."""
    dq_acc = torch.zeros(x["q"].shape, device=x["q"].device,
                         dtype=torch.float32)
    dk, dv = torch.empty_like(x["k"]), torch.empty_like(x["v"])
    fn = load_kernel("bwd_kernel").fcsa_bwd_onepass
    fn.restype = _INT
    fn.argtypes = [_PTR] * 9 + [_INT] * 8 + [ctypes.c_float, _PTR]
    code = fn(*map(_ptr, (x["q"], x["k"], x["v"], x["do"], x["delta"],
                          x["mask"], dq_acc, dk, dv)),
              *_dims(x), int(causal), float(scale), current_stream())
    check_launch(code, "fcsa_bwd_onepass")
    fused_bwd_kernel.launches += 1
    return dq_acc, dk, dv


def dq_kernel(x, *, bias_batch_dim, scale, causal):
    """Launch K3a on ``_cuda_inputs``; returns (dq at the kernel's head
    width, f32 dB or None).  Counted in ``dq_kernel.launches``."""
    dq = torch.empty_like(x["q"])
    db = None if x["bias"] is None else torch.zeros_like(x["bias"])
    fn = load_kernel("bwd_kernel").fcsa_bwd_dq
    fn.restype = _INT
    fn.argtypes = [_PTR] * 9 + [_INT] * 9 + [ctypes.c_float, _PTR]
    code = fn(*map(_ptr, (x["q"], x["k"], x["v"], x["do"], x["delta"],
                          x["mask"], x["bias"], dq, db)),
              *_dims(x), int(causal), int(bias_batch_dim), float(scale),
              current_stream())
    check_launch(code, "fcsa_bwd_dq")
    dq_kernel.launches += 1
    return dq, db


def dkdv_kernel(x, *, bias_batch_dim, scale, causal):
    """Launch K3b on ``_cuda_inputs``; returns (dk, dv) at the kernel's
    head width.  Counted in ``dkdv_kernel.launches``."""
    dk, dv = torch.empty_like(x["k"]), torch.empty_like(x["v"])
    fn = load_kernel("bwd_kernel").fcsa_bwd_dkdv
    fn.restype = _INT
    fn.argtypes = [_PTR] * 9 + [_INT] * 9 + [ctypes.c_float, _PTR]
    code = fn(*map(_ptr, (x["q"], x["k"], x["v"], x["do"], x["delta"],
                          x["mask"], x["bias"], dk, dv)),
              *_dims(x), int(causal), int(bias_batch_dim), float(scale),
              current_stream())
    check_launch(code, "fcsa_bwd_dkdv")
    dkdv_kernel.launches += 1
    return dk, dv


fused_bwd_kernel.launches = 0
dq_kernel.launches = 0
dkdv_kernel.launches = 0


def _backward_onepass(do, o, inv_l, q, k, v, mask, *, scale, causal):
    """The one-pass route on CUDA tensors (K2); returns (dq, dk, dv)."""
    x = _cuda_inputs(do, o, inv_l, q, k, v, mask, None, False)
    dq_acc, dk, dv = fused_bwd_kernel(x, scale=scale, causal=causal)
    d = q.shape[-1]
    return (dq_acc[..., :d] * scale).to(q.dtype), dk[..., :d], dv[..., :d]


def _backward_twopass(do, o, inv_l, q, k, v, mask, bias, *, bias_batch_dim,
                      scale, causal):
    """The two-pass route on CUDA tensors (K3a, then K3b); returns
    (dq, dk, dv, db or None)."""
    x = _cuda_inputs(do, o, inv_l, q, k, v, mask, bias, bias_batch_dim)
    kw = dict(bias_batch_dim=bias_batch_dim, scale=scale, causal=causal)
    dq, db = dq_kernel(x, **kw)
    dk, dv = dkdv_kernel(x, **kw)
    d = q.shape[-1]
    return (dq[..., :d], dk[..., :d], dv[..., :d],
            None if db is None else db.to(bias.dtype))


def flash_attention_backward(
    do: torch.Tensor,                # (b, h, i, d), the output's gradient
    o: torch.Tensor,                 # (b, h, i, d), the forward's output
    inv_l: torch.Tensor,             # (b, h, i, 1) f32, from the forward
    q: torch.Tensor,                 # (b, h, i, d), l2-normalized
    k: torch.Tensor,                 # (b, kvh, j, d)
    v: torch.Tensor,                 # (b, kvh, j, d)
    mask: Optional[torch.Tensor],    # (b, j) bool or None
    bias: Optional[torch.Tensor],    # (b|h, i, j) or None
    *,
    bias_batch_dim: bool,
    scale: float,
    causal: bool,
):
    """Full backward; returns (dq, dk, dv, db or None) in the inputs'
    dtypes.  CUDA tensors launch the Hopper kernels, CPU tensors take the
    plain version; any other device raises."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            do, o, inv_l, q, k, v, mask, bias, bias_batch_dim=bias_batch_dim,
            scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no backward for device {q.device}")
    if bias is None and q.shape[2] <= ONEPASS_BWD_MAX_SEQ:
        return (*_backward_onepass(do, o, inv_l, q, k, v, mask, scale=scale,
                                   causal=causal), None)
    return _backward_twopass(do, o, inv_l, q, k, v, mask, bias,
                             bias_batch_dim=bias_batch_dim, scale=scale,
                             causal=causal)
