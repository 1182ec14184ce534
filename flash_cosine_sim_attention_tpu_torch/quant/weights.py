"""INT8 weights for the serving path: per-output-channel absmax codes and
the dequant-matmul kernel.

Counterpart of ``flash_cosine_sim_attention_tpu/quant/weights.py`` with
its layouts: a quantized dense kernel is ``w8`` (in, out) int8 and
``scale`` (1, out) float32, so the bytes compare one to one with the JAX
tree.  ``quantize_params``, which rewrites a model's modules, lives with
``fuse_qkv_params`` in ``models/decoding.py``; the package ``quant``
re-exports it under JAX's name.

``quantized_matmul`` is the entry of K7: a CUDA tensor launches the
hand-written Hopper kernel ``csrc/quant_matmul_kernel.cu`` (which replaces
the TPU kernel ``_dequant_matmul_kernel``), a CPU tensor takes
``quantized_matmul_plain``.  Both dtypes of x run on the tensor cores:
bfloat16 x by bf16 products, float32 x as 2xTF32 (x split into TF32 hi
and lo, each times the codes, which are exact in TF32).  On the card the
quantized dense layers run K7 (``QuantDense``): unlike the TPU, where a
kernel per matmul broke XLA's fusion and JAX left ``dense_apply`` on its
XLA arm, a decode step here is a chain of separate kernels anyway, and
K7 reads int8 bytes only.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check_launch, current_stream, load_kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_dense_kernel(w: torch.Tensor):
    """(in, out) kernel -> (int8 kernel, (1, out) f32 scale).  Absmax over
    ``in`` in f32, codes rounded half to even (``torch.round``, as
    ``jnp.round``).  The codes come out contiguous whatever ``w``'s
    strides (a transposed ``nn.Linear`` weight, say), as K7 reads them."""
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    w8 = torch.round((wf / scale).clamp(-127, 127)).to(torch.int8)
    return w8.contiguous(), scale


def dequantize_dense_kernel(w8: torch.Tensor, scale: torch.Tensor,
                            dtype=torch.float32) -> torch.Tensor:
    return (w8.float() * scale).to(dtype)


def quantized_matmul_plain(x: torch.Tensor, w8: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: f32 product of x and the codes, the
    per-column scale after it, cast to x's dtype.  (On float32 x the
    kernel forms ``ops.mxu.dot_tf32x3(x, w8.float())``: the codes are
    exact in TF32, so that is x's hi and lo times the codes.)"""
    return ((x.float() @ w8.float()) * scale.float()).to(x.dtype)


def qmm_plan(device, rows: int, d_in: int, d_out: int):
    """K7's grid for a (rows, d_in) x (d_in, d_out) product on CUDA
    ``device``: (rows per block, input splits, input tiles per split), as
    the kernel's library picks it (its tiles are defined there only) from
    the shape and the card's SM count."""
    lib = load_kernel("quant_matmul_kernel")
    plan = (ctypes.c_int * 3)()
    lib.fcsa_qmm_plan.restype = None
    lib.fcsa_qmm_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.fcsa_qmm_plan(rows, d_in, d_out, torch.cuda.get_device_properties(
        device).multi_processor_count, plan)
    return tuple(plan)


def _matmul_cuda(x, w8, scale):
    if x.ndim != 2 or w8.ndim != 2 or x.shape[1] != w8.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w8 {tuple(w8.shape)} do not "
                         f"fit (t, in) x (in, out)")
    rows, d_in = x.shape
    d_out = w8.shape[1]
    if x.dtype not in _DTYPE_CODES or w8.dtype != torch.int8:
        raise TypeError(f"K7 takes float32 or bfloat16 x and int8 w8, got "
                        f"{x.dtype}, {w8.dtype}")
    if tuple(scale.shape) != (1, d_out):
        raise ValueError(f"scale must be (1, {d_out}), got "
                         f"{tuple(scale.shape)}")
    if rows == 0 or d_in == 0 or d_out % 16:
        raise ValueError(
            f"K7 streams weight rows in 16-byte loads: it needs out % 16 == 0 "
            f"and non-empty x, got rows {rows}, in {d_in}, out {d_out}")
    if any(t.device != x.device for t in (w8, scale)):
        raise ValueError("x, w8 and scale must lie on the same CUDA device")
    # a copy of w8 on every call would move more bytes than K7 saves
    if not w8.is_contiguous() or w8.data_ptr() % 16:
        raise ValueError("K7 reads w8 in place: it must be contiguous and "
                         "start on a 16-byte boundary")
    x = x.contiguous()
    scale = scale.float().contiguous()
    y = torch.empty((rows, d_out), device=x.device, dtype=x.dtype)
    block_rows, splits, per_split = qmm_plan(x.device, rows, d_in, d_out)
    work = (torch.empty((splits, rows, d_out), device=x.device,
                        dtype=torch.float32) if splits > 1 else None)
    lib = load_kernel("quant_matmul_kernel")
    lib.fcsa_qmm.restype = ctypes.c_int
    lib.fcsa_qmm.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                             + [ctypes.c_void_p])
    code = lib.fcsa_qmm(
        x.data_ptr(), w8.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if work is None else work.data_ptr(), _DTYPE_CODES[x.dtype],
        rows, d_in, d_out, block_rows, splits, per_split, current_stream())
    check_launch(code, "fcsa_qmm")
    quantized_matmul.launches += 1
    return y


def quantized_matmul(x: torch.Tensor, w8: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(w8)``: x (t, in) bf16/f32, w8 (in, out) int8, scale
    (1, out) f32 -> (t, out) in x's dtype, summed in f32.

    CUDA tensors launch K7 (counted in ``quantized_matmul.launches``),
    which reads only the int8 weight bytes and raises on a shape it cannot
    take; CPU tensors take the plain version.  Any other device raises.
    The JAX entry's ``block_out`` / ``block_in`` / ``interpret`` tune TPU
    tiles and have no counterpart here.
    """
    if x.device.type == "cuda":
        return _matmul_cuda(x, w8, scale)
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, w8, scale)
    raise ValueError(f"no quantized matmul for device {x.device}")


quantized_matmul.launches = 0


def dense_apply(p, x: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """Apply a (possibly quantized) dense kernel dict to ``x``, as JAX's
    ``dense_apply``: ``{"kernel_q", "kernel_scale"}`` or ``{"kernel"}``,
    each (in, out).  The default arm rounds ``x @ w8`` to x's dtype before
    scaling, as XLA does; ``use_kernel=True`` goes through
    ``quantized_matmul`` (K7 on the card), which scales the f32 sums."""
    if "kernel_q" in p:
        w8, scale = p["kernel_q"], p["kernel_scale"]
        if use_kernel:
            lead = x.shape[:-1]
            y = quantized_matmul(x.reshape(-1, x.shape[-1]), w8, scale)
            return y.reshape(*lead, -1)
        return (x @ w8.to(x.dtype)) * scale.to(x.dtype)
    return x @ p["kernel"].to(x.dtype)
