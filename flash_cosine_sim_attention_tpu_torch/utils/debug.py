"""Debug and numeric-checking helpers.

Counterpart of ``flash_cosine_sim_attention_tpu/utils/debug.py``:

  * ``checkify_attention`` builds a checked fused-attention callable that
    returns ``(err, out)``; ``err.throw()`` raises when the output holds a
    NaN or an Inf.  JAX's checkify error becomes a small error object:
    the check is taken when the callable runs, and raised only when the
    caller asks, as ``err.throw()`` does in JAX;
  * ``debug_attention`` runs the fused op and the plain op on the same
    inputs and reports the gap between them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

# the package, not its names: ``ops`` loads ``utils.profiling`` while it
# is itself loading
from .. import ops


class AttentionError:
    """The outcome of one checked call: ``msg`` is None when the output
    was finite."""

    def __init__(self, msg: Optional[str] = None):
        self.msg = msg

    def get(self) -> Optional[str]:
        return self.msg

    def throw(self) -> None:
        if self.msg is not None:
            raise FloatingPointError(self.msg)


def checkify_attention(**attn_kwargs):
    """Build a checked fused-attention callable.

    >>> checked = checkify_attention(causal=True)
    >>> err, out = checked(q, k, v)
    >>> err.throw()   # raises if the output had a NaN or an Inf
    """

    def fn(q, k, v, mask=None, attn_bias=None):
        out = ops.flash_cosine_sim_attention(
            q, k, v, mask=mask, attn_bias=attn_bias, **attn_kwargs)
        bad = ~torch.isfinite(out.float())
        msg = None
        if bool(bad.any()):
            first = tuple(int(i) for i in bad.nonzero()[0])
            msg = (f"flash_cosine_sim_attention produced non-finite values "
                   f"({int(bad.sum())} of {bad.numel()}, the first at "
                   f"{first})")
        return AttentionError(msg), out

    return fn


def debug_attention(q, k, v, mask=None, attn_bias=None, **kw
                    ) -> Dict[str, Any]:
    """Fused vs plain on the same inputs; returns a numeric report."""
    fused = ops.flash_cosine_sim_attention(
        q, k, v, mask=mask, attn_bias=attn_bias, **kw)
    plain = ops.plain_cosine_sim_attention(
        q, k, v, mask=mask, attn_bias=attn_bias, **kw)
    diff = (fused.float() - plain.float()).abs()
    return {
        "max_abs_diff": float(diff.max()),
        "mean_abs_diff": float(diff.mean()),
        "fused_finite": bool(torch.isfinite(fused.float()).all()),
        "oracle_finite": bool(torch.isfinite(plain.float()).all()),
        "shape": tuple(fused.shape),
        "dtype": str(fused.dtype),
        "backend": fused.device.type,
    }
