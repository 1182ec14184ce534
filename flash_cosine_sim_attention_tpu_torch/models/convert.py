"""Move parameters between the JAX model's flax tree and the PyTorch model.

The flax parameter tree of ``CosineSimCausalTransformer`` arrives as
nested dicts of numpy arrays (optionally under a top-level ``"params"``
key).  Two layout rules: a flax ``Dense`` kernel is (in, out) while
``nn.Linear.weight`` is (out, in); ``Embed.embedding`` and LayerNorm
``scale`` / ``bias`` map to ``weight`` / ``bias`` as they are.  A model
already quantized (``quantize_params``) and fused (``fuse_qkv_params``)
takes and gives JAX's quantized leaves, ``kernel_q`` (in, out) int8 and
``kernel_scale`` (1, out) f32 as they are, and a fused ``to_qkv`` entry
in place of ``to_q`` / ``to_k`` / ``to_v``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .transformer import CosineSimCausalTransformer, QuantDense

# (torch module, attribute, is a Dense kernel to transpose)
_Entry = Tuple[nn.Module, str, bool]


def _layout(model: CosineSimCausalTransformer) -> Dict[str, Dict[str, _Entry]]:
    """flax module name -> {flax leaf name: (torch module, attribute,
    transposed)}."""
    def dense(m):
        if isinstance(m, QuantDense):
            return {"kernel_q": (m, "weight_q", False),
                    "kernel_scale": (m, "weight_scale", False)}
        return {"kernel": (m, "weight", True)}

    def norm(m):
        return {"scale": (m, "weight", False), "bias": (m, "bias", False)}

    out = {
        "token_emb": {"embedding": (model.token_emb, "weight", False)},
        "pos_emb": {"embedding": (model.pos_emb, "weight", False)},
        "to_logits": dense(model.to_logits),
    }
    for i in range(model.depth):
        a, f = model.attn[i], model.ff[i]
        names = (("to_q", "to_k", "to_v") if a.to_qkv is None
                 else ("to_qkv",)) + ("to_out",)
        out[f"attn_{i}"] = {name: dense(getattr(a, name)) for name in names}
        out[f"ff_{i}"] = {"Dense_0": dense(f.proj_in),
                          "Dense_1": dense(f.proj_out)}
        if model.pre_norm:
            out[f"attn_{i}"]["LayerNorm_0"] = norm(a.norm)
            out[f"ff_{i}"]["LayerNorm_0"] = norm(f.norm)
        else:
            out[f"attn_norm_{i}"] = norm(model.attn_norm[i])
            out[f"ff_norm_{i}"] = norm(model.ff_norm[i])
    if model.pre_norm:
        out["final_norm"] = norm(model.final_norm)
    return out


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def flax_param_shapes(model: CosineSimCausalTransformer) -> dict:
    """The flax parameter tree's layout as nested dicts of shapes."""
    def shape(mod, attr, transposed):
        s = tuple(getattr(mod, attr).shape)
        return s[::-1] if transposed else s

    def walk(node):
        if isinstance(node, tuple):
            return shape(*node)
        return {k: walk(v) for k, v in node.items()}
    return walk(_layout(model))


@torch.no_grad()
def params_from_flax(params: dict, model: CosineSimCausalTransformer
                     ) -> CosineSimCausalTransformer:
    """Copy a flax parameter tree (nested dicts of numpy arrays) into
    ``model`` in place, cast to its parameters' dtype and device; returns
    ``model``.  Raises on a missing, extra or misshapen leaf."""
    tree = params.get("params", params)
    layout = dict(_leaves(_layout(model)))
    given = dict(_leaves(tree))
    if set(given) != set(layout):
        missing = sorted(set(layout) - set(given))
        extra = sorted(set(given) - set(layout))
        raise ValueError(f"flax params do not fit the model: missing "
                         f"{missing[:4]}, unexpected {extra[:4]}")
    for path, arr in given.items():
        mod, attr, transposed = layout[path]
        dst = getattr(mod, attr)
        # a writable copy; int8 codes stay codes
        arr = np.array(arr, dtype=np.int8 if dst.dtype == torch.int8
                       else np.float32)
        if transposed:
            arr = arr.T
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} does not "
                             f"fit {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return model


def params_to_flax(model: CosineSimCausalTransformer, grads: bool = False
                   ) -> dict:
    """The model's parameters (or, with ``grads``, their ``.grad``) as a
    flax parameter tree of float32 numpy arrays (int8 for quantized
    kernels' codes)."""
    def leaf(mod, attr, transposed):
        t = getattr(mod, attr)
        t = t.grad if grads else t
        t = t.detach().cpu()
        arr = (t if t.dtype == torch.int8 else t.float()).numpy()
        return arr.T if transposed else arr

    def walk(node):
        if isinstance(node, tuple):
            return leaf(*node)
        return {k: walk(v) for k, v in node.items()}
    return walk(_layout(model))
