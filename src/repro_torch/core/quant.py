"""int8 weight quantization — the paper's 8-bit fixed point, as a serving
feature.

Symmetric per-output-channel scales, the same arithmetic as the JAX
package's ``quantize`` in the same fp32 operation order, so the int8 values
and scales are equal bit for bit (both round half to even).  The kernels
take the int8 weights un-dequantized and apply the scale in their epilogue.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QTensor(NamedTuple):
    q: torch.Tensor          # int8, same shape as the original weight
    scale: torch.Tensor      # float32, broadcastable (per-output-channel)


def quantize(w: torch.Tensor, *, axis: int = -1,
             batch_dims: int = 0) -> QTensor:
    """Symmetric per-channel int8 quantization along ``axis`` (the output
    channel).  ``batch_dims`` leading dims keep their extent in the scale."""
    wf = w.to(torch.float32)
    ax = axis % w.ndim
    reduce_axes = tuple(i for i in range(batch_dims, w.ndim) if i != ax)
    amax = torch.amax(wf.abs(), dim=reduce_axes, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (qt.q.to(torch.float32) * qt.scale).to(dtype)


_WEIGHT_LEAVES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "w1", "w2",
                  "in_proj", "out_proj", "head", "frontend", "w")


def quantize_params(params):
    """Quantize every matmul weight leaf of an LM tree (2-D or stacked, fp32
    or bf16, outside norms; the reference's ``_is_weight``), stacked and
    per-expert dims kept in the scale; embeddings, norms and the port's
    ``embed_t`` stay as they are."""
    from repro_torch.core import tree

    def one(path, leaf):
        names = path.split(".")
        in_norm = any(n.startswith("ln") or "norm" in n for n in names[:-1])
        if (leaf.dim() >= 2 and not in_norm and names[-1] in _WEIGHT_LEAVES
                and leaf.dtype in (torch.bfloat16, torch.float32)):
            return quantize(leaf, batch_dims=max(0, leaf.dim() - 2))
        return leaf
    return tree.unflatten(params, [one(p, l) for p, l
                                   in tree.flatten_with_paths(params)])


def quantize_cnn_params(params: list) -> list:
    """Quantize a CNN parameter list (:func:`repro_torch.models.cnn.init_cnn`
    layout): every conv filter ``f`` and FC weight ``w`` becomes an int8
    :class:`QTensor`; biases and pool placeholders stay as they are."""
    out = []
    for p in params:
        if "f" in p:
            out.append({**p, "f": quantize(p["f"])})
        elif "w" in p:
            out.append({**p, "w": quantize(p["w"])})
        else:
            out.append(p)
    return out
