"""Gradient compression with error feedback — the JAX package's
``repro.optim.grad_compress`` on the port's trees.

* ``int8`` — per-tensor symmetric quantization; 1/4 of fp32's wire bytes.
* ``topk`` — the largest 1 % of magnitudes (values + indices); ~2 %.

Each step adds the previous step's compression error back before
compressing (error feedback), so the compressed sum tracks the true one.
On one card nothing crosses a wire: the roundtrip is what a data-parallel
reduce would see, and :func:`wire_bytes` is analytic."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import tree

SCHEMES = ("none", "int8", "topk")


class CompressState(NamedTuple):
    error: Any                   # error-feedback residual, like params


def init(params) -> CompressState:
    return CompressState(error=tree.map_leaves(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params))


def _int8_rt(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def _topk_rt(g: torch.Tensor, frac: float = 0.01) -> torch.Tensor:
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    idx = torch.topk(torch.abs(flat), k).indices
    mask = torch.zeros_like(flat)
    mask[idx] = 1.0
    return (flat * mask).reshape(g.shape)


@torch.no_grad()
def compress_grads(grads, state: CompressState,
                   scheme: str) -> tuple[Any, CompressState]:
    """(roundtripped grads, new error state); scheme: none | int8 | topk."""
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    if scheme == "none":
        return grads, state
    rt = _int8_rt if scheme == "int8" else _topk_rt
    out, err = [], []
    for g, e in zip(tree.leaves(grads), tree.leaves(state.error)):
        gf = g.to(torch.float32) + e
        r = rt(gf)
        out.append(r.to(g.dtype))
        err.append(gf - r)
    return (tree.unflatten(grads, out),
            CompressState(error=tree.unflatten(state.error, err)))


def wire_bytes(params, scheme: str) -> int:
    """Analytic bytes crossing the data-parallel reduce per step."""
    ls = tree.leaves(params)
    total = sum(p.numel() for p in ls)
    if scheme == "int8":
        return total * 1 + len(ls) * 4
    if scheme == "topk":
        k = max(1, int(total * 0.01))
        return k * (4 + 4)
    return total * 4
