"""Carry the JAX package's parameters into the port.

CNNs: the reference's ``init_cnn`` returns a list of ``{"f", "b"}``, ``{"w",
"b"}`` or ``{}`` entries in the same layouts the port uses (HWIO filters,
``(k, n)`` weights).  int8 leaves are any object with ``.q`` and ``.scale``
(the reference's ``QTensor``), so nothing of the reference is imported:
every leaf goes through numpy.

LMs: the reference's ``init_params`` tree (``embed``, ``final_norm``,
``head`` unless tied, ``blocks`` — a list of dicts of stacked leaves —,
``tail``, ``shared`` for zamba2's shared attention, ``frontend`` for the
stubbed audio and vision frontends, and seamless-m4t's ``encoder`` with
``lnx``/``xattn`` on every decoder block) is copied leaf for leaf into the
same layout, whatever its keys, int8 ``QTensor`` leaves (the reference's
``quantize_params``) as the port's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.accelerator import resolve_device
from repro_torch.core.quant import QTensor


def _tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":    # numpy has no bf16: widen, then round
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(arr).to(device)


def params_from_reference(params: list, *, device=None) -> list:
    """The reference's parameter list as the port's, on ``device`` (the
    card unless the caller names another)."""
    dev = resolve_device(device)
    out = []
    for p in params:
        entry = {}
        for name, leaf in p.items():
            if hasattr(leaf, "q") and hasattr(leaf, "scale"):
                entry[name] = QTensor(_tensor(leaf.q, dev),
                                      _tensor(leaf.scale, dev))
            else:
                entry[name] = _tensor(leaf, dev)
        out.append(entry)
    return out


def _tree(tree, dev: torch.device):
    if hasattr(tree, "q") and hasattr(tree, "scale"):       # int8 QTensor
        return QTensor(_tensor(tree.q, dev), _tensor(tree.scale, dev))
    if isinstance(tree, dict):
        return {k: _tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, dev) for v in tree]
    return _tensor(tree, dev)


def lm_params_from_reference(params: dict, *, device=None) -> dict:
    """The reference's LM parameter tree as the port's, on ``device`` (the
    card unless the caller names another).  A tied model (no ``head``)
    also gets ``embed_t``, the contiguous (d, V) copy of ``embed.T`` that
    the port's output projection reads."""
    dev = resolve_device(device)
    out = _tree(params, dev)
    if "head" not in out:
        out["embed_t"] = out["embed"].t().contiguous()
    return out
