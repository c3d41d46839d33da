"""Carry the JAX package's CNN parameters into the port.

The reference's ``init_cnn`` returns a list of ``{"f", "b"}``, ``{"w",
"b"}`` or ``{}`` entries in the same layouts the port uses (HWIO filters,
``(k, n)`` weights).  int8 leaves are any object with ``.q`` and ``.scale``
(the reference's ``QTensor``), so nothing of the reference is imported:
every leaf goes through numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.accelerator import resolve_device
from repro_torch.core.quant import QTensor


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


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
