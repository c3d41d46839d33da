"""Production mesh construction (fixed shapes).

Functions, not module-level constants: importing this module touches no
device.  The production meshes hold no devices: they are what the
shape-only dry run (:mod:`repro_torch.launch.dryrun`) shards over.
"""
from __future__ import annotations

import torch

from repro_torch.core.accelerator import resolve_device
from repro_torch.distributed.sharding import AbstractMesh, Mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_local_mesh(tp: int = 1, *, device=None) -> Mesh:
    """A ``("data", "model")`` mesh over the cards that exist (the CPU
    alone, when the caller names it): ``n // tp`` by ``tp``.  Raises where
    ``tp`` does not divide the device count, and where there is no card
    (nothing falls back to the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = tuple(torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()))
    else:
        devices = (dev,)
    n = len(devices)
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} does not divide {n} devices")
    return Mesh(devices, ("data", "model"), (n // tp, tp))
