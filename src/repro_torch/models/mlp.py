"""Dense feed-forward blocks (swiglu / geglu / gelu): three engine matmuls
for the gated forms, two for gelu, named as the JAX package names them."""
from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.models.layers import dense_init


def init_mlp(cfg, gen: torch.Generator, d: int, ff: int, dtype, device,
             lead: tuple[int, ...] = ()) -> dict:
    if cfg.mlp in ("swiglu", "geglu"):
        return {"wg": dense_init(gen, d, ff, dtype, device, lead),
                "wu": dense_init(gen, d, ff, dtype, device, lead),
                "wd": dense_init(gen, ff, d, dtype, device, lead)}
    return {"w1": dense_init(gen, d, ff, dtype, device, lead),
            "w2": dense_init(gen, ff, d, dtype, device, lead)}


def mlp(cfg, p: dict, x: torch.Tensor, name: str = "mlp") -> torch.Tensor:
    eng = engine.current()
    if cfg.mlp in ("swiglu", "geglu"):
        act = "silu" if cfg.mlp == "swiglu" else "gelu"
        g = eng.matmul(x, p["wg"], act=act, name=f"{name}.gate")
        u = eng.matmul(x, p["wu"], name=f"{name}.up")
        return eng.matmul(g * u, p["wd"], name=f"{name}.down")
    h = eng.matmul(x, p["w1"], act="gelu", name=f"{name}.fc1")
    return eng.matmul(h, p["w2"], name=f"{name}.fc2")
