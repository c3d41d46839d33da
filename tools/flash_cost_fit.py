#!/usr/bin/env python3
"""Fit flash attention's tiling cost model to the card.

    python3 tools/flash_cost_fit.py

Times bf16 ``flash_attention``, the tensor-core kernel
(``chip_smoke.timed``: CUDA events, L2 flushed, the card held busy), at
OLMo-1B's two prefill shapes, a full wave (b = 4) and a lone request
(b = 1) of 512 causal tokens with 16 heads of 128, under each of the four
tilings (64- or 128-row query tiles, paired or not) forced through
``kernels/attention.py::flash_geometry``, and fits the model's two bf16
constants for each tile height: the card time of one live kv tile
(``TILE_US[2]``) and of a query tile's own set-up (``QTILE_US[2]``), as
``tiling_makespan`` uses them.  For a fixed ratio of the two the modelled
makespan is linear in the tile cost, so each ratio on a grid gets its
least-squares scale and the ratio with the least relative squared error
wins.  Prints the times, the fit and each tiling's modelled against
measured time as one JSON object; needs a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def model(bq: int, paired: bool, b: int, tile: float, qtile: float) -> float:
    """The makespan flash_geometry models for one tiling of the shape."""
    from repro_torch.kernels import attention as A
    return A.tiling_makespan(bq, paired, b * 16, 512, 512, True, 0, tile,
                             qtile)


def fit(bq: int, times: dict) -> tuple[float, float, float]:
    """(TILE_US, QTILE_US, relative rms error) for one tile height."""
    best = None
    for i in range(0, 401):
        ratio = i / 40                              # QTILE_US / TILE_US
        pts = [(model(bq, p, b, 1.0, ratio), t) for (b, p), t in times.items()]
        scale = sum(m * t / t ** 2 for m, t in pts) / \
            sum(m * m / t ** 2 for m, t in pts)
        err = sum((scale * m - t) ** 2 / t ** 2 for m, t in pts) / len(pts)
        if best is None or err < best[2]:
            best = (scale, scale * ratio, err)
    return best[0], best[1], best[2] ** 0.5


def main() -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import attention as A
    if not torch.cuda.is_available():
        raise SystemExit("flash_cost_fit: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    real = A.flash_geometry
    times: dict = {bq: {} for bq in A.BQ}
    try:
        for b in (4, 1):
            q, k, v = (torch.randn((b, 512, 16, 128), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(3))
            for bq in A.BQ:
                for paired in (False, True):
                    g = A.FlashGeometry(bq, paired, -(-512 // bq), b * 16,
                                        A.smem_bytes(bq, 128, 2), 0.0,
                                        tensor_cores=True)
                    A.flash_geometry = lambda *a, g=g: g
                    times[bq][(b, paired)] = 1000 * cs.timed(
                        lambda: A.flash_attention(q, k, v))
    finally:
        A.flash_geometry = real
    out = {"device": smi, "dtype": "bf16", "us": {}, "fit": {}}
    for bq in A.BQ:
        tile, qtile, err = fit(bq, times[bq])
        out["fit"][bq] = dict(TILE_US=round(tile, 3), QTILE_US=round(qtile, 3),
                              rel_rms_err=err)
        for (b, paired), t in times[bq].items():
            out["us"][f"bq={bq} paired={paired} b={b}"] = dict(
                measured=t, modelled=model(bq, paired, b, tile, qtile))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
