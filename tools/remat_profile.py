#!/usr/bin/env python3
"""Where a remat policy's grad pass spends its time on the card.

    python3 tools/remat_profile.py [--rounds 2]

OLMo-1B as published (bf16), one 4 x 512 batch through ``make_grad_fn`` on
the kernels backend, under ``remat`` none, block and dots, and under dots
with every op recomputed (``dots-machinery``: the selective checkpoint's
dispatch mode with nothing kept, which costs what block costs on the card
plus that mode's host work).  For each, after two warm passes: five
passes timed by the host clock and by CUDA events, the host time to
enqueue the loss's forward alone, the pass's device time and idle share
and its top kernels (``chip_smoke.device_busy``), B4's device ms
(``chip_smoke.kernel_device_ms``), and the pass's
``torch.cuda.max_memory_allocated`` peak from a reset.  The policies take
turns in each round.  Prints a line a policy and round, then one JSON
object; needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

POLICIES = ("none", "block", "dots", "dots-machinery")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    from torch.utils.checkpoint import CheckpointPolicy

    import chip_smoke as cs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.engine import Engine
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = cs.environment(cs.Report())
    cfg = cs.olmo_bf16_config()
    params = T.init_params(cfg, 0)
    batch = {k: torch.as_tensor(v).cuda() for k, v in SyntheticLM(
        DataConfig(cfg.vocab_size, 512, 4, seed=0), cfg).batch_at(0).items()}
    dots_policy = T._dots_policy
    out = {}
    torch.set_grad_enabled(True)
    try:
        for rnd in range(args.rounds):
            for name in POLICIES:
                T._dots_policy = dots_policy if name != "dots-machinery" \
                    else lambda *a, **k: CheckpointPolicy.PREFER_RECOMPUTE
                remat = name.split("-")[0]
                eng = Engine(backend="kernels")
                grads_of = TS.make_grad_fn(cfg, TrainConfig(remat=remat),
                                           engine=eng)
                for _ in range(2):
                    grads_of(params, batch)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                host, events = [], []
                for _ in range(5):
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    t0 = time.perf_counter()
                    start.record()
                    grads_of(params, batch)
                    end.record()
                    torch.cuda.synchronize()
                    host.append((time.perf_counter() - t0) * 1e3)
                    events.append(start.elapsed_time(end))
                peak = torch.cuda.max_memory_allocated()
                forward = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with eng.activate():
                        loss, _ = T.loss_fn(cfg, T.trainable(params), batch,
                                            remat=remat)
                    forward.append((time.perf_counter() - t0) * 1e3)
                    del loss
                    torch.cuda.synchronize()
                busy = cs.device_busy(lambda: grads_of(params, batch),
                                      statistics.median(host) / 1e3, top=8)
                b4, _ = cs.kernel_device_ms(
                    lambda: grads_of(params, batch),
                    ("sa_conv_gemm_kernel", "sa_conv_wgmma_kernel"))
                row = dict(host_ms=host, event_ms=events,
                           forward_enqueue_ms=forward, peak_bytes=peak,
                           device_ms=busy["device_ms"],
                           idle_share=busy["idle_share"], top=busy["top"],
                           b4_device_ms=b4)
                out[f"{name} round {rnd}"] = row
                dev = "not measured" if busy["device_ms"] is None else \
                    f"{busy['device_ms']:.2f} (idle {busy['idle_share']:.3f})"
                b4s = "not measured" if b4 is None else f"{b4:.2f}"
                print(f"[{smi}] {name} round {rnd}: host "
                      f"{statistics.median(host):.1f} ms "
                      f"{[round(h, 1) for h in host]}, events "
                      f"{statistics.median(events):.1f}, forward enqueue "
                      f"{statistics.median(forward):.1f}, device {dev}, "
                      f"B4 {b4s}, peak {peak / 1e9:.3f} GB", flush=True)
    finally:
        T._dots_policy = dots_policy
    print(json.dumps({"card": smi, "policies": out}))


if __name__ == "__main__":
    main()
