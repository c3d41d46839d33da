"""Find the highest arrival rate an open-loop cell sustains: one set-up on
the card, then a window at each offered rate, in one process:

    python3 bench/tools/sweep.py --workload vgg16-fp32.rate --seconds 10 --rates 400 500 600

Prints one JSON line a rate: the images completed per second, the 50th
and 95th percentile latencies, those of the window's first and last
quarters of arrivals, and the drain (from the last arrival's due time to
the last answer).  A backlog that grows shows as a last quarter's latency
far above the first's and a drain of many waves.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness, traffic  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 1)
    args = ap.parse_args(argv)
    import torch
    spec = harness.benchmark(ROOT)
    entry = harness.workload(spec, args.workload)
    wl = harness.workload_file(args.workload)
    cfg = harness.config(spec, entry["config"])
    drv = harness.driver(wl["driver"])
    from repro_torch.kernels import _build
    _build.build(drv.LIBS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = drv.setup(cfg, wl, args.seed, torch.device("cuda:0"),
                   harness.Tracer(False))
    for rate in args.rates:
        st.tp = dict(st.tp, rate_per_s=rate)
        st.waves_before = len(st.srv.waves)
        win = drv.window(st, args.seconds, harness.Tracer(False))
        lat = np.asarray(win["latency_ms"])
        due, _ = traffic.open_loop(st.tp, st.seed, args.seconds)
        q = len(lat) // 4
        print(json.dumps({
            "rate": rate, "images": win["images"],
            "completed_per_s": win["images"] / win["window_s"],
            "p50_ms": traffic.percentile(lat, 50),
            "p95_ms": traffic.percentile(lat, 95),
            "first_quarter_p95_ms": traffic.percentile(lat[:q], 95),
            "last_quarter_p95_ms": traffic.percentile(lat[-q:], 95),
            "drain_s": win["window_s"] - float(due[-1]),
            "mean_wave": float(np.mean(win["wave_batches"]))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
