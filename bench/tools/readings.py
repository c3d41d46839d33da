"""The readings that a cell's correctness limits are set from, many seeds
in one process on the card:

    python3 bench/tools/readings.py --workload <cell> --seconds <s> --seeds <n>...
    python3 bench/tools/readings.py --workload <cell> --seconds <s> --control --seeds <n>...

Each seed runs the cell as ``bench/run.py`` does (set-up, a window of
``--seconds``, the comparison with the plain reference) and prints one
JSON line of the compared numbers: the program's (the lower readings), or
with ``--control`` the control's, the reference in the next lower
precision put in the program's place (TF32 for fp32, fp8 for bf16).  A
training cell's control line also carries ``half_batch``: the reference
with half of each batch left out, the mean taken over the rest, against
the whole reference (a fault the limits must catch).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    spec_ = importlib.util.spec_from_file_location("bench_run",
                                                   ROOT / "bench" / "run.py")
    run = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(run)
    spec = harness.benchmark(ROOT)
    drv = harness.driver(harness.workload_file(args.workload)["driver"])
    for seed in args.seeds:
        res = run.run(spec, args.workload, seed, args.seconds, False,
                      "cuda:0", control=args.control)
        st = res.pop("_readings")
        out = {"seed": seed, "control": args.control,
               "correct": res["correct"], "attempted": res["attempted"],
               "checks": {k: v["value"] for k, v in res["checks"].items()}}
        if args.control and hasattr(drv, "reference_readings"):
            ref = drv.reference_readings(st)
            rows = list(range(st.wl["traffic_params"]["global_batch"] // 2))
            out["half_batch"] = drv.compare(
                drv.reference_readings(st, rows=rows), ref)
        print(json.dumps(out), flush=True)
        del st, res
    return 0


if __name__ == "__main__":
    sys.exit(main())
