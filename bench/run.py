"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (the kernels built into the
checkout's ``build/repro_torch/``, weights and inputs drawn on the card
from the seed, every shape the traffic uses warmed) counts as
``setup_s``; then the window runs ``--seconds`` of the cell's traffic.
With ``--trace 1`` the window runs under ``torch.profiler`` and the line
carries the cell's per-layer metrics; with ``--trace 0`` its end-to-end
metrics.  After the window the program's state is freed and the plain
reference judges what the window produced (``correct``).  The last line
of standard output is the result, one JSON object; the last lines of
standard error are the compared numbers beside their limits.

Without a CUDA card, or with fewer than the cell asks for, the run exits
with code 2 and prints no result; with JAX or the JAX package loaded once
the window has closed, code 3.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402


def log(msg: str) -> None:
    print(f"[bench {time.perf_counter() - T0:8.2f}s] {msg}", file=sys.stderr,
          flush=True)


def cell_spec(spec: dict, name: str, bench: Path = harness.BENCH
              ) -> tuple[dict, dict]:
    """(the cell's ``BENCHMARK.json`` entry, its workload file), checked to
    agree on configuration, traffic, chips and end-to-end metrics."""
    entry = harness.workload(spec, name)
    wl = harness.workload_file(name, bench)
    e2e, _ = harness.cell_metrics(spec, name)
    for key in ("config", "traffic", "chips"):
        if wl[key] != entry[key]:
            raise ValueError(f"{name}: {key} {wl[key]!r} in the workload file"
                             f", {entry[key]!r} in BENCHMARK.json")
    if sorted(wl["end_to_end"]) != sorted(m["name"] for m in e2e):
        raise ValueError(f"{name}: end-to-end metrics {wl['end_to_end']} in "
                         "the workload file differ from BENCHMARK.json's")
    return entry, wl


def run(spec: dict, name: str, seed: int, seconds: float, trace: bool,
        device, *, cfg: dict | None = None, wl: dict | None = None,
        control: bool = False) -> dict:
    """One run of cell ``name`` on ``device``: the result as a dict (the
    line's keys) plus ``"_readings"``, the driver's state.  ``cfg`` and
    ``wl`` replace the cell's files (tests run reduced copies)."""
    import torch
    entry, wl_file = cell_spec(spec, name)
    wl = wl or wl_file
    cfg = cfg or harness.config(spec, entry["config"])
    drv = harness.driver(wl["driver"])
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        built = _build.build(drv.LIBS)
        log(f"kernels built: {built or 'all found in build/repro_torch'}")
    tracer = harness.Tracer(trace)
    st = drv.setup(cfg, wl, seed, dev, tracer)
    log("set-up done")
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - T0
    try:
        if trace:
            with record_function("window"):
                win = drv.window(st, seconds, tracer)
        else:
            win = drv.window(st, seconds, tracer)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    log(f"window done: {win['window_s']:.3f} s")
    tr = harness.trace_of(prof) if trace else None
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    checks = drv.check(st, wl["checks"], control=control)
    log("reference compared")
    ctx = types.SimpleNamespace(cfg=cfg, wl=wl, win=win, trace=tr,
                                setup_s=setup_s)
    e2e, per = harness.cell_metrics(spec, name)
    metrics = {}
    for m in (per if trace else e2e):
        value = setup_s if m["name"] == "setup_s" else \
            harness.metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(entry["chips"]),
                   "memory_peak_bytes": int(peak)}
    out = {"correct": harness.passed(checks) and st.failed == 0,
           "attempted": st.attempted, "failed": st.failed,
           "metrics": metrics, "device": device_info, "checks": checks,
           "_readings": st}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = harness.benchmark(ROOT)
    entry = harness.workload(spec, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"bench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch
    src = (ROOT / "src").resolve()
    if src not in Path(repro_torch.__file__).resolve().parents:
        print(f"bench: repro_torch comes from {repro_torch.__file__}, not "
              f"{src}", file=sys.stderr)
        return 2
    res = run(spec, args.workload, args.seed, args.seconds,
              bool(args.trace), "cuda:0")
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    res.pop("_readings")
    for line in harness.check_lines(res["checks"]):
        print(line, file=sys.stderr)
    print(harness.result_line(
        correct=res["correct"], attempted=res["attempted"],
        failed=res["failed"], metrics=res["metrics"], device=res["device"],
        checks=res["checks"], breakdown=res.get("breakdown")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
