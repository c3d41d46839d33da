"""Shared pieces of the port's benchmark: finding cells, configurations,
drivers and metrics by name, the profiler's trace reduced to device
intervals and host spans, and the run's result line.

Everything a cell needs is found from files: ``BENCHMARK.json`` at the
root names the cells and metrics, ``bench/workloads/<cell>.json`` holds a
cell's driver and traffic, ``bench/configs/<config>.json`` a model's sizes,
``bench/drivers/<driver>.py`` one entry kind and ``bench/metrics/<metric>.py``
one metric's reader.  Adding a cell or a metric adds files and entries and
edits none.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names a run may not hold once its window has closed:
#: JAX and the JAX package the port was made from (``repro_torch`` is the
#: port, and its top-level name is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file of ``name``, as ``BENCHMARK.json`` names it."""
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def workload_file(name: str, bench: Path = BENCH) -> dict:
    return load_json(bench / "workloads" / f"{name}.json")


def _load(path: Path, tag: str):
    """A module of the harness by its file path (metric files carry dots in
    their names, so they are not importable by a dotted name)."""
    if not path.exists():
        raise FileNotFoundError(path)
    mod_name = "bench_" + re.sub(r"[^A-Za-z0-9_]", "_", f"{tag}_{path.stem}")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench: Path = BENCH):
    return _load(bench / "drivers" / f"{name}.py", "driver")


def metric(name: str, bench: Path = BENCH):
    return _load(bench / "metrics" / f"{name}.py", "metric")


def cell_metrics(spec: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports: an
    entry with ``workloads`` where it lists the cell; an end-to-end entry
    without it everywhere; a per-layer entry without it wherever the
    end-to-end metric it moves is reported."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def sync(device) -> None:
    """Wait for the card's work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is one of :data:`FORBIDDEN`."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------
class Tracer:
    """Host spans of the benchmark's own calls into the program: a
    ``torch.profiler.record_function`` range each when the run is traced,
    nothing otherwise."""

    def __init__(self, on: bool) -> None:
        self.on = on

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        from torch.profiler import record_function
        with record_function(name):
            yield


def union_ns(intervals: list[tuple[int, int]]) -> int:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps_ns(intervals: list[tuple[int, int]], t0: int, t1: int
            ) -> list[tuple[int, int]]:
    """The stretches of ``[t0, t1]`` that no interval covers."""
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(s, e) for s, e in out if e > s]


class Trace:
    """One profiled window: the device's operations (kernels, copies and
    sets, each ``(name, start_ns, end_ns)``) and the benchmark's host spans,
    on the profiler's clock, cut to the window ``[t0, t1]``."""

    def __init__(self, device_ops: list, spans: list, t0: int, t1: int):
        self.t0, self.t1 = t0, t1
        self.device_ops = [(n, max(s, t0), min(e, t1)) for n, s, e in device_ops
                           if e > t0 and s < t1]
        self.spans = spans

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.device_ops]) / 1e9

    def kernel_s(self, pattern: str, exclude: str | None = None) -> float:
        """Seconds of the device operations whose name matches ``pattern``
        (``re.search``) and not ``exclude``."""
        rx = re.compile(pattern)
        ex = re.compile(exclude) if exclude else None
        return sum(e - s for n, s, e in self.device_ops
                   if rx.search(n) and not (ex and ex.search(n))) / 1e9

    def span_at(self, t: int) -> str:
        """The innermost host span open at ``t`` ("none" outside them)."""
        best = None
        for n, s, e in self.spans:
            if s <= t < e and (best is None or s >= best[1]):
                best = (n, s)
        return best[0] if best else "none"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for n, s, e in self.device_ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(gaps_ns([(s, e) for _, s, e in self.device_ops],
                              self.t0, self.t1),
                      key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[self.span_at(s), (e - s) / 1e9]
                              for s, e in gaps]}


def device_event(e) -> bool:
    """A kernel, copy or set that ran on the card (not a range the profiler
    mirrors onto the device's timeline for a host annotation)."""
    if "CUDA" not in str(e.device_type()) or e.is_user_annotation():
        return False
    kind = str(e.activity_type()).lower() if hasattr(e, "activity_type") \
        else ""
    return "annotation" not in kind and "runtime" not in kind


def trace_of(prof, window: str = "window") -> Trace:
    """The :class:`Trace` of a ``torch.profiler.profile`` run whose window
    is the host annotation named ``window``."""
    events = prof.profiler.kineto_results.events()
    spans, ops, win = [], [], None
    for e in events:
        if device_event(e):
            ops.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.is_user_annotation() and "CUDA" not in str(e.device_type()):
            span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.name() == window:
                win = span
            else:
                spans.append(span)
    if win is None:
        raise RuntimeError(f"the trace holds no {window!r} range")
    return Trace(ops, spans, win[1], win[2])


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------
def check_lines(checks: dict) -> list[str]:
    """One line per compared number: its name, value and limit."""
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None) -> str:
    """The run's last line: the contract's keys, then ``checks`` (each
    compared number beside its limit) last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
