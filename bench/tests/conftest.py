"""Shared pieces of the benchmark's CPU tests: the cells at sizes a test run
can hold, and a run of one through the harness on the CPU (the port's plain
versions), with the harness's look for a card skipped."""
from __future__ import annotations

import copy
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402


def load_run():
    """``bench/run.py`` as a module (it is a script, not in a package)."""
    if "bench_run" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "bench_run", ROOT / "bench" / "run.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["bench_run"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["bench_run"]


def small(name: str) -> tuple[dict, dict]:
    """(configuration, workload) of cell ``name`` cut to a CPU test's size:
    VGG-16 at 32 x 32 and a sixteenth of its channels (the last FC kept at
    1000), four-image waves; OLMo at two layers of width 64 over 32
    tokens.  The limits are the cell's own."""
    spec = harness.benchmark(ROOT)
    entry = harness.workload(spec, name)
    cfg = copy.deepcopy(harness.config(spec, entry["config"], ROOT))
    wl = copy.deepcopy(harness.workload_file(name))
    if wl["driver"] == "cnn_serve":
        cfg.update(in_res=32, width_mult=0.0625,
                   conv_blocks=[[2, 8], [2, 8], [3, 16], [3, 32], [3, 32]],
                   fc=[256, 256, 1000])
        wl["server"]["max_batch"] = 4
        wl["traffic_params"]["image_pool"] = 16
        wl["traffic_params"]["chunk_waves"] = 2
    else:
        cfg["model"].update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                            d_ff=128, vocab_size=256)
        wl["traffic_params"]["seq_len"] = 32
    return cfg, wl


def run_small(name: str, *, seed: int = 2**31 + 5, seconds: float = 0.3,
              trace: bool = False, control: bool = False) -> dict:
    run = load_run()
    cfg, wl = small(name)
    return run.run(harness.benchmark(ROOT), name, seed, seconds, trace,
                   "cpu", cfg=cfg, wl=wl, control=control)


CELLS = ("vgg16-fp32.offline", "olmo-1b-bf16.train")
