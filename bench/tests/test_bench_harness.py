"""The harness on the CPU: cells, configurations, drivers and metrics are
found by name from files; a new cell is a new file; the traffic is a pure
function of the seed; the result line has the contract's keys; a run that
finds no card, or only the benchmark's files, prints no result."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
from conftest import CELLS, ROOT, load_run, run_small

from bench import harness, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_shape():
    """The keys and limits the contract sets, as far as a file shows them."""
    spec = harness.benchmark(ROOT)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"] and spec["command"][1] == "bench/run.py"
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    e2e = [m["name"] for m in spec["end_to_end"]]
    per = [m["name"] for m in spec["per_layer"]]
    for group in (names, cells, e2e + per):
        assert len(group) == len(set(group))
    for n in names + cells + e2e + per:
        assert NAME.match(n), n
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        assert c["name"] in {w["config"] for w in spec["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in spec["workloads"]}
    assert len(pairs) == len(cells)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        got_e2e, got_per = harness.cell_metrics(spec, cell)
        assert "setup_s" in {m["name"] for m in got_e2e} and len(got_e2e) >= 2
        assert got_per
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    """Each cell's workload file agrees with ``BENCHMARK.json``; its driver,
    configuration and every metric it reports are files found by name."""
    spec = harness.benchmark(ROOT)
    entry, wl = load_run().cell_spec(spec, name)
    assert harness.config(spec, entry["config"], ROOT)["name"] == \
        entry["config"]
    drv = harness.driver(wl["driver"])
    for fn in ("setup", "window", "check"):
        assert callable(getattr(drv, fn))
    e2e, per = harness.cell_metrics(spec, name)
    for m in e2e + per:
        if m["name"] != "setup_s":
            assert callable(harness.metric(m["name"]).read)


def test_new_cell_and_metric_are_files_only(tmp_path):
    """A cell and a metric added as files, plus their entries, are found
    with no edit of any file already there."""
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.benchmark(ROOT)
    wl = harness.workload_file("vgg16-fp32.offline")
    wl.update(name="vgg16-fp32.rate", traffic="rate")
    wl["traffic_params"] = {"loop": "open", "arrivals": "poisson",
                            "rate_per_s": 640, "image_pool": 1024}
    (bench / "workloads" / "vgg16-fp32.rate.json").write_text(json.dumps(wl))
    (bench / "metrics" / "images_late.rate.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    spec["workloads"].append({"name": "vgg16-fp32.rate",
                              "config": "vgg16-fp32", "traffic": "rate",
                              "chips": 1, "why": "a test"})
    ips = next(m for m in spec["end_to_end"] if m["name"] == "images_per_s")
    ips["workloads"].append("vgg16-fp32.rate")
    spec["per_layer"].append({"name": "images_late.rate", "unit": "images",
                              "better": "lower", "source": "host_clock",
                              "layer": "server", "moves": "images_per_s",
                              "workloads": ["vgg16-fp32.rate"]})
    entry, got = load_run().cell_spec(spec, "vgg16-fp32.rate", bench)
    assert got["traffic_params"]["rate_per_s"] == 640
    _, per = harness.cell_metrics(spec, "vgg16-fp32.rate")
    assert [m["name"] for m in per] == ["images_late.rate"]
    assert harness.metric("images_late.rate", bench).read(None) == 1.0


def test_open_loop_is_a_pure_function_of_the_seed():
    tp = {"rate_per_s": 500, "image_pool": 1024, "arrivals": "poisson"}
    a = traffic.open_loop(tp, 2**31 + 11, 10)
    b = traffic.open_loop(tp, 2**31 + 11, 10)
    c = traffic.open_loop(tp, 2**31 + 12, 10)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert len(a[0]) == len(c[0]) == 5000
    # every seed gets the same set of gaps, in its own order
    ga, gc = np.diff(a[0]), np.diff(c[0])
    assert np.all(ga >= 0) and a[0][0] == 0
    assert abs(a[0][-1] - c[0][-1]) < 0.2 * 10
    assert abs(np.sort(ga).sum() - np.sort(gc).sum()) < 0.05


def test_token_batches_are_a_pure_function_of_seed_and_step():
    a = traffic.lm_batch(7, 0, 256, 4, 32)
    assert a.equal(traffic.lm_batch(7, 0, 256, 4, 32))
    assert not a.equal(traffic.lm_batch(7, 1, 256, 4, 32))
    assert len({tuple(r.tolist()) for r in a}) == 4
    assert (a[:, 1::2] == (a[:, 0:-1:2] * 2 + 1) % 256).all()


def test_result_line_has_the_contract_keys():
    res = run_small("vgg16-fp32.offline")
    line = harness.result_line(
        correct=res["correct"], attempted=res["attempted"],
        failed=res["failed"], metrics=res["metrics"], device=res["device"],
        checks=res["checks"])
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["metrics"]) == {"images_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_run_reports_per_layer_metrics_only():
    res = run_small("vgg16-fp32.offline", trace=True)
    assert "images_per_s" not in res["metrics"]
    assert set(res["device"]) >= {"busy_s", "window_s"}
    # no card: the device-trace metrics find nothing to read and are left out
    assert set(res["metrics"]) == {"mfu.offline"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = load_run().main(["--workload", "vgg16-fp32.offline", "--seed", "1",
                          "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    """In a directory holding only ``BENCHMARK.json`` and ``bench/`` a run
    exits non-zero and prints nothing on standard output."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "vgg16-fp32.offline", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_no_jax_in_the_run_or_the_reference():
    """The top-level name of every module that ``bench/run.py``, its
    drivers, metrics and references load is neither ``jax`` nor ``repro``
    (``repro_torch`` is the port), and the references load no
    ``repro_torch``."""
    code = (
        "import sys, runpy\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench.reference import vgg, olmo\n"
        "ref = {m.split('.')[0] for m in sys.modules}\n"
        "from bench import harness\n"
        "spec = harness.benchmark()\n"
        "for w in spec['workloads']:\n"
        "    harness.driver(harness.workload_file(w['name'])['driver'])\n"
        "for m in spec['end_to_end'] + spec['per_layer']:\n"
        "    if m['name'] != 'setup_s': harness.metric(m['name'])\n"
        "runpy.run_path('bench/run.py', run_name='not_main')\n"
        "import repro_torch.serve.cnn_server, repro_torch.train.train_step\n"
        "import repro_torch.kernels._build\n"
        "print(sorted(ref)); print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr
    ref, every = (set(eval(line)) for line in p.stdout.splitlines()[-2:])
    assert "repro_torch" in every
    assert not every & set(harness.FORBIDDEN)
    assert "repro_torch" not in ref and not ref & set(harness.FORBIDDEN)


def test_forbidden_modules_compares_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "jaxtyping": 1,
            "repro.core": 1, "jax": 1, "flax.linen": 1}
    assert harness.forbidden_modules(mods) == ["flax.linen", "jax",
                                               "repro.core"]


def test_trace_reduction():
    """Busy time is the union of device operations; gaps are named by the
    innermost host span open at their start."""
    ops = [("k1", 0, 10), ("k2", 5, 20), ("Memcpy HtoD", 30, 40),
           ("k1", 100, 150)]
    spans = [("run", 0, 200), ("wait logits", 40, 100)]
    tr = harness.Trace(ops, spans, 0, 200)
    assert tr.busy_s == pytest.approx(80e-9)
    assert tr.kernel_s("k1") == pytest.approx(60e-9)
    assert tr.kernel_s(".", exclude="^Memcpy") == pytest.approx(75e-9)
    bd = tr.breakdown()
    assert bd["idle_gaps"][0] == ["wait logits", pytest.approx(60e-9)]
    assert bd["device_ops"][0] == ["k1", pytest.approx(60e-9)]
