"""``correct`` at a size a test run holds, on the CPU (the port's plain
versions; the harness's look for a card skipped): a sound run of each cell
is correct; the control (the reference in the next lower precision, TF32
for the fp32 CNN and fp8 for the trained model, put in the program's place)
is not; nor is a run whose timed path is broken underneath in any of the
ways its cell can be.

The trained model runs here with fp32 weights: at two layers of width 64
a bf16 weight's rounding step is larger than an AdamW update, so a sound
bf16 run reads near the limits that the published widths set; the cell's
limits and comparison are unchanged."""
from __future__ import annotations

import copy

import numpy as np
import pytest
from conftest import CELLS, ROOT, load_run, small

from bench import harness


def run_cell(name: str, *, control: bool = False, seconds: float = 0.3):
    cfg, wl = small(name)
    if wl["driver"] == "lm_train":
        cfg = copy.deepcopy(cfg)
        cfg["model"].update(param_dtype="float32", compute_dtype="float32")
    return load_run().run(harness.benchmark(ROOT), name, 2**31 + 21, seconds,
                          False, "cpu", cfg=cfg, wl=wl, control=control)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run_cell(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = run_cell(name, control=True)
    assert not res["correct"], res["checks"]


# ---------------------------------------------------------------------------
# the timed path broken underneath
# ---------------------------------------------------------------------------
def _answer_altered(monkeypatch):
    """One logit of the first request of every wave altered where the
    server produces it."""
    from repro_torch.serve import cnn_server
    orig = cnn_server.CNNServer._fc_stage_complete

    def bad(self, buf):
        done = orig(self, buf)
        done[0].logits = np.array(done[0].logits, copy=True)
        done[0].logits[3] += 0.05 * float(np.abs(done[0].logits).max())
        return done
    monkeypatch.setattr(cnn_server.CNNServer, "_fc_stage_complete", bad)


def _answer_dropped(monkeypatch):
    """The last request of every wave never answered."""
    from repro_torch.serve import cnn_server
    orig = cnn_server.CNNServer._fc_stage_complete

    def bad(self, buf):
        done = orig(self, buf)
        done[-1].done, done[-1].logits = False, None
        return done
    monkeypatch.setattr(cnn_server.CNNServer, "_fc_stage_complete", bad)


def _state_unchanged(monkeypatch):
    """The optimizer returns the weights and its state as it got them."""
    from repro_torch.optim import adamw

    def bad(params, grads, state, tc, donate=False):
        return params, state, {"lr": adamw.lr_schedule(tc, state.step),
                               "grad_norm": 0.0}
    monkeypatch.setattr(adamw, "apply", bad)


def _half_batch(monkeypatch):
    """Half of every batch left out: the step's mean over the rest."""
    from repro_torch.train import train_step as TS
    orig = TS._on_device

    def bad(batch, device):
        b = batch["tokens"].shape[0]
        return orig({k: v[: b // 2] for k, v in batch.items()}, device)
    monkeypatch.setattr(TS, "_on_device", bad)


def _update_doubled(monkeypatch):
    """The embedding's update applied twice where the optimizer writes it
    (a leaf moved double)."""
    from repro_torch.optim import adamw
    orig = adamw.apply

    def bad(params, grads, state, tc, donate=False):
        before = params["embed"].clone()
        params, state, met = orig(params, grads, state, tc, donate=donate)
        params["embed"].copy_(2 * params["embed"] - before)
        return params, state, met
    monkeypatch.setattr(adamw, "apply", bad)


FAULTS = [("vgg16-fp32.offline", _answer_altered),
          ("vgg16-fp32.offline", _answer_dropped),
          ("olmo-1b-bf16.train", _state_unchanged),
          ("olmo-1b-bf16.train", _half_batch),
          ("olmo-1b-bf16.train", _update_doubled)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = run_cell(name)
    assert not res["correct"], res["checks"]


def test_open_loop_serves_and_times_every_request():
    """The driver's open loop (Poisson arrivals, ``step_wave`` whenever the
    queue holds any) at a CPU test's size: every request due in the window
    is served, timed from its due time, and judged by the reference."""
    import math

    import torch
    drv = harness.driver("cnn_serve")
    cfg, wl = small("vgg16-fp32.offline")
    wl["traffic_params"] = {"loop": "open", "arrivals": "poisson",
                            "rate_per_s": 40, "image_pool": 16}
    st = drv.setup(cfg, wl, 17, torch.device("cpu"), harness.Tracer(False))
    win = drv.window(st, 0.3, harness.Tracer(False))
    assert win["images"] == len(win["latency_ms"]) == 12
    assert not any(math.isnan(v) for v in win["latency_ms"])
    assert min(win["queue_wait_ms"]) >= 0
    assert harness.passed(drv.check(st, wl["checks"]))


@pytest.mark.parametrize("ahead", [0, 2, 50])
def test_train_window_reads_every_loss_late(ahead):
    """The train window sends steps ``ahead_steps`` ahead of the loss it
    reads, and still reads every step's loss once its time is up: a loss
    that is not a number, at any step sent, counts as failed."""
    import torch
    drv = harness.driver("lm_train")
    cfg, wl = small("olmo-1b-bf16.train")
    cfg["model"].update(param_dtype="float32", compute_dtype="float32")
    wl["traffic_params"]["ahead_steps"] = ahead
    st = drv.setup(cfg, wl, 23, torch.device("cpu"), harness.Tracer(False))
    step_fn, calls = st.step_fn, []

    def nan_at_second(*args):
        out = step_fn(*args)
        calls.append(1)
        if len(calls) == 2:
            out[3]["loss"] = torch.tensor(float("nan"))
        return out
    st.step_fn = nan_at_second
    win = drv.window(st, 0.3, harness.Tracer(False))
    assert win["steps"] == st.attempted == len(calls) >= 2
    assert st.failed == 1
    assert win["tokens"] == win["steps"] * 4 * 32
