#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repo root, on a machine with a
                                 # CUDA card and nvcc; no arguments

Phases (any failure raises and exits non-zero):

1. environment: card, power limit, CUDA/nvcc/torch versions, SMs, shared
   memory; fp32 matmuls must not use TF32;
2. build: every kernel of ``src/repro_torch/kernels/csrc`` with nvcc;
3. kernels against their plain PyTorch versions on the card, at the shapes
   full-width AlexNet serving gives them, plus the bitwise invariants;
4. the slice: ``CNNServer("alexnet", ...)`` at full width and 227x227 serves
   130 requests on the kernels (and one int8 wave), with every dispatch a
   schedule hit and every kernel of the path launched;
5. times: CUDA events, median of 25 runs, L2 flushed before each.

The line before the last is the ``{"kernels": [...]}`` summary, the line
before that the card's ``nvidia-smi`` name and power limit, and the last
line ``{"ok": true, "device": {...}}``.  Details go to
``build/chip_smoke.json`` (ignored by git).
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Peak rates of an H100 SXM (NVIDIA data sheet, dense): the roof each bound
# is computed against.  fp32 means fp32, so the compute roof is the CUDA
# cores' fp32 rate, not a tensor-core rate.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Tolerances (allclose: |got - want| <= atol + rtol * |want|), from the
# reference's own kernel tests (tests/test_kernels.py): both sides accumulate
# in fp32 but in different orders (the kernels sum each output sequentially,
# cuBLAS/cuDNN in blocked trees), so they differ by rounding that grows with
# the contraction length (k up to 9216 for fc1, 3456 for conv4).
TOL_FC = dict(rtol=3e-4, atol=3e-4)
TOL_CONV = dict(rtol=2e-3, atol=2e-3)
# Logits through eight layers against the plain "torch" backend: the
# per-layer rounding differences above compound, so the conv tolerance.
TOL_LOGITS = dict(rtol=2e-3, atol=2e-3)

N_REQUESTS = 130          # two full waves of 64 and a tail of 2
SEED = 0

SOURCES = {
    "sa_conv_implicit": ("src/repro_torch/kernels/csrc/sa_conv_implicit.cu",
                         "src/repro/kernels/sa_conv_implicit.py:183"),
    "sa_fc_matmul": ("src/repro_torch/kernels/csrc/sa_fc.cu",
                     "src/repro/kernels/sa_fc.py:155"),
    "maxpool_act": ("src/repro_torch/kernels/csrc/pool_act.cu",
                    "src/repro/kernels/pool_act.py:60"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Report:
    """What the run measured, per kernel and overall."""

    def __init__(self) -> None:
        self.err = {k: 0.0 for k in SOURCES}
        self.rows: list[dict] = []          # per-shape timings
        self.detail: dict = {}

    def note_err(self, kernel: str, err: float) -> None:
        self.err[kernel] = max(self.err[kernel], err)


def allclose(name: str, got, want, tol: dict) -> float:
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (got.double() - want.double()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    bad = diff > tol["atol"] + tol["rtol"] * want.double().abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"{tol}, max |diff| {err:.3g}")
    return err


def exact(name: str, got, want) -> None:
    import torch
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: not bitwise equal")


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------
def environment(rep: Report) -> str:
    import torch
    from repro_torch.core.accelerator import gpu_card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    card = gpu_card()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"nvcc: {nvcc[-1]}")
    log(f"SMs {card.sm_count}  smem/block opt-in {card.smem_per_block_optin}"
        f"  capability {card.capability}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is on")
    rep.detail["env"] = dict(smi=smi, torch=torch.__version__,
                             cuda=torch.version.cuda, nvcc=nvcc[-1],
                             sm_count=card.sm_count,
                             smem_optin=card.smem_per_block_optin,
                             name=card.name)
    return smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def build(rep: Report) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"build: {len(seconds)} libraries in "
        f"{time.perf_counter() - t0:.1f}s {seconds}")
    ptxas = {}
    for name in _build.SOURCES:
        text = _build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill", text))
        ptxas[name] = dict(registers=regs, spill_bytes=spills)
        log(f"  ptxas {name}: {len(regs)} kernels, registers "
            f"{min(regs)}..{max(regs)}, spill bytes {spills}")
    rep.detail["build_s"] = seconds
    rep.detail["ptxas"] = ptxas


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def _pad(x, pad: int):
    import torch.nn.functional as F
    return F.pad(x, (0, 0, pad, pad, pad, pad)).contiguous() if pad else x


def alexnet_layers(params):
    """(name, spec, params, pool) of AlexNet's conv layers, pools paired."""
    from repro_torch.models.cnn import ALEXNET
    out, i, ci = [], 0, 0
    while ALEXNET[i].kind != "fc":
        s = ALEXNET[i]
        ci += 1
        nxt = ALEXNET[i + 1]
        pool = (nxt.kernel, nxt.stride) if nxt.kind == "pool" else None
        out.append((f"conv{ci}", s, params[i], pool))
        i += 2 if pool else 1
    fcs = [(f"fc{j + 1}", s, params[i + j])
           for j, s in enumerate(ALEXNET[i:])]
    return out, fcs


def check_kernels(rep: Report, params, qparams, images) -> dict:
    """Every kernel at its main-path shapes against its plain version, on
    the card, on a chain of real activations.  Returns the inputs each
    kernel sees on the main path, for timing."""
    import torch
    from repro_torch.core.engine import Engine
    from repro_torch.core.dataflow import PoolSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_act import maxpool_act
    from repro_torch.kernels.sa_conv_implicit import (sa_conv_implicit,
                                                      sa_conv_plain)
    from repro_torch.kernels.sa_fc import sa_fc_matmul, sa_fc_plain

    convs, fcs = alexnet_layers(params)
    qconvs, qfcs = alexnet_layers(qparams)
    shapes: dict = {"conv": [], "fc": [], "pool": None}
    x = images
    for (name, s, p, pool), (_, _, qp, _) in zip(convs, qconvs):
        xin = _pad(x, s.pad)
        pw, ps = pool if pool else (0, 0)
        kw = dict(stride=s.stride, act=s.act, pool_window=pw, pool_stride=ps)
        got = sa_conv_implicit(xin, p["f"], p["b"], **kw)
        want = sa_conv_plain(xin, p["f"], p["b"], **kw)
        e = allclose(f"{name} fp32", got, want, TOL_CONV)
        rep.note_err("sa_conv_implicit", e)
        qf = qp["f"]
        qkw = dict(kw, w_scale=qf.scale)
        e8 = allclose(f"{name} int8",
                      sa_conv_implicit(xin, qf.q, qp["b"], **qkw),
                      sa_conv_plain(xin, qf.q, qp["b"], **qkw), TOL_CONV)
        rep.note_err("sa_conv_implicit", e8)
        log(f"  {name}: in {tuple(xin.shape)} out {tuple(got.shape)} "
            f"max|d| fp32 {e:.3g} int8 {e8:.3g}")
        if pool:
            unfused = sa_conv_implicit(xin, p["f"], p["b"], stride=s.stride,
                                       act=s.act)
            chained = maxpool_act(unfused, window=pw, stride=ps, act="none")
            exact(f"{name} fused == conv -> pool", got, chained)
            log(f"  {name}: fused pool == unfused conv -> pool kernel, "
                "bitwise")
            if name == "conv2":
                shapes["pool"] = unfused
        shapes["conv"].append((name, xin, p, qp, kw))
        x = got
    feats = x.reshape(x.shape[0], -1).contiguous()

    # standalone pool kernel: conv2's 27x27x256 map, an odd channel count,
    # and an int8 map (max is exact, so the tolerance is zero)
    pool_in = shapes["pool"]
    for label, t in (("conv2 map", pool_in),
                     ("odd channels", torch.randn(
                         8, 27, 27, 251, device=pool_in.device))):
        exact(f"maxpool_act {label}",
              maxpool_act(t, window=3, stride=2, act="relu"),
              ref.maxpool_act(t, window=3, stride=2, act="relu"))
    ti = torch.randint(-128, 127, (4, 13, 13, 131), dtype=torch.int8,
                       device=pool_in.device)
    exact("maxpool_act int8", maxpool_act(ti, window=3, stride=2, act="none"),
          ref.maxpool2d(ti, window=3, stride=2))
    log("  maxpool_act: conv2 map, 251 channels, int8 — exact")

    # declined fusion through the engine: silu is not monotone, so the
    # planner declines and the engine runs the standalone pool kernel
    eng = Engine(backend="kernels")
    reset_counters()
    with eng.tracing() as tr:
        got = eng.conv2d(shapes["conv"][2][1], params[4]["f"], params[4]["b"],
                         act="silu", pool=PoolSpec(3, 2), name="c")
    shapes["declined_launches"] = counters()
    want = Engine(backend="torch").conv2d(
        shapes["conv"][2][1], params[4]["f"], params[4]["b"], act="silu",
        pool=PoolSpec(3, 2), name="c")
    expect = {"sa_conv_implicit": 1, "sa_fc_matmul": 0, "maxpool_act": 1,
              "plain.matmul_bias_act": 0, "plain.conv2d": 0,
              "plain.maxpool2d": 0}
    if tr[0].conv_plan.fuse_pool or shapes["declined_launches"] != expect:
        raise AssertionError("declined fusion: launches "
                             f"{shapes['declined_launches']} != {expect}")
    rep.note_err("sa_conv_implicit", allclose("silu conv + pool", got, want,
                                              TOL_CONV))
    log("  engine conv2d(act=silu, pool 3/2): fusion declined, "
        "maxpool_act launched")

    # FC layers at b in {1, 13, 64}, fp32 and int8, on the real features
    for b in (1, 13, 64):
        h = feats[:b].contiguous()
        for (name, s, p), (_, _, qp) in zip(fcs, qfcs):
            got = sa_fc_matmul(h, p["w"], p["b"], act=s.act)
            e = allclose(f"{name} b={b} fp32", got,
                         sa_fc_plain(h, p["w"], p["b"], act=s.act), TOL_FC)
            qw = qp["w"]
            e8 = allclose(f"{name} b={b} int8",
                          sa_fc_matmul(h, qw.q, qp["b"], act=s.act,
                                       w_scale=qw.scale),
                          sa_fc_plain(h, qw.q, qp["b"], act=s.act,
                                      w_scale=qw.scale), TOL_FC)
            rep.note_err("sa_fc_matmul", max(e, e8))
            log(f"  {name} b={b}: max|d| fp32 {e:.3g} int8 {e8:.3g}")
            if b == 64:
                shapes["fc"].append((name, h, p, qp, s.act))
                one = sa_fc_matmul(h[:1].contiguous(), p["w"], p["b"],
                                   act=s.act)
                exact(f"{name} row 0 of b=64 == b=1", got[:1], one)
                q1 = sa_fc_matmul(h[:1].contiguous(), qw.q, qp["b"],
                                  act=s.act, w_scale=qw.scale)
                q64 = sa_fc_matmul(h, qw.q, qp["b"], act=s.act,
                                   w_scale=qw.scale)
                exact(f"{name} int8 row 0 of b=64 == b=1", q64[:1], q1)
            h = got
    log("  sa_fc_matmul: row 0 at b=64 == b=1, bitwise (fp32 and int8)")
    torch.cuda.synchronize()
    return shapes


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------
def _requests(images_np, uids):
    from repro_torch.serve.cnn_server import CNNRequest
    return [CNNRequest(uid=u, image=images_np[u]) for u in uids]


def counters():
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_act import maxpool_act
    from repro_torch.kernels.sa_conv_implicit import sa_conv_implicit
    from repro_torch.kernels.sa_fc import sa_fc_matmul
    return {"sa_conv_implicit": sa_conv_implicit.launches,
            "sa_fc_matmul": sa_fc_matmul.launches,
            "maxpool_act": maxpool_act.launches,
            **{f"plain.{k}": v for k, v in ref.counts().items()}}


def reset_counters() -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_act import maxpool_act
    from repro_torch.kernels.sa_conv_implicit import sa_conv_implicit
    from repro_torch.kernels.sa_fc import sa_fc_matmul
    sa_conv_implicit.launches = sa_fc_matmul.launches = 0
    maxpool_act.launches = 0
    ref.reset_counts()


def check_served(srv, done, n, waves_expected):
    """Every request served once with finite logits, in the expected waves,
    every dispatch a schedule hit; returns the logits in uid order."""
    import numpy as np
    if len(done) != n or not all(r.done for r in done):
        raise AssertionError(f"served {len(done)} of {n}")
    logits = np.stack([r.logits for r in sorted(done, key=lambda r: r.uid)])
    if logits.shape != (n, 1000) or not np.isfinite(logits).all():
        raise AssertionError(f"logits {logits.shape}, finite "
                             f"{np.isfinite(logits).all()}")
    if [w.batch for w in srv.waves] != waves_expected:
        raise AssertionError(f"waves {[w.batch for w in srv.waves]}")
    for w in srv.waves:
        if w.schedule_hits != len(w.trace) or len(w.trace) != 8:
            raise AssertionError(f"wave {w.wave}: {w.schedule_hits} hits of "
                                 f"{len(w.trace)} dispatches")
    return logits


def check_counts(c: dict, waves: int) -> None:
    want = {"sa_conv_implicit": 5 * waves, "sa_fc_matmul": 3 * waves,
            "maxpool_act": 0, "plain.matmul_bias_act": 0, "plain.conv2d": 0,
            "plain.maxpool2d": 0}
    if c != want:
        raise AssertionError(f"launch counts {c} != {want}")


def serve(rep: Report, params, qparams, images_np) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.engine import Engine
    from repro_torch.models import cnn
    from repro_torch.serve.cnn_server import CNNServer

    n = N_REQUESTS
    waves = [64, 64, n - 128]
    srv = CNNServer("alexnet", params)
    if srv.microbatch != 64:
        raise AssertionError(f"planner micro-batch {srv.microbatch} != 64")
    for r in _requests(images_np, range(n)):
        srv.submit(r)
    reset_counters()
    t0 = time.perf_counter()
    done = srv.run()
    first_run_s = time.perf_counter() - t0
    c = counters()
    check_counts(c, len(waves))
    logits = check_served(srv, done, n, waves)
    log(f"  served {n} requests in waves {waves} ({first_run_s:.2f}s, "
        f"schedules compiled on the way); launches {c}")
    rep.detail["launches_per_run"] = c

    # sequential == pipelined, bitwise
    seq = CNNServer("alexnet", params, pipeline=False)
    for r in _requests(images_np, range(n)):
        seq.submit(r)
    seq_logits = check_served(seq, seq.run(), n, waves)
    if not np.array_equal(seq_logits, logits):
        raise AssertionError("sequential logits != pipelined logits")
    log("  pipelined == sequential, bitwise")

    # one at a time == batched, bitwise
    for u in (0, 77, n - 1):
        one = CNNServer("alexnet", params)
        one.submit(_requests(images_np, [u])[0])
        single = one.run()[0].logits
        if not np.array_equal(single, logits[u]):
            raise AssertionError(f"request {u}: unbatched != batched")
    log("  requests 0, 77, 129 re-served alone: bitwise equal")

    # against the plain "torch" backend on the card, TF32 off
    sel = [0, 1, 2, 3, 64, 65, 128, 129]
    x = torch.from_numpy(images_np[sel]).cuda()
    with torch.no_grad():
        plain = cnn.cnn_forward("alexnet", params, x,
                                eng=Engine(backend="torch")).cpu()
    e = allclose("logits vs torch backend", torch.from_numpy(logits[sel]),
                 plain, TOL_LOGITS)
    log(f"  logits vs torch backend: max|d| {e:.3g} (|logits| max "
        f"{np.abs(logits).max():.3g})")
    rep.detail["logits_max_abs_err"] = e

    # int8 variant, one wave
    q = CNNServer("alexnet", qparams)
    for r in _requests(images_np, range(64)):
        q.submit(r)
    reset_counters()
    qlogits = check_served(q, q.run(), 64, [64])
    check_counts(counters(), 1)
    with torch.no_grad():
        qplain = cnn.cnn_forward("alexnet", qparams, x[:4],
                                 eng=Engine(backend="torch")).cpu()
    e8 = allclose("int8 logits vs torch backend",
                  torch.from_numpy(qlogits[sel[:4]]), qplain, TOL_LOGITS)
    log(f"  int8 wave: 64 served, 5 + 3 launches; vs torch backend max|d| "
        f"{e8:.3g}")
    rep.detail["int8_logits_max_abs_err"] = e8
    return dict(launches=c)


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------
def timed(fn, *, runs: int = 25, warmup: int = 3) -> float:
    """Median ms of ``fn`` over ``runs`` CUDA-event-timed calls, each after
    the L2 cache is flushed by writing a 256 MB buffer."""
    import torch
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def measure(rep: Report, shapes: dict, params, images_np) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_act import maxpool_act
    from repro_torch.kernels.sa_conv_implicit import (sa_conv_implicit,
                                                      sa_conv_plain)
    from repro_torch.kernels.sa_fc import sa_fc_matmul, sa_fc_plain
    from repro_torch.serve.cnn_server import CNNServer

    def row(kernel, label, ms, plain_ms, lib_ms, flops, nb):
        b_ms, by = bound(flops, nb)
        rep.rows.append(dict(kernel=kernel, shape=label, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=by, flops=flops,
                             bytes=nb))
        log(f"  {kernel:16s} {label:34s} {ms:9.4f} ms  bound {b_ms:8.4f} "
            f"({by})  plain {plain_ms:9.4f}  library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f}'}")

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for name, xin, p, qp, kw in shapes["conv"]:
            f, b = p["f"], p["b"]
            out = sa_conv_implicit(xin, f, b, **kw)
            batch, h, w, ci = xin.shape
            kk, _, _, co = f.shape
            oh = (h - kk) // kw["stride"] + 1
            ow = (w - kk) // kw["stride"] + 1
            flops = 2 * batch * oh * ow * co * kk * kk * ci
            xc = xin.permute(0, 3, 1, 2)          # NCHW view, channels_last
            fc = f.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            row("sa_conv_implicit", f"{name} b={batch} fp32",
                timed(lambda: sa_conv_implicit(xin, f, b, **kw)),
                timed(lambda: sa_conv_plain(xin, f, b, **kw), runs=20),
                timed(lambda: F.conv2d(xc, fc, b, stride=kw["stride"])),
                flops, nbytes(xin, f, b, out))
            qf = qp["f"]
            qkw = dict(kw, w_scale=qf.scale)
            row("sa_conv_implicit", f"{name} b={batch} int8",
                timed(lambda: sa_conv_implicit(xin, qf.q, qp["b"], **qkw)),
                timed(lambda: sa_conv_plain(xin, qf.q, qp["b"], **qkw),
                      runs=20),
                None, flops, nbytes(xin, qf.q, qf.scale, qp["b"], out))
        for name, h, p, qp, act in shapes["fc"]:
            w, b = p["w"], p["b"]
            flops = 2 * h.shape[0] * w.shape[0] * w.shape[1]
            out = sa_fc_matmul(h, w, b, act=act)
            row("sa_fc_matmul", f"{name} b={h.shape[0]} fp32",
                timed(lambda: sa_fc_matmul(h, w, b, act=act)),
                timed(lambda: sa_fc_plain(h, w, b, act=act), runs=20),
                timed(lambda: ref.apply_act(torch.addmm(b, h, w), act)),
                flops, nbytes(h, w, b, out))
            qw = qp["w"]
            row("sa_fc_matmul", f"{name} b={h.shape[0]} int8",
                timed(lambda: sa_fc_matmul(h, qw.q, qp["b"], act=act,
                                           w_scale=qw.scale)),
                timed(lambda: sa_fc_plain(h, qw.q, qp["b"], act=act,
                                          w_scale=qw.scale), runs=20),
                None, flops, nbytes(h, qw.q, qw.scale, qp["b"], out))
        t = shapes["pool"]
        out = maxpool_act(t, window=3, stride=2, act="none")
        tc = t.permute(0, 3, 1, 2)
        row("maxpool_act", f"conv2 map {tuple(t.shape)} 3/2",
            timed(lambda: maxpool_act(t, window=3, stride=2, act="none")),
            timed(lambda: ref.maxpool_act(t, window=3, stride=2, act="none")),
            timed(lambda: F.max_pool2d(tc, 3, 2)),
            out.numel() * 9, nbytes(t, out))

    # server throughput at b=64 fp32: warm schedules, then 4 full waves
    srv = CNNServer("alexnet", params)
    for r in _requests(images_np, range(64)):
        srv.submit(r)
    srv.run()
    reqs = []
    for rep_i in range(4):
        for r in _requests(images_np, range(64)):
            r.uid += 1000 * (rep_i + 1)
            reqs.append(r)
    for pipelined in (True, False):
        s = CNNServer("alexnet", params)
        s.run()
        for r in reqs:
            r.done, r.logits = False, None
            s.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(pipelined=pipelined)
        sec = time.perf_counter() - t0
        key = "pipelined" if pipelined else "sequential"
        rep.detail[f"server_images_per_s_{key}"] = len(reqs) / sec
        log(f"  server {key}: {len(reqs)} images in {sec * 1e3:.1f} ms = "
            f"{len(reqs) / sec:.1f} images/s")
    copies = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv._to_device(reqs[:64])
        torch.cuda.synchronize()
        copies.append((time.perf_counter() - t0) * 1e3)
    rep.detail["input_copy_ms_b64"] = statistics.median(copies)
    log(f"  input stack + pin + copy to device, b=64: "
        f"{rep.detail['input_copy_ms_b64']:.3f} ms (host clock, median of 10)")


def kernels_line(rep: Report, launches: dict, declined: dict) -> dict:
    """One entry per kernel.  ``launches`` counts the served run (130
    requests) for the two kernels of the serving path, and the
    declined-fusion dispatch for the pool kernel, whose path that is; the
    times are one b=64 wave's launches at their main-path shapes."""
    out = []
    for kernel, (source, replaces) in SOURCES.items():
        pool = kernel == "maxpool_act"
        rows = [r for r in rep.rows if r["kernel"] == kernel
                and not r["shape"].endswith("int8")]
        lib = [r["library_ms"] for r in rows]
        t_ops = sum(r["flops"] for r in rows) / PEAK_FP32_FLOPS * 1e3
        t_bytes = sum(r["bytes"] for r in rows) / PEAK_BYTES_PER_S * 1e3
        out.append(dict(
            name=kernel, route="cuda", source=source, replaces=replaces,
            launches=(declined if pool else launches)[kernel],
            path=("Engine.conv2d, pool fusion declined" if pool
                  else "CNNServer.run"),
            max_abs_err=rep.err[kernel],
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None if any(v is None for v in lib) else sum(lib)))
    return {"kernels": out}


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core.quant import quantize_cnn_params
    from repro_torch.models.cnn import init_cnn

    t_start = time.perf_counter()
    rep = Report()
    log("== phase 1: environment")
    smi = environment(rep)
    log("== phase 2: build")
    build(rep)

    torch.set_grad_enabled(False)
    params = init_cnn("alexnet", SEED)                       # on the card
    qparams = quantize_cnn_params(params)
    rng = np.random.default_rng(SEED)
    images_np = rng.standard_normal((N_REQUESTS, 227, 227, 3)).astype(
        np.float32)
    log("== phase 3: kernels against their plain versions (b=64 chain)")
    shapes = check_kernels(rep, params, qparams,
                           torch.from_numpy(images_np[:64]).cuda())
    log("== phase 4: CNNServer, full-width AlexNet at 227x227")
    served = serve(rep, params, qparams, images_np)
    log("== phase 5: times (median of 25, CUDA events, L2 flushed)")
    measure(rep, shapes, params, images_np)

    line = kernels_line(rep, served["launches"], shapes["declined_launches"])
    rep.detail["rows"] = rep.rows
    rep.detail["kernels"] = line["kernels"]
    rep.detail["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(rep.detail,
                                                        indent=1))
    log(f"total {rep.detail['total_s']:.1f}s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
