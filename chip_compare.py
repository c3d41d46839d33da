#!/usr/bin/env python3
"""Compare SA-CONV, SA-FC, flash attention, the pool, the CNN server and
the OLMo-1B decode step of two checkouts on one card.

    python3 chip_compare.py OLD_ROOT [NEW_ROOT] [--pairs N] [--out FILE]
                            [--parts conv,fc,attn,gemm,pool,lm,gemm_types]

``NEW_ROOT`` defaults to this checkout.  Each root runs in a process of its
own (both name their package ``repro_torch``), in ``N`` pairs (10 by
default) that alternate which side runs first, because host times drift
between processes on a shared host.  A process puts its root's ``src``
first on its path and measures with this checkout's ``chip_smoke``:

* ``conv``: ``sa_conv_implicit`` at AlexNet's five conv layers at b = 64
  (fp32 and int8 filters, on a chain of activations from normal images),
  ``ms`` with the card held busy (``chip_smoke.timed``), and
  ``CNNServer.run`` images/s over 4 waves of 64, pipelined and sequential
  (``chip_smoke.server_throughput``);
* ``fc``: ``sa_fc_matmul`` at the shapes of its two served paths (AlexNet's
  fc1-fc3 at b = 64 with fp32 and int8 weights; OLMo-1B's four GEMM shapes
  at b = 4 and m = 512, fp32): ``ms`` with the card held busy (the card's
  time), ``host_ms`` with the card drained before each call (the wrapper's
  host work included) and ``enqueue_us``, the host work alone
  (``chip_smoke.timed`` and ``chip_smoke.host_costs``);
* ``attn``: ``flash_attention`` at the LM path's two prefill shapes, a
  full wave (b = 4) and a lone request (b = 1) of 512 tokens with OLMo-1B's
  heads, causal, ``ms`` with the card held busy;
* ``gemm``: ``sa_conv_matmul`` at the four GEMM shapes of a full-wave
  OLMo-1B prefill (m = 2048: q/k/v/o, gate/up with silu, down, lm_head;
  fp32 weights and inputs, normal, scaled by k^-1/2), ``ms`` with the card
  held busy;
* ``pool``: ``maxpool_act`` (act none) at every map of
  ``chip_smoke.POOL_SWEEP`` (AlexNet's and VGG-16's pooled maps at b = 64,
  fp32 and int8), ``ms`` with the card held busy;
* ``lm``: a full-wave prefill and a decode step at b = 4 on the host
  clock, and their device busy time, by ``chip_smoke.lm_throughput``;
* ``gemm_types``: ``sa_conv_matmul`` at a full-wave prefill's q/k/v/o and
  gate/up shapes (m = 2048, no activation) for x in fp32 and bf16 times w
  in fp32, bf16 and int8, ``ms`` with the card held busy (both trees must
  take bf16 activations: PR 19 on).

``--parts`` picks which run (all but ``gemm_types`` by default); a
process builds the kernels its parts run.

Weights from ``chip_smoke.SEED``, normal inputs from a generator with that
seed.  Prints one JSON object per run, then for each number the medians
of both sides and the pairs the new side won (lower times, higher
images/s); ``--out`` writes the runs to a file.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: the kernel libraries each part runs
KERNELS = {"conv": ("sa_conv_implicit",), "fc": ("sa_fc",),
           "attn": ("attention",), "gemm": ("sa_conv",), "pool": ("pool_act",),
           "lm": ("sa_conv", "attention", "sa_fc"),
           "gemm_types": ("sa_conv",)}


def run_tree(root: str, parts: set) -> dict:
    """Measure the ``repro_torch`` of ``root`` (this process imports no
    other)."""
    sys.path.insert(0, str(Path(root, "src")))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.quant import quantize_cnn_params
    from repro_torch.kernels import _build
    from repro_torch.models.cnn import init_cnn

    torch.set_grad_enabled(False)
    _build.build(sorted({k for part in parts for k in KERNELS[part]}))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {}
    if parts & {"conv", "fc"}:
        params = init_cnn("alexnet", cs.SEED)
        qparams = quantize_cnn_params(params)
    if "conv" in parts:
        out["sa_conv"] = conv_times(cs, params, qparams, gen)
        rep = cs.Report()
        images = np.random.default_rng(cs.SEED).standard_normal(
            (64, 227, 227, 3)).astype(np.float32)
        cs.server_throughput(rep, params, images)
        out["server"] = {k.removeprefix("server_images_per_s_"): v
                         for k, v in rep.detail.items()}
    if "fc" in parts:
        out["sa_fc"] = fc_times(cs, params, qparams, gen)
    if "attn" in parts:
        out["flash"] = attn_times(cs, gen)
    if "gemm" in parts:
        out["gemm"] = gemm_times(cs, gen)
    if "pool" in parts:
        out["pool"] = pool_times(cs, gen)
    if "gemm_types" in parts:
        out["gemm_types"] = gemm_type_times(cs, gen)
    if "lm" in parts:
        from repro_torch.models import transformer as T
        if parts & {"conv", "fc"}:
            del params, qparams
        cfg = cs.olmo_config()
        lm = T.init_params(cfg, cs.SEED, device="cuda")
        rep = cs.Report()
        cs.lm_throughput(rep, cfg, lm)
        d = rep.detail
        out.update(decode_step_ms=d["lm_decode_step_ms"],
                   prefill_wave_ms=d["lm_prefill_wave_ms"],
                   device_busy=d["lm_device_busy"])
    return out


def conv_times(cs, params, qparams, gen) -> dict:
    """Card ms of each AlexNet conv layer at b = 64, fp32 and int8."""
    import torch
    from repro_torch.kernels.sa_conv_implicit import sa_conv_implicit
    convs, _ = cs.cnn_layers("alexnet", params)
    qconvs, _ = cs.cnn_layers("alexnet", qparams)
    x = torch.randn((64, 227, 227, 3), generator=gen, device="cuda")
    out = {}
    for (name, s, p, pool), (_, _, qp, _) in zip(convs, qconvs):
        xin = cs._pad(x, s.pad)
        pw, ps = pool if pool else (0, 0)
        kw = dict(stride=s.stride, act=s.act, pool_window=pw, pool_stride=ps)
        qf = qp["f"]
        out[f"alexnet {name} b=64 fp32"] = dict(ms=cs.timed(
            lambda: sa_conv_implicit(xin, p["f"], p["b"], **kw)))
        out[f"alexnet {name} b=64 int8"] = dict(ms=cs.timed(
            lambda: sa_conv_implicit(xin, qf.q, qp["b"], w_scale=qf.scale,
                                     **kw)))
        x = sa_conv_implicit(xin, p["f"], p["b"], **kw)
    return out


def fc_times(cs, params, qparams, gen) -> dict:
    """SA-FC ``ms``, ``host_ms`` and ``enqueue_us`` at its served shapes."""
    import torch
    from repro_torch.kernels.sa_fc import sa_fc_matmul
    from repro_torch.models import transformer as T
    _, fcs = cs.cnn_layers("alexnet", params)
    _, qfcs = cs.cnn_layers("alexnet", qparams)
    calls = []
    for (name, s, p), (_, _, qp) in zip(fcs, qfcs):
        h = torch.randn((64, p["w"].shape[0]), generator=gen, device="cuda")
        calls.append((f"alexnet {name} b=64 fp32", h, p["w"], p["b"], s.act,
                      None))
        calls.append((f"alexnet {name} b=64 int8", h, qp["w"].q, qp["b"],
                      s.act, qp["w"].scale))
    cfg = cs.olmo_config()
    lm = T.init_params(cfg, cs.SEED, device="cuda")
    for m in (cs.LM_BATCH, cs.LM_PROMPT):
        for label, x, w, act, _ in cs.gemm_shapes(cfg, lm, gen):
            calls.append((f"olmo {label} b={m} fp32", x[:m].contiguous(), w,
                          None, act, None))
    out = {}
    for label, h, w, bias, act, scale in calls:
        def fn():
            sa_fc_matmul(h, w, bias, act=act, w_scale=scale)
        out[label] = dict(ms=cs.timed(fn), **cs.host_costs(fn))
    return out


def attn_times(cs, gen) -> dict:
    """Card ms of flash attention at a full wave's and a lone request's
    OLMo-1B prefill, causal."""
    import torch
    from repro_torch.kernels.attention import flash_attention
    cfg = cs.olmo_config()
    out = {}
    for b in (cs.LM_BATCH, 1):
        q, k, v = (torch.randn((b, cs.LM_PROMPT, cfg.n_heads, cfg.hd),
                               generator=gen, device="cuda")
                   for _ in range(3))
        out[f"olmo prefill b={b}"] = dict(ms=cs.timed(
            lambda: flash_attention(q, k, v)))
    return out


def gemm_times(cs, gen) -> dict:
    """Card ms of the SA-CONV GEMM at a full-wave OLMo-1B prefill's four
    shapes (m = 2048, fp32)."""
    import torch
    from repro_torch.kernels.sa_conv import sa_conv_matmul
    cfg = cs.olmo_config()
    m, d, ff = cs.LM_BATCH * cs.LM_PROMPT, cfg.d_model, cfg.d_ff
    out = {}
    for name, k, n, act in (("attn.q/k/v/o", d, d, "none"),
                            ("mlp.gate/up", d, ff, "silu"),
                            ("mlp.down", ff, d, "none"),
                            ("lm_head", d, cfg.vocab_size, "none")):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        out[f"{name} {k}x{n} m={m}"] = dict(ms=cs.timed(
            lambda: sa_conv_matmul(x, w, act=act)))
        del x, w
    return out


def gemm_type_times(cs, gen) -> dict:
    """Card ms of the SA-CONV GEMM at q/k/v/o and gate/up (m = 2048) for
    every mix of fp32 or bf16 x with fp32, bf16 or int8 w."""
    import torch
    from repro_torch.core.quant import quantize
    from repro_torch.kernels.sa_conv import sa_conv_matmul
    cfg = cs.olmo_config()
    m, d, ff = cs.LM_BATCH * cs.LM_PROMPT, cfg.d_model, cfg.d_ff
    out = {}
    for name, k, n in (("attn.q/k/v/o", d, d), ("mlp.gate/up", d, ff)):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        qt = quantize(w)
        for xt in ("fp32", "bf16"):
            xx = x if xt == "fp32" else x.to(torch.bfloat16)
            for wt, ww, scale in (("fp32", w, None),
                                  ("bf16", w.to(torch.bfloat16), None),
                                  ("int8", qt.q, qt.scale)):
                out[f"{name} {k}x{n} m={m} x {xt} w {wt}"] = dict(
                    ms=cs.timed(lambda: sa_conv_matmul(xx, ww,
                                                       w_scale=scale)))
        del x, w, qt
    return out


def pool_times(cs, gen) -> dict:
    """Card ms of the pool kernel at every ``chip_smoke.POOL_SWEEP`` map."""
    from repro_torch.kernels.pool_act import maxpool_act
    out = {}
    for label, hw, c, window, dtype in cs.POOL_SWEEP:
        x = cs.pool_map(hw, c, dtype, gen)
        out[f"{label} {hw}x{hw}x{c} {window}/2 {dtype}"] = dict(ms=cs.timed(
            lambda: maxpool_act(x, window=window, stride=2, act="none")))
        del x
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new", nargs="?", default=str(ROOT))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out")
    ap.add_argument("--parts", default="conv,fc,attn,gemm,pool,lm")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    if not parts or parts - set(KERNELS):
        ap.error(f"--parts: {args.parts!r}")
    if args.child:
        print(json.dumps(run_tree(args.child, parts)))
        return 0
    sides = {"old": str(Path(args.old).resolve()),
             "new": str(Path(args.new).resolve())}
    pairs = []
    for i in range(args.pairs):
        pair = {}
        for tree in ("old", "new") if i % 2 == 0 else ("new", "old"):
            proc = subprocess.run([sys.executable, __file__, args.old,
                                   "--parts", args.parts,
                                   "--child", sides[tree]],
                                  capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            pair[tree] = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(pair=i, tree=tree, **pair[tree])),
                  flush=True)
        pairs.append(pair)
    if args.out:
        Path(args.out).write_text(json.dumps(pairs, indent=1))
    for name, get, higher in numbers(pairs[0]["old"]):
        old = [get(p["old"]) for p in pairs]
        new = [get(p["new"]) for p in pairs]
        wins = sum((n > o) if higher else (n < o) for o, n in zip(old, new))
        print(f"{name}: old median {statistics.median(old):.4f}, new median "
              f"{statistics.median(new):.4f}, new "
              f"{'higher' if higher else 'lower'} in {wins} of "
              f"{len(pairs)} pairs")
    return 0


def numbers(run: dict):
    """(name, getter, higher is better) of every number a run reports."""
    out = []
    if "decode_step_ms" in run:
        out += [("decode_step_ms", lambda r: r["decode_step_ms"], False),
                ("prefill_wave_ms", lambda r: r["prefill_wave_ms"], False),
                ("decode device_ms",
                 lambda r: r["device_busy"]["decode"]["device_ms"], False)]
    for key in run.get("server", {}):
        out.append((f"server images/s {key}",
                    lambda r, key=key: r["server"][key], True))
    for part in ("sa_conv", "sa_fc", "flash", "gemm", "pool", "gemm_types"):
        for label, v in run.get(part, {}).items():
            out += [(f"{part} {label} {key}",
                     lambda r, part=part, label=label, key=key:
                     r[part][label][key], False) for key in v]
    return out


if __name__ == "__main__":
    sys.exit(main())
