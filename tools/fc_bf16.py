#!/usr/bin/env python3
"""Time SA-FC's bf16-activation launches shape by shape on the card, two
trees side by side.

    python3 tools/fc_bf16.py [--src DIR] [--pairs N] [--out FILE]

Two kinds of launch.  Decode steps: every bf16 SA-FC shape of one decode
step of OLMo-1B and zamba2-2.7b (b = 4), seamless-m4t-large-v2 (b = 4) and
llava-next-34b cut to 4 layers (b = 2), the served batches of
``chip_smoke.py``.  Waves: AlexNet's head (fc1-fc3, fp32 weights, relu,
relu, none) at b = 64 (a full wave of the bf16 ``CNNServer``) and b = 2
(its last wave), and seamless's decoder prefill at m = 64 (4 requests of
16 tokens, bf16 weights).  The LM shapes and their launches a step or a
pass come from the engine's dispatch records on meta tensors.  Each shape
is timed with ``chip_smoke.timed`` (CUDA events, L2 flushed, the card held
busy) on random inputs from one seed, beside its bound (max of its
operations at 989 TFLOP/s and its weights, x and out once at 3.35 TB/s),
its plain version and its library call (``torch.mm`` in bf16 on the weights
rounded to bf16 before the timing, then bias and act), after its output is
held against ``sa_fc_plain`` (TOL_BF16).  With ``--src``, an older tree's
``src`` (unpacked beside this one), each tree runs in its own process, in
turns (older, this, this, older for one pair), so both are timed in one
call on one card; a shape's time is the median over its tree's processes.
Prints one JSON object (and writes it to ``--out``): per shape and per
group (a model's decode step, a wave, a prefill pass), each tree's ms, the
bound, the plain version and the library call; needs a card.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (config, served batch, layers: None for the published depth)
MODELS = (("olmo-1b", 4, None), ("zamba2-2.7b", 4, None),
          ("seamless-m4t-large-v2", 4, None), ("llava-next-34b", 2, 4))
#: AlexNet's head: (label, k, n, act), fp32 weights
ALEXNET_FC = (("fc1", 9216, 4096, "relu"), ("fc2", 4096, 4096, "relu"),
              ("fc3", 4096, 1000, "none"))
#: seamless's prefill: requests and prompt tokens (phase 13's wave)
PREFILL = ("seamless-m4t-large-v2", 4, 16)
SEED = 0


def _records(name, layers, step) -> list:
    """The engine's dispatch records of ``step(cfg, params)`` on meta."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import Engine
    from repro_torch.models import transformer as T
    cfg = get_config(name)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = T.init_params(cfg, SEED, device="meta")
    eng = Engine(backend="torch")
    with eng.tracing() as tr, eng.activate(), torch.no_grad():
        step(cfg, params)
    return list(tr)


def groups() -> dict:
    """{group: {(b, k, n, w dtype, act, bias): launches}} of the bf16
    SA-FC launches of each decode step, each AlexNet wave and seamless's
    prefill (the LM matmuls with no bias and no act, as the records hold
    no act; AlexNet's with their bias and act)."""
    import torch
    from repro_torch.serve import kvcache as KC
    from repro_torch.serve.serve_step import decode_step, prefill_step
    out = {}

    def count(records):
        return dict(collections.Counter(
            (r.m, r.k, r.n, "bfloat16", "none", False) for r in records
            if r.regime == "sa_fc" and r.dtype == "bfloat16"))

    for name, b, layers in MODELS:
        def step(cfg, params):
            cache = KC.init_cache(cfg, b, 640, enc_len=cfg.audio_frames,
                                  dtype=torch.bfloat16, device="meta")
            tok = torch.empty((b, 1), dtype=torch.int64, device="meta")
            decode_step(cfg, params, cache, tok, 16)
        out[f"{name} decode step"] = count(_records(name, layers, step))
    name, b, s = PREFILL

    def prefill(cfg, params):
        batch = {"tokens": torch.empty((b, s), dtype=torch.int64,
                                       device="meta"),
                 "audio_embeds": torch.empty(
                     (b, cfg.audio_frames, cfg.frontend_dim),
                     dtype=torch.bfloat16, device="meta")}
        prefill_step(cfg, params, batch, 640, torch.bfloat16)
    out[f"{name} prefill m={b * s}"] = count(_records(name, None, prefill))
    for b in (64, 2):
        out[f"alexnet head b={b}"] = {(b, k, n, "float32", act, True): 1
                                      for _, k, n, act in ALEXNET_FC}
    return out


def shape_key(b, k, n, wd, act, has_bias) -> str:
    return f"{b}x{k}x{n} {wd} {act}{' +bias' if has_bias else ''}"


def child(label: str, plain: bool) -> dict:
    """This process's tree: every shape checked, then timed."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ref, sa_fc
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = sorted({s for per in groups().values() for s in per})
    rows = {}
    with torch.no_grad():
        for b, k, n, wd, act, has_bias in shapes:
            x = torch.randn((b, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 * k ** -0.5).to(getattr(torch, wd))
            bias = torch.randn((n,), generator=gen, device="cuda") \
                if has_bias else None
            tc = getattr(sa_fc.sa_fc_matmul, "tc_launches", None)
            out = sa_fc.sa_fc_matmul(x, w, bias, act=act)
            torch.cuda.synchronize()
            if tc is not None and sa_fc.sa_fc_matmul.tc_launches != tc + 1:
                raise AssertionError(f"{label} {(b, k, n)}: not on the "
                                     "tensor-core kernel")
            err = cs.allclose(f"{label} {(b, k, n)}", out.float(),
                              sa_fc.sa_fc_plain(x, w, bias, act=act).float(),
                              cs.TOL_BF16)
            ms = cs.timed(lambda: sa_fc.sa_fc_matmul(x, w, bias, act=act))
            wb = w.to(torch.bfloat16)
            if has_bias:
                bb = bias.to(torch.bfloat16)
                mm = cs.timed(lambda: ref.apply_act(torch.mm(x, wb) + bb,
                                                    act))
            else:
                mm = cs.timed(lambda: ref.apply_act(torch.mm(x, wb), act))
            plain_ms = cs.timed(lambda: sa_fc.sa_fc_plain(x, w, bias,
                                                          act=act),
                                runs=5, warmup=1) if plain else None
            bound_ms, by = cs.bound(2 * b * k * n, cs.nbytes(x, w, out),
                                    cs.PEAK_BF16_FLOPS)
            rows[shape_key(b, k, n, wd, act, has_bias)] = dict(
                ms=ms, mm_ms=mm, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, max_abs_err=err, tc_kernel=tc is not None)
            print(f"{label:8s} b={b:3d} {k:6d} x {n:6d} {wd:8s} {ms:8.4f} "
                  f"ms  mm {mm:8.4f}  bound {bound_ms:7.4f}  err {err:.3g}",
                  file=sys.stderr, flush=True)
            del x, w, out, wb
            torch.cuda.empty_cache()
    return dict(label=label, rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None,
                    help="an older tree's src, timed beside this one")
    ap.add_argument("--label", default="change")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--plain", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        sys.path.insert(0, args.child)
        sys.path.insert(1, str(ROOT))
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(child(args.label, args.plain)))
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    trees = {"change": str(ROOT / "src")}
    if args.src:
        trees["parent"] = str(Path(args.src).resolve())
    order = ["parent", "change", "change", "parent"] if args.src \
        else ["change"]
    runs = collections.defaultdict(list)
    for p in range(args.pairs):
        for i, label in enumerate(order):
            plain = p == 0 and label == "change" and \
                i == order.index("change")
            proc = subprocess.run(
                [sys.executable, __file__, "--child", trees[label],
                 "--label", label] + (["--plain"] if plain else []),
                capture_output=True, text=True)
            sys.stderr.write(proc.stderr)
            if proc.returncode != 0:
                raise SystemExit(f"{label}: exit {proc.returncode}")
            runs[label].append(json.loads(proc.stdout.splitlines()[-1]))
    shapes = {}
    for key, first in runs["change"][0]["rows"].items():
        row = {f"{label}_ms": statistics.median(r["rows"][key]["ms"]
                                                for r in rs)
               for label, rs in runs.items()}
        row.update(bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                   plain_ms=first["plain_ms"],
                   mm_ms=statistics.median(r["rows"][key]["mm_ms"]
                                           for rs in runs.values()
                                           for r in rs),
                   spread={label: [r["rows"][key]["ms"] for r in rs]
                           for label, rs in runs.items()})
        shapes[key] = row
    per_group = {}
    for group, per in groups().items():
        tot = collections.Counter()
        for shape, count in per.items():
            row = shapes[shape_key(*shape)]
            for field in [f for f in row if f.endswith("_ms")]:
                tot[field] += count * row[field]
        per_group[group] = dict(tot, launches=sum(per.values()),
                                shapes={shape_key(*s): c
                                        for s, c in per.items()})
    result = dict(card=smi, order=order, pairs=args.pairs, shapes=shapes,
                  groups=per_group)
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(smi, file=sys.stderr)
    for group, s in per_group.items():
        print(f"{group:40s} " + "  ".join(
            f"{f} {v:.4f}" for f, v in s.items() if f.endswith("_ms")),
            file=sys.stderr)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
