#!/usr/bin/env python3
"""Time SA-FC's bf16 decode launches shape by shape on the card, two trees
side by side.

    python3 tools/fc_bf16_decode.py [--src DIR] [--pairs N] [--out FILE]

Every bf16 SA-FC shape of one decode step of OLMo-1B and zamba2-2.7b (b =
4), seamless-m4t-large-v2 (b = 4) and llava-next-34b cut to 4 layers (b =
2), the served batches of ``chip_smoke.py``; the shapes and their launches
a step come from the engine's dispatch records of ``decode_step`` on meta
tensors.  Each shape is timed with ``chip_smoke.timed`` (CUDA events, L2
flushed, the card held busy) on random bf16 x and w from one seed, beside
its byte bound (weights, x and out once at 3.35 TB/s) and ``torch.mm`` in
bf16, after its output is held against ``sa_fc_plain`` (TOL_BF16).  With
``--src``, an older tree's ``src`` (unpacked beside this one), each tree
runs in its own process, in turns (older, this, this, older for one pair),
so both are timed in one call on one card; a shape's time is the median
over its tree's processes.  Prints one JSON object (and writes it to
``--out``): per shape and per model's step, each tree's ms, the bound and
``torch.mm``; needs a card.
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
SEED = 0


def decode_shapes() -> dict:
    """{model: {(b, k, n): launches a decode step}} of the bf16 SA-FC
    launches, from ``decode_step``'s dispatch records on meta tensors."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import Engine
    from repro_torch.models import transformer as T
    from repro_torch.serve import kvcache as KC
    from repro_torch.serve.serve_step import decode_step
    out = {}
    for name, b, layers in MODELS:
        cfg = get_config(name)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params = T.init_params(cfg, SEED, device="meta")
        cache = KC.init_cache(cfg, b, 640, enc_len=cfg.audio_frames,
                              dtype=torch.bfloat16, device="meta")
        tok = torch.empty((b, 1), dtype=torch.int64, device="meta")
        eng = Engine(backend="torch")
        with eng.tracing() as tr, eng.activate():
            decode_step(cfg, params, cache, tok, 16)
        out[name] = dict(collections.Counter(
            (r.m, r.k, r.n) for r in tr if r.regime == "sa_fc"
            and r.dtype == r.weight_dtype == "bfloat16"))
    return out


def child(label: str) -> dict:
    """This process's tree: every shape checked, then timed."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import sa_fc
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = sorted({s for per in decode_shapes().values() for s in per})
    rows = {}
    with torch.no_grad():
        for b, k, n in shapes:
            x = torch.randn((b, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            decode = getattr(sa_fc.sa_fc_matmul, "decode_launches", None)
            out = sa_fc.sa_fc_matmul(x, w)
            torch.cuda.synchronize()
            if decode is not None and \
                    sa_fc.sa_fc_matmul.decode_launches != decode + 1:
                raise AssertionError(f"{label} {(b, k, n)}: not on the "
                                     "decode kernel")
            err = cs.allclose(f"{label} {(b, k, n)}", out.float(),
                              sa_fc.sa_fc_plain(x, w).float(), cs.TOL_BF16)
            ms = cs.timed(lambda: sa_fc.sa_fc_matmul(x, w))
            mm = cs.timed(lambda: torch.mm(x, w))
            bound_ms, _ = cs.bound(2 * b * k * n, cs.nbytes(x, w, out),
                                   cs.PEAK_BF16_FLOPS)
            rows[f"{b}x{k}x{n}"] = dict(ms=ms, mm_ms=mm, bound_ms=bound_ms,
                                        max_abs_err=err,
                                        decode_kernel=decode is not None)
            print(f"{label:8s} b={b} {k:6d} x {n:6d}  {ms:8.4f} ms  mm "
                  f"{mm:8.4f}  bound {bound_ms:7.4f}  err {err:.3g}",
                  file=sys.stderr, flush=True)
            del x, w, out
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
    args = ap.parse_args()
    if args.child is not None:
        sys.path.insert(0, args.child)
        sys.path.insert(1, str(ROOT))
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(child(args.label)))
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
    for _ in range(args.pairs):
        for label in order:
            proc = subprocess.run(
                [sys.executable, __file__, "--child", trees[label],
                 "--label", label], capture_output=True, text=True)
            sys.stderr.write(proc.stderr)
            if proc.returncode != 0:
                raise SystemExit(f"{label}: exit {proc.returncode}")
            runs[label].append(json.loads(proc.stdout.splitlines()[-1]))
    steps = decode_shapes()
    shapes = {}
    for key in runs["change"][0]["rows"]:
        row = {f"{label}_ms": statistics.median(r["rows"][key]["ms"]
                                                for r in rs)
               for label, rs in runs.items()}
        first = runs["change"][0]["rows"][key]
        row.update(bound_ms=first["bound_ms"],
                   mm_ms=statistics.median(r["rows"][key]["mm_ms"]
                                           for rs in runs.values()
                                           for r in rs),
                   spread={label: [r["rows"][key]["ms"] for r in rs]
                           for label, rs in runs.items()})
        shapes[key] = row
    per_step = {}
    for model, per in steps.items():
        tot = collections.Counter()
        for (b, k, n), count in per.items():
            row = shapes[f"{b}x{k}x{n}"]
            for field in [f for f in row if f.endswith("_ms")]:
                tot[field] += count * row[field]
        per_step[model] = dict(tot, launches=sum(per.values()),
                               shapes={f"{b}x{k}x{n}": c
                                       for (b, k, n), c in per.items()})
    result = dict(card=smi, order=order, pairs=args.pairs, shapes=shapes,
                  steps=per_step)
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    for model, s in per_step.items():
        print(f"{model:24s} " + "  ".join(
            f"{f} {v:.4f}" for f, v in s.items() if f.endswith("_ms")),
            file=sys.stderr)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
