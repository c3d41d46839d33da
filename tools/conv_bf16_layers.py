#!/usr/bin/env python3
"""Time SA-CONV implicit's bf16 launches layer by layer on the card.

    python3 tools/conv_bf16_layers.py [--src DIR] [--label NAME] [--out FILE]

Times ``sa_conv_implicit`` with bf16 activations (``chip_smoke.timed``:
CUDA events, L2 flushed, the card held busy) at AlexNet's conv1-conv5 and
VGG-16's conv1_2, conv3_3 and conv5_3 at b = 64 on their padded inputs,
each pool fused and relu as in the forward (random normal inputs and
filters from one seed), beside ``F.conv2d`` in bf16 (NCHW view of the same
input, channels_last filter, cuDNN) and the layer's bound at the tensor
cores' bf16 rate; each layer first held against ``sa_conv_plain`` on two
of its images (TOL_BF16).  Where the package's geometry has the
tensor-core tiles it also reports the tile and its slot use at b = 64.  ``--src`` imports
``repro_torch`` from another tree's ``src`` (an older commit unpacked
beside this one), so that two versions are timed in one call on one card;
the kernels are built into that tree.  Prints one JSON object (and writes
it to ``--out`` when given); needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (label, padded h = w, ci, p, co, stride, pool window, pool stride)
LAYERS = (("alexnet conv1", 227, 3, 11, 96, 4, 3, 2),
          ("alexnet conv2", 31, 96, 5, 256, 1, 3, 2),
          ("alexnet conv3", 15, 256, 3, 384, 1, 0, 0),
          ("alexnet conv4", 15, 384, 3, 384, 1, 0, 0),
          ("alexnet conv5", 15, 384, 3, 256, 1, 3, 2),
          ("vgg16 conv1_2", 226, 64, 3, 64, 1, 2, 2),
          ("vgg16 conv3_3", 58, 256, 3, 256, 1, 2, 2),
          ("vgg16 conv5_3", 16, 512, 3, 512, 1, 2, 2))
BATCH = 64
SEED = 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import sa_conv_implicit as conv
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                      allow_tf32=False):
        for label, hw, ci, p, co, stride, pw, ps in LAYERS:
            x = torch.randn((BATCH, hw, hw, ci), generator=gen,
                            device="cuda").to(torch.bfloat16)
            f = torch.randn((p, p, ci, co), generator=gen,
                            device="cuda") * (p * p * ci) ** -0.5
            b = torch.randn((co,), generator=gen, device="cuda") * 0.1
            kw = dict(stride=stride, act="relu", pool_window=pw,
                      pool_stride=ps)
            before = conv.sa_conv_implicit.launches
            out = conv.sa_conv_implicit(x, f, b, **kw)
            torch.cuda.synchronize()
            if conv.sa_conv_implicit.launches != before + 1:
                raise AssertionError(f"{label}: not one launch")
            err = cs.allclose(f"{args.label} {label}", conv.sa_conv_implicit(
                x[:2].contiguous(), f, b, **kw).float(), conv.sa_conv_plain(
                x[:2].contiguous(), f, b, **kw).float(), cs.TOL_BF16)
            ms = cs.timed(lambda: conv.sa_conv_implicit(x, f, b, **kw))
            xc = x.permute(0, 3, 1, 2)
            fc = f.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            bc = b.to(torch.bfloat16)
            lib_ms = cs.timed(lambda: F.conv2d(xc, fc, bc, stride=stride))
            oh = (hw - p) // stride + 1
            flops = 2 * BATCH * oh * oh * co * p * p * ci
            nb = cs.nbytes(x, f, b, out)
            bound_ms, by = cs.bound(flops, nb, cs.PEAK_BF16_FLOPS)
            row = dict(layer=label, label=args.label, ms=ms, max_abs_err=err,
                       library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                       tflops=flops / ms / 1e9, over_library=ms / lib_ms)
            g = conv.conv_geometry(hw, hw, ci, p, p, co, stride=stride,
                                   pool_window=pw, pool_stride=ps,
                                   x_bytes=2)
            if getattr(g, "mb", 0):
                row.update(tile=f"{g.pixels}x{g.bco}",
                           slot_use=g.slot_use(BATCH),
                           ctas=g.ctas(BATCH, co),
                           waves=g.waves(BATCH, co))
            rows.append(row)
            print(f"{args.label:12s} {label:14s} {ms:8.4f} ms  F.conv2d "
                  f"{lib_ms:8.4f}  bound {bound_ms:7.4f} ({by})  "
                  f"{row['tflops']:6.1f} TFLOP/s  "
                  f"{row.get('tile', '-')} slot use "
                  f"{row.get('slot_use', float('nan')):.3f}", flush=True)
            del x, f, b, out, xc, fc
            torch.cuda.empty_cache()
    alex = [r for r in rows if r["layer"].startswith("alexnet")]
    result = dict(label=args.label, card=smi.strip(),
                  alexnet_ms=sum(r["ms"] for r in alex),
                  alexnet_library_ms=sum(r["library_ms"] for r in alex),
                  rows=rows)
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
