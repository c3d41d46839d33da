"""Plain PyTorch VGG-style forward pass: the reference the CNN serving cells
are judged by.  It imports nothing of the program, in float32 with TF32
off unless a control asks for TF32.

The network is read from a configuration file's table (``conv_blocks``:
(convolutions, channels) per block, 3x3 "same" convolutions with bias and
ReLU, each block closed by a 2x2/2 max pool; ``fc``: the widths of the
fully connected layers, ReLU on all but the last).  Departures from the
published VGG-16 (arXiv:1409.1556, configuration D): images arrive NHWC
and the last feature map is flattened in (h, w, c) order, so fc1's rows
are a fixed permutation of the published (c, h, w) rows, which random
weights do not tell apart; no dropout and no softmax (inference, logits).

Weights (the benchmark's layout, the program's too): per convolution
``{"f": (k, k, ci, co), "b": (co,)}``, per FC ``{"w": (fan_in, fan_out),
"b": (fan_out,)}``, in order; an empty entry (a pool's, in the program's
layout) is skipped.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuBLAS and cuDNN on (the control) or off (the reference)
    for the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10 explicit mantissa bits (to nearest, ties
    away): what a TF32 product reads of an fp32 operand.  On the CPU, which
    has no TF32, the control rounds its operands with this."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def forward(cfg: dict, layers: list, images: torch.Tensor, *,
            control: bool = False) -> torch.Tensor:
    """Logits (n, classes) of NHWC float32 ``images``.  ``control`` computes
    the products in TF32 (on the card through cuBLAS and cuDNN; on the CPU
    by rounding every product's operands with :func:`round_tf32`)."""
    emulate = control and images.device.type != "cuda"
    rnd = round_tf32 if emulate else (lambda t: t)
    it = iter([p for p in layers if p])
    with torch.no_grad(), tf32(control):
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        for reps, _ in cfg["conv_blocks"]:
            for _ in range(reps):
                p = next(it)
                f = p["f"].to(torch.float32).permute(3, 2, 0, 1)
                x = F.conv2d(rnd(x), rnd(f), p["b"].to(torch.float32),
                             padding=cfg["kernel"] // 2)
                x = torch.relu(x)
            x = F.max_pool2d(x, cfg["pool"], cfg["pool"])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for i, _ in enumerate(cfg["fc"]):
            p = next(it)
            x = rnd(x) @ rnd(p["w"].to(torch.float32)) \
                + p["b"].to(torch.float32)
            if i < len(cfg["fc"]) - 1:
                x = torch.relu(x)
    return x
