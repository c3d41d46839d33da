"""SA-CONV — the direct (implicit-GEMM) convolution with its fused pool
epilogue, as a hand-written CUDA kernel (``csrc/sa_conv_implicit.cu``) with
its plain PyTorch version.

``sa_conv_implicit`` computes an NHWC x HWIO VALID convolution with stride on
an input that already carries its zero padding, then ``* w_scale + bias``
and the activation; with a pool (``pool_window`` > 0) it emits
``act(maxpool(conv * w_scale + bias))`` directly.  For a CPU tensor it runs
:func:`sa_conv_plain`; for a CUDA tensor it launches the kernel on the
current stream, or raises.

The band geometry the kernel runs (:func:`conv_geometry`) is chosen here,
from the layer's shape alone — never from the batch — so it can be tested
on the CPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build, ref

_F_KINDS = {torch.float32: 0, torch.int8: 1}

THREADS = 256
TPX = 8                         # output pixels per thread
TCO = 8                         # output channels per thread
#: shared-memory budget of one channel chunk's staging (input rows + filter)
STAGE_BYTES = 96 * 1024
#: the most dynamic shared memory a Hopper CTA may opt into
SMEM_MAX = 232448


@dataclass(frozen=True)
class ConvGeometry:
    """One launch's band decomposition (all counts, no pointers)."""
    groups: int                 # output-channel groups of 8: BCO = 8 * groups
    bco: int                    # output channels per CTA
    pixels: int                 # output-pixel capacity of a CTA
    pool_window: int            # 1 when no pool is fused
    pool_stride: int
    out_h: int                  # emitted map (pooled or conv)
    out_w: int
    rows: int                   # emitted rows per band
    bands: int
    conv_rows: int              # conv rows a full band computes
    rin: int                    # staged input rows of a full band
    bci: int                    # input channels per staged chunk
    smem_bytes: int


def conv_geometry(h: int, w: int, ci: int, p: int, q: int, co: int, *,
                  stride: int = 1, pool_window: int = 0,
                  pool_stride: int = 0) -> ConvGeometry:
    """Pick the CTA shape and band height for a conv on a padded (h, w, ci)
    input.  A CTA holds 2048 outputs (256 threads x 8 pixels x 8 channels)
    as either 32 channels x 512 pixels or 64 x 256; the choice with the
    fewest thread slots wins.  A band is a whole number of emitted rows at
    full width, so no pool window is split across CTAs."""
    oh = (h - p) // stride + 1
    ow = (w - q) // stride + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"conv output is empty: {(h, w)} * {(p, q)} "
                         f"stride {stride}")
    pw, ps = (pool_window, pool_stride or pool_window) if pool_window \
        else (1, 1)
    poh = (oh - pw) // ps + 1
    pow_ = (ow - pw) // ps + 1
    best = None
    for groups in (4, 8):
        bco = TCO * groups
        cap = THREADS // groups * TPX
        rows_max = cap // ow
        if rows_max < pw:
            continue
        pr = min(poh, (rows_max - pw) // ps + 1)
        bands = math.ceil(poh / pr)
        pr = math.ceil(poh / bands)
        cost = bands * math.ceil(co / bco) * cap * bco
        if best is None or cost < best[0]:
            best = (cost, groups, bco, cap, pr, bands)
    if best is None:
        raise NotImplementedError(
            f"sa_conv_implicit: an output row of {ow} pixels does not fit "
            f"one CTA ({THREADS // 4 * TPX} pixels) with a {pw}-row window")
    _, groups, bco, cap, pr, bands = best
    conv_rows = (pr - 1) * ps + pw
    rin = (conv_rows - 1) * stride + p
    wrow = stride * math.ceil(w / stride)
    per_ci = rin * wrow + p * q * bco
    bci = max(1, min(ci, STAGE_BYTES // (4 * per_ci)))
    stage = 4 * (-(-bci * rin * wrow // 4) * 4 + p * q * bci * bco)
    epilogue = 4 * conv_rows * ow * (bco + 1)
    smem = max(stage, epilogue)
    if smem > SMEM_MAX:
        raise NotImplementedError(
            f"sa_conv_implicit: one input channel of a band needs {smem} "
            f"bytes of shared memory (> {SMEM_MAX})")
    return ConvGeometry(groups, bco, cap, pw, ps, poh, pow_, pr, bands,
                        conv_rows, rin, bci, smem)


def sa_conv_plain(x: torch.Tensor, f: torch.Tensor,
                  bias: torch.Tensor | None = None, *, stride: int = 1,
                  act: str = "none", pool_window: int = 0,
                  pool_stride: int = 0, w_scale: torch.Tensor | None = None,
                  out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 conv, then scale, bias,
    [maxpool,] act — the epilogue's order of operations."""
    out = ref.conv2d(x, f, stride=stride, out_dtype=torch.float32)
    if w_scale is not None:
        out = out * w_scale.reshape(-1).to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    if pool_window:
        out = ref.maxpool2d(out, window=pool_window,
                            stride=pool_stride or pool_window)
    return ref.apply_act(out, act).to(out_dtype or x.dtype)


def sa_conv_implicit(x: torch.Tensor, f: torch.Tensor,
                     bias: torch.Tensor | None = None, *, stride: int = 1,
                     act: str = "none", pool_window: int = 0,
                     pool_stride: int = 0,
                     w_scale: torch.Tensor | None = None,
                     out_dtype=None) -> torch.Tensor:
    """x (batch, h, w, ci) fp32, padded; f (p, q, ci, co) fp32 or int8 ->
    (batch, oh, ow, co), or the pooled (batch, poh, pow, co)."""
    if x.device.type == "cpu":
        return sa_conv_plain(x, f, bias, stride=stride, act=act,
                             pool_window=pool_window,
                             pool_stride=pool_stride, w_scale=w_scale,
                             out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"sa_conv_implicit: unsupported device {x.device}")
    if x.dim() != 4 or f.dim() != 4 or x.shape[3] != f.shape[2]:
        raise ValueError(f"sa_conv_implicit: shapes {tuple(x.shape)} * "
                         f"{tuple(f.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"sa_conv_implicit: x must be float32, got {x.dtype}")
    if f.dtype not in _F_KINDS:
        raise TypeError(f"sa_conv_implicit: f dtype {f.dtype} not supported")
    if out_dtype not in (None, torch.float32):
        raise TypeError("sa_conv_implicit: the kernel writes float32")
    batch, h, w, ci = x.shape
    p, q, _, co = f.shape
    if w_scale is not None:
        w_scale = w_scale.reshape(-1)
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.numel() != co):
            raise ValueError(f"sa_conv_implicit: {name} must be float32 "
                             f"with {co} elements")
    tensors = [x, f] + [t for t in (w_scale, bias) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("sa_conv_implicit: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sa_conv_implicit: operands must be contiguous")
    g = conv_geometry(h, w, ci, p, q, co, stride=stride,
                      pool_window=pool_window, pool_stride=pool_stride)
    out = torch.empty((batch, g.out_h, g.out_w, co), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("sa_conv_implicit")
    err = lib.sa_conv_implicit_launch(
        x.data_ptr(), f.data_ptr(), _F_KINDS[f.dtype],
        w_scale.data_ptr() if w_scale is not None else None,
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        batch, h, w, ci, p, q, co, stride, g.pool_window, g.pool_stride,
        g.rows, g.bands, g.bci, g.rin, g.groups, _build.act_code(act),
        g.smem_bytes, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "sa_conv_implicit")
    sa_conv_implicit.launches += 1
    return out


sa_conv_implicit.launches = 0
