"""Pooling-&-activation unit — NHWC VALID maxpool then activation, as a
hand-written CUDA kernel (``csrc/pool_act.cu``) with its plain PyTorch
version (:func:`repro_torch.kernels.ref.maxpool_act`).

For a CPU tensor :func:`maxpool_act` runs the plain version; for a CUDA
tensor it launches the kernel on the current stream, or raises.  float32,
int8, uint8 and int32 maps are supported; integer maps take ``none`` or
``relu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.int8: 1, torch.uint8: 2, torch.int32: 3}


def maxpool_act(x: torch.Tensor, *, window: int = 2, stride: int = 2,
                act: str = "relu") -> torch.Tensor:
    """(N, H, W, C) -> (N, OH, OW, C): max over each window, then act."""
    if x.device.type == "cpu":
        return ref.maxpool_act(x, window=window, stride=stride, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"maxpool_act: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"maxpool_act: expected NHWC, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"maxpool_act: dtype {x.dtype} not supported")
    if x.dtype != torch.float32 and act not in ("none", "relu"):
        raise ValueError(f"maxpool_act: act {act!r} on an integer map")
    if not x.is_contiguous():
        raise ValueError("maxpool_act: x must be contiguous")
    n, h, w, c = x.shape
    if window < 1 or stride < 1 or h < window or w < window:
        raise ValueError(f"maxpool_act: window {window} stride {stride} on "
                         f"{(h, w)}")
    oh = (h - window) // stride + 1
    ow = (w - window) // stride + 1
    out = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("pool_act")
    err = lib.pool_act_launch(
        x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], n, h, w, c, window,
        stride, _build.act_code(act),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "maxpool_act")
    maxpool_act.launches += 1
    return out


maxpool_act.launches = 0
