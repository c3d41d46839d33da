"""Plain PyTorch versions of the kernels' functions.

They are the ground truth the CUDA kernels are held against on the card,
what the kernel wrappers run for CPU tensors, and the ``"torch"`` backend of
:class:`~repro_torch.core.engine.Engine` (the counterpart of the JAX
package's XLA path).  Layouts are the JAX package's: NHWC activations,
HWIO filters, ``(k, n)`` weights.

Every sample is computed on its own (one row of a matmul, one image of a
convolution), so an output never depends on the batch it rides in — the
same invariant the kernels keep, which makes batched results bitwise equal
to unbatched ones on every device.  Each counted function carries a
``calls`` integer, so a run can show that the kernels, and not these, ran.

On CUDA, fp32 means fp32: convolutions run with TF32 off here, and matmuls
rely on PyTorch's default ``torch.backends.cuda.matmul.allow_tf32 = False``
(which ``chip_smoke.py`` asserts).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def _counted(fn):
    """Count the calls that compute (shape-only runs on ``meta`` tensors,
    as schedule compilation makes, do not count)."""
    @functools.wraps(fn)
    def wrapper(x, *args, **kwargs):
        if x.device.type != "meta":
            wrapper.calls += 1
        return fn(x, *args, **kwargs)
    wrapper.calls = 0
    return wrapper


def reset_counts() -> None:
    for fn in (matmul_bias_act, conv2d, maxpool2d):
        fn.calls = 0


def counts() -> dict[str, int]:
    return {fn.__name__: fn.calls for fn in (matmul_bias_act, conv2d,
                                             maxpool2d)}


def apply_act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "none":
        return x
    if act == "relu":
        return torch.relu(x)
    if act == "leaky_relu":
        return F.leaky_relu(x, negative_slope=0.1)
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default form
    raise ValueError(f"unknown act {act!r}")


@_counted
def matmul_bias_act(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor | None = None, act: str = "none", *,
                    out_dtype=None, w_scale: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """``act((x @ w) * w_scale + b)`` for ``x`` (m, k) and ``w`` (k, n),
    fp32 accumulation; ``w`` may be int8 with (1, n) per-column scales
    (the scale multiplies the accumulator, as in the kernel epilogue)."""
    out_dtype = out_dtype or x.dtype
    xf = x.to(torch.float32)
    wf = w.to(torch.float32)
    # one row at a time, each from its own allocation: a BLAS call's
    # blocking (and so its rounding) may depend on m and on alignment
    acc = torch.cat([xf[i:i + 1].clone() @ wf
                     for i in range(xf.shape[0])]) if xf.shape[0] else \
        xf.new_empty((0, wf.shape[1]))
    if b is None and act == "none" and w_scale is None:
        return acc.to(out_dtype)
    if w_scale is not None:
        acc = acc * w_scale.reshape(1, -1).to(torch.float32)
    if b is not None:
        acc = acc + b.to(torch.float32)
    return apply_act(acc, act).to(out_dtype)


@_counted
def conv2d(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
           out_dtype=None) -> torch.Tensor:
    """NHWC x HWIO -> NHWC VALID convolution with fp32 accumulation."""
    fw = f.to(torch.float32).permute(3, 2, 0, 1).contiguous()   # OIHW
    outs = []
    for i in range(x.shape[0]):
        xi = x[i:i + 1].to(torch.float32).permute(0, 3, 1, 2).contiguous()
        if xi.is_cuda:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                o = F.conv2d(xi, fw, stride=stride)
        else:
            o = F.conv2d(xi, fw, stride=stride)
        outs.append(o.permute(0, 2, 3, 1))
    return torch.cat(outs).to(out_dtype or x.dtype)


@_counted
def maxpool2d(x: torch.Tensor, *, window: int = 2,
              stride: int = 2) -> torch.Tensor:
    """NHWC VALID maxpool, any dtype: the max of ``window**2`` shifted
    strided views (no identity element is ever needed)."""
    _, h, w, _ = x.shape
    oh = (h - window) // stride + 1
    ow = (w - window) // stride + 1
    out = None
    for dp in range(window):
        for dq in range(window):
            sl = x[:, dp:dp + (oh - 1) * stride + 1:stride,
                   dq:dq + (ow - 1) * stride + 1:stride, :]
            out = sl if out is None else torch.maximum(out, sl)
    return out.contiguous()


def maxpool_act(x: torch.Tensor, *, window: int = 2, stride: int = 2,
                act: str = "relu") -> torch.Tensor:
    """Pooling-&-activation unit: the activation applied AFTER the max
    (valid for monotone activations — paper Sec. IV-D)."""
    return apply_act(maxpool2d(x, window=window, stride=stride), act)
