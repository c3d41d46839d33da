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


def _counted_fns():
    return (matmul_bias_act, conv2d, maxpool2d, attention)


def reset_counts() -> None:
    for fn in _counted_fns():
        fn.calls = 0


def counts() -> dict[str, int]:
    return {fn.__name__: fn.calls for fn in _counted_fns()}


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
    (the scale multiplies the accumulator, as in the kernel epilogue).

    ``w`` is first rounded to ``x``'s dtype, as the reference does (an
    fp32 ``w`` with bf16 ``x`` rounds to nearest even; int8 and bf16 stay
    exact), then both are widened to fp32: a product of two bf16 values is
    exact in fp32, so only the order of the sums differs from the
    kernels'.  The epilogue runs in fp32 and the result is rounded once to
    ``out_dtype`` (default ``x``'s)."""
    out_dtype = out_dtype or x.dtype
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    xf = x.to(torch.float32)
    wf = w.to(torch.float32)
    if xf.device.type == "meta":            # shapes only (schedule compile)
        acc = xf @ wf
    else:
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
    (valid for monotone activations — paper Sec. IV-D).  A bf16 max is
    exact; its act runs in fp32 and is rounded once, as the kernel does."""
    out = maxpool2d(x, window=window, stride=stride)
    if x.dtype == torch.bfloat16 and act != "none":
        return apply_act(out.to(torch.float32), act).to(x.dtype)
    return apply_act(out, act)


def repeat_kv(x: torch.Tensor, g: int) -> torch.Tensor:
    """(b, s, hkv, d) -> (b, s, hkv * g, d): query head h reads kv head
    h // g (GQA)."""
    return x if g == 1 else x.repeat_interleave(g, dim=2)


@_counted
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: float | None = None) -> torch.Tensor:
    """q: (b, sq, hq, d); k/v: (b, skv, hkv, d), hq % hkv == 0 (GQA) ->
    (b, sq, hq, d).  The whole (sq, skv) score matrix, fp32.

    Queries are aligned to the end of the keys (query i sits at position
    i + skv - sq, as in decode); a key is visible when ``kpos <= qpos``
    (causal) and ``kpos > qpos - window`` (window > 0); scores are capped
    as ``c * tanh(s / c)`` (softcap > 0); masked scores take -1e30.  The
    JAX package's banded and chunked variants compute this same function
    with less memory under XLA, so one version stands for all three."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          repeat_kv(k, g).to(torch.float32)) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p,
                       repeat_kv(v, g).to(torch.float32))
    return out.to(q.dtype)
