"""SA-FC — the batch-amortized weight stream, as a hand-written CUDA kernel
(``csrc/sa_fc.cu``) with its plain PyTorch version.

``sa_fc_matmul`` computes ``act((x @ w) * w_scale + bias)`` for ``x`` (b, k)
fp32 and ``w`` (k, n) fp32, bf16 or int8 (int8 with a (1, n) or (n,)
per-column ``w_scale``).  For a CPU tensor it runs :func:`sa_fc_plain`; for
a CUDA tensor it launches the kernel on the current stream, or raises.
Ragged k, n and b are masked inside the kernel: no padded copies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

#: weight types of the GEMM kernels and their codes
W_KINDS = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}
#: batch tiles the kernel is instantiated for
_ROW_TILES = (1, 2, 4, 8, 16, 32, 64)


def sa_fc_plain(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None, *, act: str = "none",
                w_scale: torch.Tensor | None = None,
                out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return ref.matmul_bias_act(x, w, bias, act=act, out_dtype=out_dtype,
                               w_scale=w_scale)


def check_operands(name: str, x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None, w_scale: torch.Tensor | None,
                   out_dtype) -> torch.Tensor | None:
    """Refuse what the GEMM kernels (SA-FC and SA-CONV) do not take: a
    device other than CUDA, shapes that do not chain, activations other
    than fp32, weights other than fp32, bf16 or int8, an output type other
    than fp32, a scale or bias of another length or type, operands on
    different devices or not contiguous.  Returns ``w_scale`` flattened."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32, got {x.dtype}")
    if w.dtype not in W_KINDS:
        raise TypeError(f"{name}: w dtype {w.dtype} not supported")
    if out_dtype not in (None, torch.float32):
        raise TypeError(f"{name}: the kernel writes float32")
    n = w.shape[1]
    if w_scale is not None:
        w_scale = w_scale.reshape(-1)
    for what, t in (("w_scale", w_scale), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.numel() != n:
            raise ValueError(f"{name}: {what} must be float32 with "
                             f"{n} elements")
    tensors = [x, w] + [t for t in (w_scale, bias) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    return w_scale


def row_tile(b: int) -> int:
    """The kernel's batch tile for ``b`` rows: the smallest instantiated
    tile that holds them, at most 64 (larger batches loop over tiles)."""
    return next(t for t in _ROW_TILES if t >= min(b, 64))


def sa_fc_matmul(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None, *, act: str = "none",
                 w_scale: torch.Tensor | None = None,
                 out_dtype=None) -> torch.Tensor:
    """(b, k) @ (k, n) on the SA-FC kernel, fused scale + bias + act."""
    if x.device.type == "cpu":
        return sa_fc_plain(x, w, bias, act=act, w_scale=w_scale,
                           out_dtype=out_dtype)
    w_scale = check_operands("sa_fc_matmul", x, w, bias, w_scale, out_dtype)
    b, k = x.shape
    n = w.shape[1]
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("sa_fc")
    err = lib.sa_fc_launch(
        x.data_ptr(), w.data_ptr(), W_KINDS[w.dtype],
        w_scale.data_ptr() if w_scale is not None else None,
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        b, k, n, row_tile(b), _build.act_code(act),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "sa_fc_matmul")
    sa_fc_matmul.launches += 1
    return out


sa_fc_matmul.launches = 0
