"""SA-CONV GEMM — the output-stationary tiled matmul of the compute-bound
regime, as a hand-written CUDA kernel (``csrc/sa_conv.cu``) with its plain
PyTorch version.

``sa_conv_matmul`` computes ``act((x @ w) * w_scale + bias)`` for ``x``
(m, k) fp32 and ``w`` (k, n) fp32, bf16 or int8 (int8 with a (1, n) or
(n,) per-column ``w_scale``), fp32 accumulation, the epilogue once per
output.  For a CPU tensor it runs :func:`sa_conv_matmul_plain`; for a CUDA
tensor it launches the kernel on the current stream, or raises.  The kernel
picks its own tiles (128 x 128 outputs per CTA); the planner's TPU tiles do
not reach it.  Ragged m, n and k are masked inside the kernel: no padded
copies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.sa_fc import W_KINDS, check_operands


def sa_conv_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor | None = None, *,
                         act: str = "none",
                         w_scale: torch.Tensor | None = None,
                         out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return ref.matmul_bias_act(x, w, bias, act=act, out_dtype=out_dtype,
                               w_scale=w_scale)


def sa_conv_matmul(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None, *, act: str = "none",
                   w_scale: torch.Tensor | None = None,
                   out_dtype=None) -> torch.Tensor:
    """(m, k) @ (k, n) on the SA-CONV GEMM kernel, fused scale + bias +
    act."""
    if x.device.type == "cpu":
        return sa_conv_matmul_plain(x, w, bias, act=act, w_scale=w_scale,
                                    out_dtype=out_dtype)
    w_scale = check_operands("sa_conv_matmul", x, w, bias, w_scale,
                             out_dtype)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("sa_conv")
    err = lib.sa_conv_launch(
        x.data_ptr(), w.data_ptr(), W_KINDS[w.dtype],
        w_scale.data_ptr() if w_scale is not None else None,
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        m, k, n, _build.act_code(act),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "sa_conv_matmul")
    sa_conv_matmul.launches += 1
    return out


sa_conv_matmul.launches = 0
