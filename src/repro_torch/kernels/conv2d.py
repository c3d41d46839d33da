"""CONV layers as GEMMs on the SA-CONV array (paper Fig. 5 loop nest): the
(I x P x Q) contraction on the array's rows, the J output channels on its
columns.

The production path is the implicit-GEMM kernel
(:mod:`repro_torch.kernels.sa_conv_implicit`), which gathers each patch
inside the kernel, so no im2col matrix ever reaches device memory; dispatch,
planning and tracing live in :meth:`repro_torch.core.engine.Engine.conv2d`.
This module keeps the JAX package's two entry points of
``repro.kernels.conv2d``:

* :func:`conv2d_mpna` — a shim over the current engine's ``conv2d`` on the
  kernels backend, so old call sites run under the ambient engine's policy,
  trace and schedule.
* :func:`conv2d_im2col` — the materialised-im2col path, kept only as a
  reference point for benchmarks: it writes the (N*OH*OW, I*P*Q) patch
  matrix to memory, then multiplies it on the SA-CONV GEMM kernel
  (:func:`repro_torch.kernels.sa_conv.sa_conv_matmul`).  No model uses it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sa_conv import sa_conv_matmul


def conv2d_mpna(x: torch.Tensor, f, bias: torch.Tensor | None = None, *,
                stride: int = 1, act: str = "none") -> torch.Tensor:
    """``current().conv2d(...)`` on the kernels backend.

    x: (N, H, W, I); f: (P, Q, I, J) (or a ``QTensor``) -> (N, OH, OW, J),
    VALID.  Runs the implicit-GEMM SA-CONV kernel under the ambient
    engine's policy, trace and schedule; prefer :meth:`Engine.conv2d`."""
    from repro_torch.core import engine
    eng = engine.current().with_(backend="kernels")
    return eng.conv2d(x, f, bias, stride=stride, act=act, name="conv2d_mpna")


def im2col(x: torch.Tensor, p: int, q: int, stride: int) -> torch.Tensor:
    """The (N*OH*OW, I*P*Q) patch matrix of NHWC ``x`` for a VALID (P, Q)
    window at ``stride``, features ordered (I, P, Q) as the JAX package's
    ``conv_general_dilated_patches`` orders them: one strided view of x,
    copied once."""
    n, h, w, i = x.shape
    oh, ow = (h - p) // stride + 1, (w - q) // stride + 1
    sn, sh, sw, sc = x.stride()
    view = x.as_strided((n, oh, ow, i, p, q),
                        (sn, sh * stride, sw * stride, sc, sh, sw))
    return view.reshape(n * oh * ow, i * p * q)


def conv2d_im2col(x: torch.Tensor, f: torch.Tensor,
                  bias: torch.Tensor | None = None, *, stride: int = 1,
                  act: str = "none") -> torch.Tensor:
    """Materialised-im2col CONV — a benchmark reference only.

    x: (N, H, W, I); f: (P, Q, I, J) -> (N, OH, OW, J), VALID: the patch
    matrix (a kernel-area-times blow-up of x) times f transposed to (I, P,
    Q, J) rows, with bias and activation in the GEMM's epilogue."""
    n, h, w, i = x.shape
    p, q, i2, j = f.shape
    if i != i2:
        raise ValueError(f"conv2d_im2col: input {tuple(x.shape)} vs filter "
                         f"{tuple(f.shape)}")
    oh, ow = (h - p) // stride + 1, (w - q) // stride + 1
    lhs = im2col(x, p, q, stride)
    rhs = f.permute(2, 0, 1, 3).reshape(i * p * q, j)
    out = sa_conv_matmul(lhs, rhs, bias, act=act)
    return out.reshape(n, oh, ow, j)
