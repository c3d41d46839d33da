"""The port's kernel API in one place, as ``repro.kernels.ops`` gathers the
JAX package's.

Each op has a hand-written CUDA kernel, launched for CUDA tensors, and a
plain PyTorch version (:mod:`repro_torch.kernels.ref`), which the wrappers
take for CPU tensors and the engine's ``"torch"`` backend runs.  The
selection lives in :mod:`repro_torch.core.engine`; this module only wires.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.conv2d import conv2d_im2col, conv2d_mpna
from repro_torch.kernels.pool_act import maxpool_act
from repro_torch.kernels.sa_conv import sa_conv_matmul
from repro_torch.kernels.sa_conv_implicit import sa_conv_implicit
from repro_torch.kernels.sa_fc import sa_fc_matmul

__all__ = [
    "flash_attention", "conv2d_mpna", "conv2d_im2col", "sa_conv_implicit",
    "maxpool_act", "sa_conv_matmul", "sa_fc_matmul", "ref",
]
