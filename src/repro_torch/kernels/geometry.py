"""Launch geometry of the planner's tiles as inspectable data.

Every ``pallas_call`` of the TPU kernels (SA-CONV, SA-FC) that the plans
in :mod:`repro_torch.core.dataflow` are written for is fully determined by
a grid, a set of block specs (block shape + grid->block index map), the
dimension semantics, and the fp32 scratch blocks.  This module computes
that geometry as plain data -- :class:`KernelGeometry` -- from a plan's
tiles, so the static checks of :mod:`repro_torch.analysis` can re-derive
grid coverage, VMEM residency and write-race freedom of the *plans*
without executing anything: the index maps are ordinary Python callables
over integer grid coordinates, so "symbolic evaluation over the grid" is
a nested loop.

This is the tiling the plans describe -- the TPU launch the planner is
written for -- not what the port's CUDA kernels launch.  Those pick their
own tiles, from the op's shape alone:
:func:`repro_torch.kernels.sa_fc.fc_launch`,
:func:`repro_torch.kernels.sa_conv.gemm_geometry`,
:func:`repro_torch.kernels.sa_conv_implicit.conv_geometry` (with
``conv_tiles`` and ``column_strips``),
:func:`repro_torch.kernels.attention.flash_geometry` and
:func:`repro_torch.kernels.pool_act.pool_geometry`;
:mod:`repro_torch.analysis.launch` checks those.  Mind the name clash:
``sa_conv_implicit.conv_geometry`` is the CUDA tiling and takes other
arguments than :func:`conv_geometry` here.

The normalization rules are the TPU kernels' (``sa_fc_matmul`` batch-tile
rounding, ``sa_conv_implicit`` pooled output blocks); a plan whose tiles
disagree with the normalized kernel tiles is a planner/kernel drift bug,
and the coverage pass exists to flag it.
"""
from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass

from repro_torch.core.dataflow import ConvPlan

LANE = 128
SUBLANE = 16

#: grid coordinates -> block indices, one int per array dimension
IndexMap = Callable[..., tuple[int, ...]]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class BlockSpecInfo:
    """One operand's block spec: named, so verifier diagnostics can say
    *which* operand's coverage or residency is wrong."""
    name: str
    block: tuple[int, ...]
    index_map: IndexMap

    @property
    def elems(self) -> int:
        return math.prod(self.block)


@dataclass(frozen=True)
class KernelGeometry:
    """The complete launch geometry of one kernel invocation.

    ``out_shape`` is the (padded) array the kernel writes; ``scratch``
    lists the fp32 VMEM scratch blocks (the accumulator SPMs).  Grid
    dimensions marked ``"arbitrary"`` in ``dimension_semantics`` execute
    sequentially (reduction-carrying); ``"parallel"`` dimensions may be
    reordered/parallelized by the compiler, which is exactly why no two
    of their steps may write the same output block."""
    kernel: str                         # 'sa_fc' | 'sa_conv' | 'sa_conv_implicit'
    grid: tuple[int, ...]
    dimension_semantics: tuple[str, ...]
    inputs: tuple[BlockSpecInfo, ...]
    out: BlockSpecInfo
    out_shape: tuple[int, ...]
    scratch: tuple[tuple[int, ...], ...]

    def input(self, name: str) -> BlockSpecInfo:
        for spec in self.inputs:
            if spec.name == name:
                return spec
        raise KeyError(f"{self.kernel} geometry has no input {name!r}; "
                       f"has {[s.name for s in self.inputs]}")

    @property
    def points(self) -> int:
        """Total grid steps (the verifier enumerates them)."""
        return math.prod(self.grid)


# -- index maps (module-level so geometries are comparable/documented) ------

def _im_x_mk(i: int, j: int, kk: int) -> tuple[int, int]:
    return (i, kk)


def _im_w_kn(i: int, j: int, kk: int) -> tuple[int, int]:
    return (kk, j)


def _im_row_n(i: int, j: int, kk: int) -> tuple[int, int]:
    return (0, j)


def _im_out_mn(i: int, j: int, kk: int) -> tuple[int, int]:
    return (i, j)


def _im_conv_x(n_: int, j: int, k_: int) -> tuple[int, int, int, int]:
    return (n_, 0, 0, k_)


def _im_conv_f(n_: int, j: int, k_: int) -> tuple[int, int, int, int]:
    return (0, 0, k_, j)


def _im_conv_row(n_: int, j: int, k_: int) -> tuple[int, int]:
    return (0, j)


def _im_conv_out(n_: int, j: int, k_: int) -> tuple[int, int, int, int]:
    return (n_, 0, 0, j)


# -- geometry functions -----------------------------------------------------

def fc_normalize(b: int, n: int, k: int, *, bb: int | None,
                 bn: int, bk: int) -> tuple[int, int, int, int]:
    """``sa_fc_matmul``'s historical tile normalization: padded batch
    ``bp``, and the executed ``(bb, bn, bk)``.  ``bb=None`` keeps the
    whole padded batch resident."""
    bp = max(SUBLANE, _round_up(b, SUBLANE))
    if bb is None:
        bb = bp
    bb = max(SUBLANE, min(_round_up(bb, SUBLANE), bp))
    bn = min(bn, _round_up(n, LANE))
    bk = min(bk, _round_up(k, LANE))
    return bp, bb, bn, bk


def fc_geometry(b: int, n: int, k: int, *, bb: int | None = None,
                bn: int = 512, bk: int = 512,
                has_scale: bool = False,
                has_bias: bool = False) -> KernelGeometry:
    """Launch geometry of the TPU kernel ``sa_fc_matmul`` for a
    ``(b,k) @ (k,n)`` op — grid ``(batch-tiles, n-tiles, k-tiles)``,
    K innermost-sequential so the ``(bb, bn)`` accumulator never spills."""
    bp, bb, bn, bk = fc_normalize(b, n, k, bb=bb, bn=bn, bk=bk)
    gb, gn, gk = _cdiv(bp, bb), _cdiv(n, bn), _cdiv(k, bk)
    inputs = [BlockSpecInfo("x", (bb, bk), _im_x_mk),
              BlockSpecInfo("w", (bk, bn), _im_w_kn)]
    if has_scale:
        inputs.append(BlockSpecInfo("scale", (1, bn), _im_row_n))
    if has_bias:
        inputs.append(BlockSpecInfo("bias", (1, bn), _im_row_n))
    return KernelGeometry(
        kernel="sa_fc", grid=(gb, gn, gk),
        dimension_semantics=("parallel", "parallel", "arbitrary"),
        inputs=tuple(inputs),
        out=BlockSpecInfo("out", (bb, bn), _im_out_mn),
        out_shape=(gb * bb, gn * bn),
        scratch=((bb, bn),))


def matmul_geometry(m: int, n: int, k: int, *, bm: int, bn: int, bk: int,
                    has_scale: bool = False,
                    has_bias: bool = False) -> KernelGeometry:
    """Launch geometry of the TPU kernel ``sa_conv_matmul``
    for an ``(m,k) @ (k,n)`` op — output-stationary ``(m, n, k)`` grid,
    K innermost-sequential."""
    gm, gn, gk = _cdiv(m, bm), _cdiv(n, bn), _cdiv(k, bk)
    inputs = [BlockSpecInfo("x", (bm, bk), _im_x_mk),
              BlockSpecInfo("w", (bk, bn), _im_w_kn)]
    if has_scale:
        inputs.append(BlockSpecInfo("scale", (1, bn), _im_row_n))
    if has_bias:
        inputs.append(BlockSpecInfo("bias", (1, bn), _im_row_n))
    return KernelGeometry(
        kernel="sa_conv", grid=(gm, gn, gk),
        dimension_semantics=("parallel", "parallel", "arbitrary"),
        inputs=tuple(inputs),
        out=BlockSpecInfo("out", (bm, bn), _im_out_mn),
        out_shape=(gm * bm, gn * bn),
        scratch=((bm, bn),))


def conv_geometry(batch: int, h: int, w: int, ci: int,
                  p: int, q: int, co: int, *, stride: int,
                  plan: ConvPlan,
                  has_scale: bool = False,
                  has_bias: bool = False) -> KernelGeometry:
    """Launch geometry of
    the TPU kernel ``sa_conv_implicit`` — grid
    ``(batch, co-tiles, ci-tiles)`` with the input-channel contraction
    innermost-sequential; the output block is the *pooled* map when the
    plan committed the fused maxpool flush epilogue."""
    oh = (h - p) // stride + 1
    ow = (w - q) // stride + 1
    ooh, oow = oh, ow
    if plan.fuse_pool:
        ooh = (oh - plan.pool_window) // plan.pool_stride + 1
        oow = (ow - plan.pool_window) // plan.pool_stride + 1
    bi, bj = plan.bi, plan.bj
    gi, gj = _cdiv(ci, bi), _cdiv(co, bj)
    inputs = [BlockSpecInfo("x", (1, h, w, bi), _im_conv_x),
              BlockSpecInfo("w", (p, q, bi, bj), _im_conv_f)]
    if has_scale:
        inputs.append(BlockSpecInfo("scale", (1, bj), _im_conv_row))
    if has_bias:
        inputs.append(BlockSpecInfo("bias", (1, bj), _im_conv_row))
    return KernelGeometry(
        kernel="sa_conv_implicit", grid=(batch, gj, gi),
        dimension_semantics=("parallel", "parallel", "arbitrary"),
        inputs=tuple(inputs),
        out=BlockSpecInfo("out", (1, ooh, oow, bj), _im_conv_out),
        out_shape=(batch, ooh, oow, gj * bj),
        scratch=((oh * ow, bj),))
