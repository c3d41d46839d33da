"""bf16 activations through the port's CNN kernels (SA-CONV implicit and
the pool) against the JAX package, on the CPU.

The reference's Pallas kernels compute in their input's dtype: an fp32
filter rounded to x's dtype (``w_tile.astype(patch.dtype)``), products
summed in fp32, scale, bias, the fused pool and act in fp32, the output
written as ``out_dtype`` (x's by default); the pool takes the max in x's
dtype.  The same numpy inputs from a seed go through
``repro.core.engine.Engine(backend="pallas", interpret=True)`` and through
the port's ``Engine(backend="kernels")``, whose wrappers take their plain
versions for CPU tensors.  Tolerance: the reference's own bf16 kernel
tolerance, 3e-2 (``tests/test_kernels.py``).  Inside the port, the plain
versions keep the kernels' bitwise rules: a bf16 call equals the fp32 call
on the widened operands, rounded once.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dataflow import PoolSpec as RPoolSpec
from repro.core.engine import Engine as REngine
from repro.core.quant import quantize as rquantize
from repro_torch.core.dataflow import PoolSpec
from repro_torch.core.engine import Engine
from repro_torch.core.quant import QTensor, quantize
from repro_torch.kernels import ref
from repro_torch.kernels.pool_act import maxpool_act
from repro_torch.kernels.sa_conv_implicit import (BF16_TILES, TILES,
                                                  column_strips,
                                                  conv_geometry,
                                                  sa_conv_implicit,
                                                  sa_conv_plain)

TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
JBF, TBF = jnp.bfloat16, torch.bfloat16


def _np(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _filters(ci, p, co, wdtype):
    """(reference filter, port filter) from one numpy draw: fp32 arrays,
    or int8 QTensors from each package's quantizer (bit for bit equal)."""
    f = _np(1, (p, p, ci, co), (p * p * ci) ** -0.5)
    if wdtype == "fp32":
        return jnp.asarray(f), torch.from_numpy(f)
    rq, tq = rquantize(jnp.asarray(f)), quantize(torch.from_numpy(f))
    np.testing.assert_array_equal(np.asarray(rq.q), tq.q.numpy())
    return rq, tq


#: (h, ci, p, co, stride, pad, pool): AlexNet's three filter shapes with
#: their 3/2 pools and VGG-16's 3x3 with its 2/2 pool, at small widths
LAYERS = [(35, 3, 11, 16, 4, 0, (3, 2)), (13, 8, 5, 24, 1, 2, (3, 2)),
          (16, 12, 3, 20, 1, 1, (2, 2)), (9, 16, 3, 8, 1, 1, None)]


@pytest.mark.parametrize("h,ci,p,co,stride,pad,pool", LAYERS)
@pytest.mark.parametrize("wdtype", ["fp32", "int8"])
@pytest.mark.parametrize("act", ["relu", "silu"])
def test_bf16_engine_conv2d_matches_reference_pallas(h, ci, p, co, stride,
                                                     pad, pool, wdtype, act):
    """relu fuses the pool into the conv epilogue; silu (not monotone)
    makes the planner decline, so the conv writes bf16 and the pool kernel
    runs on it."""
    x = _np(0, (2, h, h, ci))
    b = _np(2, (co,), 0.1)
    rf, tf = _filters(ci, p, co, wdtype)
    kw = dict(stride=stride, pad=pad, act=act)
    want = REngine(backend="pallas", interpret=True).conv2d(
        jnp.asarray(x, JBF), rf, jnp.asarray(b), name="c",
        pool=RPoolSpec(*pool) if pool else None, **kw)
    eng = Engine(backend="kernels")
    with eng.tracing() as tr:
        got = eng.conv2d(torch.from_numpy(x).to(TBF), tf, torch.from_numpy(b),
                         name="c", pool=PoolSpec(*pool) if pool else None,
                         **kw)
    assert got.dtype == TBF and want.dtype == JBF
    assert tr[0].dtype == "bfloat16"
    if pool:
        assert tr[0].conv_plan.fuse_pool == (act == "relu")
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL_BF16)


@pytest.mark.parametrize("window,stride", [(3, 2), (2, 2)])
@pytest.mark.parametrize("act", ["none", "relu", "silu"])
def test_bf16_engine_pool_matches_reference_pallas(window, stride, act):
    x = _np(0, (2, 13, 13, 24))
    want = REngine(backend="pallas", interpret=True).pool(
        jnp.asarray(x, JBF), window=window, stride=stride, act=act)
    got = Engine(backend="kernels").pool(torch.from_numpy(x).to(TBF),
                                         window=window, stride=stride,
                                         act=act)
    assert got.dtype == TBF
    if act == "silu":
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL_BF16)
    else:                   # a max, and relu on it, are exact in bf16
        np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("wdtype", ["fp32", "int8"])
@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("out", [TBF, torch.float32])
def test_bf16_plain_conv_equals_fp32_on_widened_operands(wdtype, window,
                                                          out):
    """The plain version, as the kernel: an fp32 filter rounded to bf16,
    the sums and the epilogue in fp32, one rounding at the end."""
    x = torch.from_numpy(_np(0, (3, 15, 15, 8))).to(TBF)
    f = torch.from_numpy(_np(1, (3, 3, 8, 16), 0.2))
    bias = torch.from_numpy(_np(2, (16,)))
    scale = None
    if wdtype == "int8":
        qt = quantize(f)
        f, scale, wide = qt.q, qt.scale, qt.q.float()
    else:
        wide = f.to(TBF).float()
    kw = dict(act="relu", pool_window=window,
              pool_stride=2 if window else 0, w_scale=scale)
    got = sa_conv_implicit(x, f, bias, out_dtype=out, **kw)
    assert got.dtype == out
    assert torch.equal(got, sa_conv_plain(x.float(), wide, bias,
                                          **kw).to(out))
    if window:
        conv = sa_conv_implicit(x, f, bias, act="relu", w_scale=scale,
                                out_dtype=out)
        assert torch.equal(got, maxpool_act(conv, window=3, stride=2,
                                            act="none"))


def test_bf16_plain_pool_rounds_its_act_once():
    """A bf16 max is exact; the act runs in fp32 and rounds once."""
    x = torch.from_numpy(_np(0, (2, 9, 9, 12))).to(TBF)
    for act in ("none", "relu", "silu", "gelu", "leaky_relu"):
        got = maxpool_act(x, window=3, stride=2, act=act)
        want = ref.apply_act(ref.maxpool2d(x.float(), window=3, stride=2),
                             act).to(TBF)
        assert got.dtype == TBF and torch.equal(got, want), act


def test_bf16_engine_conv2d_takes_qtensor_and_bf16_bias():
    """An int8 QTensor and a bf16 bias through the kernels backend: the
    scale and the bias widen exactly into the fp32 epilogue."""
    x = torch.from_numpy(_np(0, (1, 9, 9, 8))).to(TBF)
    qt = quantize(torch.from_numpy(_np(1, (3, 3, 8, 16), 0.2)))
    assert isinstance(qt, QTensor)
    b = torch.from_numpy(_np(2, (16,))).to(TBF)
    got = Engine(backend="kernels").conv2d(x, qt, b, act="relu")
    want = sa_conv_plain(x, qt.q, b.float(), act="relu", w_scale=qt.scale)
    assert torch.equal(got, want)


#: (h, ci, p, co, stride, pool window, pool stride): AlexNet's and
#: VGG-16's layers at full width on their padded inputs
FULL_LAYERS = [(227, 3, 11, 96, 4, 3, 2), (31, 96, 5, 256, 1, 3, 2),
               (15, 256, 3, 384, 1, 0, 0), (15, 384, 3, 384, 1, 0, 0),
               (15, 384, 3, 256, 1, 3, 2), (226, 3, 3, 64, 1, 0, 0),
               (226, 64, 3, 64, 1, 2, 2), (58, 256, 3, 256, 1, 2, 2),
               (16, 512, 3, 512, 1, 2, 2)]


@pytest.mark.parametrize("h,ci,p,co,stride,pw,ps", FULL_LAYERS)
def test_bf16_geometry_keeps_off_the_8x16_tile(h, ci, p, co, stride, pw,
                                               ps):
    """bf16 x runs the 8 x 8 and 6 x 16 tiles only (the 8 x 16 tile spills
    with widened pixels); the geometry is the layer's alone, and a bf16
    layer's shared memory fits where the fp32 one does."""
    assert set(BF16_TILES) < set(TILES)
    kw = dict(stride=stride, pool_window=pw, pool_stride=ps)
    g16 = conv_geometry(h, h, ci, p, p, co, x_bytes=2, **kw)
    assert (g16.tpx, g16.tco, g16.groups) in BF16_TILES
    g32 = conv_geometry(h, h, ci, p, p, co, **kw)
    assert g16.out_h == g32.out_h and g16.out_w == g32.out_w
    assert len(column_strips(h, h, ci, p, p, co, x_bytes=2, **kw)) == \
        len(column_strips(h, h, ci, p, p, co, **kw)) == 1
