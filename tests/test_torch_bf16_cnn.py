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
from repro_torch.kernels.sa_conv_implicit import (MAX_SEGMENTS, SMEM_MAX,
                                                  TC_STAGES, TC_TILES,
                                                  column_strips,
                                                  conv_geometry, conv_tiles,
                                                  sa_conv_implicit,
                                                  sa_conv_plain,
                                                  widened_bound)

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
def test_bf16_tensor_core_geometry_covers_each_layer(h, ci, p, co, stride,
                                                     pw, ps):
    """bf16 x runs a tensor-core tile (256 x 128 or 512 x 64): at AlexNet's
    and VGG-16's full widths every emitted output is computed by one CTA
    that holds its whole pool window (every conv pixel once without a
    pool), the tile's ring, tables and parked fp32 tile fit shared memory,
    one strip covers the width (no column strips: 5 and 13 launches a
    forward), and the tiling does not depend on the batch."""
    kw = dict(stride=stride, pool_window=pw, pool_stride=ps)
    g = conv_geometry(h, h, ci, p, p, co, x_bytes=2, **kw)
    assert (g.mb, g.bco) in TC_TILES and g.pixels == 128 * g.mb
    assert (g.tpx, g.tco, g.groups, g.cpg, g.rin, g.ng) == (0,) * 6
    ring = TC_STAGES[g.mb] * 64 * 2 * (g.pixels + g.bco)
    assert g.pixels * (g.bco + 4) * 4 <= ring < g.smem_bytes <= SMEM_MAX
    assert len(column_strips(h, h, ci, p, p, co, x_bytes=2, **kw)) == 1
    g32 = conv_geometry(h, h, ci, p, p, co, **kw)
    assert (g.conv_h, g.conv_w, g.out_h, g.out_w) == \
        (g32.conv_h, g32.conv_w, g32.out_h, g32.out_w)
    for batch in (1, 2, 3):
        computed = np.zeros((batch, g.conv_h, g.conv_w), np.int32)
        emitted = np.zeros((batch, g.out_h, g.out_w), np.int32)
        for tile in range(g.pixel_tiles(batch)):
            segs = conv_tiles(g, batch, tile)
            assert sum(hi - lo for _, _, _, lo, hi, _, _ in segs) <= g.pixels
            if g.bands:
                assert 1 <= len(segs) <= MAX_SEGMENTS
            for img, r0, nr, lo, hi, pr0, npr in segs:
                block = computed[img, r0:r0 + nr].reshape(-1)
                block[lo:hi] += 1
                computed[img, r0:r0 + nr] = block.reshape(nr, g.conv_w)
                if g.bands:
                    assert pr0 * g.pool_stride == r0 and lo == 0
                    assert (npr - 1) * g.pool_stride + g.pool_window <= nr
                    emitted[img, pr0:pr0 + npr] += 1
        if not g.bands:
            assert (computed == 1).all()
        else:
            assert (emitted == 1).all()
        # the batch changes the CTA count only
        assert conv_geometry(h, h, ci, p, p, co, x_bytes=2, **kw) is g
        units = batch * (g.bands or g.conv_h * g.conv_w)
        assert g.pixel_tiles(batch) == -(-units // g.per_cta)


def _sum_in_order(cols: np.ndarray, f: np.ndarray, order) -> np.ndarray:
    """fp32 sums of cols (pixels, K) @ f (K, co) over k in ``order``, one
    rounding a term, as one thread's chain of fp32 adds."""
    acc = np.zeros((cols.shape[0], f.shape[1]), np.float32)
    for k in order:
        acc = (acc + np.outer(cols[:, k], f[k]).astype(np.float32)).astype(
            np.float32)
    return acc


@pytest.mark.parametrize("pool", [0, 3])
@pytest.mark.parametrize("act", ["relu", "silu"])
@pytest.mark.parametrize("out", [TBF, torch.float32])
def test_widened_bound_holds_two_summation_orders(pool, act, out):
    """``widened_bound``: one bf16 conv summed in two fp32 orders (k
    increasing, as the tensor cores' steps; and channel-major, the FMA
    loop's grouping, reversed), through the fp32 epilogue, the pool and
    the act, lies within it of the other; the same result moved a few
    ulps past the bound does not."""
    rng = np.random.default_rng(0)
    b, h, ci, p, co = 2, 9, 24, 3, 8
    x = torch.from_numpy(rng.standard_normal((b, h, h, ci)).astype(
        np.float32)).to(TBF)
    f = torch.from_numpy((rng.standard_normal((p, p, ci, co)) * 3).astype(
        np.float32))
    bias = torch.from_numpy(rng.standard_normal(co).astype(np.float32))
    fw = f.to(TBF).float().numpy().reshape(-1, co)
    oh = h - p + 1
    xs = x.float().numpy()
    cols = np.stack([xs[:, i:i + oh, j:j + oh, :] for i in range(p)
                     for j in range(p)], axis=3).reshape(b * oh * oh, -1)
    kdim = p * p * ci
    k_major = list(range(kdim))
    by_channel = [t * ci + c for c in reversed(range(ci))
                  for t in range(p * p)]
    kw = dict(act=act, pool_window=pool, pool_stride=2 if pool else 0)

    def finish(acc):
        y = torch.from_numpy(acc.reshape(b, oh, oh, co)) + bias
        if pool:
            y = ref.maxpool2d(y, window=pool, stride=2)
        return ref.apply_act(y, act)

    wide = finish(_sum_in_order(cols, fw, by_channel))
    got = finish(_sum_in_order(cols, fw, k_major)).to(out)
    bound = widened_bound(x, f, bias, wide, out_dtype=out, **kw)
    d = (got.double() - wide.double()).abs()
    assert (d > 0).any() and (d <= bound).all()
    # a result past the bound by a few fp32 ulps is caught
    far = wide.double() + bound * (1 + 2.0 ** -20) + 4 * torch.ldexp(
        torch.ones_like(bound), torch.frexp(wide.double())[1] - 24)
    assert ((far - wide.double()).abs() > bound).all()


def test_tc_constants_match_the_cuda_source():
    """kernels/sa_conv_implicit.py mirrors csrc/sa_conv_implicit.cu's
    tensor-core tiles, ring depths, k per stage and alignment, and its
    shared-memory budget is the kernel's own sum."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sa_conv_implicit import (SG_FIELDS, TC_ALIGN,
                                                      TC_BK, tc_smem)
    src = (_build.CSRC / "sa_conv_implicit.cu").read_text()
    assert f"constexpr int TC_BK = {TC_BK};" in src
    assert f"constexpr int TC_ALIGN = {TC_ALIGN};" in src
    assert "static constexpr int BN = 256 / MB;" in src
    assert "static constexpr int BM = 128 * MB;" in src
    assert all(mb * bn == 256 for mb, bn in TC_TILES)
    assert "static constexpr int STAGES = MB == 2 ? 4 : 3;" in src
    assert TC_STAGES == {2: 4, 4: 3}
    assert "SMEM = TC_ALIGN + RING + TABLES + 2 * STAGES * 8;" in src
    assert src.count("enum { SG_IMG,") == 1 and SG_FIELDS == 7
    assert tc_smem(2, 128) == 1024 + 4 * 384 * 128 + 2048 + 896 + 16 + 64
    assert tc_smem(4, 64) == 1024 + 3 * 576 * 128 + 4096 + 896 + 16 + 48
