"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device (and nvcc) every test here skips.  On
the GPU machine run ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``.  Shapes are small and ragged on purpose: the
main-path shapes are covered by ``chip_smoke.py``.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.core.dataflow import PoolSpec
from repro_torch.core.engine import Engine
from repro_torch.core.quant import QTensor, quantize
from repro_torch.kernels import ref
from repro_torch.kernels import attention as tattn
from repro_torch.kernels.attention import (HEAD_DIMS, flash_attention,
                                           flash_plain)
from repro_torch.kernels.pool_act import maxpool_act, pool_geometry
from repro_torch.kernels import sa_conv as tgemm
from repro_torch.kernels.sa_conv import (sa_conv_matmul,
                                         sa_conv_matmul_plain)
from repro_torch.kernels.sa_conv_implicit import (column_strips,
                                                  conv_geometry, conv_tiles,
                                                  sa_conv_implicit,
                                                  sa_conv_plain,
                                                  widened_bound)
from repro_torch.kernels import sa_fc as tfc
from repro_torch.kernels.sa_fc import fc_launch, sa_fc_matmul, sa_fc_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(seed, shape, dev, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dev)


@pytest.mark.parametrize("b,k,n", [(1, 130, 190), (5, 300, 257),
                                   (33, 512, 384), (70, 1000, 129),
                                   (4, 8192, 256), (3, 4608, 1000)])
@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
def test_sa_fc_kernel(cuda, b, k, n, wdtype):
    x, w, bias = _t(0, (b, k), cuda), _t(1, (k, n), cuda, 0.1), \
        _t(2, (n,), cuda)
    scale = None
    if wdtype == "int8":
        qt = quantize(w)
        w, scale = qt.q, qt.scale
    elif wdtype == "bf16":
        w = w.to(torch.bfloat16)
    got = sa_fc_matmul(x, w, bias, act="relu", w_scale=scale)
    want = sa_fc_plain(x, w, bias, act="relu", w_scale=scale)
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    one = sa_fc_matmul(x[:1].contiguous(), w, bias, act="relu",
                       w_scale=scale)
    assert torch.equal(got[:1], one)


def _fc_operands(dev, k, n, wdtype):
    w = _t(1, (k, n), dev, k ** -0.5)
    scale = None
    if wdtype == "int8":
        qt = quantize(w)
        w, scale = qt.q, qt.scale
    elif wdtype == "bf16":
        w = w.to(torch.bfloat16)
    return w, scale, _t(2, (n,), dev)


@pytest.mark.parametrize("k,n", [(1000, 300), (700, 4100)])
@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
def test_sa_fc_every_row_equals_its_b1_result(cuda, k, n, wdtype):
    """Bitwise, across row tiles, split and whole launches (4100 columns
    run whole at b = 130 and split below)."""
    w, scale, bias = _fc_operands(cuda, k, n, wdtype)
    x = _t(0, (130, k), cuda)
    alone = torch.cat([sa_fc_matmul(x[i:i + 1].contiguous(), w, bias,
                                    act="gelu", w_scale=scale)
                       for i in range(130)])
    modes = set()
    for b in (1, 3, 4, 13, 64, 65, 130):
        got = sa_fc_matmul(x[:b].contiguous(), w, bias, act="gelu",
                           w_scale=scale)
        assert torch.equal(got, alone[:b]), b
        modes.add(fc_launch(b, k, n).split)
    assert fc_launch(1, k, n).segments > 1
    if n == 4100:
        assert modes == {True, False}


@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
def test_sa_fc_operands_off_16_byte_alignment(cuda, wdtype):
    """x and w as views one element into their buffers take narrower
    copies (4 bytes, or element loads for int8 and bf16): same bits."""
    b, k, n = 5, 300, 260
    w, scale, bias = _fc_operands(cuda, k, n, wdtype)
    x = _t(0, (b, k), cuda)
    xo = torch.empty(b * k + 1, device=cuda)[1:].view(b, k)
    wo = torch.empty(k * n + 1, dtype=w.dtype, device=cuda)[1:].view(k, n)
    xo.copy_(x)
    wo.copy_(w)
    got = sa_fc_matmul(xo, wo, bias, act="relu", w_scale=scale)
    assert torch.equal(got, sa_fc_matmul(x, w, bias, act="relu",
                                         w_scale=scale))


def test_sa_fc_split_launches_leave_the_arrival_counters_at_zero(cuda):
    w, scale, bias = _fc_operands(cuda, 4096, 1000, "int8")
    x = _t(0, (64, 4096), cuda)
    assert fc_launch(64, 4096, 1000).split
    first = sa_fc_matmul(x, w, bias, act="relu", w_scale=scale)
    second = sa_fc_matmul(x, w, bias, act="relu", w_scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not tfc._SCRATCH[(x.device, stream)][0].any()


@pytest.mark.parametrize("h,ci,p,co,stride,window", [
    (13, 5, 3, 24, 1, 0), (17, 5, 3, 70, 4, 0), (35, 6, 3, 24, 1, 3),
    (67, 3, 11, 40, 4, 3), (10, 8, 3, 16, 1, 2), (15, 8, 3, 16, 3, 3)])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none"])
def test_sa_conv_kernel_and_fused_pool(cuda, h, ci, p, co, stride, window,
                                       act):
    x, f, bias = _t(0, (2, h, h, ci), cuda), _t(1, (p, p, ci, co), cuda,
                                                0.2), _t(2, (co,), cuda)
    kw = dict(stride=stride, act=act, pool_window=window,
              pool_stride=2 if window else 0)
    got = sa_conv_implicit(x, f, bias, **kw)
    torch.testing.assert_close(got, sa_conv_plain(x, f, bias, **kw),
                               rtol=2e-3, atol=2e-3)
    if window:
        conv = sa_conv_implicit(x, f, bias, stride=stride, act=act)
        assert torch.equal(got, maxpool_act(conv, window=window, stride=2,
                                            act="none"))
    one = sa_conv_implicit(x[:1].contiguous(), f, bias, **kw)
    assert torch.equal(got[:1], one)


def test_sa_conv_int8_kernel(cuda):
    x = _t(0, (2, 12, 12, 6), cuda)
    qt = quantize(_t(1, (3, 3, 6, 16), cuda, 0.2))
    bias = _t(2, (16,), cuda)
    got = sa_conv_implicit(x, qt.q, bias, stride=2, act="relu",
                           w_scale=qt.scale)
    want = sa_conv_plain(x, qt.q, bias, stride=2, act="relu",
                         w_scale=qt.scale)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def _conv_operands(dev, ci, p, co, wdtype):
    f = _t(1, (p, p, ci, co), dev, (p * p * ci) ** -0.5)
    scale = None
    if wdtype == "int8":
        qt = quantize(f)
        f, scale = qt.q, qt.scale
    return f, scale, _t(2, (co,), dev)


@pytest.mark.parametrize("layer,tile", [
    (dict(h=15, ci=32, p=3, co=48, stride=1, window=0), (8, 8, 4)),
    (dict(h=15, ci=24, p=3, co=40, stride=1, window=3), (8, 8, 4)),
    (dict(h=31, ci=12, p=5, co=24, stride=1, window=3), (8, 8, 4)),
    (dict(h=15, ci=16, p=3, co=384, stride=1, window=0), (8, 16, 4)),
    (dict(h=15, ci=16, p=3, co=256, stride=1, window=3), (6, 16, 2)),
    (dict(h=31, ci=8, p=5, co=64, stride=1, window=3), (6, 16, 2)),
])
@pytest.mark.parametrize("wdtype", ["fp32", "int8"])
def test_sa_conv_every_row_equals_its_b1_result(cuda, layer, tile, wdtype):
    """Bitwise, at every batch the served waves give (flat tiles across
    images, several bands or images per CTA, partial last tiles), in each
    tile: 13x13 maps (conv3/conv4) and pooled maps (conv2, conv5) at
    reduced input widths."""
    h, ci, p, co = layer["h"], layer["ci"], layer["p"], layer["co"]
    g = conv_geometry(h, h, ci, p, p, co, stride=layer["stride"],
                      pool_window=layer["window"],
                      pool_stride=2 if layer["window"] else 0)
    assert (g.tpx, g.tco, g.groups) == tile
    f, scale, bias = _conv_operands(cuda, ci, p, co, wdtype)
    kw = dict(stride=layer["stride"], act="relu",
              pool_window=layer["window"],
              pool_stride=2 if layer["window"] else 0, w_scale=scale)
    x = _t(0, (65, h, h, ci), cuda)
    alone = torch.cat([sa_conv_implicit(x[i:i + 1].contiguous(), f, bias,
                                        **kw) for i in range(65)])
    for b in (1, 2, 3, 13, 64, 65):
        got = sa_conv_implicit(x[:b].contiguous(), f, bias, **kw)
        assert torch.equal(got, alone[:b]), b
    torch.testing.assert_close(alone, sa_conv_plain(x, f, bias, **kw),
                               rtol=2e-3, atol=2e-3)


def test_sa_conv_tile_straddles_two_images(cuda):
    """A flat 13x13 tile that ends in the middle of an image and the next
    one that starts there."""
    x = _t(0, (5, 15, 15, 8), cuda)
    f, _, bias = _conv_operands(cuda, 8, 3, 16, "fp32")
    g = conv_geometry(15, 15, 8, 3, 3, 16)
    assert not g.bands and g.per_cta % 169
    assert len(conv_tiles(g, 5, 0)) > 1 and conv_tiles(g, 5, 0)[-1][4] < 169
    got = sa_conv_implicit(x, f, bias, act="none")
    torch.testing.assert_close(got, sa_conv_plain(x, f, bias, act="none"),
                               rtol=2e-3, atol=2e-3)
    for i in range(5):
        assert torch.equal(got[i:i + 1], sa_conv_implicit(
            x[i:i + 1].contiguous(), f, bias, act="none"))


@pytest.mark.parametrize("ci,p,stride,window", [
    (3, 11, 4, 3), (3, 3, 1, 0), (5, 3, 1, 3), (5, 5, 1, 0), (5, 11, 4, 0)])
@pytest.mark.parametrize("wdtype", ["fp32", "int8"])
def test_sa_conv_channels_not_a_multiple_of_four(cuda, ci, p, stride,
                                                 window, wdtype):
    """4-byte copies of the input, zero-filled past ci (no 16-byte
    copies); ci = 3 at 11x11 stride 4 stages its whole window at once."""
    h = 55 if p == 11 else 17
    x = _t(0, (3, h, h, ci), cuda)
    f, scale, bias = _conv_operands(cuda, ci, p, 24, wdtype)
    kw = dict(stride=stride, act="relu", pool_window=window,
              pool_stride=2 if window else 0, w_scale=scale)
    got = sa_conv_implicit(x, f, bias, **kw)
    torch.testing.assert_close(got, sa_conv_plain(x, f, bias, **kw),
                               rtol=2e-3, atol=2e-3)
    assert torch.equal(got[2:], sa_conv_implicit(x[2:].contiguous(), f,
                                                 bias, **kw))


@pytest.mark.parametrize("window", [0, 3])
def test_sa_conv_int8_filters_with_ragged_channels(cuda, window):
    """co % 4 != 0: int8 filters are staged by element loads, not 4-byte
    copies."""
    x = _t(0, (3, 15, 15, 8), cuda)
    f, scale, bias = _conv_operands(cuda, 8, 3, 30, "int8")
    kw = dict(act="relu", pool_window=window,
              pool_stride=2 if window else 0, w_scale=scale)
    got = sa_conv_implicit(x, f, bias, **kw)
    torch.testing.assert_close(got, sa_conv_plain(x, f, bias, **kw),
                               rtol=2e-3, atol=2e-3)
    assert torch.equal(got[1:2], sa_conv_implicit(x[1:2].contiguous(), f,
                                                  bias, **kw))


def test_sa_conv_vgg16_layer_with_a_fused_2x2_pool(cuda):
    """VGG-16 conv1_2 (224-wide rows, 64 channels) at b = 2 with its 2/2
    pool, against the plain version and against conv -> pool kernel."""
    x = _t(0, (2, 226, 226, 64), cuda)
    f, _, bias = _conv_operands(cuda, 64, 3, 64, "fp32")
    got = sa_conv_implicit(x, f, bias, act="relu", pool_window=2,
                           pool_stride=2)
    assert got.shape == (2, 112, 112, 64)
    torch.testing.assert_close(
        got, sa_conv_plain(x, f, bias, act="relu", pool_window=2,
                           pool_stride=2), rtol=2e-3, atol=2e-3)
    conv = sa_conv_implicit(x, f, bias, act="relu")
    assert torch.equal(got, maxpool_act(conv, window=2, stride=2,
                                        act="none"))


@pytest.mark.parametrize("hw,window", [(259, 3), (388, 2)])
def test_sa_conv_pooled_rows_wider_than_a_cta(cuda, hw, window):
    """A pool window whose conv rows (257 or 386 wide) do not fit one CTA:
    the engine still fuses the pool, and the wrapper runs two column
    strips.  Against the plain version at b = 8; fused == conv -> pool
    kernel and every row == its b = 1 result, bitwise."""
    x = _t(0, (8, hw, hw, 16), cuda)
    f, _, bias = _conv_operands(cuda, 16, 3, 64, "fp32")
    kw = dict(act="relu", pool_window=window, pool_stride=2)
    eng = Engine(backend="kernels")
    before = sa_conv_implicit.launches
    with eng.tracing() as tr:
        got = eng.conv2d(x, f, bias, act="relu", pool=PoolSpec(window, 2),
                         name="wide")
    assert tr[0].conv_plan.fuse_pool
    assert sa_conv_implicit.launches == before + 2
    n_out = (hw - 2 - window) // 2 + 1
    assert got.shape == (8, n_out, n_out, 64)
    torch.testing.assert_close(got, sa_conv_plain(x, f, bias, **kw),
                               rtol=2e-3, atol=2e-3)
    conv = sa_conv_implicit(x, f, bias, act="relu")
    assert torch.equal(got, maxpool_act(conv, window=window, stride=2,
                                        act="none"))
    for i in range(8):
        assert torch.equal(got[i:i + 1], sa_conv_implicit(
            x[i:i + 1].contiguous(), f, bias, **kw)), i


def test_sa_conv_operands_off_16_byte_alignment(cuda):
    """x and f one element into their buffers take 4-byte copies: same
    bits."""
    x = _t(0, (2, 15, 15, 16), cuda)
    f, _, bias = _conv_operands(cuda, 16, 3, 32, "fp32")
    xo = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    fo = torch.empty(f.numel() + 1, device=cuda)[1:].view(f.shape)
    xo.copy_(x)
    fo.copy_(f)
    for window in (0, 3):
        kw = dict(act="relu", pool_window=window,
                  pool_stride=2 if window else 0)
        assert torch.equal(sa_conv_implicit(xo, fo, bias, **kw),
                           sa_conv_implicit(x, f, bias, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.uint8,
                                   torch.int32])
def test_pool_kernel(cuda, dtype):
    if dtype == torch.float32:
        x = _t(0, (2, 9, 9, 37), cuda)
    else:
        x = torch.randint(0 if dtype == torch.uint8 else -100, 100,
                          (2, 9, 9, 37), dtype=dtype, device=cuda)
    for act in ("none", "relu"):
        assert torch.equal(maxpool_act(x, window=3, stride=2, act=act),
                           ref.maxpool_act(x, window=3, stride=2, act=act))


#: chip_smoke.POOL_SWEEP's maps (h = w, c, window), stride 2, b = 64
POOL_SWEEP_MAPS = [(55, 96, 3), (27, 256, 3), (13, 256, 3), (224, 64, 2),
                   (112, 128, 2), (56, 256, 2), (28, 512, 2), (14, 512, 2)]
POOL_DTYPES = [torch.float32, torch.int8, torch.uint8, torch.int32]


def _pool_map(shape, dtype, dev, offset=0):
    """A map of ``shape`` that starts ``offset`` elements into its
    buffer: normal fp32, or integers over the dtype's whole range."""
    gen = torch.Generator(device=dev).manual_seed(0)
    numel = math.prod(shape) + offset
    if dtype == torch.float32:
        flat = torch.randn(numel, generator=gen, device=dev)
    else:
        info = torch.iinfo(dtype)
        flat = torch.randint(info.min, info.max, (numel,), generator=gen,
                             dtype=dtype, device=dev)
    return flat[offset:].view(shape)


def _same_bits(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("hw,c,window", POOL_SWEEP_MAPS)
@pytest.mark.parametrize("dtype", POOL_DTYPES)
def test_pool_kernel_at_the_sweep_maps(cuda, hw, c, window, dtype):
    x = _pool_map((64, hw, hw, c), dtype, cuda)
    for act in ("none", "relu"):
        assert torch.equal(maxpool_act(x, window=window, stride=2, act=act),
                           ref.maxpool_act(x, window=window, stride=2,
                                           act=act))


@pytest.mark.parametrize("c,offset", [(3, 0), (251, 0), (256, 1), (256, 2)])
@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (3, 1)])
@pytest.mark.parametrize("dtype", POOL_DTYPES)
def test_pool_kernel_odd_channels_and_bases(cuda, c, offset, window, stride,
                                            dtype):
    """Vectors narrower than 16 bytes: an odd channel count, or a base one
    or two elements off alignment."""
    x = _pool_map((5, 17, 19, c), dtype, cuda, offset)
    g = pool_geometry(5, 17, 19, c, x.element_size(), window, stride,
                      x.data_ptr() & -x.data_ptr())
    assert g.vec_bytes < 16
    for act in ("none", "relu"):
        assert torch.equal(maxpool_act(x, window=window, stride=stride,
                                       act=act),
                           ref.maxpool_act(x, window=window, stride=stride,
                                           act=act))


#: one NaN at each position (dp, dq) of a window, for 2/2 and 3/2 pools
NAN_POSITIONS = [(w, dp, dq) for w in (2, 3) for dp in range(w)
                 for dq in range(w)]


@pytest.mark.parametrize("window,dp,dq", NAN_POSITIONS)
@pytest.mark.parametrize("act", ["none", "relu"])
def test_pool_kernel_keeps_nan_at_every_window_position(cuda, window, dp, dq,
                                                        act):
    x = _t(0, (2, 9, 9, 36), cuda)
    x[1, 2 + dp, 2 + dq, ::3] = float("nan")
    got = maxpool_act(x, window=window, stride=2, act=act)
    assert torch.isnan(got).any()
    _same_bits(got, ref.maxpool_act(x, window=window, stride=2, act=act))


@pytest.mark.parametrize("window,dp,dq", NAN_POSITIONS)
def test_fused_pool_keeps_nan_at_every_window_position(cuda, window, dp, dq):
    """One NaN conv output at each window position (a 3x3 conv at stride 3
    reads each input pixel for one output alone): the fused pool equals
    conv -> pool kernel bitwise, NaN included, and has the plain version's
    NaN at its places."""
    res = 18 if window == 2 else 15
    x, f, bias = _t(0, (2, res, res, 8), cuda), _t(1, (3, 3, 8, 16), cuda,
                                                  0.2), _t(2, (16,), cuda)
    x[1, 3 * (2 + dp), 3 * (2 + dq)] = float("nan")
    kw = dict(stride=3, act="relu")
    fused = sa_conv_implicit(x, f, bias, pool_window=window, pool_stride=2,
                             **kw)
    assert torch.isnan(fused).any()
    _same_bits(fused, maxpool_act(sa_conv_implicit(x, f, bias, **kw),
                                  window=window, stride=2, act="none"))
    torch.testing.assert_close(
        fused, sa_conv_plain(x, f, bias, pool_window=window, pool_stride=2,
                             **kw), rtol=2e-3, atol=2e-3, equal_nan=True)


@pytest.mark.parametrize("kernel", ["sa_fc", "gemm", "sa_conv"])
def test_relu_keeps_nan_as_the_pool_does(cuda, kernel):
    """A NaN row of x (a NaN image for SA-CONV) through relu: NaN where the
    plain version has it, the finite outputs within the usual tolerance."""
    if kernel == "sa_conv":
        x, w, bias = _t(0, (3, 13, 13, 8), cuda), _t(1, (3, 3, 8, 16), cuda,
                                                     0.2), _t(2, (16,), cuda)
        kern, plain, tol = sa_conv_implicit, sa_conv_plain, 2e-3
    else:
        x, w, bias = _t(0, (6, 300), cuda), _t(1, (300, 200), cuda, 0.06), \
            _t(2, (200,), cuda)
        kern, plain = ((sa_fc_matmul, sa_fc_plain) if kernel == "sa_fc"
                       else (sa_conv_matmul, sa_conv_matmul_plain))
        tol = 3e-4
    x[1] = float("nan")
    got, want = kern(x, w, bias, act="relu"), plain(x, w, bias, act="relu")
    assert torch.isnan(got[1]).all() and not torch.isnan(got[0]).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=tol, atol=tol, equal_nan=True)


def test_engine_declined_fusion_launches_the_pool_kernel(cuda):
    x, f = _t(0, (2, 15, 15, 8), cuda), _t(1, (3, 3, 8, 32), cuda, 0.2)
    before = maxpool_act.launches
    got = Engine(backend="kernels").conv2d(x, f, act="silu",
                                           pool=PoolSpec(3, 2))
    assert maxpool_act.launches == before + 1
    want = Engine(backend="torch").conv2d(x, f, act="silu",
                                          pool=PoolSpec(3, 2))
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, w = _t(0, (4, 32), cuda), _t(1, (32, 16), cuda)
    with pytest.raises(TypeError):
        sa_fc_matmul(x.double(), w)
    with pytest.raises(ValueError, match="contiguous"):
        sa_fc_matmul(x, w.t().contiguous().t())
    with pytest.raises(ValueError, match="devices"):
        sa_fc_matmul(x, w.cpu())
    with pytest.raises(ValueError, match="integer map"):
        maxpool_act(torch.zeros(1, 4, 4, 3, dtype=torch.int8, device=cuda),
                    window=2, stride=2, act="silu")


@pytest.mark.parametrize("m,k,n", [(1, 130, 190), (130, 300, 257),
                                   (257, 513, 129), (300, 64, 1000)])
@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
@pytest.mark.parametrize("act", ["none", "silu", "gelu"])
def test_sa_conv_gemm_kernel(cuda, m, k, n, wdtype, act):
    x, w, bias = _t(0, (m, k), cuda), _t(1, (k, n), cuda, k ** -0.5), \
        _t(2, (n,), cuda)
    scale = None
    if wdtype == "int8":
        qt = quantize(w)
        w, scale = qt.q, qt.scale
    elif wdtype == "bf16":
        w = w.to(torch.bfloat16)
    got = sa_conv_matmul(x, w, bias, act=act, w_scale=scale)
    want = sa_conv_matmul_plain(x, w, bias, act=act, w_scale=scale)
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("m", [1, 3, 130, 257, 2048])
@pytest.mark.parametrize("wdtype", ["fp32", "int8"])
def test_sa_conv_gemm_every_row_equals_its_m1_result(cuda, m, wdtype):
    """Bitwise: an output's k sum runs in one thread in increasing k,
    whatever m and the tiling."""
    k, n = 700, 520
    w, scale, bias = _fc_operands(cuda, k, n, wdtype)
    x = _t(0, (m, k), cuda)
    got = sa_conv_matmul(x, w, bias, act="silu", w_scale=scale)
    for i in range(m):
        assert torch.equal(got[i:i + 1], sa_conv_matmul(
            x[i:i + 1].contiguous(), w, bias, act="silu", w_scale=scale)), i


@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
def test_sa_conv_gemm_operands_off_16_byte_alignment(cuda, wdtype):
    """x and w as views one element into their buffers take narrower w
    copies (4 bytes, or element loads for int8 and bf16): same bits,
    within the plain version's tolerance."""
    m, k, n = 130, 300, 260
    w, scale, bias = _fc_operands(cuda, k, n, wdtype)
    x = _t(0, (m, k), cuda)
    xo = torch.empty(m * k + 1, device=cuda)[1:].view(m, k)
    wo = torch.empty(k * n + 1, dtype=w.dtype, device=cuda)[1:].view(k, n)
    xo.copy_(x)
    wo.copy_(w)
    assert tgemm.copy_bytes(n * w.element_size(), wo.data_ptr()) < 16
    got = sa_conv_matmul(xo, wo, bias, act="relu", w_scale=scale)
    assert torch.equal(got, sa_conv_matmul(x, w, bias, act="relu",
                                           w_scale=scale))
    torch.testing.assert_close(got, sa_conv_matmul_plain(
        x, w, bias, act="relu", w_scale=scale), rtol=3e-4, atol=3e-4)


#: OLMo-1B's prefill GEMMs of a full wave (m = 4 x 512): (k, n, act)
OLMO_GEMMS = [(2048, 2048, "none"), (2048, 8192, "silu"),
              (8192, 2048, "none"), (2048, 50304, "none")]


@pytest.mark.parametrize("k,n,act", OLMO_GEMMS)
def test_sa_conv_gemm_at_the_path_shapes(cuda, k, n, act):
    x, w = _t(0, (2048, k), cuda), _t(1, (k, n), cuda, k ** -0.5)
    before = sa_conv_matmul.launches
    got = sa_conv_matmul(x, w, act=act)
    assert sa_conv_matmul.launches == before + 1
    torch.testing.assert_close(got, sa_conv_matmul_plain(x, w, act=act),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("case", [
    dict(b=2, sq=256, skv=256, hq=4, hkv=2, d=64, window=0, softcap=0.0),
    dict(b=1, sq=256, skv=256, hq=8, hkv=8, d=32, window=64, softcap=0.0),
    dict(b=2, sq=128, skv=128, hq=4, hkv=1, d=64, window=0, softcap=50.0),
    dict(b=1, sq=1, skv=300, hq=4, hkv=2, d=64, window=0, softcap=0.0),
    dict(b=1, sq=1, skv=300, hq=4, hkv=2, d=64, window=128, softcap=0.0),
    dict(b=2, sq=200, skv=200, hq=2, hkv=2, d=48, window=0, softcap=0.0),
    dict(b=1, sq=77, skv=77, hq=2, hkv=1, d=128, window=0, softcap=0.0),
    dict(b=1, sq=40, skv=90, hq=2, hkv=2, d=16, window=7, softcap=0.0),
    # the LM path's prefills: a full wave and a lone request (OLMo-1B)
    dict(b=4, sq=512, skv=512, hq=16, hkv=16, d=128, window=0, softcap=0.0),
    dict(b=1, sq=512, skv=512, hq=16, hkv=16, d=128, window=0, softcap=0.0),
] + [dict(b=2, sq=300, skv=300, hq=4, hkv=2, d=d, window=0, softcap=0.0)
     for d in HEAD_DIMS])
def test_flash_attention_kernel(cuda, case):
    c = case
    q = _t(0, (c["b"], c["sq"], c["hq"], c["d"]), cuda)
    k = _t(1, (c["b"], c["skv"], c["hkv"], c["d"]), cuda)
    v = _t(2, (c["b"], c["skv"], c["hkv"], c["d"]), cuda)
    kw = dict(window=c["window"], softcap=c["softcap"])
    torch.testing.assert_close(flash_attention(q, k, v, **kw),
                               flash_plain(q, k, v, **kw), rtol=3e-4,
                               atol=3e-4)


def test_flash_attention_rows_of_a_wave_equal_a_lone_request(cuda):
    """Rows of a b = 4 prefill launch (128-row query tiles) equal a b = 1
    launch of the same request (64-row tiles), bitwise."""
    q = _t(0, (4, 512, 16, 128), cuda)
    k, v = _t(1, q.shape, cuda), _t(2, q.shape, cuda)
    full = flash_attention(q, k, v)
    for i in range(4):
        one = flash_attention(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                              v[i:i + 1].contiguous())
        assert torch.equal(full[i:i + 1], one), i


@pytest.mark.parametrize("d,window,causal,dtype", [
    (128, 0, True, "fp32"), (48, 0, True, "fp32"), (64, 100, True, "fp32"),
    (128, 0, True, "bf16"), (48, 0, True, "bf16"), (80, 0, True, "bf16"),
    (128, 100, True, "bf16"), (48, 100, True, "bf16"), (80, 100, True, "bf16"),
    (80, 0, False, "bf16"), (128, 0, False, "bf16")])
def test_flash_attention_every_tiling_gives_the_same_bits(cuda, monkeypatch,
                                                          d, window, causal,
                                                          dtype):
    """64- and 128-row query tiles, paired or not: the same bits, within
    the tolerance of the plain version (fp32 on the FMA kernel; bf16 on the
    tensor cores, also within the error bound of the fp32 launch on the
    widened operands); GQA, with and without a window, causal or not."""
    b, s, hq, hkv = 2, 390, 4, 2
    dt = torch.float32 if dtype == "fp32" else BF16
    q = _t(0, (b, s, hq, d), cuda).to(dt)
    k, v = (_t(i, (b, s, hkv, d), cuda).to(dt) for i in (1, 2))
    kw = dict(window=window, causal=causal)
    want = flash_plain(q, k, v, **kw)
    outs = []
    for bq in tattn.BQ:
        for paired in (False, True):
            g = tattn.FlashGeometry(
                bq, paired, -(-s // bq), b * hq,
                tattn.smem_bytes(bq, d, q.element_size()), 0.0,
                tensor_cores=dt == BF16)
            monkeypatch.setattr(tattn, "flash_geometry", lambda *a, g=g: g)
            outs.append(flash_attention(q, k, v, **kw))
            if dt == BF16:
                torch.testing.assert_close(outs[-1].float(), want.float(),
                                           **TOL_BF16)
            else:
                torch.testing.assert_close(outs[-1], want, rtol=3e-4,
                                           atol=3e-4)
    assert all(torch.equal(o, outs[0]) for o in outs)
    if dt == BF16:
        monkeypatch.undo()
        _flash_within_widened_bound(outs[0], q, k, v, **kw)


@pytest.mark.parametrize("d,window", [(48, 0), (80, 0), (128, 0), (48, 100),
                                      (80, 100), (128, 100)])
def test_flash_attention_bf16_launch_repeated_is_bitwise_itself(cuda, d,
                                                                window):
    """The tensor cores' sums run in one order: a bf16 launch repeated (a
    causal GQA prefill and a non-causal one) gives the same bits."""
    q = _t(0, (2, 390, 4, d), cuda).to(BF16)
    k, v = (_t(s, (2, 390, 2, d), cuda).to(BF16) for s in (1, 2))
    for causal in (True, False):
        kw = dict(window=window, causal=causal)
        first = flash_attention(q, k, v, **kw)
        for _ in range(3):
            assert torch.equal(flash_attention(q, k, v, **kw), first)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["b2 h4 d64 non-causal",
                                    "b1 gqa hkv1 d80 causal"])
def test_flash_attention_reads_strided_inputs(cuda, layout, dtype):
    """q, k and v as views into one fused projection: (b, s, 3, h, d), or
    for GQA (b, s, hq + 2 hkv, d) split by heads, with b = 1 and hkv = 1 so
    the bf16 tensor maps take a packed stride for the size-1 dimensions.
    fp32 within the plain version's tolerance; bf16 within TOL_BF16 of it
    and within the error bound of the fp32 launch on the widened
    operands."""
    dt = torch.float32 if dtype == "fp32" else BF16
    if layout.startswith("b2"):
        qkv = _t(0, (2, 100, 3, 4, 64), cuda).to(dt)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        kw = dict(causal=False)
    else:
        qkv = _t(0, (1, 100, 4 + 2, 80), cuda).to(dt)
        q, k, v = qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:]
        kw = dict(causal=True)
    assert not q.is_contiguous() and not k.is_contiguous()
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    want = flash_plain(q, k, v, **kw)
    if dt == BF16:
        torch.testing.assert_close(got.float(), want.float(), **TOL_BF16)
        _flash_within_widened_bound(got, q, k, v, **kw)
    else:
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, w = _t(0, (4, 32), cuda), _t(1, (32, 16), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sa_conv_matmul(x, w.t().contiguous().t())
    with pytest.raises(TypeError):
        sa_conv_matmul(x.double(), w)
    q = _t(0, (1, 8, 2, 40), cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = _t(0, (1, 8, 2, 66), cuda)[..., 1:65]
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())


def test_serve_engine_on_the_card_matches_the_torch_backend(cuda):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = reduced(get_config("olmo-1b"), param_dtype="float32",
                  compute_dtype="float32")
    params = T.init_params(cfg, 0)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 300))
    outs = {}
    for backend in ("kernels", "torch"):
        srv = ServeEngine(cfg, params, batch_size=2, max_seq=320,
                          engine=Engine(backend=backend))
        for i, p in enumerate(prompts):
            srv.submit(Request(uid=i, prompt=p, max_new=4))
        outs[backend] = {r.uid: r for r in srv.run()}
    for uid, r in outs["kernels"].items():
        np.testing.assert_allclose(r.logits[0], outs["torch"][uid].logits[0],
                                   rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# bf16 activations (SA-FC, the SA-CONV GEMM, flash attention)
# ---------------------------------------------------------------------------
#: the reference's bf16 kernel tolerance (tests/test_kernels.py)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
BF16 = torch.bfloat16


def _bf16_operands(dev, m, k, n, wdtype):
    """x (m, k) bf16; w (k, n) in ``wdtype``; its scale; a bias; and the fp32
    weights the bf16 kernels multiply by (w rounded to bf16, widened)."""
    x = _t(0, (m, k), dev).to(BF16)
    w = _t(1, (k, n), dev, k ** -0.5)
    scale = None
    if wdtype == "int8":
        qt = quantize(w)
        w, scale = qt.q, qt.scale
        wide = w.float()
    elif wdtype == "bf16":
        w = w.to(BF16)
        wide = w.float()
    else:
        wide = w.to(BF16).float()
    return x, w, scale, _t(2, (n,), dev), wide


def _fc_within_widened_bound(x, w, scale, wide, out_dtype):
    """SA-FC with bf16 x on the tensor cores (act none, no bias) against the
    FMA kernel's fp32 launch on the widened operands, per output, within
    ``kernels/sa_fc.py::widened_bound``; returns the largest |d| / bound."""
    got = sa_fc_matmul(x, w, w_scale=scale, out_dtype=out_dtype).double()
    fp32 = sa_fc_matmul(x.float(), wide, w_scale=scale)
    bound = tfc.widened_bound(x, wide, fp32, w_scale=scale,
                              out_dtype=out_dtype)
    d = (got - fp32.double()).abs()
    assert (d <= bound).all(), (d - bound).max().item()
    return (d / bound.clamp_min(1e-300)).max().item()


@pytest.mark.parametrize("b,k,n", [(1, 130, 190), (4, 2048, 2048),
                                   (33, 512, 384), (70, 1000, 129),
                                   (4, 8192, 256)])
@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
@pytest.mark.parametrize("out", ["bf16", "fp32"])
def test_sa_fc_bf16_kernel(cuda, b, k, n, wdtype, out):
    """bf16 x against the plain version within the reference's bf16
    tolerance; within the derived bound of the fp32 launch on the widened
    operands (the tensor cores sum in another order); the bf16 output the
    fp32 output rounded once."""
    out_dtype = BF16 if out == "bf16" else torch.float32
    x, w, scale, bias, wide = _bf16_operands(cuda, b, k, n, wdtype)
    got = sa_fc_matmul(x, w, bias, act="silu", w_scale=scale,
                       out_dtype=out_dtype)
    assert got.dtype == out_dtype
    want = sa_fc_plain(x, w, bias, act="silu", w_scale=scale,
                       out_dtype=out_dtype)
    torch.testing.assert_close(got.float(), want.float(), **TOL_BF16)
    assert torch.equal(got, sa_fc_matmul(
        x, w, bias, act="silu", w_scale=scale,
        out_dtype=torch.float32).to(out_dtype))
    _fc_within_widened_bound(x, w, scale, wide, out_dtype)


@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
def test_sa_fc_bf16_every_row_equals_its_b1_result(cuda, wdtype):
    """Bitwise across row tiles and both launch forms, in bf16."""
    x, w, scale, bias, _ = _bf16_operands(cuda, 130, 700, 4100, wdtype)
    alone = torch.cat([sa_fc_matmul(x[i:i + 1].contiguous(), w, bias,
                                    act="gelu", w_scale=scale)
                       for i in range(130)])
    for b in (1, 3, 4, 13, 64, 65, 130):
        got = sa_fc_matmul(x[:b].contiguous(), w, bias, act="gelu",
                           w_scale=scale)
        assert torch.equal(got, alone[:b]), b


@pytest.mark.parametrize("k,n", [(300, 260), (301, 261), (302, 262),
                                 (296, 257)])
@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
def test_sa_fc_bf16_odd_widths_and_unaligned_bases(cuda, k, n, wdtype):
    """bf16 rows whose bytes are not a multiple of 16 (odd k: element
    loads), from bases one element into their buffers: the aligned
    launch's bits, and the plain version's values."""
    b = 5
    x, w, scale, bias, _ = _bf16_operands(cuda, b, k, n, wdtype)
    want = sa_fc_matmul(x, w, bias, act="relu", w_scale=scale)
    torch.testing.assert_close(
        want.float(), sa_fc_plain(x, w, bias, act="relu",
                                  w_scale=scale).float(), **TOL_BF16)
    xo = torch.empty(b * k + 1, dtype=BF16, device=cuda)[1:].view(b, k)
    wo = torch.empty(k * n + 1, dtype=w.dtype, device=cuda)[1:].view(k, n)
    xo.copy_(x)
    wo.copy_(w)
    assert torch.equal(sa_fc_matmul(xo, wo, bias, act="relu",
                                    w_scale=scale), want)


#: the LM decode shapes of the tensor-core kernel: OLMo-1B's q/k/v/o,
#: seamless's attention, zamba2's in_proj, llava's gate/up
DECODE_SHAPES = [(2048, 2048), (1024, 1024), (2560, 10448), (7168, 20480)]


def _decode_operands(dev, b, k, n, wdtype="bf16"):
    x, w, scale, bias, wide = _bf16_operands(dev, b, k, n, wdtype)
    return x, w, scale, bias, wide


def _on_tc_kernel(fn):
    """``fn()`` and whether it launched the tensor-core kernel once (and
    the SA-FC wrapper once)."""
    before = (sa_fc_matmul.launches, sa_fc_matmul.tc_launches)
    out = fn()
    return out, (sa_fc_matmul.launches - before[0],
                 sa_fc_matmul.tc_launches - before[1]) == (1, 1)


@pytest.mark.parametrize("k,n", DECODE_SHAPES)
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8])
def test_sa_fc_tc_decode_within_the_bound_of_the_fma_kernel(cuda, b, k, n):
    """bf16 x and w at b <= 8 run the tensor-core kernel: within the
    derived bound of the FMA kernel's fp32 launch on the widened operands;
    with bias and silu, gelu or none, the bf16 output its fp32 output
    rounded once; every row bitwise its b = 1 launch."""
    x, w, _, bias, wide = _decode_operands(cuda, b, k, n)
    for act in ("silu", "gelu", "none"):
        got, on = _on_tc_kernel(lambda: sa_fc_matmul(
            x, w, bias, act=act, out_dtype=BF16))
        assert on and got.dtype == BF16
        fp32 = sa_fc_matmul(x, w, bias, act=act, out_dtype=torch.float32)
        assert torch.equal(got, fp32.to(BF16)), act
    for out in (BF16, torch.float32):
        _fc_within_widened_bound(x, w, None, wide, out)
    alone = torch.cat([sa_fc_matmul(x[i:i + 1].contiguous(), w, bias,
                                    act="none", out_dtype=BF16)
                       for i in range(b)])
    assert torch.equal(got, alone)
    torch.testing.assert_close(got.float(), sa_fc_plain(
        x, w, bias, out_dtype=BF16).float(), **TOL_BF16)


@pytest.mark.parametrize("k,n", [(301, 261), (300, 260), (302, 262),
                                 (296, 257), (3999, 1001), (4097, 262),
                                 (301, 4201), (3999, 5002), (2048, 8190)])
@pytest.mark.parametrize("b", [1, 5, 8, 37])
@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
def test_sa_fc_tc_odd_widths_and_unaligned_bases(cuda, b, k, n, wdtype):
    """Rows whose bytes allow 8- or 4-byte pieces or only elements (odd k,
    odd n), from bases one element into their buffers, narrow (k and n <=
    4096, b <= 8) and wide (cp.async where TMA would take the aligned
    launch): the tensor-core kernel, within the bound of the FMA kernel on
    the widened operands, bitwise the aligned launch."""
    x, w, scale, bias, wide = _decode_operands(cuda, b, k, n, wdtype)
    want, on = _on_tc_kernel(lambda: sa_fc_matmul(x, w, bias, act="relu",
                                                  w_scale=scale))
    assert on
    _fc_within_widened_bound(x, w, scale, wide, BF16)
    xo = torch.empty(b * k + 1, dtype=BF16, device=cuda)[1:].view(b, k)
    wo = torch.empty(k * n + 1, dtype=w.dtype, device=cuda)[1:].view(k, n)
    xo.copy_(x)
    wo.copy_(w)
    got, on = _on_tc_kernel(lambda: sa_fc_matmul(xo, wo, bias, act="relu",
                                                 w_scale=scale))
    assert on and torch.equal(got, want)


@pytest.mark.parametrize("b,k,n,wdtype", [
    (8, 4000, 8, "bf16"), (1, 4000, 16, "bf16"), (4, 2048, 2048, "bf16"),
    (4, 2048, 8192, "bf16"), (8, 20000, 4104, "bf16"), (8, 20000, 40, "bf16"),
    (64, 9216, 4096, "fp32"), (130, 4096, 1000, "int8"),
    (65, 20000, 40, "fp32")])
def test_sa_fc_tc_split_launches_leave_the_arrival_counters_at_zero(
        cuda, b, k, n, wdtype):
    """k split into segments: narrow, the partials in shared memory (125
    one-chunk segments of 8 and of 1 rows; OLMo-1B's q/k/v/o); wide, the
    partials through the workspace and the (row tile, column tile)
    counters (OLMo-1B's gate/up; 313 segments of 4104 and of 40 columns;
    AlexNet's fc1 at b = 64, fc3 at three row tiles).  Two launches
    bitwise equal, within the bound of the FMA kernel, every counter back
    at zero."""
    x, w, scale, bias, wide = _decode_operands(cuda, b, k, n, wdtype)
    d = tfc.tc_launch(b, k, n, w.element_size())
    assert d.split and d.narrow == (b <= 8 and k <= 4096 and n <= 4096)
    first, on = _on_tc_kernel(lambda: sa_fc_matmul(x, w, bias, act="silu",
                                                   w_scale=scale))
    assert on and torch.equal(first, sa_fc_matmul(x, w, bias, act="silu",
                                                  w_scale=scale))
    _fc_within_widened_bound(x, w, scale, wide, torch.float32)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    scratch = tfc._SCRATCH.get((x.device, stream))
    assert scratch is None or not scratch[0].any()


@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
def test_sa_fc_tc_row_tiles_of_8_rows_equal_b1(cuda, wdtype):
    """k = 1024 at n = 1000 is split into 32 one-chunk segments: narrow at
    b <= 8 (partials in shared memory), wide above in row tiles of 8 (the
    partials of each through the workspace).  Every row of every b is
    bitwise its b = 1 launch, within the bound of the FMA kernel."""
    k, n = 1024, 1000
    d = tfc.tc_launch(64, k, n, {"fp32": 4, "int8": 1, "bf16": 2}[wdtype])
    assert not d.narrow and (d.rows, d.row_tiles, d.segments) == (8, 8, 32)
    x, w, scale, bias, wide = _bf16_operands(cuda, 130, k, n, wdtype)
    alone = torch.cat([sa_fc_matmul(x[i:i + 1].contiguous(), w, bias,
                                    act="relu", w_scale=scale)
                       for i in range(130)])
    for b in (1, 8, 9, 16, 17, 33, 64, 65, 130):
        got = sa_fc_matmul(x[:b].contiguous(), w, bias, act="relu",
                           w_scale=scale)
        assert torch.equal(got, alone[:b]), b
    _fc_within_widened_bound(x[:64].contiguous(), w, scale, wide,
                             torch.float32)


def test_sa_fc_tc_route_is_x_dtype(cuda):
    """bf16 x takes the tensor-core kernel at every b with every weight
    type; fp32 x the FMA kernel."""
    k, n = 512, 384
    x, w, _, bias, _ = _decode_operands(cuda, 130, k, n)
    q = quantize(w.float())
    for xs, ws, scale, tc in ((x[:8], w, None, True),
                              (x[:1], w, None, True),
                              (x, w, None, True),
                              (x[:9], w, None, True),
                              (x[:4], w.float(), None, True),
                              (x[:64], q.q, q.scale, True),
                              (x[:4].float(), w, None, False),
                              (x.float(), q.q, q.scale, False)):
        before = sa_fc_matmul.tc_launches
        sa_fc_matmul(xs.contiguous(), ws, bias, w_scale=scale)
        assert (sa_fc_matmul.tc_launches - before == 1) == tc


@pytest.mark.parametrize("m,k,n", [(2048, 2048, 2048), (512, 2048, 8192),
                                   (130, 257, 300), (1000, 1001, 2999),
                                   (3, 64, 50304)])
@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
@pytest.mark.parametrize("out", ["bf16", "fp32"])
def test_gemm_bf16_kernel(cuda, m, k, n, wdtype, out):
    """bf16 x against the plain version within the reference's bf16
    tolerance; within the tensor cores' error bound of the fp32 launch on
    the widened operands."""
    out_dtype = BF16 if out == "bf16" else torch.float32
    x, w, scale, bias, wide = _bf16_operands(cuda, m, k, n, wdtype)
    got = sa_conv_matmul(x, w, bias, act="silu", w_scale=scale,
                         out_dtype=out_dtype)
    assert got.dtype == out_dtype
    if m * n * k <= 2**32:
        want = sa_conv_matmul_plain(x, w, bias, act="silu", w_scale=scale,
                                    out_dtype=out_dtype)
        torch.testing.assert_close(got.float(), want.float(), **TOL_BF16)
    _within_widened_bound(x, w, wide, out_dtype)


def _within_widened_bound(x, w, wide, out_dtype=torch.float32):
    """B4 with bf16 x (act none, no bias or scale) against the fp32 launch
    on the widened operands, per output: |got - fp32| <= k 2^-22 (|x| @
    |w|), the worst case of two fp32 summation orders of k terms with
    truncating accumulation, plus one bf16 ulp of the fp32 launch for a
    bf16 output.  Computed in fp64."""
    got = sa_conv_matmul(x, w, out_dtype=out_dtype).double()
    ref = sa_conv_matmul(x.float(), wide).double()
    bound = x.shape[1] * 2.0 ** -22 * (x.double().abs() @ wide.double().abs())
    if out_dtype == BF16:
        bound += torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8)
    excess = ((got - ref).abs() - bound).max().item()
    assert excess <= 0, excess
    return got


@pytest.mark.parametrize("m,k,n,wdtype,offset,producer", [
    (1000, 2048, 1024, "bf16", False, "tma"),
    (300, 296, 257, "bf16", True, "cp.async"),
    (300, 1000, 384, "fp32", False, "cp.async"),
    (300, 1000, 384, "int8", False, "cp.async")])
def test_gemm_bf16_tensor_cores_bound_rows_and_determinism(
        cuda, m, k, n, wdtype, offset, producer):
    """bf16 x on the tensor cores, through each producer: within the error
    bound of the fp32 launch on the widened operands, every row tested
    bitwise its m = 1 launch, two launches bitwise equal; the producer the
    built kernel picks is the one ``tma_ok`` derives and the wrapper
    counts."""
    x, w, _, _, wide = _bf16_operands(cuda, m, k, n, wdtype)
    if offset:
        xo = torch.empty(m * k + 1, dtype=BF16, device=cuda)[1:].view(m, k)
        wo = torch.empty(k * n + 1, dtype=w.dtype,
                         device=cuda)[1:].view(k, n)
        xo.copy_(x)
        wo.copy_(w)
        x, w = xo, wo
    assert tgemm.kernel_producer(x, w) == producer
    assert tgemm.tma_ok(k, n, tgemm.W_KINDS[w.dtype], x.data_ptr(),
                        w.data_ptr()) == (producer == "tma")
    before = dict(sa_conv_matmul.producers)
    got = _within_widened_bound(x, w, wide).float()
    assert sa_conv_matmul.producers[producer] == before[producer] + 1
    assert torch.equal(sa_conv_matmul(x, w, out_dtype=torch.float32), got)
    for r in (0, 1, m // 2, m - 1):
        assert torch.equal(sa_conv_matmul(x[r:r + 1].contiguous(), w,
                                          out_dtype=torch.float32),
                           got[r:r + 1]), r


@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
def test_gemm_bf16_every_row_equals_its_m1_launch(cuda, wdtype):
    x, w, scale, bias, _ = _bf16_operands(cuda, 2048, 520, 300, wdtype)
    full = sa_conv_matmul(x, w, bias, act="relu", w_scale=scale)
    for m in (1, 3, 130, 257):
        assert torch.equal(sa_conv_matmul(x[:m].contiguous(), w, bias,
                                          act="relu", w_scale=scale),
                           full[:m]), m
    for r in (0, 1000, 2047):
        assert torch.equal(sa_conv_matmul(x[r:r + 1].contiguous(), w, bias,
                                          act="relu", w_scale=scale),
                           full[r:r + 1]), r


@pytest.mark.parametrize("k,n", [(300, 260), (301, 261), (302, 262),
                                 (296, 257)])
@pytest.mark.parametrize("wdtype", ["fp32", "int8", "bf16"])
def test_gemm_bf16_odd_widths_and_unaligned_bases(cuda, k, n, wdtype):
    """bf16 x rows of 600, 602, 604 and 592 bytes (8-byte, element,
    4-byte and 16-byte copies) from bases one element into their buffers:
    the aligned launch's bits, and the plain version's values."""
    m = 300
    x, w, scale, bias, _ = _bf16_operands(cuda, m, k, n, wdtype)
    want = sa_conv_matmul(x, w, bias, act="relu", w_scale=scale)
    torch.testing.assert_close(
        want.float(), sa_conv_matmul_plain(x, w, bias, act="relu",
                                           w_scale=scale).float(),
        **TOL_BF16)
    xo = torch.empty(m * k + 1, dtype=BF16, device=cuda)[1:].view(m, k)
    wo = torch.empty(k * n + 1, dtype=w.dtype, device=cuda)[1:].view(k, n)
    xo.copy_(x)
    wo.copy_(w)
    assert torch.equal(sa_conv_matmul(xo, wo, bias, act="relu",
                                      w_scale=scale), want)
    assert tgemm.gemm_geometry(m, n, k, 0, 2).x_copy in (0, 4, 8, 16)


def _flash_within_widened_bound(got, q, k, v, **kw) -> float:
    """bf16 flash on the tensor cores against the fp32 launch on the
    widened operands, per output: within ``tattn.widened_bound`` (one bf16
    ulp, the scores' summation orders carried through the softmax, P's
    split, the sums over keys).  Returns the largest |d| / bound."""
    wide = flash_attention(q.float(), k.float(), v.float(), **kw)
    bound = tattn.widened_bound(q, k, v, wide, **kw)
    d = (got.double() - wide.double()).abs()
    excess = (d - bound).max().item()
    assert excess <= 0, excess
    return (d / bound).max().item()


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window,softcap", [
    (4, 512, 512, 16, 16, 128, 0, 0.0), (1, 512, 512, 16, 16, 128, 0, 0.0),
    (2, 256, 256, 4, 2, 64, 0, 0.0), (1, 256, 256, 8, 8, 32, 64, 0.0),
    (2, 128, 128, 4, 1, 64, 0, 50.0), (1, 1, 300, 4, 2, 64, 128, 0.0),
    (2, 200, 200, 2, 2, 48, 0, 0.0)])
def test_flash_attention_bf16_kernel(cuda, b, sq, skv, hq, hkv, d, window,
                                     softcap):
    """bf16 q, k, v (causal, window, GQA, softcap, 1 query): within the
    reference's bf16 tolerance of the plain version, and within the error
    bound of the fp32 launch on the widened operands."""
    q = _t(0, (b, sq, hq, d), cuda).to(BF16)
    k, v = (_t(s, (b, skv, hkv, d), cuda).to(BF16) for s in (1, 2))
    kw = dict(window=window, softcap=softcap)
    got = flash_attention(q, k, v, **kw)
    assert got.dtype == BF16
    torch.testing.assert_close(got.float(),
                               flash_plain(q, k, v, **kw).float(), **TOL_BF16)
    _flash_within_widened_bound(got, q, k, v, **kw)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_bf16_every_head_dim(cuda, d):
    q, k, v = (_t(s, (2, 300, 4 if s == 0 else 2, d), cuda).to(BF16)
               for s in range(3))
    got = flash_attention(q, k, v)
    torch.testing.assert_close(got.float(), flash_plain(q, k, v).float(),
                               **TOL_BF16)
    _flash_within_widened_bound(got, q, k, v)


def test_flash_attention_bf16_rows_of_a_wave_equal_a_lone_request(cuda):
    q, k, v = (_t(s, (4, 512, 16, 128), cuda).to(BF16) for s in range(3))
    full = flash_attention(q, k, v)
    for i in (0, 3):
        one = [t[i:i + 1].contiguous() for t in (q, k, v)]
        assert torch.equal(full[i:i + 1], flash_attention(*one))


def test_bf16_wrappers_refuse_unsupported_mixes(cuda):
    """A bf16 call with a mix the kernels do not take raises: no cast, no
    plain fallback."""
    x = _t(0, (4, 64), cuda).to(BF16)
    w = _t(1, (64, 32), cuda)
    for kern in (sa_fc_matmul, sa_conv_matmul):
        before = (kern.launches, ref.matmul_bias_act.calls)
        with pytest.raises(TypeError):
            kern(x.half(), w)
        with pytest.raises(TypeError):
            kern(x, w, out_dtype=torch.float16)
        with pytest.raises(ValueError):
            kern(x, w, _t(2, (32,), cuda).half())
        assert (kern.launches, ref.matmul_bias_act.calls) == before
    q = _t(0, (1, 64, 2, 64), cuda)
    before = (flash_attention.launches, ref.attention.calls)
    with pytest.raises(TypeError):
        flash_attention(q.to(BF16), q, q.to(BF16))
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    assert (flash_attention.launches, ref.attention.calls) == before
    # a bf16 row of 72 bytes is not 16-byte aligned
    q = _t(0, (1, 8, 2, 52), cuda).to(BF16)[..., :48]
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# bf16 activations in SA-CONV implicit and the pool (C6)
# ---------------------------------------------------------------------------
def _bf16_conv_operands(dev, ci, p, co, wdtype):
    """f in ``wdtype``, its scale, a bias, and the fp32 filter the bf16
    kernel multiplies by (an fp32 f rounded to bf16, widened; int8 as it
    is)."""
    f, scale, bias = _conv_operands(dev, ci, p, co, wdtype)
    wide = f.float() if wdtype == "int8" else f.to(BF16).float()
    return f, scale, bias, wide


def _conv_within_widened_bound(got, x, f, bias, wide_out, **kw):
    """The tensor cores' bf16 launch ``got`` within ``widened_bound`` of
    the fp32 launch on the widened operands (NaN where it is NaN)."""
    bound = widened_bound(x, f, bias, wide_out, out_dtype=got.dtype, **kw)
    g, w = got.double(), wide_out.double()
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    d = (g - w).abs().nan_to_num(0.0)
    assert (d <= bound).all(), (d - bound).max().item()


#: (h, ci, p, co, stride, window): AlexNet's filters and VGG-16's 3x3 at
#: reduced widths, each tile, flat and banded, ci = 3 (element loads)
BF16_CONV_LAYERS = [(67, 3, 11, 40, 4, 3), (31, 12, 5, 24, 1, 3),
                    (15, 16, 3, 384, 1, 0), (15, 16, 3, 256, 1, 3),
                    (18, 64, 3, 64, 1, 2), (17, 3, 3, 24, 1, 2),
                    (13, 5, 3, 24, 1, 0)]


@pytest.mark.parametrize("h,ci,p,co,stride,window", BF16_CONV_LAYERS)
@pytest.mark.parametrize("wdtype", ["fp32", "int8"])
@pytest.mark.parametrize("out", ["bf16", "fp32"])
def test_sa_conv_bf16_kernel(cuda, h, ci, p, co, stride, window, wdtype,
                             out):
    """bf16 x (the tensor cores) against the plain version within the
    reference's bf16 tolerance; within the derived bound of the fp32
    launch on the widened operands (the FMA loop sums in another order);
    a bf16 output is its launch's fp32 output rounded once; fused == conv
    -> pool kernel and rows == b = 1, bitwise."""
    out_dtype = BF16 if out == "bf16" else torch.float32
    x = _t(0, (5, h, h, ci), cuda).to(BF16)
    f, scale, bias, wide = _bf16_conv_operands(cuda, ci, p, co, wdtype)
    kw = dict(stride=stride, act="relu", pool_window=window,
              pool_stride=2 if window else 0, w_scale=scale)
    got = sa_conv_implicit(x, f, bias, out_dtype=out_dtype, **kw)
    assert got.dtype == out_dtype
    torch.testing.assert_close(
        got.float(), sa_conv_plain(x, f, bias, out_dtype=out_dtype,
                                   **kw).float(), **TOL_BF16)
    fp32 = sa_conv_implicit(x.float(), wide, bias, **kw)
    _conv_within_widened_bound(got, x, f, bias, fp32, **kw)
    assert torch.equal(got, sa_conv_implicit(
        x, f, bias, out_dtype=torch.float32, **kw).to(out_dtype))
    if window:
        conv = sa_conv_implicit(x, f, bias, stride=stride, act="relu",
                                w_scale=scale, out_dtype=out_dtype)
        assert torch.equal(got, maxpool_act(conv, window=window, stride=2,
                                            act="none"))
    for i in (0, 4):
        assert torch.equal(got[i:i + 1], sa_conv_implicit(
            x[i:i + 1].contiguous(), f, bias, out_dtype=out_dtype, **kw)), i


@pytest.mark.parametrize("wdtype", ["fp32", "int8"])
def test_sa_conv_bf16_every_row_equals_its_b1_result(cuda, wdtype):
    """Bitwise at every batch a wave gives, flat tiles and bands."""
    f, scale, bias, _ = _bf16_conv_operands(cuda, 24, 3, 40, wdtype)
    x = _t(0, (65, 15, 15, 24), cuda).to(BF16)
    for window in (0, 3):
        kw = dict(act="relu", pool_window=window,
                  pool_stride=2 if window else 0, w_scale=scale)
        alone = torch.cat([sa_conv_implicit(x[i:i + 1].contiguous(), f,
                                            bias, **kw) for i in range(65)])
        for b in (1, 2, 13, 64, 65):
            got = sa_conv_implicit(x[:b].contiguous(), f, bias, **kw)
            assert torch.equal(got, alone[:b]), (window, b)


def test_sa_conv_bf16_operands_off_alignment(cuda):
    """bf16 x one element into its buffer (2-byte loads, not 8-byte
    copies) and f one element into its: the aligned launch's bits."""
    x = _t(0, (2, 15, 15, 16), cuda).to(BF16)
    f, _, bias = _conv_operands(cuda, 16, 3, 32, "fp32")
    xo = torch.empty(x.numel() + 1, dtype=BF16, device=cuda)[1:].view(
        x.shape)
    fo = torch.empty(f.numel() + 1, device=cuda)[1:].view(f.shape)
    xo.copy_(x)
    fo.copy_(f)
    for window in (0, 3):
        kw = dict(act="relu", pool_window=window,
                  pool_stride=2 if window else 0)
        assert torch.equal(sa_conv_implicit(xo, fo, bias, **kw),
                           sa_conv_implicit(x, f, bias, **kw))


def test_sa_conv_bf16_pooled_rows_wider_than_a_cta(cuda):
    """Column strips in bf16: one launch a strip of the tensor-core
    geometry, fused == conv -> pool kernel, bitwise; within the derived
    bound of the fp32 launch on the widened operands."""
    x = _t(0, (2, 259, 259, 16), cuda).to(BF16)
    f, _, bias = _conv_operands(cuda, 16, 3, 64, "fp32")
    kw = dict(act="relu", pool_window=3, pool_stride=2)
    strips = column_strips(259, 259, 16, 3, 3, 64, pool_window=3,
                           pool_stride=2, x_bytes=2)
    before = sa_conv_implicit.launches
    got = sa_conv_implicit(x, f, bias, **kw)
    assert sa_conv_implicit.launches == before + len(strips) and \
        len(strips) > 1 and got.dtype == BF16
    conv = sa_conv_implicit(x, f, bias, act="relu")
    assert torch.equal(got, maxpool_act(conv, window=3, stride=2,
                                        act="none"))
    _conv_within_widened_bound(got, x, f, bias, sa_conv_implicit(
        x.float(), f.to(BF16).float(), bias, **kw), **kw)


def test_sa_conv_bf16_refuses_unsupported_mixes(cuda):
    x = _t(0, (1, 9, 9, 8), cuda)
    f = _t(1, (3, 3, 8, 16), cuda)
    before = (sa_conv_implicit.launches, ref.conv2d.calls)
    with pytest.raises(TypeError):
        sa_conv_implicit(x.half(), f)
    with pytest.raises(TypeError):
        sa_conv_implicit(x, f, out_dtype=BF16)          # fp32 x writes fp32
    with pytest.raises(TypeError):
        sa_conv_implicit(x.to(BF16), f.to(BF16))        # bf16 filters
    with pytest.raises(TypeError):
        sa_conv_implicit(x.to(BF16), f, out_dtype=torch.float16)
    assert (sa_conv_implicit.launches, ref.conv2d.calls) == before


BF16_ACTS = ["none", "relu", "leaky_relu", "silu", "gelu"]


@pytest.mark.parametrize("hw,c,window", POOL_SWEEP_MAPS)
def test_pool_kernel_bf16_at_the_sweep_maps(cuda, hw, c, window):
    """A bf16 max is exact: none and relu equal the plain version and the
    fp32 kernel on the widened map, bitwise; the other acts run in fp32
    and round once (within the bf16 tolerance of the plain version)."""
    x = _pool_map((64, hw, hw, c), torch.float32, cuda).to(BF16)
    for act in BF16_ACTS:
        got = maxpool_act(x, window=window, stride=2, act=act)
        want = ref.maxpool_act(x, window=window, stride=2, act=act)
        assert got.dtype == BF16
        if act in ("none", "relu"):
            assert torch.equal(got, want), act
            assert torch.equal(got, maxpool_act(
                x.float(), window=window, stride=2, act=act).to(BF16)), act
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL_BF16)


@pytest.mark.parametrize("c,offset", [(3, 0), (251, 0), (256, 1), (256, 2),
                                      (256, 4), (2, 0)])
@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (3, 1)])
def test_pool_kernel_bf16_odd_channels_and_bases(cuda, c, offset, window,
                                                 stride):
    """bf16 vectors of 2, 4 and 8 bytes: an odd channel count, or a base
    one, two or four elements off alignment."""
    x = _pool_map((5, 17, 19, c), torch.float32, cuda)
    xo = torch.empty(x.numel() + offset, dtype=BF16, device=cuda)[
        offset:].view(x.shape)
    xo.copy_(x)
    g = pool_geometry(5, 17, 19, c, 2, window, stride,
                      xo.data_ptr() & -xo.data_ptr())
    assert g.vec_bytes < 16
    for act in ("none", "relu"):
        assert torch.equal(maxpool_act(xo, window=window, stride=stride,
                                       act=act),
                           ref.maxpool_act(xo, window=window, stride=stride,
                                           act=act))


@pytest.mark.parametrize("window,dp,dq", NAN_POSITIONS)
def test_pool_kernel_bf16_keeps_nan_at_every_window_position(cuda, window,
                                                             dp, dq):
    x = _t(0, (2, 9, 9, 36), cuda).to(BF16)
    x[1, 2 + dp, 2 + dq, ::3] = float("nan")
    for act in ("none", "relu"):
        got = maxpool_act(x, window=window, stride=2, act=act)
        assert torch.isnan(got).any()
        _same_bits(got, ref.maxpool_act(x, window=window, stride=2,
                                        act=act))


def test_engine_bf16_conv_and_pool_on_the_kernels(cuda):
    """bf16 through Engine.conv2d (fused and declined pools) and
    Engine.pool launches the kernels and stays within the bf16 tolerance
    of the torch backend."""
    x = _t(0, (2, 15, 15, 8), cuda).to(BF16)
    f, bias = _t(1, (3, 3, 8, 32), cuda, 0.2), _t(2, (32,), cuda)
    kern, plain = Engine(backend="kernels"), Engine(backend="torch")
    for act in ("relu", "silu"):
        before = (sa_conv_implicit.launches, maxpool_act.launches)
        got = kern.conv2d(x, f, bias, act=act, pool=PoolSpec(3, 2))
        after = (sa_conv_implicit.launches, maxpool_act.launches)
        assert after == (before[0] + 1, before[1] + (act == "silu"))
        assert got.dtype == BF16
        torch.testing.assert_close(
            got.float(), plain.conv2d(x, f, bias, act=act,
                                      pool=PoolSpec(3, 2)).float(),
            **TOL_BF16)
    got = kern.pool(x, window=3, stride=2, act="relu")
    assert torch.equal(got, ref.maxpool_act(x, window=3, stride=2,
                                            act="relu"))


# ---------------------------------------------------------------------------
# the fleet and the bf16 CNNServer (C7) on the card
# ---------------------------------------------------------------------------
def _fleet_zoo(device, names=("alexnet-int8", "alexnet")):
    from repro_torch.serve.zoo import build_zoo
    return build_zoo(names, seed=0, in_res={"alexnet": 67},
                     width_mult=0.125, max_batch=4, device=device)


def _fleet_burst(fleet, model, n, uid0):
    from repro_torch.serve.zoo import ZooRequest
    rng = np.random.default_rng(uid0)
    for k in range(n):
        fleet.submit(ZooRequest(
            uid=uid0 + k, model=model, tenant="t",
            image=rng.standard_normal((67, 67, 3)).astype(np.float32)))


def _served_bitwise(rep, models):
    from repro_torch.models import cnn
    by_name = {m.name: m for m in models}
    for r in rep.served:
        m = by_name[r.model]
        x = torch.from_numpy(r.image[None]).to(m.server.device)
        one = cnn.cnn_forward(m.spec.net, m.params, x,
                              eng=m.server.engine).cpu().numpy()[0]
        assert np.isfinite(r.logits).all()
        np.testing.assert_array_equal(r.logits, one)


def test_fleet_executed_on_the_card(cuda):
    """Per-replica and cooperative waves (one forward per participant, at
    most a micro-batch each) on the one card: every served row bitwise its
    unbatched forward, launches as the decisions imply, no GEMM."""
    from repro_torch.serve.fleet import FleetServer, cooperative_blocks
    from repro_torch.serve.zoo import FIFOPolicy
    models = _fleet_zoo(cuda)
    fleet = FleetServer(models, n_replicas=4, policy=FIFOPolicy(),
                        shard_waves=True)
    _fleet_burst(fleet, "alexnet-int8", 16, 0)
    _fleet_burst(fleet, "alexnet", 3, 100)
    assert len(fleet.devices()) == torch.cuda.device_count()
    before = (sa_conv_implicit.launches, sa_fc_matmul.launches,
              sa_conv_matmul.launches)
    rep = fleet.serve()
    torch.cuda.synchronize()
    assert rep.unaccounted == () and len(rep.served) == 19
    assert any(d.sharded and d.batch == 16 for d in rep.decisions)
    mb = {m.name: m.microbatch for m in models}
    forwards = sum(len(cooperative_blocks(d.batch, len(d.shards),
                                          mb[d.model])) if d.shards else 1
                   for d in rep.decisions)
    if torch.cuda.device_count() == 1:
        assert (sa_conv_implicit.launches - before[0],
                sa_fc_matmul.launches - before[1],
                sa_conv_matmul.launches - before[2]) == \
            (5 * forwards, 3 * forwards, 0)
    assert all(max(r.conv_shape[0] if r.conv_shape else r.m for r in tr)
               <= 4 for tr in fleet.shard_traces)
    _served_bitwise(rep, models)


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs 2 or more CUDA devices")
def test_fleet_lane_on_a_second_device(cuda):
    """Replicas round-robin over the cards: a lane on a card other than
    its model's gets one copy of the parameters, and its rows stay bitwise
    the unbatched forward on the model's own card."""
    from repro_torch.serve.fleet import FleetServer
    from repro_torch.serve.zoo import FIFOPolicy
    models = _fleet_zoo(torch.device("cuda", 0))
    fleet = FleetServer(models, n_replicas=2, policy=FIFOPolicy(),
                        shard_waves=True)
    assert fleet.replica_device(1) == torch.device("cuda", 1)
    assert fleet.mesh().size == 2
    _fleet_burst(fleet, "alexnet-int8", 8, 0)
    _fleet_burst(fleet, "alexnet", 2, 100)
    rep = fleet.serve()
    assert rep.unaccounted == () and len(rep.served) == 10
    assert {r.replica for r in rep.served} >= {"r0"}
    copies = fleet._device_params
    assert copies and all(k[1] == torch.device("cuda", 1) for k in copies)
    for (name, dev), params in copies.items():
        assert params[0]["b"].device == dev
    _served_bitwise(rep, models)


def test_bf16_cnn_server_delivers_logits_on_the_card(cuda):
    """C7: a bf16 CNNServer serves its logits widened to fp32, each the
    unbatched bf16 forward bitwise, pipelined == sequential."""
    from repro_torch.models import cnn
    from repro_torch.serve.cnn_server import CNNRequest, CNNServer
    params = cnn.init_cnn("alexnet", 0, in_res=67, width_mult=0.125,
                          device=cuda)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((9, 67, 67, 3)).astype(np.float32)
    out = []
    for pipeline in (True, False):
        srv = CNNServer("alexnet", params, in_res=67, width_mult=0.125,
                        max_batch=4, dtype=BF16, pipeline=pipeline)
        for k, x in enumerate(images):
            srv.submit(CNNRequest(uid=k, image=x))
        done = sorted(srv.run(), key=lambda r: r.uid)
        assert [w.batch for w in srv.waves] == [4, 4, 1]
        out.append(np.stack([r.logits for r in done]))
    assert out[0].dtype == np.float32
    np.testing.assert_array_equal(out[0], out[1])
    for k, x in enumerate(images):
        one = cnn.cnn_forward("alexnet", params,
                              torch.from_numpy(x[None]).to(cuda, BF16),
                              eng=srv.engine)
        np.testing.assert_array_equal(out[0][k], one.float().cpu().numpy()[0])


# ---------------------------------------------------------------------------
# training: the kernels backend's autograd Functions and a train step
# ---------------------------------------------------------------------------
def _close_rms(got, want, tol):
    """Within ``tol`` relative to ``want``'s RMS (a gradient summed over
    many rows is large in its typical element, where bf16's ulp is)."""
    scale = want.double().pow(2).mean().sqrt()
    torch.testing.assert_close(got.double() / scale, want.double() / scale,
                               **tol)


GRAD_TOL = {"fp32": dict(rtol=3e-4, atol=3e-4),
            "bf16": dict(rtol=3e-2, atol=3e-2)}


def _grads(eng, x, w, b, act, cot):
    """(dx, dw[, db]), or (dx[, db]) for a QTensor ``w``."""
    frozen = isinstance(w, QTensor)
    live = [t.detach().requires_grad_()
            for t in ((x, b) if frozen else (x, w, b)) if t is not None]
    y = eng.matmul(live[0], w if frozen else live[1],
                   live[-1] if b is not None else None, act=act)
    return torch.autograd.grad((y.float() * cot).sum(), live)


@pytest.mark.parametrize("regime,m", [("sa_fc", 4), ("sa_conv", 130)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("act,bias", [("none", False), ("silu", True),
                                      ("relu", False), ("gelu", True)])
def test_matmul_function_grads_on_the_card(cuda, regime, m, dtype, act,
                                           bias):
    """dx on the regime's kernel against a contiguous w.T, dw on the GEMM,
    db in fp32: the plain versions' autograd gradients, and one launch of
    each (``pre`` again only for a non-linear act)."""
    from repro_torch.core.engine import DispatchPolicy
    dt = BF16 if dtype == "bf16" else torch.float32
    k, n = 300, 257
    x, w = _t(0, (m, k), cuda).to(dt), _t(1, (k, n), cuda, k ** -0.5).to(dt)
    b = _t(2, (n,), cuda).to(dt) if bias else None
    cot = _t(3, (m, n), cuda)
    eng = Engine(backend="kernels",
                 policy=DispatchPolicy(force_regime=regime))
    wrap = sa_fc_matmul if regime == "sa_fc" else sa_conv_matmul
    before = (wrap.launches, sa_conv_matmul.launches)
    got = _grads(eng, x, w, b, act, cot)
    runs = 2 + (act != "none")
    if regime == "sa_fc":
        assert (sa_fc_matmul.launches - before[0],
                sa_conv_matmul.launches - before[1]) == (runs, 1)
    else:
        assert sa_conv_matmul.launches - before[1] == runs + 1
    want = _grads(Engine(backend="torch"), x, w, b, act, cot)
    for g, wv in zip(got, want):
        assert g.dtype == wv.dtype and g.shape == wv.shape
        _close_rms(g, wv, GRAD_TOL[dtype])


@pytest.mark.parametrize("regime,m", [("sa_fc", 4), ("sa_conv", 130)])
def test_quantized_matmul_function_grads_on_the_card(cuda, regime, m):
    from repro_torch.core.engine import DispatchPolicy
    x, b, cot = _t(0, (m, 300), cuda), _t(2, (257,), cuda), \
        _t(3, (m, 257), cuda)
    qt = quantize(_t(1, (300, 257), cuda, 0.05))
    eng = Engine(backend="kernels",
                 policy=DispatchPolicy(force_regime=regime))
    got = _grads(eng, x, qt, b, "relu", cot)
    want = _grads(Engine(backend="torch"), x, qt, b, "relu", cot)
    for g, wv in zip(got, want):
        _close_rms(g, wv, GRAD_TOL["fp32"])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hq,hkv,window,softcap", [(4, 4, 0, 0.0),
                                                   (4, 2, 8, 0.0),
                                                   (4, 2, 0, 5.0)])
def test_flash_function_grads_on_the_card(cuda, dtype, hq, hkv, window,
                                          softcap):
    """Flash's forward, the plain version's backward: the torch backend's
    gradients (its backward is the same plain computation)."""
    dt = BF16 if dtype == "bf16" else torch.float32
    q = _t(0, (2, 40, hq, 64), cuda).to(dt)
    k, v = (_t(s, (2, 40, hkv, 64), cuda).to(dt) for s in (1, 2))
    cot = _t(3, (2, 40, hq, 64), cuda)
    res = []
    for backend in ("kernels", "torch"):
        live = [t.detach().requires_grad_() for t in (q, k, v)]
        before = (flash_attention.launches, ref.counts()["attention"])
        out = Engine(backend=backend).attention(*live, window=window,
                                                softcap=softcap)
        res.append(torch.autograd.grad((out.float() * cot).sum(), live))
        if backend == "kernels":
            assert (flash_attention.launches - before[0],
                    ref.counts()["attention"] - before[1]) == (1, 1)
    for g, wv in zip(*res):
        _close_rms(g, wv, GRAD_TOL[dtype])


def test_train_steps_on_the_card(cuda):
    """Three steps of a reduced OLMo config on the kernels backend (remat
    by block) follow the torch backend's on the card within 1e-4 of loss;
    the tied copy follows embed."""
    from repro_torch.configs.base import TrainConfig, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import train_step as TS
    cfg = reduced(get_config("olmo-1b"), param_dtype="float32",
                  compute_dtype="float32")
    tc = TrainConfig(global_batch=4, seq_len=64, total_steps=3,
                     warmup_steps=1, lr=3e-3, remat="block")
    data = SyntheticLM(DataConfig(cfg.vocab_size, 64, 4, seed=1))
    losses = {}
    for backend in ("kernels", "torch"):
        state = TS.init_train_state(cfg, tc, 0, device=cuda)
        step = TS.make_train_step(cfg, tc, engine=Engine(backend=backend))
        losses[backend] = []
        for s in range(3):
            *state, m = step(*state, data.batch_at(s))
            losses[backend].append(float(m["loss"]))
        params = state[0]
        assert torch.equal(params["embed_t"], params["embed"].t())
    np.testing.assert_allclose(losses["kernels"], losses["torch"],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_family_train_steps_on_the_card(cuda, arch):
    """Three steps of a reduced MoE, Mamba2 or zamba2 config (fp32, remat
    by block) on the kernels backend follow the torch backend's on the
    card within 1e-4 of loss, and a donated step (the state updated in
    place) gives the functional step's losses and parameters bitwise."""
    from repro_torch.configs.base import TrainConfig, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import train_step as TS
    cfg = reduced(get_config(arch), param_dtype="float32",
                  compute_dtype="float32")
    tc = TrainConfig(global_batch=4, seq_len=64, total_steps=3,
                     warmup_steps=1, lr=3e-3, remat="block")
    data = SyntheticLM(DataConfig(cfg.vocab_size, 64, 4, seed=1))
    losses, params = {}, {}
    for backend, donate in (("kernels", False), ("kernels", True),
                            ("torch", False)):
        state = TS.init_train_state(cfg, tc, 0, device=cuda)
        step = TS.make_train_step(cfg, tc, engine=Engine(backend=backend),
                                  donate=donate)
        run = losses[backend, donate] = []
        for s in range(3):
            *state, m = step(*state, data.batch_at(s))
            run.append(float(m["loss"]))
        params[backend, donate] = state[0]
    assert all(np.isfinite(v).all() for v in losses.values())
    assert losses["kernels", True] == losses["kernels", False]
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(params["kernels", True]),
        tree.leaves(params["kernels", False])))
    np.testing.assert_allclose(losses["kernels", False],
                               losses["torch", False], rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llava-next-34b"])
def test_frontend_family_train_steps_on_the_card(cuda, arch):
    """Three steps of reduced seamless (no schedule) or llava (its schedule
    text-only) through ``make_train_step`` in fp32, remat by block, over
    ``SyntheticLM``'s frames or vision embeddings: the kernels backend follows the torch backend's within
    1e-4 of loss, a donated step gives the functional step's losses and
    parameters bitwise, and the GEMM and flash both launched."""
    from repro_torch.configs.base import TrainConfig, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import train_step as TS
    cfg = reduced(get_config(arch), param_dtype="float32",
                  compute_dtype="float32")
    tc = TrainConfig(global_batch=4, seq_len=64, total_steps=3,
                     warmup_steps=1, lr=3e-3, remat="block")
    data = SyntheticLM(DataConfig(cfg.vocab_size, 64, 4, seed=1), cfg)
    losses, params = {}, {}
    for backend, donate in (("kernels", False), ("kernels", True),
                            ("torch", False)):
        state = TS.init_train_state(cfg, tc, 0, device=cuda)
        step = TS.make_train_step(cfg, tc, engine=Engine(backend=backend),
                                  donate=donate)
        before = (sa_conv_matmul.launches, flash_attention.launches)
        run = losses[backend, donate] = []
        for s in range(3):
            *state, m = step(*state, data.batch_at(s))
            run.append(float(m["loss"]))
        if backend == "kernels":
            assert sa_conv_matmul.launches > before[0]
            assert flash_attention.launches > before[1]
        params[backend, donate] = state[0]
    assert all(np.isfinite(v).all() for v in losses.values())
    assert losses["kernels", True] == losses["kernels", False]
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(params["kernels", True]),
        tree.leaves(params["kernels", False])))
    np.testing.assert_allclose(losses["kernels", False],
                               losses["torch", False], rtol=0, atol=1e-4)


def test_smem_queries_equal_the_launch_pass(cuda):
    """Each kernel's exported shared-memory query gives the dynamic shared
    memory ``analysis/launch.py`` derives, for every launch of the zoo's
    variants and every edge launch; the card's opt-in shared memory per
    CTA is the SA-CONV geometry's ``SMEM_MAX + SMEM_STATIC``."""
    from repro_torch.analysis import launch as tlaunch
    from repro_torch.analysis.__main__ import zoo_variant_pairs
    from repro_torch.core.accelerator import gpu_card
    from repro_torch.kernels import _build
    from repro_torch.kernels import sa_conv_implicit as tconv
    assert gpu_card().smem_per_block_optin == \
        tconv.SMEM_MAX + tconv.SMEM_STATIC == tlaunch.SMEM_OPTIN
    launches = [lau for _, pair in zoo_variant_pairs(8) for sched in pair
                for lau in tlaunch.schedule_launches(sched)]
    launches += tlaunch.edge_launches()
    asked = 0
    for lau in launches:
        for lib, args, derived in tlaunch.smem_queries(lau):
            assert _build.smem_query(lib, *args) == derived, (lau.op, args)
            asked += 1
    assert asked >= len(launches)
    # a tile or type with no instantiation answers -1
    assert _build.smem_query("sa_fc", 0, 0, 3) == -1
    assert _build.smem_query("sa_fc", 0, 2, 8) == -1         # bf16 x
    assert _build.smem_query("sa_fc_tc", 2, 4, 2048, 2048, 12, 1, 1) == -1
    assert _build.smem_query("attention", 40, 64, 0) == -1


# -- non-causal flash: encoders and cross-attention ---------------------------

def _noncausal_cases():
    from repro_torch.analysis.launch import noncausal_edge_launches
    return [pytest.param(lau.shape, id=lau.op.removesuffix(" [attention]"))
            for lau in noncausal_edge_launches()]


@pytest.mark.parametrize("shape", _noncausal_cases())
def test_flash_attention_noncausal_against_the_plain_version(cuda, shape):
    """The phase 13 sweep: fewer, as many and more queries than keys, odd
    query tiles paired and unpaired, hd 64 and 128, GQA up to 7, fp32
    within the reference's flash tolerance and bf16 within its bf16 one,
    bf16 within the error bound of the fp32 launch on the widened
    operands."""
    b, sq, skv, hq, hkv, d, causal, window, itemsize = shape
    dt = torch.float32 if itemsize == 4 else BF16
    q = _t(0, (b, sq, hq, d), cuda).to(dt)
    k, v = (_t(s, (b, skv, hkv, d), cuda).to(dt) for s in (1, 2))
    kw = dict(causal=causal, window=window)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    tol = dict(rtol=3e-4, atol=3e-4) if itemsize == 4 else TOL_BF16
    torch.testing.assert_close(got.float(), flash_plain(q, k, v, **kw).float(),
                               **tol)
    if itemsize == 2:
        _flash_within_widened_bound(got, q, k, v, **kw)


@pytest.mark.parametrize("sq,skv", [(100, 390), (390, 390), (390, 100)])
def test_flash_attention_noncausal_every_tiling_gives_the_same_bits(
        cuda, monkeypatch, sq, skv):
    b, hq, hkv, d = 2, 7, 1, 64
    q = _t(0, (b, sq, hq, d), cuda)
    k, v = _t(1, (b, skv, hkv, d), cuda), _t(2, (b, skv, hkv, d), cuda)
    want = flash_plain(q, k, v, causal=False)
    outs = []
    for bq in tattn.BQ:
        for paired in (False, True):
            g = tattn.FlashGeometry(bq, paired, -(-sq // bq), b * hq,
                                    tattn.smem_bytes(bq, d), 0.0)
            monkeypatch.setattr(tattn, "flash_geometry", lambda *a, g=g: g)
            outs.append(flash_attention(q, k, v, causal=False))
            torch.testing.assert_close(outs[-1], want, rtol=3e-4, atol=3e-4)
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llava-next-34b"])
def test_frontend_families_generate_on_the_card(cuda, arch):
    """Reduced seamless (encoder, cross-attention) and llava (vision prefix)
    through ``greedy_generate`` on the kernels: prefill logits within 1e-3
    of the torch backend's, the three kernels launched, no plain call."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import greedy_generate
    cfg = reduced(get_config(arch), param_dtype="float32",
                  compute_dtype="float32")
    params = T.init_params(cfg, 0)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40))).to(cuda)
    key = "audio_embeds" if cfg.enc_dec else "vision_embeds"
    extra = {key: _t(3, (2, cfg.audio_frames or cfg.vision_tokens,
                         cfg.frontend_dim), cuda)}
    batch = {"tokens": prompt, **extra}
    with Engine(backend="torch").activate():
        want, _, _ = T.forward(cfg, params, batch, mode="prefill")
    kern = Engine(backend="kernels")
    ref.reset_counts()
    kernels = {"sa_conv": sa_conv_matmul, "sa_fc": sa_fc_matmul,
               "attention": flash_attention}
    before = {r: f.launches for r, f in kernels.items()}
    with kern.tracing() as tr, kern.activate():
        got, _, _ = T.forward(cfg, params, batch, mode="prefill")
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    with kern.tracing() as tr2:
        toks = greedy_generate(cfg, params, prompt, 4, extra=extra,
                               engine=kern)
    assert toks.shape == (2, 4)
    recs = [x.regime for x in (*tr, *tr2)]
    assert {r: f.launches - before[r] for r, f in kernels.items()} == \
        {r: recs.count(r) for r in kernels}
    # a prefill's flash launches: self- (and cross-) attention per decoder
    # block, one per encoder block; two prefills
    per = cfg.n_layers * (2 if cfg.enc_dec else 1) + cfg.n_enc_layers
    assert recs.count("attention") == 2 * per
    assert all(v == 0 for v in ref.counts().values())


def test_pipelined_forward_two_streams_bitwise_sequential(cuda):
    """GPipe on the card: a reduced OLMo (bf16, 4 layers) cut into 2 stages,
    4 microbatches of one 64-token sequence, each stage on its own stream
    (``distributed/pipeline.py``): the logits bitwise the unpipelined
    forward of the whole wave and the stages run one after another on the
    default stream, and the kernels ran."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.pipeline import (lm_stages,
                                                  pipelined_forward)
    from repro_torch.models import transformer as T
    cfg = reduced(get_config("olmo-1b"), n_layers=4, d_model=256,
                  n_heads=4, head_dim=64, d_ff=512)
    p = T.init_params(cfg, 0, device=cuda)
    tok = torch.randint(0, cfg.vocab_size, (4, 64), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    stages = lm_stages(cfg, p, 2)
    launches = sa_conv_matmul.launches + sa_fc_matmul.launches
    with torch.no_grad(), Engine(backend="kernels").activate():
        want = T.forward(cfg, p, {"tokens": tok})[0]
        seq = torch.stack([stages[1](stages[0](t[None])) for t in tok])
        got = pipelined_forward(stages, tok[:, None])
    torch.cuda.synchronize()
    assert sa_conv_matmul.launches + sa_fc_matmul.launches > launches
    assert torch.equal(got, seq)
    assert torch.equal(got[:, 0], want)
