"""The port's kernel modules against the JAX package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as the JAX package's own tests run
them.  Inputs are made once with numpy from a seed and given to both.
Tolerances are the reference tests' (tests/test_fc_batch.py,
tests/test_conv_dispatch.py, tests/test_fused_pool.py, tests/test_kernels.py).
"""
from __future__ import annotations

import ctypes
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import quant as rquant
from repro.core.dataflow import PoolSpec as RPoolSpec
from repro.core.engine import DispatchPolicy as RPolicy
from repro.core.engine import Engine as REngine
from repro.kernels import ref as rref
from repro.kernels.attention import flash_attention as r_flash_attention
from repro.kernels.pool_act import maxpool_act as r_maxpool_act
from repro.kernels.sa_conv import sa_conv_matmul as r_sa_conv_matmul
from repro.kernels.sa_fc import sa_fc_matmul as r_sa_fc_matmul
from repro_torch.core import quant
from repro_torch.core.dataflow import PoolSpec
from repro_torch.core.engine import DispatchPolicy, Engine
from repro_torch.kernels import _build, ref
from repro_torch.kernels import attention as tattn
from repro_torch.kernels.attention import flash_attention, live_tiles
from repro_torch.kernels import pool_act as tpool
from repro_torch.kernels.pool_act import maxpool_act, pool_geometry
from repro_torch.kernels import sa_conv as tgemm
from repro_torch.kernels.sa_conv_implicit import (MAX_ROWS, MAX_SEGMENTS,
                                                  SMEM_MAX, THREADS,
                                                  TILES, column_strips,
                                                  conv_geometry, conv_tiles,
                                                  sa_conv_implicit,
                                                  sa_conv_plain)
from repro_torch.kernels import sa_fc as tfc
from repro_torch.kernels.sa_fc import (K_CHUNK, TARGET_CTAS, fc_launch,
                                       fc_split, row_tile, sa_fc_matmul,
                                       tc_launch, tc_route, tc_rows)

RTOL_FC = dict(rtol=3e-4, atol=3e-4)
RTOL_CONV = dict(rtol=2e-3, atol=2e-3)


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# SA-FC
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,k,n,bb", [
    (1, 512, 1024, None),      # b=1, whole-batch tile
    (1, 130, 190, 16),         # b=1 + unaligned k/n
    (5, 300, 257, 16),         # b below one tile, unaligned k/n
    (33, 512, 384, 16),        # b not a multiple of the batch tile
    (64, 1000, 129, 32),       # multiple batch tiles, unaligned n
])
def test_sa_fc_matches_reference(b, k, n, bb):
    x, w = _np(0, (b, k)), _np(1, (k, n))
    want = r_sa_fc_matmul(jnp.asarray(x), jnp.asarray(w), act="none", bb=bb,
                          bn=128, bk=128)
    got = sa_fc_matmul(torch.from_numpy(x), torch.from_numpy(w), act="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL_FC)


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu", "silu",
                                 "gelu"])
def test_sa_fc_int8_scale_bias_acts(act):
    x, w, bias = _np(0, (40, 300), 0.5), _np(1, (300, 200), 0.1), \
        _np(2, (200,))
    rq = rquant.quantize(jnp.asarray(w))
    want = r_sa_fc_matmul(jnp.asarray(x), rq.q, jnp.asarray(bias), act=act,
                          bb=16, bn=128, bk=128,
                          w_scale=rq.scale.reshape(1, -1))
    tq = quant.quantize(torch.from_numpy(w))
    got = sa_fc_matmul(torch.from_numpy(x), tq.q, torch.from_numpy(bias),
                       act=act, w_scale=tq.scale.reshape(1, -1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("b,tile", [(1, 1), (3, 4), (13, 16), (64, 64),
                                    (130, 64)])
def test_sa_fc_row_tile(b, tile):
    assert row_tile(b) == tile


#: SA-FC's shapes on the served paths: AlexNet fc1-fc3 and VGG-16 fc1 at
#: b = 64, and OLMo-1B's q/k/v/o, gate/up, down and lm_head at b = 4
#: (decode) and m = 512 (a lone request's prefill)
PATH_FC_SHAPES = [(64, 9216, 4096), (64, 4096, 4096), (64, 4096, 1000),
                  (64, 25088, 4096)] + [
    (b, k, n) for b in (4, 512)
    for k, n in ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 50304))]


@pytest.mark.parametrize("b,k,n", PATH_FC_SHAPES)
def test_sa_fc_launch_puts_two_ctas_on_every_sm(b, k, n):
    plan = fc_launch(b, k, n)
    assert plan.ctas >= TARGET_CTAS == 264
    assert plan.grid[0] * plan.cols >= n and plan.grid[1] * plan.rows >= b


@settings(max_examples=200, deadline=None)
@given(k=st.integers(0, 50000), n=st.integers(1, 60000))
def test_fc_split_covers_k_in_whole_chunks(k, n):
    segments, seg_k = fc_split(k, n)
    assert segments >= 1 and seg_k >= K_CHUNK and seg_k % K_CHUNK == 0
    # every k lies in exactly one segment, and no segment is empty
    assert (segments - 1) * seg_k < max(k, 1) <= segments * seg_k
    # the kernel counts the segments from seg_k alone
    chunks, per = -(-k // K_CHUNK), seg_k // K_CHUNK
    assert segments == (-(-chunks // per) if chunks > per else 1)


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 600), b2=st.integers(1, 600),
       k=st.integers(0, 30000), n=st.integers(1, 60000))
def test_fc_split_does_not_depend_on_the_batch(b, b2, k, n):
    p, q = fc_launch(b, k, n), fc_launch(b2, k, n)
    assert (p.segments, p.seg_k) == (q.segments, q.seg_k) == fc_split(k, n)
    for plan, rows in ((p, b), (q, b2)):
        assert plan.rows == row_tile(rows) and plan.cols == tfc._COLS[
            plan.rows]
        assert plan.grid[2] == (plan.segments if plan.split else 1)
        assert plan.split == (plan.segments > 1 and plan.grid[0]
                              * plan.grid[1] < TARGET_CTAS)


def test_sa_fc_split_scratch_is_reused_per_stream(monkeypatch):
    """Split launches take their counters and workspace from one cache per
    (device, stream): reused while large enough, grown when not, and a
    workspace above ``WORKSPACE_KEEP`` is made for its launch alone."""
    monkeypatch.setattr(tfc, "_SCRATCH", {})
    monkeypatch.setattr(tfc, "WORKSPACE_KEEP", 1000)
    cpu = torch.device("cpu")
    arr, part = tfc._scratch(cpu, 7, 10, 600)
    assert arr.dtype == torch.int32 and not arr.any() and arr.numel() >= 10
    assert part.dtype == torch.float32 and part.numel() == 600
    again = tfc._scratch(cpu, 7, 10, 500)
    assert again[0] is arr and again[1] is part
    assert tfc._scratch(cpu, 8, 10, 500)[1] is not part   # another stream
    grown = tfc._scratch(cpu, 7, 5000, 900)
    assert grown[0].numel() >= 5000 and grown[1].numel() == 900
    big = tfc._scratch(cpu, 7, 10, 2000)[1]
    assert big.numel() == 2000 and tfc._SCRATCH[(cpu, 7)][1] is grown[1]


#: the SA-FC shapes of the card's tests (tests/test_torch_gpu.py)
GPU_FC_SHAPES = [(1, 130, 190), (5, 300, 257), (33, 512, 384),
                 (70, 1000, 129), (4, 8192, 256), (3, 4608, 1000),
                 (130, 700, 4100)]


@pytest.mark.parametrize("b,k,n", GPU_FC_SHAPES)
def test_sa_fc_launch_at_the_gpu_test_shapes(b, k, n):
    """The tiles cover (b, n) with none to spare, the kernel's own count of
    segments (csrc/sa_fc.cu: ceil(ceil(k / 32) / seg_chunks)) is
    ``fc_split``'s, and the cases meant to split over k do."""
    plan = fc_launch(b, k, n)
    assert (plan.grid[0] - 1) * plan.cols < n <= plan.grid[0] * plan.cols
    assert (plan.grid[1] - 1) * plan.rows < b <= plan.grid[1] * plan.rows
    chunks = -(-k // K_CHUNK)
    assert plan.segments == max(1, -(-chunks // (plan.seg_k // K_CHUNK)))
    if k >= 4096:
        assert plan.split and plan.segments > 1


def test_sa_fc_rows_do_not_depend_on_the_batch():
    x, w = _np(0, (13, 700)), _np(1, (700, 50), 0.1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    full = sa_fc_matmul(xt, wt, act="relu")
    for i in range(13):
        one = sa_fc_matmul(torch.from_numpy(x[i:i + 1].copy()), wt,
                           act="relu")
        assert torch.equal(full[i:i + 1], one)


# ---------------------------------------------------------------------------
# SA-FC's tensor-core kernel (bf16 x, every weight type, every b)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8, 9, 13, 64, 130])
def test_sa_fc_decode_route_follows_dtype_and_row_tile(b):
    """bf16 x runs the tensor-core kernel whatever the weights and the
    batch, at the row tile :func:`tc_rows` gives; fp32 x the FMA kernel.
    On the CPU the wrapper runs its plain version and launches neither."""
    for xd in (torch.float32, torch.bfloat16):
        for wd in (torch.float32, torch.bfloat16, torch.int8):
            assert tc_route(xd) == (xd == torch.bfloat16)
            if tc_route(xd):
                d = tc_launch(b, 40, 24, torch.tensor([], dtype=wd)
                              .element_size())
                assert d.rows == tc_rows(b) == max(8, row_tile(b))
                assert d.row_tiles == -(-b // d.rows)
    before = (sa_fc_matmul.launches, sa_fc_matmul.tc_launches)
    x = torch.from_numpy(_np(0, (b, 40))).to(torch.bfloat16)
    w = torch.from_numpy(_np(1, (40, 24))).to(torch.bfloat16)
    sa_fc_matmul(x, w)
    assert (sa_fc_matmul.launches, sa_fc_matmul.tc_launches) == before


#: the bf16 decode shapes (b, k, n) of the served LM paths: OLMo-1B (b = 4
#: and the lone request's b = 1), zamba2-2.7b and mamba2-130m (b = 4),
#: seamless-m4t (b = 4) and llava-next-34b (b = 2)
LM_DECODE_SHAPES = [
    (b, k, n) for b in (4, 1)
    for k, n in ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 50304))] + [
    (4, 2560, 10448), (4, 5120, 2560), (4, 2560, 2560), (4, 2560, 10240),
    (4, 10240, 2560), (4, 2560, 32000), (4, 768, 3352), (4, 1536, 768),
    (4, 768, 50280), (4, 1024, 1024), (4, 1024, 8192), (4, 8192, 1024),
    (4, 1024, 256206), (2, 7168, 7168), (2, 7168, 1024), (2, 7168, 20480),
    (2, 20480, 7168), (2, 7168, 64000)]


@pytest.mark.parametrize("b,k,n", LM_DECODE_SHAPES)
def test_decode_units_cover_every_tile_and_segment_once(b, k, n):
    """Every (column tile, k segment, row tile) unit runs on one warp:
    narrow (k and n <= 4096), a warp of the CTA that owns the tile's
    segments, CTAs owning contiguous runs of 16-column tiles whose counts
    differ by at most one, one CTA an SM; wide, the grid one CTA an SM
    and no CTA without a unit.  The split is :func:`fc_split`'s; the CTAs
    fit an SM's shared memory."""
    d = tc_launch(b, k, n)
    assert (d.segments, d.seg_k) == fc_split(k, n) == (
        fc_launch(b, k, n).segments, fc_launch(b, k, n).seg_k)
    assert d.narrow == (k <= 4096 and n <= 4096) and d.rows == 8
    assert d.split == (d.segments > 1)
    assert d.tiles == -(-n // d.cols) and d.cols == (16 if d.narrow else 64)
    runs = {}
    for c in range(d.ctas):
        if d.narrow:
            t0, t1 = d.cta_tiles(c)
            assert t1 - t0 in (d.span, d.span - 1) and t1 - t0 >= 1
        for i in range(d.workers):
            for t, sg, rt in d.worker_units(c, i):
                assert not d.narrow or t0 <= t < t1
                runs[t, sg, rt] = runs.get((t, sg, rt), 0) + 1
    assert sorted(runs) == [(t, sg, 0) for t in range(d.tiles)
                            for sg in range(d.segments)]
    assert set(runs.values()) == {1}
    if d.narrow:
        assert d.ctas == min(d.tiles, 132)
        assert d.smem == tfc.narrow_smem_bytes(2, d.segments, d.span)
        assert d.smem - tfc.narrow_smem_bytes(2, 1, 1) <= 65536
    else:
        assert d.ctas == min(d.tiles * d.segments, 132)
        assert d.smem == tfc.wide_smem_bytes(d.rows, 2)
    assert d.smem + 1024 <= 233472


@settings(max_examples=60, deadline=None)
@given(k=st.integers(0, 30000), n=st.integers(1, 60000))
def test_decode_assignment_does_not_depend_on_the_batch(k, n):
    """The mode, the grid and the units of each warp are the same at every
    b of a row tile; the split over k at every b; from b = 9 wide, at row
    tiles of 8 where k is split into 8 or more segments, else of 16 and
    up."""
    one = tc_launch(1, k, n)
    sample = [(c, i) for c in sorted({0, one.ctas // 2, one.ctas - 1})
              for i in range(one.workers)]
    for b in range(2, 9):
        d = tc_launch(b, k, n)
        assert d.rows == 8
        assert (d.narrow, d.segments, d.seg_k, d.tiles, d.ctas, d.span) == (
            one.narrow, one.segments, one.seg_k, one.tiles, one.ctas,
            one.span)
        assert all(d.worker_units(c, i) == one.worker_units(c, i)
                   for c, i in sample)
    for b in (9, 33, 64, 65, 512):
        d = tc_launch(b, k, n)
        assert not d.narrow and d.rows == tc_rows(b, d.segments)
        assert d.rows == (8 if d.segments >= 8 else tc_rows(b))
        assert (d.segments, d.seg_k) == (one.segments, one.seg_k)


def test_decode_constants_match_the_cuda_source():
    """kernels/sa_fc.py mirrors csrc/sa_fc_tc.cu's two modes: the narrow
    units, warps and partials; the wide warps and rings; the chunk, the x
    row and the mode boundary; and the ctypes signatures have the launch's
    17 arguments and the query's 7."""
    src = (_build.CSRC / "sa_fc_tc.cu").read_text()
    narrow = src[src.index("namespace narrow {"):
                 src.index("}  // namespace narrow")]
    wide = src[src.index("namespace wide {"):src.index("}  // namespace wide")]
    for part, name, value in (
            (src, "BK", tfc.K_CHUNK), (src, "SM_COUNT", tfc.SM_COUNT),
            (src, "NARROW_MAX", tfc.NARROW_MAX), (src, "ROWS", 8),
            (narrow, "WARPS", tfc.N_WARPS), (narrow, "GCOLS", tfc.GCOLS),
            (narrow, "PART_SMEM_MAX", tfc.PART_SMEM_MAX),
            (wide, "DEPTH", tfc.W_DEPTH)):
        assert f"constexpr int {name} = {value};" in part, name
    for part, line in (
            (src, "constexpr int X_ROW = BK * 2;"),
            (narrow, "static constexpr int DEPTH = sizeof(WT) == 4 ? 4 : 6;"),
            (narrow, "static constexpr int STAGE = W_BYTES + ROWS * X_ROW;"),
            (wide, "static constexpr int TC = RB <= 16 ? (WB == 4 ? 32 : "
                   "64) : 2048 / RB;"),
            (wide, "static constexpr int WARPS = RB <= 16 ? 8 : 4;"),
            (wide, "static constexpr int STAGE = (W_BYTES + X_BYTES + 1023) "
                   "/ 1024 * 1024;"),
            (wide, "static constexpr int SP = TC + 4;"),
            (wide, "1024 + WARPS * DEPTH * STAGE + WARPS * RB * SP * 4 + "
                   "WARPS * DEPTH * 8;")):
        assert line in part, line
    assert tfc.TC_ROWS == (8, 16, 32, 64) and tfc.X_ROW == 64
    assert "case 8: return launch_kernel<WT, 8>(a);" in src
    assert "case 64: return launch_kernel<WT, 64>(a);" in src
    assert [tfc.tc_cols(r, wb) for r in tfc.TC_ROWS for wb in (4, 2, 1)] == [
        32, 64, 64, 32, 64, 64, 64, 64, 64, 32, 32, 32]
    assert [tfc.wide_warps(r) for r in tfc.TC_ROWS] == [8, 8, 4, 4]
    name, args = _build.SIGNATURES["sa_fc_tc"]
    assert name == "sa_fc_tc_launch" and len(args) == 17
    assert _build.SMEM_SIGNATURES["sa_fc_tc"] == ("sa_fc_tc_smem",
                                                  (ctypes.c_int,) * 7)
    assert "sa_fc_tc" in _build.SOURCES and "sa_fc_decode" not in \
        _build.SOURCES


# ---------------------------------------------------------------------------
# SA-CONV through the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("pad", [0, 1, 2])
def test_conv2d_matches_reference_stride_pad(stride, pad):
    x, f, b = _np(0, (2, 13, 15, 5)), _np(1, (3, 3, 5, 24), 0.2), \
        _np(2, (24,))
    want = REngine(backend="pallas", interpret=True).conv2d(
        jnp.asarray(x), jnp.asarray(f), jnp.asarray(b), stride=stride,
        pad=pad, act="relu")
    got = Engine(backend="kernels").conv2d(
        torch.from_numpy(x), torch.from_numpy(f), torch.from_numpy(b),
        stride=stride, pad=pad, act="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL_CONV)


@pytest.mark.parametrize("stride,pad", [(1, 1), (2, 2), (4, 0)])
def test_conv2d_int8_matches_reference(stride, pad):
    x, f, b = _np(0, (2, 12, 12, 6)), _np(1, (3, 3, 6, 16), 0.2), \
        _np(2, (16,))
    want = REngine(backend="pallas", interpret=True).conv2d(
        jnp.asarray(x), rquant.quantize(jnp.asarray(f)), jnp.asarray(b),
        stride=stride, pad=pad, act="relu")
    eng = Engine(backend="kernels")
    with eng.tracing() as tr:
        got = eng.conv2d(torch.from_numpy(x),
                         quant.quantize(torch.from_numpy(f)),
                         torch.from_numpy(b), stride=stride, pad=pad,
                         act="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=5e-3)
    assert tr[0].weight_dtype == "int8"


@pytest.mark.parametrize("window,conv_stride,res", [
    (2, 1, 10), (3, 1, 11), (3, 2, 11)])      # OFMs 8, 9, 5: windows tile
@pytest.mark.parametrize("act", ["relu", "none"])
def test_fused_pool_matches_reference(window, conv_stride, res, act):
    x, f, b = _np(0, (2, res, res, 6)), _np(1, (3, 3, 6, 24), 0.2), \
        _np(2, (24,))
    want = REngine(backend="pallas", interpret=True).conv2d(
        jnp.asarray(x), jnp.asarray(f), jnp.asarray(b), stride=conv_stride,
        act=act, pool=RPoolSpec(window, 2))
    eng = Engine(backend="kernels")
    xt, ft, bt = map(torch.from_numpy, (x, f, b))
    with eng.tracing() as tr:
        fused = eng.conv2d(xt, ft, bt, stride=conv_stride, act=act,
                           pool=PoolSpec(window, 2))
    assert len(tr) == 1 and tr[0].conv_plan.fuse_pool
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), **RTOL_CONV)
    conv = eng.conv2d(xt, ft, bt, stride=conv_stride, act=act)
    assert torch.equal(fused, maxpool_act(conv, window=window, stride=2,
                                          act="none"))


def test_declined_fusion_runs_the_pool_kernel_path():
    x, f = _np(0, (2, 15, 15, 8)), _np(1, (3, 3, 8, 32), 0.2)
    eng = Engine(backend="kernels")
    with eng.tracing() as tr:
        got = eng.conv2d(torch.from_numpy(x), torch.from_numpy(f),
                         act="silu", pool=PoolSpec(3, 2), name="c")
    assert not tr[0].conv_plan.fuse_pool
    assert [r.name for r in tr] == ["c", "c.pool"] and tr[1].regime == "pool"
    want = REngine(backend="xla").conv2d(jnp.asarray(x), jnp.asarray(f),
                                         act="silu", pool=RPoolSpec(3, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL_CONV)


def _check_tiling(g, batch, stride, p):
    """Every emitted output once, each from a CTA that holds its whole
    pool window; every CTA within its pixel slots, staged rows and
    segment table."""
    computed = np.zeros((batch, g.conv_h, g.conv_w), np.int32)
    emitted = np.zeros((batch, g.out_h, g.out_w), np.int32)
    for tile in range(g.pixel_tiles(batch)):
        segs = conv_tiles(g, batch, tile)
        assert 1 <= len(segs) <= MAX_SEGMENTS
        assert sum(hi - lo for _, _, _, lo, hi, _, _ in segs) <= (
            g.per_cta if not g.bands else g.pixels)
        assert sum((nr - 1) * stride + p for _, _, nr, *_ in segs) <= g.rin
        for img, r0, nr, lo, hi, pr0, npr in segs:
            block = computed[img, r0:r0 + nr].reshape(-1)
            assert block.size == nr * g.conv_w and 0 <= lo < hi <= block.size
            block[lo:hi] += 1
            computed[img, r0:r0 + nr] = block.reshape(nr, g.conv_w)
            if g.bands:
                # the emitted rows' windows lie inside the segment's rows
                assert pr0 * g.pool_stride == r0 and lo == 0
                assert (npr - 1) * g.pool_stride + g.pool_window <= nr
                emitted[img, pr0:pr0 + npr] += 1
    if not g.bands:
        emitted = computed                    # no pool: emitted == conv
    assert (emitted == 1).all()
    used = (g.out_h - 1) * g.pool_stride + g.pool_window
    assert (computed[:, :used] >= 1).all()


@pytest.mark.parametrize("name,h,w,ci,p,co,stride,window", [
    ("alexnet conv1", 227, 227, 3, 11, 96, 4, 3),
    ("alexnet conv2", 31, 31, 96, 5, 256, 1, 3),
    ("alexnet conv3", 15, 15, 256, 3, 384, 1, 0),
    ("alexnet conv4", 15, 15, 384, 3, 384, 1, 0),
    ("alexnet conv5", 15, 15, 384, 3, 256, 1, 3),
    ("vgg16 conv1_2", 226, 226, 64, 3, 64, 1, 2),
    ("vgg16 conv5_3", 16, 16, 512, 3, 512, 1, 2),
    ("ragged", 13, 15, 5, 3, 24, 2, 0),
    ("pooled, stride 3", 15, 15, 8, 3, 16, 3, 3),
])
def test_conv_geometry_covers_the_output(name, h, w, ci, p, co, stride,
                                         window):
    """The tiling covers every output once without splitting a pool
    window, fits a Hopper CTA's shared memory and tables, and at AlexNet's
    five layers uses at least 90 % of the pixel slots of a b=64 launch."""
    g = conv_geometry(h, w, ci, p, p, co, stride=stride, pool_window=window,
                      pool_stride=2 if window else 0)
    assert (g.tpx, g.tco, g.groups) in TILES and g.bco == g.tco * g.groups
    assert g.pixels == THREADS // g.groups * g.tpx
    assert g.smem_bytes <= SMEM_MAX and g.rin <= MAX_ROWS
    assert g.out_h == ((h - p) // stride + 1 - g.pool_window) \
        // g.pool_stride + 1
    for batch in (1, 3):
        _check_tiling(g, batch, stride, p)
    use = g.slot_use(64)
    print(f"{name}: tile {g.pixels} px x {g.bco} co, "
          f"{'flat' if not g.bands else f'{g.bands} bands x {g.rows} rows, {g.per_cta} per CTA'}"
          f"; b=64: {g.ctas(64, co)} CTAs, one per SM at a time, "
          f"{g.waves(64, co):.2f} waves, slot use {use:.3f}, needed pixels "
          f"per slot {g.needed_pixels(64) / (g.pixel_tiles(64) * g.pixels):.3f}")
    if name.startswith("alexnet"):
        assert use >= 0.90
        assert g.waves(64, co) % 1 == 0 or g.waves(64, co) % 1 >= 0.85 \
            or g.waves(64, co) > 3


@pytest.mark.parametrize("batch", [1, 2, 13, 64, 65])
def test_conv_geometry_does_not_depend_on_the_batch(batch):
    """The tile is the layer's; the batch changes only the CTA count."""
    g = conv_geometry(15, 15, 256, 3, 3, 384)
    assert g.ctas(batch, 384) == -(-batch * 169 // g.per_cta) * (384 // g.bco)
    _check_tiling(g, batch, 1, 3)


def test_conv_geometry_refuses_rows_wider_than_a_cta():
    """Flat pixel tiles cut rows wider than a CTA (no pool); a pool window
    whose rows do not fit one CTA is still refused by the geometry (the
    wrapper then runs column strips, :func:`column_strips`)."""
    g = conv_geometry(1000, 1000, 3, 3, 3, 8)
    assert not g.bands and g.conv_w > g.pixels
    _check_tiling(g, 1, 1, 3)
    with pytest.raises(NotImplementedError, match="does not fit"):
        conv_geometry(1000, 1000, 3, 3, 3, 8, pool_window=3, pool_stride=2)


#: pooled rows wider than a CTA holds: conv_geometry refuses the whole
#: width, so the wrapper runs column strips (h = w, ci, co, pool)
WIDE_POOLED = [(259, 16, 64, 3, 2), (388, 16, 64, 2, 2), (1000, 3, 8, 3, 2)]


@pytest.mark.parametrize("hw,ci,co,pw,ps", WIDE_POOLED)
def test_column_strips_cover_the_pooled_columns(hw, ci, co, pw, ps):
    """Every pooled column in exactly one strip, each strip whole pool
    windows over its own input columns, each strip's input fits one CTA,
    and no fewer strips would."""
    kw = dict(pool_window=pw, pool_stride=ps)
    with pytest.raises(NotImplementedError, match="does not fit"):
        conv_geometry(hw, hw, ci, 3, 3, co, **kw)
    strips = column_strips(hw, hw, ci, 3, 3, co, **kw)
    n_out = (hw - 3 + 1 - pw) // ps + 1
    covered = np.zeros(n_out, np.int32)
    for j0, j1, x0, x1 in strips:
        covered[j0:j1] += 1
        # conv columns [j0 ps, (j1 - 1) ps + pw) from input [x0, x1)
        assert x0 == j0 * ps and x1 == (j1 - 1) * ps + pw - 1 + 3 <= hw
        g = conv_geometry(hw, x1 - x0, ci, 3, 3, co, **kw)
        assert g.out_w == j1 - j0 and g.smem_bytes <= SMEM_MAX
        _check_tiling(g, 1, 1, 3)
    assert (covered == 1).all()
    widths = [j1 - j0 for j0, j1, _, _ in strips]
    assert max(widths) - min(widths) <= 1
    fewer = -(-n_out // (len(strips) - 1))
    with pytest.raises(NotImplementedError):
        conv_geometry(hw, (fewer - 1) * ps + pw - 1 + 3, ci, 3, 3, co, **kw)


@pytest.mark.parametrize("h,ci,p,co,stride,window", [
    (227, 3, 11, 96, 4, 3), (31, 96, 5, 256, 1, 3), (15, 384, 3, 256, 1, 3),
    (15, 256, 3, 384, 1, 0), (226, 64, 3, 64, 1, 2)])
def test_column_strips_keep_a_layer_that_fits_whole(h, ci, p, co, stride,
                                                    window):
    """AlexNet's and VGG-16's layers stay one launch over the whole width."""
    kw = dict(stride=stride, pool_window=window,
              pool_stride=2 if window else 0)
    g = conv_geometry(h, h, ci, p, p, co, **kw)
    assert column_strips(h, h, ci, p, p, co, **kw) == (
        (0, g.out_w, 0, h),)


@pytest.mark.parametrize("hw,ci,co,pw,ps", WIDE_POOLED[:2])
def test_sa_conv_plain_strips_stitch_to_the_whole_width(hw, ci, co, pw, ps):
    """The plain version run strip by strip and stitched equals it run over
    the whole width, bitwise (narrow output channels)."""
    x = torch.from_numpy(_np(0, (1, hw, hw, ci)))
    f, b = torch.from_numpy(_np(1, (3, 3, ci, 8), 0.1)), \
        torch.from_numpy(_np(2, (8,)))
    kw = dict(act="relu", pool_window=pw, pool_stride=ps)
    whole = sa_conv_plain(x, f, b, **kw)
    parts = [sa_conv_plain(x[:, :, x0:x1].contiguous(), f, b, **kw)
             for _, _, x0, x1 in column_strips(hw, hw, ci, 3, 3, co,
                                               pool_window=pw,
                                               pool_stride=ps)]
    assert torch.equal(torch.cat(parts, dim=2), whole)


def test_sa_conv_plain_is_the_kernel_order_of_operations():
    """Scale, bias, pool, act — the epilogue's order."""
    x, f = _np(0, (1, 9, 9, 4)), _np(1, (3, 3, 4, 8), 0.2)
    s, b = _np(2, (8,)) ** 2, _np(3, (8,))
    xt, ft, st, bt = map(torch.from_numpy, (x, f, s, b))
    got = sa_conv_implicit(xt, ft, bt, act="relu", pool_window=3,
                           pool_stride=2, w_scale=st)
    want = torch.relu(ref.maxpool2d(ref.conv2d(xt, ft) * st + bt, window=3,
                                    stride=2))
    assert torch.equal(got, want)
    assert torch.equal(got, sa_conv_plain(xt, ft, bt, act="relu",
                                          pool_window=3, pool_stride=2,
                                          w_scale=st))


# ---------------------------------------------------------------------------
# SA-CONV GEMM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,n,k", [(64, 256, 384), (100, 300, 200),
                                   (257, 513, 129)])
@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu", "silu",
                                 "gelu"])
def test_sa_conv_matmul_matches_reference(m, n, k, act):
    x, w, b = _np(0, (m, k)), _np(1, (k, n), k ** -0.5), _np(2, (n,))
    want = r_sa_conv_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            act=act)
    got = tgemm.sa_conv_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL_FC)


@pytest.mark.parametrize("m,n,k", [(1, 128, 256), (100, 300, 200),
                                   (130, 70, 513)])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_sa_conv_matmul_int8_matches_reference(m, n, k, act):
    x, w, b = _np(0, (m, k)), _np(1, (k, n), 0.1), _np(2, (n,))
    rq = rquant.quantize(jnp.asarray(w))
    want = r_sa_conv_matmul(jnp.asarray(x), rq.q, jnp.asarray(b), act=act,
                            w_scale=rq.scale.reshape(1, -1))
    tq = quant.quantize(torch.from_numpy(w))
    got = tgemm.sa_conv_matmul(torch.from_numpy(x), tq.q, torch.from_numpy(b),
                         act=act, w_scale=tq.scale.reshape(1, -1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL_FC)
    plain = tgemm.sa_conv_matmul_plain(torch.from_numpy(x), tq.q,
                                       torch.from_numpy(b), act=act,
                                       w_scale=tq.scale)
    assert torch.equal(got, plain)


def _gemm_tile_cover() -> np.ndarray:
    """How many threads of a CTA own each output of its BM x BN tile."""
    cover = np.zeros((tgemm.BM, tgemm.BN), np.int32)
    g = tgemm.gemm_geometry(tgemm.BM, tgemm.BN, tgemm.BK, 0)
    for t in range(tgemm.THREADS):
        rows, cols = g.thread_outputs(t)
        cover[np.ix_(rows, cols)] += 1
    return cover


@settings(max_examples=60, deadline=None)
@given(m=st.integers(1, 700), n=st.integers(1, 900), k=st.integers(0, 3000),
       w_kind=st.sampled_from([0, 1, 2]))
def test_gemm_geometry_covers_every_output_once(m, n, k, w_kind):
    """Every output of a ragged (m, n) in exactly one CTA and one thread;
    the CTAs' origins are the distinct tiles, row tiles fastest."""
    g = tgemm.gemm_geometry(m, n, k, w_kind)
    assert (_gemm_tile_cover() == 1).all()
    seen = np.zeros((g.row_tiles * tgemm.BM, g.col_tiles * tgemm.BN),
                    np.int32)
    for cta in range(g.ctas):
        r0, c0 = g.cta_origin(cta)
        seen[r0:r0 + tgemm.BM, c0:c0 + tgemm.BN] += 1
        if cta + 1 < g.ctas and (cta + 1) % g.row_tiles:
            assert g.cta_origin(cta + 1) == (r0 + tgemm.BM, c0)
    assert (seen == 1).all()
    assert seen.shape[0] - tgemm.BM < m <= seen.shape[0]
    assert seen.shape[1] - tgemm.BN < n <= seen.shape[1]


#: (m, k, n) of a full-wave OLMo-1B prefill's GEMMs: q/k/v/o, gate/up,
#: down, lm_head
OLMO_GEMMS = [(2048, 2048, 2048), (2048, 2048, 8192), (2048, 8192, 2048),
              (2048, 2048, 50304)]


@pytest.mark.parametrize("shape,ctas,waves", [
    (OLMO_GEMMS[0], 256, 0.97), (OLMO_GEMMS[1], 1024, 3.88),
    (OLMO_GEMMS[2], 256, 0.97), (OLMO_GEMMS[3], 6288, 23.82)])
def test_gemm_geometry_at_the_path_shapes(shape, ctas, waves):
    """128 x 128 tiles at two CTAs per SM: 256 CTAs on 264 slots for
    q/k/v/o and down, 16-byte w copies, 4-byte x copies."""
    m, k, n = shape
    g = tgemm.gemm_geometry(m, n, k, 0)
    assert (g.row_tiles, g.ctas) == (16, ctas)
    assert round(g.waves, 2) == waves
    assert (g.x_copy, g.w_copy) == (4, 16)
    print(f"{shape}: {g.ctas} CTAs, {g.waves:.2f} waves, "
          f"{g.smem_bytes} B shared memory per CTA")


#: the most shared memory a Hopper CTA may opt into, and an SM holds
SMEM_OPTIN, SMEM_PER_SM = 232448, 233472


@pytest.mark.parametrize("w_kind", [0, 1, 2])
def test_gemm_shared_memory_fits_every_weight_type(w_kind):
    g = tgemm.gemm_geometry(2048, 2048, 2048, w_kind)
    assert g.smem_bytes <= SMEM_OPTIN
    assert tgemm.PER_SM * (g.smem_bytes + 1024) <= SMEM_PER_SM
    assert g.smem_bytes % 16 == 0


@pytest.mark.parametrize("n,w_kind,w_copy", [
    (2999, 0, 4), (2998, 0, 8), (1000, 0, 16), (1001, 1, 0), (1002, 1, 0),
    (1004, 1, 4), (1000, 1, 8), (1008, 1, 16), (1001, 2, 0), (1002, 2, 4),
    (1004, 2, 8), (1000, 2, 16)])
def test_gemm_copy_widths_fall_back_for_unaligned_rows(n, w_kind, w_copy):
    """w's copies narrow to what its row bytes allow (element loads where
    not 4); x goes in 4-byte copies whatever k (1001 included)."""
    for k in (1001, 2048):
        g = tgemm.gemm_geometry(1000, n, k, w_kind)
        assert (g.x_copy, g.w_copy) == (4, w_copy)
    # a base one element into its buffer: 4-byte copies (fp32) or
    # element loads (int8, bf16)
    item = tgemm.W_BYTES[w_kind]
    assert tgemm.copy_bytes(n * item, 256 + item) == (4 if item == 4 else 0)


@pytest.mark.parametrize("k", [0, 1, 15, 16, 1001, 2048])
def test_gemm_sum_order_depends_on_k_alone(k):
    """Every output adds x[r, i] * w[i, c] for i = 0, 1, ..., k - 1 in
    order, then the zero-filled terms of the last stage: the same sequence
    at any m, n, weight type, CTA and thread."""
    want = list(range(k)) + [-1] * (-k % tgemm.BK)
    for m, n, w_kind in ((1, 1, 0), (2048, 50304, 0), (130, 257, 1),
                         (3, 8192, 2)):
        assert tgemm.gemm_geometry(m, n, k, w_kind).k_order(k) == want


def test_gemm_constants_match_the_cuda_source():
    """kernels/sa_conv.py mirrors csrc/sa_conv.cu's tiling and rings (the
    FMA loop's and the tensor cores'), and the ctypes signature has the
    launch's 15 arguments."""
    src = (_build.CSRC / "sa_conv.cu").read_text()
    for name, value in (("BM", tgemm.BM), ("BN", tgemm.BN),
                        ("THREADS", tgemm.THREADS), ("PER_SM", tgemm.PER_SM),
                        ("BK", tgemm.BK), ("STAGES", tgemm.STAGES),
                        ("TC_STAGES", tgemm.TC_STAGES),
                        ("TC_RAW_STAGES", tgemm.TC_RAW_STAGES)):
        assert f"constexpr int {name} = {value};" in src, name
    assert "constexpr int AP = BM + 4;" in src
    name, args = _build.SIGNATURES["sa_conv"]
    assert name == "sa_conv_launch" and len(args) == 15


def test_engine_sa_conv_route_matches_reference():
    """A matmul the policy puts in the sa_conv regime runs the SA-CONV GEMM
    wrapper (its plain version here) and records what the reference
    records."""
    x, w, b = _np(0, (48, 96)), _np(1, (96, 80), 0.1), _np(2, (80,))
    reng = REngine(backend="pallas", interpret=True,
                   policy=RPolicy(force_regime="sa_conv"))
    with reng.tracing() as rtr:
        want = reng.matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           act="relu", name="proj")
    eng = Engine(backend="kernels",
                 policy=DispatchPolicy(force_regime="sa_conv"))
    with eng.tracing() as tr:
        got = eng.matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), act="relu", name="proj")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL_FC)
    assert tr[0].regime == "sa_conv" and tr[0].plan is not None
    assert (tr[0].m, tr[0].n, tr[0].k, tr[0].case) == \
        (rtr[0].m, rtr[0].n, rtr[0].k, rtr[0].case)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def _qkv(b, sq, skv, hq, hkv, d, seeds=(0, 1, 2)):
    return (_np(seeds[0], (b, sq, hq, d)), _np(seeds[1], (b, skv, hkv, d)),
            _np(seeds[2], (b, skv, hkv, d)))


FLASH_CASES = [   # tests/test_kernels.py's, which cover GQA, window,
                  # softcap, one query against 300 keys, and d = 48
    dict(b=2, sq=256, skv=256, hq=4, hkv=2, d=64, window=0, softcap=0.0),
    dict(b=1, sq=256, skv=256, hq=8, hkv=8, d=32, window=64, softcap=0.0),
    dict(b=2, sq=128, skv=128, hq=4, hkv=1, d=64, window=0, softcap=50.0),
    dict(b=1, sq=1, skv=300, hq=4, hkv=2, d=64, window=0, softcap=0.0),
    dict(b=1, sq=1, skv=300, hq=4, hkv=2, d=64, window=128, softcap=0.0),
    dict(b=2, sq=200, skv=200, hq=2, hkv=2, d=48, window=0, softcap=0.0),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_reference(case):
    c = dict(case)
    q, k, v = _qkv(c["b"], c["sq"], c["skv"], c["hq"], c["hkv"], c["d"])
    want = r_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=c["window"], softcap=c["softcap"],
                             bq=64, bkv=128)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), window=c["window"],
                          softcap=c["softcap"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)
    plain = rref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           window=c["window"], softcap=c["softcap"])
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), rtol=3e-4,
                               atol=3e-4)


@settings(max_examples=6, deadline=None)
@given(sq=st.integers(1, 160), hkv=st.sampled_from([1, 2, 4]),
       g=st.sampled_from([1, 2]), window=st.sampled_from([0, 32]))
def test_flash_attention_property(sq, hkv, g, window):
    q, k, v = _qkv(1, sq, sq, hkv * g, hkv, 32, seeds=(6, 7, 8))
    want = r_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=window, bq=32, bkv=128)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-4)


def test_flash_attention_non_causal_and_scale():
    q, k, v = _qkv(1, 10, 24, 4, 2, 16)
    kw = dict(causal=False, scale=0.3, softcap=5.0)
    want = rref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          **kw)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def _reference_live(iq, bq, sq, skv, causal, window):
    """The kv tiles of the kernel's size that the TPU kernel's grid-level
    test (attention.py, ``live``) keeps for query tile ``iq`` of ``bq``
    rows."""
    bkv = tattn.BKV
    q_lo = iq * bq + skv - sq
    q_hi = min(q_lo + bq - 1, skv - 1)           # the last real row
    want = []
    for ikv in range(-(-skv // bkv)):
        k_lo, k_hi = ikv * bkv, ikv * bkv + bkv - 1
        live = k_lo <= skv - 1
        if causal:
            live &= k_lo <= q_hi
        if window > 0:
            live &= k_hi > q_lo - window
        if live:
            want.append(ikv)
    return want


@pytest.mark.parametrize("sq,skv", [(512, 512), (200, 200), (1, 300),
                                    (64, 640), (130, 70)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 16, 64, 100])
def test_flash_loop_bounds_are_the_reference_skip(sq, skv, causal, window):
    """The kernel's loop over kv tiles visits exactly the tiles the TPU
    kernel's grid-level test keeps for a query tile of each of the kernel's
    heights, and every unmasked key of a real row lies in a visited
    tile."""
    for bq in tattn.BQ:
        offset = skv - sq
        for iq in range(-(-sq // bq)):
            tiles = live_tiles(iq, sq, skv, causal=causal, window=window,
                               bq=bq)
            assert list(tiles) == _reference_live(iq, bq, sq, skv, causal,
                                                  window)
            q_lo = iq * bq + offset
            for qpos in range(q_lo, min(q_lo + bq - 1, skv - 1) + 1):
                for kpos in range(skv):
                    seen = (not causal or kpos <= qpos) and \
                        (window <= 0 or kpos > qpos - window)
                    if seen:
                        assert kpos // tattn.BKV in tiles


#: (b, sq, skv, hq, hkv, d, causal, window): the LM path's two prefill
#: shapes (a full wave and a lone request, OLMo-1B), then FLASH_CASES
GEOMETRY_SHAPES = [(4, 512, 512, 16, 16, 128, True, 0),
                   (1, 512, 512, 16, 16, 128, True, 0)] + [
    (c["b"], c["sq"], c["skv"], c["hq"], c["hkv"], c["d"], True,
     c["window"]) for c in FLASH_CASES]


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_flash_geometry_covers_every_row_once(shape):
    """Every (batch * head, query row) in exactly one CTA's query tiles,
    each tile looping over the reference's live kv tiles; shared memory
    within a Hopper CTA's."""
    b, sq, skv, hq, hkv, d, causal, window = shape
    g = tattn.flash_geometry(*shape)
    assert g.bq in tattn.BQ and g.heads == b * hq
    assert g.q_tiles == -(-sq // g.bq) and g.smem_bytes <= SMEM_OPTIN
    seen = np.zeros((b * hq, sq), np.int32)
    for cta in range(g.ctas):
        bh, tiles = g.cta_tiles(cta)
        assert 1 <= len(tiles) <= (2 if g.paired else 1)
        for iq in tiles:
            seen[bh, iq * g.bq:(iq + 1) * g.bq] += 1
            assert list(live_tiles(iq, sq, skv, causal=causal, window=window,
                                   bq=g.bq)) == _reference_live(
                iq, g.bq, sq, skv, causal, window)
    assert (seen == 1).all()
    print(f"{shape}: {g.bq} rows per tile, paired {g.paired}, {g.ctas} "
          f"CTAs, {g.ctas / tattn.SM_COUNT:.2f} waves, modelled "
          f"{g.makespan_us:.1f} us")


def test_flash_geometry_at_the_path_shapes():
    """A full wave's prefill pairs query tiles so every CTA has the same
    live kv tiles; a lone request's prefill keeps at least 128 CTAs."""
    full = tattn.flash_geometry(4, 512, 512, 16, 16, 128, True, 0)
    lone = tattn.flash_geometry(1, 512, 512, 16, 16, 128, True, 0)
    assert lone.ctas >= 128
    if full.paired:
        counts = {sum(len(live_tiles(iq, 512, 512, causal=True, window=0,
                                     bq=full.bq))
                      for iq in full.cta_tiles(c)[1])
                  for c in range(full.ctas)}
        assert len(counts) == 1


#: the most shared memory a Hopper CTA may opt into
SMEM_OPTIN = 232448


@pytest.mark.parametrize("d", tattn.HEAD_DIMS)
def test_flash_shared_memory_fits_every_head_dim(d):
    for bq in tattn.BQ:
        assert tattn.smem_bytes(bq, d) <= SMEM_OPTIN


def _tensor_core_numerics(q, k, v, *, causal, window, softcap):
    """bf16 flash as csrc/attention.cu's tensor-core kernel orders it, in
    plain fp32 on the CPU: each score summed over 16-column steps of d,
    the online softmax in base 2 over kv tiles of 64, P split into hi =
    bf16(p) and lo = bf16(p - hi) for P V, the output rounded once."""
    b, sq, hq, d = q.shape
    skv, g = k.shape[1], hq // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf, vf = (ref.repeat_kv(t, g).float().permute(0, 2, 1, 3) for t in (k, v))
    scale2 = d ** -0.5 * 1.4426950408889634
    qpos = torch.arange(sq)[:, None] + skv - sq
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, skv, 64):
        kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        s = torch.zeros((b, hq, sq, kt.shape[2]))
        for c in range(0, d, 16):
            s = s + qf[..., c:c + 16] @ kt[..., c:c + 16].transpose(-1, -2)
        if softcap > 0:
            t = softcap * torch.tanh(s * d ** -0.5 / softcap) \
                * 1.4426950408889634
        else:
            t = s * scale2
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones((sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        t = torch.where(ok, t, torch.tensor(-1e30))
        mnew = torch.maximum(m, t.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mnew)
        p = torch.where(ok, torch.exp2(t - mnew), torch.tensor(0.0))
        l = alpha * l + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        acc = acc * alpha + hi @ vt + lo @ vt
        m = mnew
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("case", FLASH_CASES + [
    dict(b=1, sq=70, skv=70, hq=4, hkv=2, d=80, window=0, softcap=0.0),
    dict(b=1, sq=100, skv=100, hq=2, hkv=2, d=128, window=40, softcap=0.0)])
def test_flash_widened_bound_covers_the_tensor_core_numerics(case):
    """``widened_bound`` holds for bf16 flash computed as the tensor-core
    kernel orders it (16-wide d steps, kv tiles of 64, P split into two
    bf16 terms) against the fp32 function on the widened operands."""
    c = dict(case)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(
        c["b"], c["sq"], c["skv"], c["hq"], c["hkv"], c["d"]))
    kw = dict(causal=True, window=c["window"], softcap=c["softcap"])
    wide = ref.attention(q.float(), k.float(), v.float(), **kw)
    got = _tensor_core_numerics(q, k, v, **kw)
    bound = tattn.widened_bound(q, k, v, wide, **kw)
    assert bound.shape == wide.shape and (bound > 0).all()
    d = (got.double() - wide.double()).abs()
    assert (d <= bound).all(), (d / bound).max().item()


#: the bf16 kernel's dynamic shared memory by padded row (64 or 128
#: columns) and tile height: 1024 B of alignment, two Q tiles, three
#: stages of K and V, eight mbarriers
BF16_FLASH_SMEM = {64: {64: 66624, 128: 83008}, 128: {64: 132160, 128: 164928}}


@pytest.mark.parametrize("d", tattn.HEAD_DIMS)
def test_flash_bf16_geometry_and_shared_memory_at_every_head_dim(d):
    """bf16 launches run the tensor-core kernel at either tile height: one
    consumer warpgroup a 64 rows, rows padded to 64 or 128 columns, the
    shared memory pinned and under the 227 KB a CTA may opt into; its
    fragment map stores every (row, column) of a query tile once."""
    dp = tattn.padded_dim(d)
    assert dp == (64 if d <= 64 else 128)
    for bq in tattn.BQ:
        assert tattn.smem_bytes(bq, d, 2) == BF16_FLASH_SMEM[dp][bq] \
            <= SMEM_OPTIN
        g = tattn.FlashGeometry(bq, False, 1, 1, tattn.smem_bytes(bq, d, 2),
                                0.0, tensor_cores=True)
        seen = np.zeros((bq, d), np.int32)
        for t in range(g.threads):
            rows, cols = g.thread_outputs(t, d)
            for r in rows:
                seen[r, cols] += 1
        assert (seen == 1).all()
    for shape in ((4, 512, 512, 16, 16, d, True, 0),
                  (1, 512, 512, 16, 16, d, True, 0),
                  (4, 1024, 1024, 16, 16, d, False, 0)):
        g = tattn.flash_geometry(*shape, 2)
        assert g.tensor_cores and g.threads == 2 * g.bq
        assert g.smem_bytes == BF16_FLASH_SMEM[dp][g.bq]


def test_engine_attention_records_and_routes():
    q, k, v = _qkv(2, 24, 24, 4, 2, 16)
    reng = REngine(backend="pallas", interpret=True)
    with reng.tracing() as rtr:
        want = reng.attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), window=8, name="attn")
    for backend in ("kernels", "torch"):
        eng = Engine(backend=backend)
        with eng.tracing() as tr:
            got = eng.attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=8, name="attn")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                                   atol=3e-4)
        assert (tr[0].name, tr[0].regime, tr[0].m, tr[0].n, tr[0].k,
                tr[0].dtype) == (rtr[0].name, rtr[0].regime, rtr[0].m,
                                 rtr[0].n, rtr[0].k, rtr[0].dtype)
    grads = []
    for backend in ("kernels", "torch"):
        qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = Engine(backend=backend).attention(*qkv, window=8)
        grads.append(torch.autograd.grad((out * out).sum(), qkv))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)


# ---------------------------------------------------------------------------
# pool
# ---------------------------------------------------------------------------
def test_maxpool_act_odd_channels_matches_reference():
    x = _np(0, (2, 9, 9, 37))
    want = r_maxpool_act(jnp.asarray(x), window=3, stride=2, act="relu")
    got = maxpool_act(torch.from_numpy(x), window=3, stride=2, act="relu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_maxpool_act_int8_matches_reference():
    x = np.random.default_rng(0).integers(-120, -1, (2, 6, 6, 130)
                                          ).astype(np.int8)
    want = r_maxpool_act(jnp.asarray(x), window=2, stride=2, act="none",
                         bc=128)
    got = maxpool_act(torch.from_numpy(x), window=2, stride=2, act="none")
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


#: chip_smoke.POOL_SWEEP's maps at b = 64: AlexNet's pooled maps (3/2) and
#: VGG-16's (2/2); (h = w, c, window, itemsize)
POOL_SWEEP = [(55, 96, 3, 4), (27, 256, 3, 4), (27, 256, 3, 1),
              (13, 256, 3, 4), (224, 64, 2, 4), (224, 64, 2, 1),
              (112, 128, 2, 4), (56, 256, 2, 4), (28, 512, 2, 4),
              (14, 512, 2, 4)]


def _check_pool_geometry(g):
    """Every output vector of an image stored by exactly one thread, whose
    window lies inside the map and is loaded row by row, each input row
    once; the last CTA of an image is the only ragged one."""
    assert g.vecs * g.vec_bytes == g.c * g.itemsize
    assert (g.blocks - 1) * tpool.THREADS < g.per_image <= \
        g.blocks * tpool.THREADS
    cv, oy, ox = g.outputs()
    count = np.zeros((g.oh, g.ow, g.vecs), np.int32)
    np.add.at(count, (oy, ox, cv), 1)
    assert (count == 1).all()
    assert (oy * g.stride + g.window <= g.h).all()
    assert (ox * g.stride + g.window <= g.w).all()


@pytest.mark.parametrize("hw,c,window,itemsize", POOL_SWEEP)
def test_pool_geometry_at_the_sweep_maps(hw, c, window, itemsize):
    """16-byte vectors, every output once, and enough CTAs to fill the
    card's 132 SMs several times over."""
    g = pool_geometry(64, hw, hw, c, itemsize, window, 2, 256)
    assert g.vec_bytes == 16 and g.grid == (g.blocks, 64)
    assert g.blocks * g.n >= 4 * 132
    _check_pool_geometry(g)


@pytest.mark.parametrize("c", [3, 251])
@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (3, 1)])
@pytest.mark.parametrize("itemsize,align", [(4, 256), (4, 4), (1, 256),
                                            (1, 1)])
def test_pool_geometry_covers_every_output_once(c, window, stride, itemsize,
                                                align):
    for n, h, w in ((1, 17, 19), (3, 9, 40)):
        _check_pool_geometry(pool_geometry(n, h, w, c, itemsize, window,
                                           stride, align))


@pytest.mark.parametrize("c,itemsize,align,vec", [
    (256, 4, 256, 16), (256, 4, 4, 4), (256, 4, 8, 8), (251, 4, 256, 4),
    (3, 4, 256, 4), (2, 4, 256, 8), (256, 1, 256, 16), (256, 1, 1, 1),
    (256, 1, 2, 1), (251, 1, 256, 1), (12, 1, 256, 4), (24, 1, 256, 8)])
def test_pool_vector_width(c, itemsize, align, vec):
    """The widest vector that the pixel's bytes and the base allow."""
    assert tpool.vector_bytes(c, itemsize, align) == vec
    assert pool_geometry(1, 4, 4, c, itemsize, 2, 2, align).vec_bytes == vec


def test_pool_constants_match_the_cuda_source():
    src = (_build.CSRC / "pool_act.cu").read_text()
    assert f"constexpr int THREADS = {tpool.THREADS};" in src
    for window in tpool.UNROLLED:
        assert f"case {window}: pool_act_kernel<T, VB, {window}>" in src
    for v in tpool.VEC_BYTES:
        assert f"case {v}: return by_window<T, {v}>" in src
    name, args = _build.SIGNATURES["pool_act"]
    assert name == "pool_act_launch" and len(args) == 13


#: one NaN at each position (dp, dq) of a window, for 2/2 and 3/2 pools
NAN_POSITIONS = [(w, dp, dq) for w in (2, 3) for dp in range(w)
                 for dq in range(w)]


@pytest.mark.parametrize("window,dp,dq", NAN_POSITIONS)
@pytest.mark.parametrize("act", ["none", "relu"])
def test_pool_keeps_nan_like_the_reference(window, dp, dq, act):
    """A NaN anywhere in a window gives NaN, as the reference's Pallas
    pool (jnp.maximum, then jax.nn.relu) gives; atol 0."""
    x = _np(0, (2, 9, 9, 36))
    x[1, 2 + dp, 2 + dq, ::3] = np.nan
    want = np.asarray(r_maxpool_act(jnp.asarray(x), window=window, stride=2,
                                    act=act))
    got = maxpool_act(torch.from_numpy(x), window=window, stride=2, act=act)
    assert np.isnan(want).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window,dp,dq", NAN_POSITIONS)
@pytest.mark.parametrize("act", ["none", "relu"])
def test_fused_pool_keeps_nan_like_the_reference(window, dp, dq, act):
    """The fused conv + pool with one NaN conv output at each window
    position: a 3x3 conv at stride 3 reads each input pixel for one output
    alone, so a NaN pixel makes one NaN conv output.  The conv map (6x6 or
    5x5) is tiled by the pool's windows, so the planner fuses."""
    res = 18 if window == 2 else 15
    x, f, b = _np(0, (2, res, res, 6)), _np(1, (3, 3, 6, 24), 0.2), \
        _np(2, (24,))
    x[1, 3 * (2 + dp), 3 * (2 + dq)] = np.nan
    want = np.asarray(REngine(backend="pallas", interpret=True).conv2d(
        jnp.asarray(x), jnp.asarray(f), jnp.asarray(b), stride=3, act=act,
        pool=RPoolSpec(window, 2)))
    eng = Engine(backend="kernels")
    with eng.tracing() as tr:
        got = eng.conv2d(*map(torch.from_numpy, (x, f, b)), stride=3,
                         act=act, pool=PoolSpec(window, 2))
    assert tr[0].conv_plan.fuse_pool and np.isnan(want).any()
    np.testing.assert_allclose(got.numpy(), want, equal_nan=True,
                               **RTOL_CONV)


# ---------------------------------------------------------------------------
# build and launch checks: nothing falls back
# ---------------------------------------------------------------------------
def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["pool_act"])


def test_build_times_each_library_by_its_own_process(monkeypatch, tmp_path):
    """The libraries build in parallel, and each one's seconds end when its
    own nvcc does (not when the slowest ahead of it in the list does); its
    output lands as its build log."""
    fake = tmp_path / "nvcc"
    fake.write_text(textwrap.dedent("""\
        #!/bin/sh
        out=""; prev=""
        for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
        case "$a" in *sa_fc.cu) sleep 1.5;; esac
        echo "ptxas info    : Used 32 registers ($a)"
        : > "$out"
        """))
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    seconds = _build.build(["sa_fc", "pool_act"])
    assert set(seconds) == {"sa_fc", "pool_act"}
    assert seconds["pool_act"] < 1.0 < 1.5 <= seconds["sa_fc"]
    for name in seconds:
        assert _build.library_path(name).exists()
        assert f"{name}.cu)" in _build.build_log(name)
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_launch_error_raises():
    class Lib:
        @staticmethod
        def cuda_error_string(err):
            return b"invalid configuration argument"
    _build.check(Lib, 0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.check(Lib, 9, "sa_fc_matmul")


def test_act_codes_match_the_cuda_table():
    src = (_build.CSRC / "common.cuh").read_text()
    for act, code in _build.ACT_CODES.items():
        name = {"none": "ACT_NONE", "relu": "ACT_RELU",
                "leaky_relu": "ACT_LEAKY", "silu": "ACT_SILU",
                "gelu": "ACT_GELU"}[act]
        assert f"{name} = {code}" in src
    with pytest.raises(ValueError):
        _build.act_code("tanh")
