"""SA-CONV — the direct (implicit-GEMM) convolution with its fused pool
epilogue, as a hand-written CUDA kernel (``csrc/sa_conv_implicit.cu``) with
its plain PyTorch version.

``sa_conv_implicit`` computes an NHWC x HWIO VALID convolution with stride on
an input that already carries its zero padding, then ``* w_scale + bias``
and the activation; with a pool (``pool_window`` > 0) it emits
``act(maxpool(conv * w_scale + bias))`` directly.  ``x`` is fp32 or bf16;
as in the TPU kernel an fp32 filter is rounded to ``x``'s dtype, the sums
and the epilogue run in fp32, and the output is rounded once to
``out_dtype`` (``x``'s by default; fp32 x writes fp32).  For a CPU tensor it
runs :func:`sa_conv_plain`; for a CUDA tensor it launches the kernel on the
current stream, or raises.  fp32 x runs the FMA loop (``sa_conv_kernel``);
bf16 x runs an implicit GEMM on the tensor cores (``sa_conv_wgmma_kernel``),
whose sums differ from the FMA loop's by summation order only, within
:func:`widened_bound`.

The tiling the kernel runs (:func:`conv_geometry`, :func:`conv_tiles`) is
chosen here, from the layer's shape alone — never from the batch, which
changes only the CTA count — so it can be tested on the CPU.  Where a pool
window's rows are wider than a CTA holds, :func:`column_strips` cuts the
emitted columns into strips of whole pool windows, one launch each.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build, ref

_F_KINDS = {torch.float32: 0, torch.int8: 1}
#: activation and output types and their codes (csrc/common.cuh Kind):
#: fp32 x writes fp32, bf16 x writes bf16 or fp32
_X_KINDS = {torch.float32: 0, torch.bfloat16: 2}
_OUT_TYPES = {torch.float32: (torch.float32,),
              torch.bfloat16: (torch.bfloat16, torch.float32)}

THREADS = 256
#: the CTA tiles the kernel is instantiated for, as (output pixels per
#: thread, output channels per thread, thread groups along the channels):
#: 512 pixels x 32 channels, 512 x 64 and 768 x 32
#: (csrc/sa_conv_implicit.cu::dispatch holds the same list)
TILES = ((8, 8, 4), (8, 16, 4), (6, 16, 2))
#: the tensor-core tiles of bf16 x, as (m64 row blocks per consumer
#: warpgroup, output channels per CTA): two consumer warpgroups, so 256
#: pixels x 128 channels or 512 x 64, 128 fp32 sums a consumer thread
#: either way (csrc/sa_conv_implicit.cu::TcTile holds the same)
TC_TILES = ((2, 128), (4, 64))
#: ring stages of each tensor-core tile (by its m64 blocks), k per stage
#: (128 bytes of bf16 a pixel row), and the 1024-byte slack that aligns the
#: ring to the 128-byte swizzle's period
TC_STAGES = {2: 4, 4: 3}
TC_BK = 64
TC_ALIGN = 1024
#: card time per FMA slot of a tile with 8 output channels per thread
#: against one with 16: 8-15 % more at AlexNet's conv2-conv5 (measured on
#: an H100 SXM), where a thread's 16 channels halve the pixel loads per FMA
SLOT_COST = {8: 1.1, 16: 1.0}
#: input channels per staged group (16 bytes a staged pixel), and the most
#: groups per staged chunk (the most that fit shared memory are staged at
#: once; one when ci = 3)
GROUP = 4
MAX_GROUPS = 8
#: filter shapes (p, q, stride) with a compile-time tap loop; any other
#: shape runs the kernel's generic instantiation
SPECIALIZED = ((11, 11, 4), (5, 5, 1), (3, 3, 1))
#: most segments (image bands) and staged input rows of one CTA (the
#: kernel's static tables)
MAX_SEGMENTS = 32
MAX_ROWS = 256
#: fields of a segment (csrc/sa_conv_implicit.cu SG_*)
SG_FIELDS = 7
#: the kernel's static shared memory (the row and segment tables, with
#: room for their counts), as ptxas allots it: up to the 16-byte alignment
#: of the dynamic buffer that follows (1936 B on an H100 build, not the
#: tables' 1932; C8)
SMEM_STATIC = -(-4 * (MAX_ROWS + 7 * MAX_SEGMENTS + 3) // 16) * 16
#: the most dynamic shared memory a CTA may take: what a Hopper CTA may
#: opt into, less the static tables
SMEM_MAX = 232448 - SMEM_STATIC
#: one 256-thread CTA per SM (__launch_bounds__(256, 1): a tile takes up to
#: 255 registers without spills), so a wave is one CTA per SM
SM_COUNT = 132                  # H100 SXM
#: the batch the tile is costed at (the planner's serving micro-batch);
#: the tile depends on it only through this constant, never on the batch
#: of a launch, which changes only the CTA count
NOMINAL_BATCH = 64


@dataclass(frozen=True)
class ConvGeometry:
    """One layer's tiling (all counts, no pointers).  ``mb`` > 0 is a
    tensor-core tile (bf16 x): ``pixels`` = 128 ``mb`` slots by ``bco``
    channels, no staged rows (``tpx``, ``tco``, ``groups``, ``cpg``,
    ``rin`` and ``ng`` are 0), flat tiles of ``pixels`` pixels.

    ``bands == 0``: the pixel tiles run over the flattened (image, row,
    column) conv output, ``per_cta`` pixels to a CTA (``pixels``, or fewer
    where a tile could touch more than :data:`MAX_SEGMENTS` images or stage
    more than :data:`MAX_ROWS` rows), across row and image boundaries (no
    pool is fused).  Otherwise each image's emitted (pooled)
    rows are cut into ``bands`` bands of at most ``rows`` rows at full
    width, and a CTA computes the conv rows of ``per_cta`` consecutive bands
    of the flattened (image, band) list, so no pool window is split."""
    tpx: int                    # output pixels per thread
    tco: int                    # output channels per thread
    groups: int                 # thread groups along the channels
    bco: int                    # output channels per CTA
    pixels: int                 # output-pixel slots of a CTA
    cpg: int                    # channels of a staged group (4, or 3)
    pool_window: int            # 1 when no pool is fused
    pool_stride: int
    conv_h: int
    conv_w: int
    out_h: int                  # emitted map (pooled or conv)
    out_w: int
    bands: int                  # bands per image; 0: flat pixel tiles
    rows: int                   # emitted rows of a full band
    per_cta: int                # bands per CTA; flat: pixels per CTA
    rin: int                    # most staged input rows of a CTA
    ng: int                     # groups of GROUP channels per staged chunk
    smem_bytes: int             # dynamic shared memory
    mb: int = 0                 # m64 blocks per consumer warpgroup; 0: FMA

    def band_rows(self) -> list[int]:
        """Emitted rows of each band of an image."""
        return [min(self.rows, self.out_h - i * self.rows)
                for i in range(self.bands)]

    def computed_pixels(self, batch: int) -> int:
        """Conv pixels the launch computes, recomputed rows included."""
        if not self.bands:
            return batch * self.conv_h * self.conv_w
        return batch * self.conv_w * sum(
            (r - 1) * self.pool_stride + self.pool_window
            for r in self.band_rows())

    def needed_pixels(self, batch: int) -> int:
        """Conv pixels the emitted map needs, each once."""
        used = (self.out_h - 1) * self.pool_stride + self.pool_window
        return batch * used * self.conv_w

    def pixel_tiles(self, batch: int) -> int:
        units = batch * (self.bands or self.conv_h * self.conv_w)
        return -(-units // self.per_cta)

    def co_tiles(self, co: int) -> int:
        return -(-co // self.bco)

    def ctas(self, batch: int, co: int) -> int:
        return self.pixel_tiles(batch) * self.co_tiles(co)

    def slot_use(self, batch: int) -> float:
        """Share of the CTAs' pixel slots that hold a computed pixel."""
        return self.computed_pixels(batch) / (self.pixel_tiles(batch)
                                              * self.pixels)

    def waves(self, batch: int, co: int) -> float:
        """CTAs per SM of the launch (one runs on an SM at a time)."""
        return self.ctas(batch, co) / SM_COUNT


def _flat_bounds(pixels: int, oh: int, ow: int, stride: int,
                 p: int) -> tuple[int, int]:
    """Most segments (images) and staged input rows of a flat tile of
    ``pixels`` conv pixels, wherever it starts: the conv rows it touches
    (a partial row at each end) and, per image, the filter's extra rows."""
    segs = (pixels - 2) // (oh * ow) + 2
    rows = min((pixels - 2) // ow + 2, segs * oh)
    segs = min(rows, segs)
    return segs, rows * stride + segs * max(p - stride, 0)


def tc_channels(ci: int) -> int:
    """The channels a pixel of bf16 x is gathered with on the tensor cores
    (csrc/sa_conv_implicit.cu::tc_channels): ci where ci % 8 == 0 or ci ==
    4 (16- or 8-byte pieces of one tap), else ci padded with zeros to 4 (ci
    < 4) or to a multiple of 8.  The summation order depends on it, so on
    ci alone."""
    return ci if ci % 8 == 0 or ci == 4 else 4 if ci < 4 else -(-ci // 8) * 8


def tc_smem(mb: int, bn: int) -> int:
    """Dynamic shared memory of a tensor-core tile: the alignment slack,
    the ring (a stage holds 128 ``mb`` pixel rows and ``bn`` filter columns
    of TC_BK bf16 each), the pixel table (8 bytes a pixel), the segment
    table and its counts (16 bytes), a full and an empty mbarrier a stage.
    The epilogue parks the tile in the ring."""
    stages, bm = TC_STAGES[mb], 128 * mb
    return (TC_ALIGN + stages * (bm + bn) * 2 * TC_BK + 8 * bm
            + 4 * SG_FIELDS * MAX_SEGMENTS + 16 + 16 * stages)


def _tc_geometry(oh: int, ow: int, pw: int, ps: int, poh: int, pow_: int,
                 co: int, pooled: bool) -> ConvGeometry | None:
    """The tensor-core tile of a bf16 layer: for each of :data:`TC_TILES`,
    flat tiles of all its slots without a pool, every band height with
    one (as many bands a CTA as its slots and the segment table hold),
    costed at :data:`NOMINAL_BATCH` as waves of CTAs (one CTA an SM; every
    tile does 128 x 256 slot-columns of products a k step); ties go to
    fewer pixel slots (more channels a CTA: fewer gathers of the same
    pixels), then more needed pixels a slot, then fewer computed pixels
    (a recomputed halo row costs gathers and no fewer products: a CTA's
    products cover all its slots)."""
    best = None
    for mb, bn in TC_TILES:
        bm = 128 * mb
        if pooled:
            shapes = set()
            for nb in range(1, poh + 1):
                r = -(-poh // nb)
                shapes.add((-(-poh // r), r))
            cands = []
            for nb, r in sorted(shapes):
                k = min(bm // (((r - 1) * ps + pw) * ow), MAX_SEGMENTS)
                if k:
                    cands.append((nb, r, k))
        else:
            cands = [(0, 0, bm)]
        for nb, r, k in cands:
            g = ConvGeometry(0, 0, 0, bn, bm, 0, pw, ps, oh, ow, poh, pow_,
                             nb, r, k, 0, 0, tc_smem(mb, bn), mb)
            b = NOMINAL_BATCH
            waves = -(-g.ctas(b, co) // SM_COUNT)
            key = (waves, bm, -g.needed_pixels(b) / (g.pixel_tiles(b) * bm),
                   g.computed_pixels(b))
            if best is None or key < best[0]:
                best = (key, g)
    return None if best is None else best[1]


@functools.lru_cache(maxsize=None)
def conv_geometry(h: int, w: int, ci: int, p: int, q: int, co: int, *,
                  stride: int = 1, pool_window: int = 0,
                  pool_stride: int = 0, x_bytes: int = 4) -> ConvGeometry:
    """Pick the CTA tile and the pixel tiling for a conv on a padded
    (h, w, ci) input, from the layer's shape alone.  Every candidate (a
    tile of :data:`TILES`; flat pixel tiles without a pool, every band
    height and bands-per-CTA with one) is costed at
    :data:`NOMINAL_BATCH` as the waves of CTAs it puts on the card (one
    CTA per SM) times the outputs per thread and their :data:`SLOT_COST`;
    ties go to more needed pixels per slot, then more slots in use, then
    fewer staged rows.  Each chunk stages as many groups of :data:`GROUP`
    channels as shared memory holds (at most :data:`MAX_GROUPS`).  The
    16-channel tiles are not built for the 11x11 stride-4 filter (its
    unrolled rows need more than 255 registers).  bf16 x (``x_bytes`` 2)
    takes a tensor-core tile (:func:`_tc_geometry`)."""
    oh = (h - p) // stride + 1
    ow = (w - q) // stride + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"conv output is empty: {(h, w)} * {(p, q)} "
                         f"stride {stride}")
    pw, ps = (pool_window, pool_stride or pool_window) if pool_window \
        else (1, 1)
    poh = (oh - pw) // ps + 1
    pow_ = (ow - pw) // ps + 1
    if poh < 1 or pow_ < 1:
        raise ValueError(f"pool {pw}/{ps} does not fit a {oh}x{ow} map")
    if x_bytes == 2:
        g = _tc_geometry(oh, ow, pw, ps, poh, pow_, co, bool(pool_window))
        if g is None:
            raise NotImplementedError(
                f"sa_conv_implicit: a {pw}-row pool window over {ow}-pixel "
                f"rows does not fit one tensor-core CTA ({h}x{w}x{ci}, "
                f"filter {p}x{q}, stride {stride})")
        return g
    specialized = (p, q, stride) in SPECIALIZED
    split = specialized and stride > 1
    wst = stride * -(-w // stride) if split else w
    cpg = 3 if split and ci == 3 else GROUP
    taps = p * q

    def smem_of(rin: int, bco: int, cap: int, ng: int = 1) -> int:
        """Dynamic shared memory: the staging ring, or the epilogue tile."""
        stage = ng * (rin * wst * 4 + taps * cpg * bco
                      + taps * cpg * bco // 4)
        stages = 2 if -(-ci // (GROUP * ng)) > 1 else 1
        return 4 * max(stages * stage, cap * (bco + 1))

    best = None
    for tpx, tco, groups in TILES:
        if tpx * tco > 64 and split:
            continue
        bco = tco * groups
        cap = THREADS // groups * tpx
        if pool_window:
            shapes = set()
            for nb in range(1, poh + 1):
                r = -(-poh // nb)
                shapes.add((-(-poh // r), r))
            cands = []
            for nb, r in sorted(shapes):
                band_px = ((r - 1) * ps + pw) * ow
                band_rows = ((r - 1) * ps + pw - 1) * stride + p
                k = min(cap // band_px, MAX_SEGMENTS, MAX_ROWS // band_rows)
                if k:
                    cands.append((nb, r, k, k, k * band_rows))
        else:
            px = cap          # the most pixels whose tables and rows fit
            while px > 1:
                segs, rin = _flat_bounds(px, oh, ow, stride, p)
                if (segs <= MAX_SEGMENTS and rin <= MAX_ROWS
                        and smem_of(rin, bco, cap) <= SMEM_MAX):
                    break
                px -= 1
            cands = [(0, 0, px) + _flat_bounds(px, oh, ow, stride, p)]
        for nb, r, k, segs, rin in cands:
            if rin > MAX_ROWS or segs > MAX_SEGMENTS:
                continue
            ng = 1
            while (cpg == GROUP and ng < min(MAX_GROUPS, -(-ci // GROUP))
                   and smem_of(rin, bco, cap, 2 * ng) <= SMEM_MAX):
                ng *= 2
            smem = smem_of(rin, bco, cap, ng)
            if smem > SMEM_MAX:
                continue
            g = ConvGeometry(tpx, tco, groups, bco, cap, cpg, pw, ps, oh, ow,
                             poh, pow_, nb, r, k, rin, ng, smem)
            b = NOMINAL_BATCH
            waves = -(-g.ctas(b, co) // SM_COUNT)
            cost = waves * tpx * tco * SLOT_COST[tco]
            key = (cost, -g.needed_pixels(b) / (g.pixel_tiles(b) * cap),
                   -g.slot_use(b), rin)
            if best is None or key < best[0]:
                best = (key, g)
    if best is None:
        raise NotImplementedError(
            f"sa_conv_implicit: a {pw}-row pool window over {ow}-pixel rows "
            f"does not fit one CTA, or its staging does not fit shared "
            f"memory ({h}x{w}x{ci}, filter {p}x{q}, stride {stride})")
    return best[1]


@functools.lru_cache(maxsize=None)
def column_strips(h: int, w: int, ci: int, p: int, q: int, co: int, *,
                  stride: int = 1, pool_window: int = 0,
                  pool_stride: int = 0,
                  x_bytes: int = 4) -> tuple[tuple[int, int, int, int], ...]:
    """The fewest strips of emitted columns whose inputs each fit
    :func:`conv_geometry`, from the shape alone, as (first and last-plus-one
    emitted column, first and last-plus-one input column).  Emitted columns
    [j0, j1) need conv columns [j0 * ps, (j1 - 1) * ps + pw), and those need
    input columns [j0 * ps * stride, ((j1 - 1) * ps + pw - 1) * stride + q):
    a strip holds whole pool windows, and neighbouring strips overlap by
    pw - ps conv columns.  Strip widths differ by at most one column.  One
    strip, the whole width, wherever the whole width fits."""
    ow = (w - q) // stride + 1
    pw, ps = (pool_window, pool_stride or pool_window) if pool_window \
        else (1, 1)
    n_out = (ow - pw) // ps + 1 if ow >= pw else 0
    kw = dict(stride=stride, pool_window=pool_window,
              pool_stride=pool_stride, x_bytes=x_bytes)

    def in_cols(j0: int, j1: int) -> tuple[int, int]:
        return j0 * ps * stride, ((j1 - 1) * ps + pw - 1) * stride + q

    err = None
    for n in range(1, max(n_out, 1) + 1):
        base, extra = divmod(n_out, n)
        bounds = [i * base + min(i, extra) for i in range(n + 1)]
        strips = tuple((j0, j1) + in_cols(j0, j1)
                       for j0, j1 in zip(bounds, bounds[1:]))
        try:
            for width in {x1 - x0 for _, _, x0, x1 in strips}:
                conv_geometry(h, width, ci, p, q, co, **kw)
        except NotImplementedError as e:
            err = e
            continue
        return strips
    raise err if err is not None else ValueError(
        f"sa_conv_implicit: no emitted column ({h}x{w}, filter {p}x{q})")


def conv_tiles(g: ConvGeometry, batch: int, tile: int) -> list[tuple]:
    """The segments of pixel tile ``tile``, as the kernel builds them:
    (image, first conv row, conv rows, first and last-plus-one pixel of the
    segment's rows x ``conv_w`` block that the CTA computes, first emitted
    row, emitted rows), in the CTA's pixel order."""
    ow, ohw = g.conv_w, g.conv_h * g.conv_w
    out = []
    if not g.bands:
        p0 = tile * g.per_cta
        p1 = min(p0 + g.per_cta, batch * ohw)
        for img in range(p0 // ohw, (p1 - 1) // ohw + 1):
            a, b = max(p0, img * ohw), min(p1, (img + 1) * ohw)
            r0, r1 = (a - img * ohw) // ow, (b - 1 - img * ohw) // ow
            out.append((img, r0, r1 - r0 + 1, a - img * ohw - r0 * ow,
                        b - img * ohw - r0 * ow, r0, r1 - r0 + 1))
        return out
    for u in range(tile * g.per_cta,
                   min((tile + 1) * g.per_cta, batch * g.bands)):
        img, band = divmod(u, g.bands)
        pr0 = band * g.rows
        npr = min(g.rows, g.out_h - pr0)
        nr = (npr - 1) * g.pool_stride + g.pool_window
        out.append((img, pr0 * g.pool_stride, nr, 0, nr * ow, pr0, npr))
    return out


def sa_conv_plain(x: torch.Tensor, f: torch.Tensor,
                  bias: torch.Tensor | None = None, *, stride: int = 1,
                  act: str = "none", pool_window: int = 0,
                  pool_stride: int = 0, w_scale: torch.Tensor | None = None,
                  out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the filter rounded to x's
    dtype, an fp32 conv, then scale, bias, [maxpool,] act — the epilogue's
    order of operations — rounded once to ``out_dtype``."""
    if f.dtype != x.dtype:
        f = f.to(x.dtype)
    out = ref.conv2d(x, f, stride=stride, out_dtype=torch.float32)
    if w_scale is not None:
        out = out * w_scale.reshape(-1).to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    if pool_window:
        out = ref.maxpool2d(out, window=pool_window,
                            stride=pool_stride or pool_window)
    return ref.apply_act(out, act).to(out_dtype or x.dtype)


def sa_conv_implicit(x: torch.Tensor, f: torch.Tensor,
                     bias: torch.Tensor | None = None, *, stride: int = 1,
                     act: str = "none", pool_window: int = 0,
                     pool_stride: int = 0,
                     w_scale: torch.Tensor | None = None,
                     out_dtype=None) -> torch.Tensor:
    """x (batch, h, w, ci) fp32 or bf16, padded; f (p, q, ci, co) fp32 or
    int8 -> (batch, oh, ow, co), or the pooled (batch, poh, pow, co)."""
    if x.device.type == "cpu":
        return sa_conv_plain(x, f, bias, stride=stride, act=act,
                             pool_window=pool_window,
                             pool_stride=pool_stride, w_scale=w_scale,
                             out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"sa_conv_implicit: unsupported device {x.device}")
    if x.dim() != 4 or f.dim() != 4 or x.shape[3] != f.shape[2]:
        raise ValueError(f"sa_conv_implicit: shapes {tuple(x.shape)} * "
                         f"{tuple(f.shape)}")
    if x.dtype not in _X_KINDS:
        raise TypeError(f"sa_conv_implicit: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if f.dtype not in _F_KINDS:
        raise TypeError(f"sa_conv_implicit: f dtype {f.dtype} not supported")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in _OUT_TYPES[x.dtype]:
        raise TypeError(f"sa_conv_implicit: {x.dtype} x writes "
                        f"{_OUT_TYPES[x.dtype]}, not {out_dtype}")
    batch, h, w, ci = x.shape
    p, q, _, co = f.shape
    if w_scale is not None:
        w_scale = w_scale.reshape(-1)
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and (t.dtype not in _X_KINDS or t.numel() != co):
            raise ValueError(f"sa_conv_implicit: {name} must be float32 or "
                             f"bfloat16 with {co} elements")
    tensors = [x, f] + [t for t in (w_scale, bias) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("sa_conv_implicit: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sa_conv_implicit: operands must be contiguous")
    # the epilogue runs in fp32: a bf16 scale or bias widens exactly
    w_scale, bias = (None if t is None else t.to(torch.float32)
                     for t in (w_scale, bias))
    kw = dict(stride=stride, pool_window=pool_window,
              pool_stride=pool_stride, x_bytes=x.element_size())
    strips = column_strips(h, w, ci, p, q, co, **kw)
    if len(strips) == 1:
        return _launch(x, f, w_scale, bias, stride, act, out_dtype,
                       conv_geometry(h, w, ci, p, q, co, **kw))
    # a pool window wider than a CTA: one launch per strip of whole windows
    # on a copy of its input columns, each output summed in the one order
    g = conv_geometry(h, strips[0][3] - strips[0][2], ci, p, q, co, **kw)
    out = torch.empty((batch, g.out_h, strips[-1][1], co),
                      dtype=out_dtype, device=x.device)
    for j0, j1, x0, x1 in strips:
        part = x[:, :, x0:x1].contiguous()
        out[:, :, j0:j1] = _launch(part, f, w_scale, bias, stride, act,
                                   out_dtype,
                                   conv_geometry(h, x1 - x0, ci, p, q, co,
                                                 **kw))
    return out


def _launch(x: torch.Tensor, f: torch.Tensor, w_scale, bias, stride: int,
            act: str, out_dtype, g: ConvGeometry) -> torch.Tensor:
    """One launch of the kernel over the whole of ``x`` in geometry ``g``.
    A tensor-core launch first rounds the filter into a (p q cp, co
    rounded up to 8) bf16 scratch, which its producer loads by TMA (cp =
    :func:`tc_channels`); where cp != ci, or x's base does not align with
    the gather's pieces, it also copies x into an (n, h, w, cp) scratch
    with the channels zero-padded."""
    batch, h, w, ci = x.shape
    p, q, _, co = f.shape
    out = torch.empty((batch, g.out_h, g.out_w, co), dtype=out_dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    fb = xp = None
    if g.mb:
        tile = TC_TILES.index((g.mb, g.bco))
        cp = tc_channels(ci)
        per = (2 ** 31 - 1) // (h * w * cp)
        if batch > per:
            # the tensor cores address pixels by 32-bit offsets: launch
            # batch slices (an output's terms and order do not change)
            for b0 in range(0, batch, per):
                out[b0:b0 + per] = _launch(x[b0:b0 + per], f, w_scale, bias,
                                           stride, act, out_dtype, g)
            return out
        fb = torch.empty((p * q * cp, -(-co // 8) * 8), dtype=torch.bfloat16,
                         device=x.device)
        if cp != ci or x.data_ptr() % (16 if cp % 8 == 0 else 8):
            xp = torch.empty((batch, h, w, cp), dtype=torch.bfloat16,
                             device=x.device)
    else:
        tile = TILES.index((g.tpx, g.tco, g.groups))
    lib = _build.load("sa_conv_implicit")
    err = lib.sa_conv_implicit_launch(
        x.data_ptr(), _X_KINDS[x.dtype], _X_KINDS[out_dtype], f.data_ptr(),
        _F_KINDS[f.dtype],
        w_scale.data_ptr() if w_scale is not None else None,
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        batch, h, w, ci, p, q, co, stride, g.pool_window, g.pool_stride,
        tile, g.bands, g.rows, g.per_cta, g.rin, g.ng, _build.act_code(act),
        g.smem_bytes, None if fb is None else fb.data_ptr(),
        None if xp is None else xp.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "sa_conv_implicit")
    sa_conv_implicit.launches += 1
    return out


sa_conv_implicit.launches = 0


#: the activations' Lipschitz constants: relu, leaky relu and none 1;
#: silu's slope lies in [-0.0998, 1.0998], gelu's (tanh form) in [-0.13,
#: 1.129]
_LIPSCHITZ = {"none": 1.0, "relu": 1.0, "leaky_relu": 1.0, "silu": 1.1,
              "gelu": 1.13}


def widened_bound(x: torch.Tensor, f: torch.Tensor,
                  bias: torch.Tensor | None, wide_out: torch.Tensor, *,
                  stride: int = 1, act: str = "none", pool_window: int = 0,
                  pool_stride: int = 0, w_scale: torch.Tensor | None = None,
                  out_dtype=None) -> torch.Tensor:
    """The worst-case |got - wide_out| (fp64, shaped like the output) of a
    launch ``got`` on bf16 ``x`` (the tensor cores) against ``wide_out``,
    the fp32 launch on the same operands widened (the FMA loop: x widened,
    an fp32 filter rounded to bf16 and widened, an int8 filter as is).
    Derived, not fitted:

    Both kernels see the same exact operands, and every product of two
    bf16 values is exact in fp32, so they differ only in their roundings.
    Write K = p q cp for the terms the tensor cores add (cp =
    :func:`tc_channels`: zero-padded channels add exact zeros; K >= p q ci,
    the FMA loop's terms), A = conv(|x|, |f|) per conv output, s and b the
    output channel's scale (1 without) and bias (0 without), and u =
    2^-22.  A is computed here as an fp32 conv (no TF32) of exact products
    that are all >= 0, so within K 2^-24 of exact whatever the order, and
    taken times (1 + K u); the rest runs in fp64.

    1. The sums.  The FMA loop adds the K products in (channel group, tap,
       channel) order with fmaf, the tensor cores in 16-wide steps in (tap,
       channel) order with truncating accumulation: the two sums lie within
       K 2^-22 A of each other (the GEMM's bound, k 2^-22 (|x| @ |w|), with
       k = K).
    2. The epilogue: conv * s, then + b, each rounded once in each kernel
       (within 2^-24 of a value at most |s| A + |b| each, four roundings
       in all, with room for the (1 + K 2^-22) growth): together
       D = |s| (K + 2) u A + u |b|.
    3. The pool: both take the max over the same window of values that
       differ by at most D each, and a max moves by at most the largest
       move of its terms: D becomes the window's max of D.
    4. The activation, evaluated in fp32 by both: at most L D, L its
       Lipschitz constant (relu, leaky relu 1; silu 1.1; gelu 1.13), plus
       each evaluation's own rounding for every act but none and relu:
       2^-20 (|wide_out| + L D), and for gelu, whose 1 + tanh cancels,
       2^-21 (|s| A + |b|) (pooled by max) more.
    5. A bf16 output is the fp32 result rounded once: half a bf16 ulp of a
       value at most |wide_out| + the bound so far, so at most 2^-8 of
       that (one ulp of its binade).

    A NaN or an infinity reaches the same outputs of both kernels; the
    bound holds where both are finite."""
    f64, f32 = torch.float64, torch.float32
    p, q, ci, co = f.shape
    k = p * q * tc_channels(ci)
    u = 2.0 ** -22
    fw = f.to(torch.bfloat16) if f.dtype == f32 else f
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        a = torch.nn.functional.conv2d(
            x.to(f32).abs().permute(0, 3, 1, 2),
            fw.to(f32).abs().permute(3, 2, 0, 1).contiguous(),
            stride=stride).to(f64) * (1 + k * u)              # NCHW
    s = (torch.ones(co, dtype=f64, device=x.device) if w_scale is None
         else w_scale.reshape(-1).to(f64).abs()).view(1, co, 1, 1)
    b = (torch.zeros(co, dtype=f64, device=x.device) if bias is None
         else bias.to(f64).abs()).view(1, co, 1, 1)
    d = s * (k + 2) * u * a + u * b
    mag = s * a + b if act == "gelu" else None
    del a
    if pool_window:
        win = (pool_window, pool_stride or pool_window)
        d = torch.nn.functional.max_pool2d(d, *win)
        mag = None if mag is None else torch.nn.functional.max_pool2d(
            mag, *win)
    d = d.permute(0, 2, 3, 1)
    lip = _LIPSCHITZ[act]
    wide = wide_out.to(f64).abs()
    bound = lip * d
    if act not in ("none", "relu"):
        bound = bound + 2.0 ** -20 * (wide + lip * d)
    if mag is not None:
        bound = bound + 2.0 ** -21 * mag.permute(0, 2, 3, 1)
    if (out_dtype or x.dtype) == torch.bfloat16:
        bound = bound + 2.0 ** -8 * (wide + bound)
    return bound
