"""SA-CONV — the direct (implicit-GEMM) convolution with its fused pool
epilogue, as a hand-written CUDA kernel (``csrc/sa_conv_implicit.cu``) with
its plain PyTorch version.

``sa_conv_implicit`` computes an NHWC x HWIO VALID convolution with stride on
an input that already carries its zero padding, then ``* w_scale + bias``
and the activation; with a pool (``pool_window`` > 0) it emits
``act(maxpool(conv * w_scale + bias))`` directly.  For a CPU tensor it runs
:func:`sa_conv_plain`; for a CUDA tensor it launches the kernel on the
current stream, or raises.

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

THREADS = 256
#: the CTA tiles the kernel is instantiated for, as (output pixels per
#: thread, output channels per thread, thread groups along the channels):
#: 512 pixels x 32 channels, 512 x 64 and 768 x 32
#: (csrc/sa_conv_implicit.cu::dispatch holds the same list)
TILES = ((8, 8, 4), (8, 16, 4), (6, 16, 2))
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
#: the kernel's static shared memory (the row and segment tables, with
#: room for their counts)
SMEM_STATIC = 4 * (MAX_ROWS + 7 * MAX_SEGMENTS + 3)
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
    """One layer's tiling (all counts, no pointers).

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


@functools.lru_cache(maxsize=None)
def conv_geometry(h: int, w: int, ci: int, p: int, q: int, co: int, *,
                  stride: int = 1, pool_window: int = 0,
                  pool_stride: int = 0) -> ConvGeometry:
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
    unrolled rows need more than 255 registers)."""
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
                  pool_stride: int = 0) -> tuple[tuple[int, int, int, int],
                                                 ...]:
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
              pool_stride=pool_stride)

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
    """The kernel's function in plain PyTorch: fp32 conv, then scale, bias,
    [maxpool,] act — the epilogue's order of operations."""
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
    """x (batch, h, w, ci) fp32, padded; f (p, q, ci, co) fp32 or int8 ->
    (batch, oh, ow, co), or the pooled (batch, poh, pow, co)."""
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
    if x.dtype != torch.float32:
        raise TypeError(f"sa_conv_implicit: x must be float32, got {x.dtype}")
    if f.dtype not in _F_KINDS:
        raise TypeError(f"sa_conv_implicit: f dtype {f.dtype} not supported")
    if out_dtype not in (None, torch.float32):
        raise TypeError("sa_conv_implicit: the kernel writes float32")
    batch, h, w, ci = x.shape
    p, q, _, co = f.shape
    if w_scale is not None:
        w_scale = w_scale.reshape(-1)
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.numel() != co):
            raise ValueError(f"sa_conv_implicit: {name} must be float32 "
                             f"with {co} elements")
    tensors = [x, f] + [t for t in (w_scale, bias) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("sa_conv_implicit: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sa_conv_implicit: operands must be contiguous")
    kw = dict(stride=stride, pool_window=pool_window,
              pool_stride=pool_stride)
    strips = column_strips(h, w, ci, p, q, co, **kw)
    if len(strips) == 1:
        return _launch(x, f, w_scale, bias, stride, act,
                       conv_geometry(h, w, ci, p, q, co, **kw))
    # a pool window wider than a CTA: one launch per strip of whole windows
    # on a copy of its input columns, each output summed in the one order
    g = conv_geometry(h, strips[0][3] - strips[0][2], ci, p, q, co, **kw)
    out = torch.empty((batch, g.out_h, strips[-1][1], co),
                      dtype=torch.float32, device=x.device)
    for j0, j1, x0, x1 in strips:
        part = x[:, :, x0:x1].contiguous()
        out[:, :, j0:j1] = _launch(part, f, w_scale, bias, stride, act,
                                   conv_geometry(h, x1 - x0, ci, p, q, co,
                                                 **kw))
    return out


def _launch(x: torch.Tensor, f: torch.Tensor, w_scale, bias, stride: int,
            act: str, g: ConvGeometry) -> torch.Tensor:
    """One launch of the kernel over the whole of ``x`` in geometry ``g``."""
    batch, h, w, ci = x.shape
    p, q, _, co = f.shape
    out = torch.empty((batch, g.out_h, g.out_w, co), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("sa_conv_implicit")
    err = lib.sa_conv_implicit_launch(
        x.data_ptr(), f.data_ptr(), _F_KINDS[f.dtype],
        w_scale.data_ptr() if w_scale is not None else None,
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        batch, h, w, ci, p, q, co, stride, g.pool_window, g.pool_stride,
        TILES.index((g.tpx, g.tco, g.groups)), g.bands, g.rows, g.per_cta,
        g.rin,
        g.ng, _build.act_code(act), g.smem_bytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "sa_conv_implicit")
    sa_conv_implicit.launches += 1
    return out


sa_conv_implicit.launches = 0
