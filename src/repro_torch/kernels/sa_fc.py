"""SA-FC — the batch-amortized weight stream, as hand-written CUDA kernels
(``csrc/sa_fc.cu`` for fp32 x, ``csrc/sa_fc_tc.cu`` for bf16 x) with their
plain PyTorch version.

``sa_fc_matmul`` computes ``act((x @ w) * w_scale + bias)`` for ``x`` (b, k)
fp32 or bf16 and ``w`` (k, n) fp32, bf16 or int8 (int8 with a (1, n) or
(n,) per-column ``w_scale``), written as ``out_dtype`` (fp32 or bf16, by
default ``x``'s).  As in the TPU kernel, ``w`` is rounded to ``x``'s dtype,
products are summed in fp32 and the epilogue runs in fp32.  For a CPU
tensor it runs :func:`sa_fc_plain`; for a CUDA tensor it launches a
kernel on the current stream, or raises.  Ragged k, n and b are masked
inside the kernel: no padded copies.

Each kernel splits k into :func:`fc_split` segments, a function of (k, n)
only, and adds every output's terms in an order fixed by that split, so a
row's output is bitwise the same whatever batch it rides in.
:func:`fc_launch` and :func:`tc_launch` are the whole launch geometries, in
Python so that the CPU tests reach them.

Two kernels run that order's split.  bf16 ``x`` runs the tensor-core
kernel (``csrc/sa_fc_tc.cu``, launch geometry :func:`tc_launch`) with
every weight type at every b: mma.sync k16 steps in increasing k within a
segment, segments in order, so its rows too are bitwise the same at every
b; fp32 ``x`` runs the FMA kernel (``csrc/sa_fc.cu``).  :func:`tc_route` is
the choice, by x's dtype alone.  The two kernels sum in other orders: a
bf16 launch lies within :func:`widened_bound` of the fp32 launch on the
widened operands.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _build, ref

#: weight types of the GEMM kernels and their codes (csrc/common.cuh Kind)
W_KINDS = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}
#: activation and output types of the GEMM kernels, the same codes
X_KINDS = {torch.float32: 0, torch.bfloat16: 2}
#: columns per CTA at each batch tile the kernel is instantiated for
#: (``Cfg<WT, RB>::BN`` in csrc/sa_fc.cu, whose launch refuses a width that
#: differs from its own, so a change to one side fails on the card)
_COLS = {1: 64, 2: 64, 4: 64, 8: 64, 16: 64, 32: 64, 64: 32}
_ROW_TILES = tuple(_COLS)
#: k per chunk of the kernel (csrc/sa_fc.cu's BK); segments are whole chunks
K_CHUNK = 32
#: k-lanes per output (csrc/sa_fc.cu's KL): a thread sums one lane's k
K_LANES = 4
#: CTAs a launch aims for: two on each of an H100's 132 SMs
TARGET_CTAS = 2 * 132
#: the tensor-core kernel (csrc/sa_fc_tc.cu, the same names there): its
#: row tiles (an n8 slice's 8 rows and up); the largest k and n it runs
#: narrow (at row tile 8); narrow: the columns of a warp's unit (one m16
#: tile), warps a CTA, the most partials it keeps in shared memory (what k
#: and n up to NARROW_MAX give); wide: stages of a warp's ring (its warps
#: a CTA: :func:`wide_warps`); a staged x row (32 k in bf16); the SMs of an
#: H100
TC_ROWS = (8, 16, 32, 64)
NARROW_MAX = 4096
GCOLS = 16
N_WARPS = 16
PART_SMEM_MAX = 65536
W_DEPTH = 4
X_ROW = K_CHUNK * 2
SM_COUNT = 132
#: the segments from which a launch runs row tiles of 8 (:func:`tc_rows`)
SPLIT_ROWS = 8


def sa_fc_plain(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None, *, act: str = "none",
                w_scale: torch.Tensor | None = None,
                out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return ref.matmul_bias_act(x, w, bias, act=act, out_dtype=out_dtype,
                               w_scale=w_scale)


def check_operands(name: str, x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None, w_scale: torch.Tensor | None,
                   out_dtype) -> tuple[torch.dtype, torch.Tensor | None,
                                       torch.Tensor | None]:
    """Refuse what the GEMM kernels (SA-FC and SA-CONV) do not take: a
    device other than CUDA, shapes that do not chain, activations other
    than fp32 or bf16, weights other than fp32, bf16 or int8, an output
    type other than fp32 or bf16, a scale or bias of another length or
    type than fp32 or bf16, operands on different devices or not
    contiguous.  Returns ``(out_dtype, w_scale, bias)``: the output type
    resolved (``x``'s by default), ``w_scale`` flattened, and both widened
    to fp32 (exact: the epilogue runs in fp32)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.dtype not in X_KINDS:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if w.dtype not in W_KINDS:
        raise TypeError(f"{name}: w dtype {w.dtype} not supported")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in X_KINDS:
        raise TypeError(f"{name}: the kernel writes float32 or bfloat16, "
                        f"not {out_dtype}")
    n = w.shape[1]
    if w_scale is not None:
        w_scale = w_scale.reshape(-1)
    for what, t in (("w_scale", w_scale), ("bias", bias)):
        if t is None:
            continue
        if t.dtype not in X_KINDS or t.numel() != n:
            raise ValueError(f"{name}: {what} must be float32 or bfloat16 "
                             f"with {n} elements")
    tensors = [x, w] + [t for t in (w_scale, bias) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    widen = [None if t is None else t.to(torch.float32)
             for t in (w_scale, bias)]
    return out_dtype, widen[0], widen[1]


def row_tile(b: int) -> int:
    """The kernel's batch tile for ``b`` rows: the smallest instantiated
    tile that holds them, at most 64 (larger batches run a grid dimension
    of 64-row tiles)."""
    return next(t for t in _ROW_TILES if t >= min(b, 64))


def fc_split(k: int, n: int) -> tuple[int, int]:
    """``(segments, k per segment)`` of the kernel's fixed split over k.

    A pure function of ``(k, n)``: the kernel sums every output in an order
    that depends on this split and nothing else, so a row's result does not
    depend on the batch.  Segments are whole chunks of :data:`K_CHUNK`, the
    last one may be shorter, and there are enough of them that even the
    widest column tile gives :data:`TARGET_CTAS` CTAs (where k allows)."""
    chunks = -(-k // K_CHUNK)
    if chunks <= 1:
        return 1, K_CHUNK
    want = -(-TARGET_CTAS // -(-n // max(_COLS.values())))
    per = max(1, chunks // want)
    return -(-chunks // per), per * K_CHUNK


@dataclasses.dataclass(frozen=True)
class FcLaunch:
    """How :func:`sa_fc_matmul` launches the kernel for one shape."""
    rows: int                   # row tile (an instantiation)
    cols: int                   # columns per CTA at that tile
    segments: int               # fc_split's S
    seg_k: int                  # k per segment
    split: bool                 # one CTA per segment (else one per tile)
    grid: tuple[int, int, int]  # (column tiles, row tiles, S or 1)

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def fc_smem_bytes(rows: int, w_bytes: int) -> int:
    """Dynamic shared memory of a CTA at row tile ``rows`` (csrc/sa_fc.cu
    ``Cfg::SMEM``): a ring of 6 stages (4 above 8 rows), each a chunk of
    fp32 x (``rows`` rows of :data:`K_CHUNK`, padded by 4 elements) and of
    w (:data:`K_CHUNK` rows of the tile's columns, in ``w_bytes``), then
    the k-lanes' sums and the running total in fp32."""
    cols = _COLS[rows]
    stages = 6 if rows <= 8 else 4
    stage = rows * (K_CHUNK + 4) * 4 + K_CHUNK * cols * w_bytes
    return stages * stage + (K_LANES + 1) * rows * cols * 4


@functools.lru_cache(maxsize=1024)
def fc_launch(b: int, k: int, n: int) -> FcLaunch:
    """The launch for ``(b, k) @ (k, n)``: the row tile and its columns
    follow b, the split follows (k, n) alone.  A CTA walks all segments
    itself where the tiles already give :data:`TARGET_CTAS` CTAs, and takes
    one segment otherwise (partials through a workspace); both add the
    partials in the same order."""
    rb = row_tile(b)
    bn = _COLS[rb]
    segments, seg_k = fc_split(k, n)
    col_tiles, row_tiles = -(-n // bn), -(-b // rb)
    split = segments > 1 and col_tiles * row_tiles < TARGET_CTAS
    return FcLaunch(rb, bn, segments, seg_k, split,
                    (col_tiles, row_tiles, segments if split else 1))


def tc_route(x_dtype: torch.dtype) -> bool:
    """Whether :func:`sa_fc_matmul` runs the tensor-core kernel: bf16 x,
    whatever the weights and the batch."""
    return x_dtype == torch.bfloat16


def tc_rows(b: int, segments: int = 1) -> int:
    """The tensor-core kernel's row tile for ``b`` rows and k split into
    ``segments``: 8 from :data:`SPLIT_ROWS` segments on (n is then small:
    the weights stay in L2 while ceil(b / 8) row tiles read them, and each
    tile's tail of segment partials stays short), else the smallest of
    :data:`TC_ROWS` that holds b, 64 above (row tiles of 64)."""
    if segments >= SPLIT_ROWS:
        return TC_ROWS[0]
    return next(t for t in TC_ROWS if t >= min(b, 64))


def tc_cols(rows: int, w_bytes: int) -> int:
    """Columns of a wide unit (csrc/sa_fc_tc.cu ``wide::Cfg::TC``): 4 KB
    of weights a chunk at row tiles 8 and 16 (64 columns of bf16, 32 of
    fp32; 64 of int8), 64 columns at 32 rows and 32 at 64, so a thread
    holds at most 64 accumulators."""
    return (32 if w_bytes == 4 else 64) if rows <= 16 else 2048 // rows


def wide_warps(rows: int) -> int:
    """Warps of a wide CTA, one CTA an SM (``wide::Cfg::WARPS``): 8 at row
    tiles 8 and 16, 4 above."""
    return 8 if rows <= 16 else 4


def narrow_depth(w_bytes: int) -> int:
    """Stages of a narrow warp's ring (``narrow::Cfg::DEPTH``)."""
    return 4 if w_bytes == 4 else 6


def narrow_smem_bytes(w_bytes: int, segments: int, span: int) -> int:
    """Dynamic shared memory of a narrow CTA (csrc/sa_fc_tc.cu
    ``narrow::smem_bytes``): its warps' rings, a stage a chunk of 16
    columns of w then its 32 k of 8 x rows; then, where k is split, the
    partials of the CTA's units (``span`` groups x ``segments`` x 8 rows x
    :data:`GCOLS` floats)."""
    part = span * segments * 8 * GCOLS * 4 if segments > 1 else 0
    stage = K_CHUNK * GCOLS * w_bytes + 8 * X_ROW
    return N_WARPS * narrow_depth(w_bytes) * stage + part


def wide_stage_bytes(rows: int, w_bytes: int) -> int:
    """A wide warp's stage (``wide::Cfg::STAGE``): a chunk of its unit's
    columns of w, then 32 k of its ``rows`` x rows, rounded up to the
    1024-byte period of the swizzle."""
    raw = K_CHUNK * tc_cols(rows, w_bytes) * w_bytes + rows * X_ROW
    return -(-raw // 1024) * 1024


def wide_smem_bytes(rows: int, w_bytes: int) -> int:
    """Dynamic shared memory of a wide CTA (``wide::Cfg::SMEM``): 1024
    bytes to align, the rings of its :func:`wide_warps` warps, each warp's
    scratch of its unit's outputs (``rows`` rows of the unit's columns
    and 4 more, in fp32), each warp's mbarriers."""
    warps = wide_warps(rows)
    scratch = rows * (tc_cols(rows, w_bytes) + 4) * 4
    return (1024 + warps * W_DEPTH * wide_stage_bytes(rows, w_bytes)
            + warps * scratch + warps * W_DEPTH * 8)


@dataclasses.dataclass(frozen=True)
class TcLaunch:
    """How :func:`sa_fc_matmul` launches the tensor-core kernel for one
    shape.

    A unit is (column tile, k segment, row tile), run by one warp.  Narrow
    (b <= 8 and k and n at most :data:`NARROW_MAX`): tiles of
    :data:`GCOLS` columns; CTA ``c`` owns tiles :meth:`cta_tiles` and every
    segment of them, its units segment-major round-robin over its
    :data:`N_WARPS` warps, and adds each output's segments in order from
    shared memory.  Wide: tiles of :func:`tc_cols` columns; unit ``u =
    (segment x tiles + tile) x row_tiles + row tile`` runs on warp ``(u //
    ctas) % wide_warps(rows)`` of CTA ``u % ctas``; where k is split, partials
    through the (S, b, n) workspace and one arrival counter per (row tile,
    column tile), the last warp on a tile adding them in segment order, or,
    :meth:`worker_units` is either assignment."""
    narrow: bool
    rows: int                   # row tile (an instantiation)
    segments: int               # fc_split's S
    seg_k: int                  # k per segment
    cols: int                   # columns of a unit
    tiles: int                  # column tiles
    row_tiles: int              # row tiles (more than one past 64 rows)
    ctas: int                   # the grid
    span: int                   # narrow: most tiles a CTA owns
    smem: int                   # dynamic shared memory of a CTA

    @property
    def split(self) -> bool:
        return self.segments > 1

    @property
    def workers(self) -> int:
        """Warps of a CTA, each running its own units."""
        return N_WARPS if self.narrow else wide_warps(self.rows)

    def cta_tiles(self, c: int) -> tuple[int, int]:
        """The tiles narrow CTA ``c`` owns (every segment of them)."""
        return c * self.tiles // self.ctas, (c + 1) * self.tiles // self.ctas

    def worker_units(self, c: int, i: int) -> list[tuple[int, int, int]]:
        """(tile, segment, row tile) of each unit warp ``i`` of CTA ``c``
        runs, in its order."""
        if self.narrow:
            t0, t1 = self.cta_tiles(c)
            gc = t1 - t0
            return [(t0 + u % gc, u // gc, 0)
                    for u in range(i, gc * self.segments, N_WARPS)]
        units = self.row_tiles * self.tiles * self.segments
        return [((u // self.row_tiles) % self.tiles,
                 u // self.row_tiles // self.tiles, u % self.row_tiles)
                for u in range(i * self.ctas + c, units,
                               self.ctas * self.workers)]


@functools.lru_cache(maxsize=1024)
def tc_launch(b: int, k: int, n: int, w_bytes: int = 2) -> TcLaunch:
    """The tensor-core kernel's launch for ``(b, k) @ (k, n)`` with weights
    of ``w_bytes`` (4 fp32, 2 bf16, 1 int8): the split (:func:`fc_split`)
    and so every output's order follow (k, n) alone; the row tile follows b
    and the split; the mode, the tiles and the grid follow b, the row tile
    and (k, n)."""
    segments, seg_k = fc_split(k, n)
    rows = tc_rows(b, segments)
    if b <= 8 and k <= NARROW_MAX and n <= NARROW_MAX:
        tiles = -(-n // GCOLS)
        ctas = min(tiles, SM_COUNT)
        span = -(-tiles // ctas)
        return TcLaunch(True, rows, segments, seg_k, GCOLS, tiles, 1, ctas,
                        span, narrow_smem_bytes(w_bytes, segments, span))
    cols = tc_cols(rows, w_bytes)
    tiles, row_tiles = -(-n // cols), -(-b // rows)
    ctas = min(row_tiles * tiles * segments, SM_COUNT)
    return TcLaunch(False, rows, segments, seg_k, cols, tiles, row_tiles,
                    ctas, 0, wide_smem_bytes(rows, w_bytes))


def widened_bound(x: torch.Tensor, w: torch.Tensor, wide_out: torch.Tensor,
                  *, w_scale: torch.Tensor | None = None,
                  out_dtype=None) -> torch.Tensor:
    """The worst-case |got - wide_out| (fp64, shaped like the output) of a
    tensor-core launch ``got`` on bf16 ``x`` (act none, no bias) against
    ``wide_out``, the FMA kernel's fp32 launch on the same operands widened
    (x widened, an fp32 w rounded to bf16 and widened, an int8 w as is,
    the same ``w_scale``).  Derived, not fitted:

    Both kernels see the same exact operands, and every product of two
    bf16 values is exact in fp32, so they differ only in their roundings.
    With A = |x| @ |w| per output (computed here in fp64), u = 2^-24 and k
    terms: the FMA loop's sum lies within (k - 1) u A of the exact sum; the
    tensor-core kernel's within (k - 1) 3u A: each k16 step's sum of its
    products, truncated as it goes, within 2u per term added, and the steps
    added with rounding to nearest, within u per add.  The two lie within
    4 (k - 1) u A of each other; an int8 launch then multiplies each by the
    column's scale s, rounded once in each (2 u |s| A more).  Together at
    most k 2^-22 |s| A (s = 1 without a scale).  A bf16 output is the fp32
    result rounded once: one bf16 ulp of ``wide_out`` more."""
    a = x.double().abs() @ w.double().abs()
    if w_scale is not None:
        a = a * w_scale.double().abs().reshape(1, -1)
    bound = max(x.shape[1], 1) * 2.0 ** -22 * a
    if (out_dtype or x.dtype) == torch.bfloat16:
        ref = wide_out.double()
        bound = bound + torch.ldexp(torch.ones_like(ref),
                                    torch.frexp(ref)[1] - 8)
    return bound


#: per (device, stream): the split launches' arrival counters (all 0
#: between launches: the last CTA on a tile resets its own) and the
#: workspace of their partials, grown as needed and reused by every launch
#: on that stream (launches on one stream run in order)
_SCRATCH: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
#: the largest workspace kept between launches (floats); a larger one is
#: allocated for its launch alone
WORKSPACE_KEEP = 2**24


def _scratch(device: torch.device, stream: int, tiles: int,
             partials: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(arrivals, part)`` for a split launch on ``stream``: at least
    ``tiles`` zeroed counters and ``partials`` floats of workspace."""
    key = (device, stream)
    arrivals, part = _SCRATCH.get(key, (None, None))
    if arrivals is None or arrivals.numel() < tiles:
        arrivals = torch.zeros(max(tiles, 4096), dtype=torch.int32,
                               device=device)
    if part is None or part.numel() < partials:
        fresh = torch.empty(partials, dtype=torch.float32, device=device)
        if partials > WORKSPACE_KEEP:
            _SCRATCH[key] = (arrivals, part)
            return arrivals, fresh
        part = fresh
    _SCRATCH[key] = (arrivals, part)
    return arrivals, part


def sa_fc_matmul(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None, *, act: str = "none",
                 w_scale: torch.Tensor | None = None,
                 out_dtype=None) -> torch.Tensor:
    """(b, k) @ (k, n) on an SA-FC kernel, fused scale + bias + act: the
    tensor-core kernel for bf16 x (:func:`tc_route`), the FMA kernel for
    fp32 x.  ``launches`` counts both kernels' launches, ``tc_launches``
    the tensor-core kernel's."""
    if x.device.type == "cpu":
        return sa_fc_plain(x, w, bias, act=act, w_scale=w_scale,
                           out_dtype=out_dtype)
    out_dtype, w_scale, bias = check_operands("sa_fc_matmul", x, w, bias,
                                              w_scale, out_dtype)
    b, k = x.shape
    n = w.shape[1]
    out = torch.empty((b, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scale_p = w_scale.data_ptr() if w_scale is not None else None
    bias_p = bias.data_ptr() if bias is not None else None
    if tc_route(x.dtype):
        d = tc_launch(b, k, n, w.element_size())
        part = arrivals = None
        if d.split and not d.narrow:
            arrivals, part = _scratch(x.device, stream, d.row_tiles * d.tiles,
                                      d.segments * b * n)
        lib = _build.load("sa_fc_tc")
        err = lib.sa_fc_tc_launch(
            x.data_ptr(), w.data_ptr(), W_KINDS[w.dtype], X_KINDS[out_dtype],
            scale_p, bias_p, out.data_ptr(),
            part.data_ptr() if part is not None else None,
            arrivals.data_ptr() if arrivals is not None else None, b, k, n,
            d.rows, d.seg_k // K_CHUNK, d.ctas, _build.act_code(act), stream)
        _build.check(lib, err, "sa_fc_matmul")
        sa_fc_matmul.launches += 1
        sa_fc_matmul.tc_launches += 1
        return out
    plan = fc_launch(b, k, n)
    part = arrivals = None
    if plan.split:
        arrivals, part = _scratch(x.device, stream,
                                  plan.grid[0] * plan.grid[1],
                                  plan.segments * b * n)
    lib = _build.load("sa_fc")
    err = lib.sa_fc_launch(
        x.data_ptr(), w.data_ptr(), W_KINDS[w.dtype], X_KINDS[x.dtype],
        X_KINDS[out_dtype], scale_p, bias_p, out.data_ptr(),
        part.data_ptr() if part is not None else None,
        arrivals.data_ptr() if arrivals is not None else None,
        b, k, n, plan.rows, plan.cols, plan.seg_k // K_CHUNK,
        _build.act_code(act), stream)
    _build.check(lib, err, "sa_fc_matmul")
    sa_fc_matmul.launches += 1
    return out


sa_fc_matmul.launches = 0
sa_fc_matmul.tc_launches = 0
