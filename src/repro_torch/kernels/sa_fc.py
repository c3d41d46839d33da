"""SA-FC — the batch-amortized weight stream, as a hand-written CUDA kernel
(``csrc/sa_fc.cu``) with its plain PyTorch version.

``sa_fc_matmul`` computes ``act((x @ w) * w_scale + bias)`` for ``x`` (b, k)
fp32 or bf16 and ``w`` (k, n) fp32, bf16 or int8 (int8 with a (1, n) or
(n,) per-column ``w_scale``), written as ``out_dtype`` (fp32 or bf16, by
default ``x``'s).  As in the TPU kernel, ``w`` is rounded to ``x``'s dtype,
products are summed in fp32 and the epilogue runs in fp32.  For a CPU
tensor it runs :func:`sa_fc_plain`; for a CUDA tensor it launches the
kernel on the current stream, or raises.  Ragged k, n and b are masked
inside the kernel: no padded copies.

The kernel splits k into :func:`fc_split` segments, a function of (k, n)
only, and adds every output's terms in an order fixed by that split, so a
row's output is bitwise the same whatever batch it rides in.
:func:`fc_launch` is the whole launch geometry, in Python so that the CPU
tests reach it.

Two kernels run that order.  bf16 ``x`` with bf16 ``w`` at a row tile of at
most 8 (every LM decode step) runs the decode kernel
(``csrc/sa_fc_decode.cu``, launch geometry :func:`decode_launch`), a weight
stream laid out for the card's memory; everything else runs the FMA kernel
(``csrc/sa_fc.cu``).  :func:`decode_route` is the choice, by dtype and row
tile alone, and the two give the same bits.
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
#: the decode kernel (csrc/sa_fc_decode.cu, the same names there): its row
#: tiles and the largest k and n it runs narrow; narrow: the columns of a warp's
#: unit (a group), warps a CTA, stages of a warp's ring, where a stage's x
#: rows start, the most partials it keeps in shared memory (what k and n up
#: to NARROW_MAX give); wide: the columns of a
#: team's unit (a tile), teams of K_LANES warps a CTA, CTAs an SM, stages
#: of a warp's ring and their bytes (a lane's 8 weight rows of a tile, then
#: 128 bytes for its 8 k of the x rows); the SMs of an H100
DECODE_ROWS = (1, 2, 4, 8)
NARROW_MAX = 4096
GCOLS = 16
N_WARPS = 16
N_DEPTH = 6
N_X_OFF = K_LANES * (8 * GCOLS * 2 + 32)
PART_SMEM_MAX = 65536
TILE = 128
TEAMS = 2
PER_SM = 2
W_DEPTH = 4
W_STAGE = 8 * TILE * 2 + 128
SM_COUNT = 132


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


def fc_smem_bytes(rows: int, w_bytes: int, x_bytes: int = 4) -> int:
    """Dynamic shared memory of a CTA at row tile ``rows`` (csrc/sa_fc.cu
    ``Cfg::SMEM``): a ring of 6 stages (4 above 8 rows), each a chunk of x
    (``rows`` rows of :data:`K_CHUNK`, padded by 4 fp32 or 8 bf16
    elements) and of w (:data:`K_CHUNK` rows of the tile's columns, in
    ``w_bytes``), then the k-lanes' sums and the running total in fp32."""
    cols = _COLS[rows]
    stages = 6 if rows <= 8 else 4
    x_row = K_CHUNK + (4 if x_bytes == 4 else 8)
    stage = rows * x_row * x_bytes + K_CHUNK * cols * w_bytes
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


def decode_route(b: int, x_dtype: torch.dtype, w_dtype: torch.dtype) -> bool:
    """Whether :func:`sa_fc_matmul` runs the decode kernel for ``b`` rows:
    bf16 ``x`` with bf16 ``w`` at a row tile of at most 8."""
    return (x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16
            and row_tile(b) in DECODE_ROWS)


def narrow_smem_bytes(rows: int, segments: int, span: int) -> int:
    """Dynamic shared memory of a narrow decode CTA (csrc/sa_fc_decode.cu
    ``narrow::smem_bytes``): its warps' rings, a stage a chunk of 16
    columns (4 k-lanes' blocks of 8 rows padded by 32 bytes) then its 32 k
    of each x row; then, where k is split, the partials of the CTA's units
    (``span`` groups x ``segments`` x ``rows`` x :data:`GCOLS` floats)."""
    part = span * segments * rows * GCOLS * 4 if segments > 1 else 0
    return N_WARPS * N_DEPTH * (N_X_OFF + rows * K_CHUNK * 2) + part


def wide_smem_bytes(rows: int) -> int:
    """Dynamic shared memory of a wide decode CTA (csrc/sa_fc_decode.cu
    ``wide::smem_bytes``): 128 bytes to align, the rings of its ``TEAMS``
    x ``K_LANES`` warps, each team's buffer of warps 1-3's lane sums
    (``rows`` x :data:`TILE` floats each), each warp's mbarriers."""
    warps = TEAMS * K_LANES
    return (128 + warps * W_DEPTH * W_STAGE
            + TEAMS * (K_LANES - 1) * rows * TILE * 4 + warps * W_DEPTH * 8)


@dataclasses.dataclass(frozen=True)
class DecodeLaunch:
    """How :func:`sa_fc_matmul` launches the decode kernel for one shape.

    A unit is (column tile, k segment).  Narrow (k and n at most
    :data:`NARROW_MAX`):
    tiles of :data:`GCOLS` columns, a warp a unit; CTA ``c`` owns tiles
    :meth:`cta_tiles` and every segment of them, its units
    segment-major round-robin over its :data:`N_WARPS` warps, and adds
    each output's segments in order from shared memory.  Wide: tiles of
    :data:`TILE` columns, a team of K_LANES warps a unit; units
    segment-major (``u = segment x tiles + tile``) round-robin over the
    ``ctas x TEAMS`` teams; where k is split, partials through the
    (S, b, n) workspace and one arrival counter per tile, the last team on
    a tile adding them in segment order.  :meth:`worker_units` is either
    assignment."""
    narrow: bool
    rows: int                   # row tile (an instantiation)
    segments: int               # fc_split's S
    seg_k: int                  # k per segment
    cols: int                   # columns of a unit
    tiles: int                  # column tiles
    ctas: int                   # the grid
    span: int                   # narrow: most tiles a CTA owns
    smem: int                   # dynamic shared memory of a CTA

    @property
    def split(self) -> bool:
        return self.segments > 1

    @property
    def workers(self) -> int:
        """Workers of a CTA, each running its own units: warps (narrow) or
        teams (wide)."""
        return N_WARPS if self.narrow else TEAMS

    def cta_tiles(self, c: int) -> tuple[int, int]:
        """The tiles narrow CTA ``c`` owns (every segment of them)."""
        return c * self.tiles // self.ctas, (c + 1) * self.tiles // self.ctas

    def worker_units(self, c: int, i: int) -> list[tuple[int, int]]:
        """(tile, segment) of each unit worker ``i`` of CTA ``c`` runs, in
        its order."""
        if self.narrow:
            t0, t1 = self.cta_tiles(c)
            gc = t1 - t0
            return [(t0 + u % gc, u // gc)
                    for u in range(i, gc * self.segments, N_WARPS)]
        units = self.tiles * self.segments
        return [(u % self.tiles, u // self.tiles)
                for u in range(c * TEAMS + i, units, self.ctas * TEAMS)]


@functools.lru_cache(maxsize=1024)
def decode_launch(b: int, k: int, n: int) -> DecodeLaunch:
    """The decode kernel's launch for ``(b, k) @ (k, n)``, b <= 8: the row
    tile follows b; the mode, the split, the tiles, the grid and every
    worker's units follow (k, n) alone."""
    rb = row_tile(b)
    if rb not in DECODE_ROWS:
        raise ValueError(f"decode_launch: b={b} is above the decode row tiles")
    segments, seg_k = fc_split(k, n)
    if k <= NARROW_MAX and n <= NARROW_MAX:
        tiles = -(-n // GCOLS)
        ctas = min(tiles, SM_COUNT)
        span = -(-tiles // ctas)
        return DecodeLaunch(True, rb, segments, seg_k, GCOLS, tiles, ctas,
                            span, narrow_smem_bytes(rb, segments, span))
    tiles = -(-n // TILE)
    ctas = min(-(-tiles * segments // TEAMS), SM_COUNT * PER_SM)
    return DecodeLaunch(False, rb, segments, seg_k, TILE, tiles, ctas, 0,
                        wide_smem_bytes(rb))


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
    decode kernel where :func:`decode_route` says so, else the FMA kernel.
    ``launches`` counts both kernels' launches, ``decode_launches`` the
    decode kernel's."""
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
    if decode_route(b, x.dtype, w.dtype):
        d = decode_launch(b, k, n)
        part = arrivals = None
        if d.split and not d.narrow:
            arrivals, part = _scratch(x.device, stream, d.tiles,
                                      d.segments * b * n)
        lib = _build.load("sa_fc_decode")
        err = lib.sa_fc_decode_launch(
            x.data_ptr(), w.data_ptr(), X_KINDS[out_dtype],
            w_scale.data_ptr() if w_scale is not None else None,
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            part.data_ptr() if part is not None else None,
            arrivals.data_ptr() if arrivals is not None else None, b, k, n,
            d.rows, d.seg_k // K_CHUNK, d.ctas, _build.act_code(act), stream)
        _build.check(lib, err, "sa_fc_matmul")
        sa_fc_matmul.launches += 1
        sa_fc_matmul.decode_launches += 1
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
        X_KINDS[out_dtype],
        w_scale.data_ptr() if w_scale is not None else None,
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        part.data_ptr() if part is not None else None,
        arrivals.data_ptr() if arrivals is not None else None,
        b, k, n, plan.rows, plan.cols, plan.seg_k // K_CHUNK,
        _build.act_code(act), stream)
    _build.check(lib, err, "sa_fc_matmul")
    sa_fc_matmul.launches += 1
    return out


sa_fc_matmul.launches = 0
sa_fc_matmul.decode_launches = 0
