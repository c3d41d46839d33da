"""The ``launch`` pass: what the port's CUDA kernels launch, checked
statically.

In the reference the plan's tiles *are* the Pallas launch (the kernels
build their ``BlockSpec``\\ s from :mod:`repro_torch.kernels.geometry`'s
counterpart), so the four schedule passes certify what runs.  The port's
CUDA kernels pick their own tiles from the op's shape:
:func:`~repro_torch.kernels.sa_fc.fc_launch`,
:func:`~repro_torch.kernels.sa_conv.gemm_geometry`,
:func:`~repro_torch.kernels.sa_conv_implicit.conv_geometry` with
``conv_tiles`` and ``column_strips``,
:func:`~repro_torch.kernels.pool_act.pool_geometry` and
:func:`~repro_torch.kernels.attention.flash_geometry`.  This module builds,
for each schedule entry, the launch the kernels backend makes for it (as
:class:`Launch`, built the way each wrapper builds it) and checks four
invariants of it, all under the pass name ``launch``:

* **coverage** — every output element is written by exactly one CTA and
  one thread (the kernels' masks for partial tiles included); conv bands
  never split a pool window and compute every conv row the emitted map
  needs; column strips cover the emitted columns once and read exactly
  the input columns they need; SA-FC's segments cover k once (the last
  may be shorter); the kv tiles a query tile loops over include every key
  any of its rows may see;
* **residency** — each kernel's dynamic plus static shared memory is at
  most what a CTA may opt into on an H100, and the CTAs an SM must hold
  fit its shared memory; the dynamic figure is re-derived here from the
  tile's fields and must equal the figure the geometry passes to the
  kernel; SA-CONV's staged rows and segments fit its static tables;
* **race** — no two CTAs write one output; a split SA-FC launch gives
  each (segment, row, column) partial slot and each (column tile, row
  tile) arrival counter one writer, its scratch holds what the kernel
  indexes, and the scratch is kept per (device, stream);
* **order** — every output sums its terms in an order that depends only
  on the contraction's shape, never on the batch, ``m``, the CTA or the
  thread, checked over every batch from 1 to the entry's: SA-FC's split
  over k, the GEMM's k order, SA-CONV's tile and channel grouping (fused
  pool or not), and the kv tiles each query row sums for every query-tile
  height and pairing.  Rows == m = 1, batched == unbatched and fused ==
  unfused pool rest on this.

Flash attention is never scheduled: :func:`lm_launches` checks it at the
attention shapes of every LM config the port runs.  Nothing here launches
a kernel or touches a device: the launches are built with the wrappers' own
Python geometry functions, called through their modules (so a test can
replace one with a faulty version and see the pass catch it).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.analysis.report import AnalysisReport, Finding
from repro_torch.core.dataflow import ConvPlan
from repro_torch.kernels import attention, pool_act, sa_conv, sa_fc
from repro_torch.kernels import sa_conv_implicit as conv

#: shared memory of an H100 (the CUDA programming guide's Hopper figures;
#: phase 11 of chip_smoke.py holds the opt-in against the card): what one
#: CTA may opt into, what one SM holds, and what the system keeps of it
#: for each resident CTA
SMEM_OPTIN = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024

#: each kernel's static shared memory, as ptxas must report it: its
#: static variables, counted up to the 16-byte alignment of the dynamic
#: buffer that follows them -- SA-FC's ``__shared__ int last``; SA-CONV
#: implicit's row table (MAX_ROWS ints), segment table (MAX_SEGMENTS x 7
#: fields) and its 3 counts (csrc/sa_conv_implicit.cu); none for the others
SG_FIELDS = 7


def _static(var_bytes: int) -> int:
    return -(-var_bytes // 16) * 16


STATIC_SMEM = {
    "sa_fc": _static(4),
    "sa_conv": 0,
    "sa_conv_implicit": _static(4 * (conv.MAX_ROWS
                                     + SG_FIELDS * conv.MAX_SEGMENTS + 3)),
    "pool_act": 0,
    "attention": 0,
}

#: codes of the kernels' operand types (csrc/common.cuh Kind)
W_KIND = {"float32": 0, "int8": 1, "bfloat16": 2}
X_KIND = {"float32": 0, "bfloat16": 2}
KIND_BYTES = {0: 4, 1: 1, 2: 2}

#: the pool kernel's type code of a map of each element size (the maps
#: the engine pools: fp32, bf16, int8)
POOL_DTYPE = {4: 0, 2: 4, 1: 1}
#: base alignments a pool operand may have: the pool kernel's vector
#: follows the pointers, so its coverage is checked at each
POOL_ALIGNS = (16, 8, 4, 2, 1)

#: LM shapes whose launches :func:`lm_launches` checks, as (phase, batch,
#: sequence): chip_smoke.py phases 6 and 7 (waves of 4 and a lone request
#: of 512 prompt tokens, decode at 4 slots), phase 10 (training on 4 x
#: 512 tokens) and launch/serve.py (prompts of 8 tokens, waves of 4)
LM_SHAPES = (("prefill", 4, 512), ("prefill", 1, 512), ("decode", 4, 512),
             ("train", 4, 512), ("prefill", 4, 8))
#: the KV cache depth of chip_smoke.py's ServeEngine
LM_MAX_SEQ = 640


@dataclass(frozen=True)
class Launch:
    """What a kernel wrapper launches for one op, as data.

    ``geoms`` holds one geometry per kernel launch: one, or one per column
    strip for SA-CONV (``strips``), or, for the pool, the launch at each
    base alignment a pointer may have.  ``shape`` is the wrapper's
    arguments: SA-FC ``(b, k, n, w_kind, x_kind)``; the GEMM ``(m, n, k,
    w_kind, x_kind)``; SA-CONV ``(batch, h, w, ci, p, q, co, stride,
    x_kind)`` with ``pool`` the fused ``(window, stride)`` or ``(0, 0)``;
    the pool ``(n, h, w, c, itemsize, window, stride)``; flash ``(b, sq,
    skv, hq, hkv, d, causal, window, itemsize)``."""
    op: str
    kernel: str
    shape: tuple
    geoms: tuple
    strips: tuple = ()
    pool: tuple[int, int] = (0, 0)


# ---------------------------------------------------------------------------
# launches: each wrapper's geometry, built as the wrapper builds it
# ---------------------------------------------------------------------------
def fc_launch(op: str, b: int, k: int, n: int, w_kind: int,
              x_kind: int) -> Launch:
    """:func:`~repro_torch.kernels.sa_fc.sa_fc_matmul` on (b, k) @ (k, n)."""
    return Launch(op, "sa_fc", (b, k, n, w_kind, x_kind),
                  (sa_fc.fc_launch(b, k, n),))


def gemm_launch(op: str, m: int, n: int, k: int, w_kind: int,
                x_kind: int) -> Launch:
    """:func:`~repro_torch.kernels.sa_conv.sa_conv_matmul` on (m, k) @
    (k, n)."""
    return Launch(op, "sa_conv", (m, n, k, w_kind, x_kind),
                  (sa_conv.gemm_geometry(m, n, k, w_kind, x_kind),))


def conv_launch(op: str, batch: int, h: int, w: int, ci: int, p: int,
                q: int, co: int, stride: int, pool_window: int,
                pool_stride: int, x_kind: int) -> Launch:
    """:func:`~repro_torch.kernels.sa_conv_implicit.sa_conv_implicit` on a
    padded (batch, h, w, ci) input, pool fused when ``pool_window``: one
    launch over the whole width, or one per column strip."""
    kw = dict(stride=stride, pool_window=pool_window,
              pool_stride=pool_stride, x_bytes=KIND_BYTES[x_kind])
    strips = conv.column_strips(h, w, ci, p, q, co, **kw)
    if len(strips) == 1:
        geoms = (conv.conv_geometry(h, w, ci, p, q, co, **kw),)
    else:
        geoms = tuple(conv.conv_geometry(h, x1 - x0, ci, p, q, co, **kw)
                      for _, _, x0, x1 in strips)
    pool = (pool_window, pool_stride or pool_window) if pool_window \
        else (0, 0)
    return Launch(op, "sa_conv_implicit",
                  (batch, h, w, ci, p, q, co, stride, x_kind), geoms, strips,
                  pool)


def pool_launch(op: str, n: int, h: int, w: int, c: int, itemsize: int,
                window: int, stride: int) -> Launch:
    """:func:`~repro_torch.kernels.pool_act.maxpool_act` on an (n, h, w, c)
    map, at every base alignment (each vector width the wrapper may
    pick)."""
    geoms = {}
    for align in POOL_ALIGNS:
        g = pool_act.pool_geometry(n, h, w, c, itemsize, window, stride,
                                   align)
        geoms.setdefault(g.vec_bytes, g)
    return Launch(op, "pool_act", (n, h, w, c, itemsize, window, stride),
                  tuple(geoms.values()))


def flash_launch(op: str, b: int, sq: int, skv: int, hq: int, hkv: int,
                 d: int, causal: bool, window: int,
                 itemsize: int) -> Launch:
    """:func:`~repro_torch.kernels.attention.flash_attention` on q (b, sq,
    hq, d) and k/v (b, skv, hkv, d)."""
    g = attention.flash_geometry(b, sq, skv, hq, hkv, d, causal, window,
                                 itemsize)
    return Launch(op, "attention",
                  (b, sq, skv, hq, hkv, d, causal, window, itemsize), (g,))


def launches_for(key, plan) -> list[Launch]:
    """The launches the kernels backend makes for one schedule entry, as
    :class:`~repro_torch.core.engine.Engine` dispatches it: a conv on
    SA-CONV (its pool fused, or then on the pool kernel when the planner
    declined to fuse it), a matmul on SA-FC in the ``sa_fc`` regime and on
    the GEMM otherwise."""
    if isinstance(plan, ConvPlan):
        x_kind = X_KIND[key.dtype]
        out = [conv_launch(f"{key.name} [sa_conv_implicit]", key.batch,
                           key.h, key.w, key.ci, key.p, key.q, key.co,
                           key.stride,
                           plan.pool_window if plan.fuse_pool else 0,
                           plan.pool_stride, x_kind)]
        if key.pool_window and not plan.fuse_pool:
            oh = (key.h - key.p) // key.stride + 1
            ow = (key.w - key.q) // key.stride + 1
            out.append(pool_launch(f"{key.name}.pool [pool_act]", key.batch,
                                   oh, ow, key.co, KIND_BYTES[x_kind],
                                   key.pool_window, key.pool_stride))
        return out
    kinds = (W_KIND[key.weight_dtype], X_KIND[key.dtype])
    if plan.regime == "sa_fc":
        return [fc_launch(f"{key.name} [sa_fc]", key.m, key.k, key.n,
                          *kinds)]
    return [gemm_launch(f"{key.name} [sa_conv]", key.m, key.n, key.k,
                        *kinds)]


def schedule_launches(schedule) -> list[Launch]:
    """Every launch of a compiled schedule, conv entries first."""
    out = []
    for key, plan in schedule.conv_entries.items():
        out.extend(launches_for(key, plan))
    for key, plan in schedule.items():
        out.extend(launches_for(key, plan))
    return out


def lm_configs() -> dict[str, Any]:
    """The LM configs the port runs (those ``check_supported`` accepts), as
    published, and OLMo-1B in fp32 (chip_smoke.py phase 6) as
    ``"olmo-1b@fp32"``."""
    from repro_torch.configs.registry import all_lm_configs, get_config
    from repro_torch.models.transformer import check_supported
    out = {}
    for name, cfg in sorted(all_lm_configs().items()):
        try:
            check_supported(cfg)
        except NotImplementedError:
            continue
        out[name] = cfg
    out["olmo-1b@fp32"] = dataclasses.replace(
        get_config("olmo-1b"), param_dtype="float32",
        compute_dtype="float32")
    return out


def lm_launches(configs: dict[str, Any] | None = None,
                shapes=LM_SHAPES) -> list[Launch]:
    """The launches of LM serving and training: every matmul of each
    config's compiled schedule at ``shapes`` (SA-FC or the GEMM), and flash
    attention at each prefill and train shape, once per attention kind
    (global; sliding-window with the config's window).  Each config is
    compiled one layer pattern deep: every period of the pattern makes the
    same launches."""
    from repro_torch.configs.base import ATTN_LOCAL
    from repro_torch.core.schedule import LayerSchedule
    configs = lm_configs() if configs is None else configs
    out: list[Launch] = []
    for name, cfg in configs.items():
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
        itemsize = getattr(torch, cfg.compute_dtype).itemsize
        seen = set()
        for phase, batch, seq in shapes:
            sched = LayerSchedule.compile(cfg, phase, batch=batch, seq=seq,
                                          max_seq=LM_MAX_SEQ,
                                          cache_dtype=getattr(
                                              torch, cfg.compute_dtype))
            for lau in schedule_launches(sched):
                if (lau.kernel, lau.shape) not in seen:
                    seen.add((lau.kernel, lau.shape))
                    out.append(dataclasses.replace(
                        lau, op=f"{name} {phase} b{batch}x{seq}: {lau.op}"))
            if phase == "decode":
                continue                    # decode attention is plain
            windows = sorted({cfg.sliding_window if ak == ATTN_LOCAL else 0
                              for ak, _ in cfg.block_kinds()})
            for window in windows:
                shape = (batch, seq, seq, cfg.n_heads, cfg.n_kv_heads,
                         cfg.hd, True, window, itemsize)
                if ("attention", shape) in seen:
                    continue
                seen.add(("attention", shape))
                out.append(flash_launch(
                    f"{name} {phase} b{batch}x{seq}: attn window {window} "
                    f"[attention]", *shape))
    return out


def edge_launches() -> list[Launch]:
    """The edge geometries phase 11 of chip_smoke.py launches on the card
    (each must pass this pass first): partial last tiles in m and n; SA-FC
    split over k with a short, ragged last segment at b = 1 and one row
    past a 64-row tile; SA-CONV flat tiles that cross image boundaries and
    pooled bands whose last band is short; the pool at 16-, 8- and 4-byte
    vectors and a single bf16 element; flash with paired CTAs over an odd
    number of query tiles (a partial last one), without and with a window
    that kills each tile's leading kv tiles."""
    f32, bf16 = X_KIND["float32"], X_KIND["bfloat16"]
    return [
        fc_launch("edge b=1 [sa_fc]", 1, 3999, 1000, W_KIND["float32"], f32),
        fc_launch("edge b=65 [sa_fc]", 65, 3999, 1000, W_KIND["int8"], f32),
        gemm_launch("edge 130x200 [sa_conv]", 130, 200, 1000,
                    W_KIND["float32"], f32),
        gemm_launch("edge 130x200 bf16 [sa_conv]", 130, 200, 1000,
                    W_KIND["bfloat16"], bf16),
        conv_launch("edge flat [sa_conv_implicit]", 3, 15, 15, 16, 3, 3, 40,
                    1, 0, 0, f32),
        conv_launch("edge bands [sa_conv_implicit]", 3, 25, 25, 64, 3, 3, 96,
                    1, 3, 2, f32),
        pool_launch("edge 16 B [pool_act]", 2, 13, 13, 64, 4, 3, 2),
        pool_launch("edge 8 B [pool_act]", 2, 13, 13, 66, 4, 3, 2),
        pool_launch("edge 4 B [pool_act]", 2, 13, 13, 65, 4, 3, 2),
        pool_launch("edge bf16 element [pool_act]", 2, 13, 13, 65, 2, 2, 2),
        flash_launch("edge paired [attention]", 1, 392, 392, 128, 32, 64,
                     True, 0, 4),
        flash_launch("edge paired window [attention]", 1, 392, 392, 128, 32,
                     64, True, 100, 4),
    ]


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def _spans(what: str, spans, extent: int) -> list[tuple[str, str]]:
    """(sub-check, message) for half-open ``spans`` that do not tile
    ``[0, extent)`` exactly once: a gap is a coverage fault, an overlap a
    race, a span past the end an unmasked write."""
    out = []
    at = 0
    for lo, hi in sorted(spans):
        if hi <= lo:
            out.append(("coverage", f"{what} [{lo}, {hi}) is empty"))
            continue
        if lo > at:
            out.append(("coverage", f"{what} [{at}, {lo}) written by no "
                                    "CTA"))
        elif lo < at:
            out.append(("race", f"{what} [{lo}, {min(at, hi)}) written by "
                                "more than one CTA"))
        at = max(at, hi)
    if at < extent:
        out.append(("coverage", f"{what} [{at}, {extent}) written by no "
                                "CTA"))
    elif at > extent:
        out.append(("coverage", f"{what} [{extent}, {at}) past the extent "
                                f"{extent} is written"))
    return out


def _tiles(extent: int, tile: int, count: int) -> list[tuple[int, int]]:
    """The unmasked spans of ``count`` tiles of ``tile`` over ``extent``."""
    return [(i * tile, min((i + 1) * tile, extent)) for i in range(count)]


def _residency(kernel: str, what: str, derived: int, stated: int,
               per_sm: int = 1) -> list[tuple[str, str]]:
    """Shared memory of a launch: the figure re-derived from the tile
    against the one the geometry passes, and the card's limits."""
    out = []
    static = STATIC_SMEM[kernel]
    if derived != stated:
        out.append(("residency", f"{what}: dynamic shared memory re-derived "
                                 f"from the tile {derived} B != the "
                                 f"geometry's {stated} B — launch and "
                                 "geometry disagree"))
    total = max(derived, stated) + static
    if total > SMEM_OPTIN:
        out.append(("residency", f"{what}: {total} B of shared memory "
                                 f"({static} B static) over the "
                                 f"{SMEM_OPTIN} B a CTA may opt into"))
    elif per_sm * (total + SMEM_RESERVED) > SMEM_PER_SM:
        out.append(("residency", f"{what}: {per_sm} CTAs of {total} B do "
                                 f"not fit an SM's {SMEM_PER_SM} B"))
    return out


def _thread_map(what: str, cells: np.ndarray, size: int
                ) -> list[tuple[str, str]]:
    """Every cell of a CTA's tile owned by exactly one thread."""
    counts = np.bincount(cells, minlength=size)
    out = []
    if (counts == 0).any():
        out.append(("coverage", f"{what}: {(counts == 0).sum()} outputs of "
                                "the CTA's tile owned by no thread"))
    if (counts > 1).any():
        out.append(("race", f"{what}: {(counts > 1).sum()} outputs of the "
                            "CTA's tile owned by more than one thread"))
    return out


# ---------------------------------------------------------------------------
# SA-FC
# ---------------------------------------------------------------------------
def _fc_smem(rows: int, cols: int, w_bytes: int, x_bytes: int) -> int:
    """A CTA's dynamic shared memory from its tile: a ring of stages (6 at
    up to 8 rows, else 4), each a chunk of 32 k of x (each row padded to
    36 fp32 or 40 bf16 elements) and of w, then 4 k-lanes' sums and a
    running total of the tile in fp32."""
    ring = (6 if rows <= 8 else 4) * (
        rows * (36 if x_bytes == 4 else 40) * x_bytes + 32 * cols * w_bytes)
    return ring + 5 * rows * cols * 4


def _scratch_fits(fl, b: int, n: int, nseg: int) -> list[tuple[str, str]]:
    """The split launch's scratch, as the wrapper asks for it: enough
    arrival counters and partial floats for what the kernel indexes, kept
    per (device, stream)."""
    out = []
    dev = torch.device("meta")
    streams = (-1, -2)
    saved = {s: sa_fc._SCRATCH.pop((dev, s), None) for s in streams}
    try:
        arrivals, part = sa_fc._scratch(dev, streams[0],
                                        fl.grid[0] * fl.grid[1],
                                        fl.segments * b * n)
        other, _ = sa_fc._scratch(dev, streams[1], 1, 1)
        keyed = (dev, streams[0]) in sa_fc._SCRATCH and \
            (dev, streams[1]) in sa_fc._SCRATCH and other is not arrivals
    finally:
        for s, v in saved.items():
            sa_fc._SCRATCH.pop((dev, s), None)
            if v is not None:
                sa_fc._SCRATCH[(dev, s)] = v
    tiles = fl.grid[0] * fl.grid[1]
    if arrivals.numel() < tiles:
        out.append(("race", f"arrival counters: {arrivals.numel()} < "
                            f"{tiles}, one per (column tile, row tile) — "
                            "CTAs of different tiles share a counter"))
    if part.numel() < nseg * b * n:
        out.append(("race", f"partials workspace: {part.numel()} floats < "
                            f"{nseg} segments x {b} x {n} — partial slots "
                            "past its end"))
    if not keyed:
        out.append(("race", "split-k scratch is not kept per (device, "
                            "stream): launches on two streams would share "
                            "counters and partials"))
    return out


def check_fc(lau: Launch) -> list[tuple[str, str]]:
    b, k, n, w_kind, x_kind = lau.shape
    (fl,) = lau.geoms
    out: list[tuple[str, str]] = []
    rows, cols = fl.rows, fl.cols
    # coverage and races of the outputs: CTA (x, y) writes rows [y rb, ...)
    # and columns [x bn, ...) of out, masked at b and n
    out += _spans("out rows", _tiles(b, rows, fl.grid[1]), b)
    out += _spans("out columns", _tiles(n, cols, fl.grid[0]), n)
    # the epilogue: thread t takes outputs t + threads i of the tile (k-lanes
    # x row groups of up to 8 rows x column groups of 4 columns)
    threads = 4 * (rows // min(rows, 8)) * (cols // 4)
    per = rows * cols // threads
    e = np.arange(threads)[:, None] + threads * np.arange(per)[None, :]
    out += _thread_map("out epilogue", e.ravel(), rows * cols)
    # the split over k, as the kernel derives it from seg_k
    chunks = -(-k // sa_fc.K_CHUNK)
    seg_chunks = fl.seg_k // sa_fc.K_CHUNK
    if fl.seg_k % sa_fc.K_CHUNK or seg_chunks < 1:
        out.append(("coverage", f"k segments: seg_k {fl.seg_k} is not a "
                                f"whole number of {sa_fc.K_CHUNK}-k chunks"))
        return out
    nseg = -(-chunks // seg_chunks) if chunks > seg_chunks else 1
    if fl.segments != nseg:
        out.append(("coverage", f"k segments: fc_launch says "
                                f"{fl.segments}, the kernel derives {nseg} "
                                f"from seg_k {fl.seg_k}"))
    out += _spans("k segments", _tiles(k, fl.seg_k, nseg), k)
    if fl.split:
        # CTA (x, y, z) writes segment z's partials of its tile, slot (z b
        # + row) n + col: with rows and columns tiled once and one z per
        # segment, each slot has one writer; the last CTA to arrive on
        # counter y gx + x adds them
        if fl.grid[2] != nseg:
            out.append(("coverage", f"k segments: grid z {fl.grid[2]} != "
                                    f"{nseg} segments"))
        out += _scratch_fits(fl, b, n, nseg)
    elif fl.grid[2] != 1:
        out.append(("race", f"grid z {fl.grid[2]} on a whole launch: every "
                            "CTA of a tile writes its outputs"))
    # residency
    w_bytes, x_bytes = KIND_BYTES[w_kind], KIND_BYTES[x_kind]
    out += _residency("sa_fc", f"{rows} x {cols} tile",
                      _fc_smem(rows, cols, w_bytes, x_bytes),
                      sa_fc.fc_smem_bytes(rows, w_bytes, x_bytes))
    # order: the split over k at every batch up to b
    for bb in range(1, b + 1):
        other = sa_fc.fc_launch(bb, k, n)
        if (other.segments, other.seg_k) != (fl.segments, fl.seg_k):
            out.append(("order", f"out sums k in {other.segments} segments "
                                 f"of {other.seg_k} at b={bb} but "
                                 f"{fl.segments} of {fl.seg_k} at b={b}: "
                                 "the split over k must be a function of "
                                 "(k, n) alone"))
            break
    return out


# ---------------------------------------------------------------------------
# SA-CONV GEMM
# ---------------------------------------------------------------------------
def _gemm_smem(w_bytes: int, x_kind: int) -> int:
    """A CTA's dynamic shared memory from its tile: a ring of stages of an
    x tile and a w tile of BK k (fp32 x: 4 stages, x k-major in rows of
    BM + 4 floats; bf16 x: 5 stages, x as it lies in rows of XRP bytes,
    then two widened fp32 x tiles and two widened fp32 w tiles)."""
    g = sa_conv
    w_tile = g.BK * g.BN * w_bytes
    if x_kind == 0:
        return g.STAGES * (g.BK * (g.BM + 4) * 4 + w_tile)
    return (g.STAGES_BF16 * (g.BM * g.XRP + w_tile)
            + 2 * g.BK * (g.BM + 4) * 4 + 2 * g.BK * g.BN * 4)


def check_gemm(lau: Launch) -> list[tuple[str, str]]:
    m, n, k, w_kind, x_kind = lau.shape
    (g,) = lau.geoms
    bm, bn = sa_conv.BM, sa_conv.BN
    out: list[tuple[str, str]] = []
    origins: dict[tuple[int, int], int] = {}
    for c in range(g.ctas):
        o = g.cta_origin(c)
        if o in origins:
            out.append(("race", f"out tile at {o}: CTAs {origins[o]} and "
                                f"{c} both write it"))
            break
        origins[o] = c
    r0s = sorted({o[0] for o in origins})
    c0s = sorted({o[1] for o in origins})
    out += _spans("out rows", [(r, min(r + bm, m)) for r in r0s], m)
    out += _spans("out columns", [(c, min(c + bn, n)) for c in c0s], n)
    if len(origins) != len(r0s) * len(c0s):
        out.append(("coverage", f"out: {len(origins)} CTA tiles do not "
                                f"span the {len(r0s)} x {len(c0s)} grid "
                                "of row and column tiles"))
    cells = []
    for t in range(sa_conv.THREADS):
        rows, cols = g.thread_outputs(t)
        cells += [r * bn + c for r in rows for c in cols]
    out += _thread_map("out", np.asarray(cells), bm * bn)
    out += _residency("sa_conv", f"{'fp32' if x_kind == 0 else 'bf16'} x",
                      _gemm_smem(KIND_BYTES[w_kind], x_kind), g.smem_bytes,
                      per_sm=sa_conv.PER_SM)
    # order: one thread sums every real k of an output in increasing order,
    # the zero-filled tail after them; the launch differs by m only in its
    # row tiles
    order = g.k_order(k)
    pad = len(order) - k
    if order[:k] != list(range(k)) or any(v != -1 for v in order[k:]) \
            or not 0 <= pad < sa_conv.BK:
        out.append(("order", f"out: k_order({k}) is not 0..{k - 1} in "
                             "increasing order followed by fewer than "
                             f"{sa_conv.BK} zero-filled terms"))
    for mm in range(1, m + 1):
        other = sa_conv.gemm_geometry(mm, n, k, w_kind, x_kind)
        diff = [f.name for f in dataclasses.fields(g) if f.name != "row_tiles"
                and getattr(g, f.name) != getattr(other, f.name)]
        if diff:
            out.append(("order", f"out: the launch at m={mm} differs from "
                                 f"m={m} in {diff}"))
            break
    return out


# ---------------------------------------------------------------------------
# SA-CONV implicit
# ---------------------------------------------------------------------------
def _conv_smem(g, w: int, ci: int, p: int, q: int, stride: int) -> int:
    """A CTA's dynamic shared memory from its tile: the larger of the
    staging ring (one stage, or two when ci takes several chunks; a stage
    is ng groups of rin staged rows of wst pixels of 16 bytes, and of the
    filter's taps x cpg channels x bco output channels plus a quarter of
    that for int8's copies) and the epilogue's tile (pixels x bco + 1
    floats)."""
    split = (p, q, stride) == (11, 11, 4)
    wst = stride * -(-w // stride) if split else w
    taps = p * q
    words = g.ng * (g.rin * wst * 4 + taps * g.cpg * g.bco
                    + taps * g.cpg * g.bco // 4)
    stages = 2 if -(-ci // (conv.GROUP * g.ng)) > 1 else 1
    return 4 * max(stages * words, g.pixels * (g.bco + 1))


def _conv_order(g, ci: int, p: int, q: int, stride: int) -> tuple:
    """What fixes an output's summation order: channel groups of cpg in
    order, taps in (p, q) order (by stride phase at stride 4), the group's
    channels in order."""
    return (ci, p, q, stride, g.cpg)


def _conv_segments(g, batch: int, pool: tuple[int, int], oh: int, ow: int,
                   stride: int, p: int, what: str
                   ) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    pw, ps = pool if pool[0] else (1, 1)
    poh = (oh - pw) // ps + 1
    spans = []
    bad_band = None
    for tile in range(g.pixel_tiles(batch)):
        segs = conv.conv_tiles(g, batch, tile)
        if not 1 <= len(segs) <= conv.MAX_SEGMENTS:
            out.append(("residency", f"{what} CTA {tile}: {len(segs)} "
                                     f"segments (1..{conv.MAX_SEGMENTS} "
                                     "fit the segment table)"))
        pixels = sum(b - a for _, _, _, a, b, _, _ in segs)
        staged = sum((nr - 1) * stride + p for _, _, nr, *_ in segs)
        if pixels > g.pixels:
            out.append(("coverage", f"{what} CTA {tile}: {pixels} conv "
                                    f"pixels > its {g.pixels} slots"))
        if staged > g.rin:
            out.append(("residency", f"{what} CTA {tile}: stages {staged} "
                                     f"input rows > rin {g.rin}"))
        for img, r0, nr, a, b, pr0, npr in segs:
            if not g.bands:
                spans.append((img * oh * ow + r0 * ow + a,
                              img * oh * ow + r0 * ow + b))
                continue
            spans.append((img * poh + pr0, img * poh + pr0 + npr))
            lo, hi = pr0 * ps, (pr0 + npr - 1) * ps + pw
            if (lo < r0 or hi > r0 + nr or r0 + nr > oh) and bad_band is None:
                bad_band = (f"{what} band of image {img}, emitted rows "
                            f"[{pr0}, {pr0 + npr}): computes conv rows "
                            f"[{r0}, {r0 + nr}) but its {pw}/{ps} pool "
                            f"windows need [{lo}, {hi}) of {oh} — the band "
                            "splits a pool window")
    if bad_band:
        out.append(("coverage", bad_band))
    if g.bands:
        out += _spans(f"{what} emitted rows (image-major)", spans,
                      batch * poh)
    else:
        out += _spans(f"{what} conv pixels (image-major)", spans,
                      batch * oh * ow)
    return out


def check_conv(lau: Launch) -> list[tuple[str, str]]:
    batch, h, w, ci, p, q, co, stride, x_kind = lau.shape
    out: list[tuple[str, str]] = []
    pw, ps = lau.pool if lau.pool[0] else (1, 1)
    oh = (h - p) // stride + 1
    ow = (w - q) // stride + 1
    pow_ = (ow - pw) // ps + 1
    # column strips: whole pool windows, every emitted column once, each
    # reading exactly the input columns its windows need
    out += _spans("out columns (strips)", [s[:2] for s in lau.strips], pow_)
    for j0, j1, x0, x1 in lau.strips:
        need = (j0 * ps * stride, ((j1 - 1) * ps + pw - 1) * stride + q)
        if (x0, x1) != need or x1 > w:
            out.append(("coverage", f"strip [{j0}, {j1}): reads input "
                                    f"columns [{x0}, {x1}), needs "
                                    f"[{need[0]}, {need[1]}) of {w}"))
    if STATIC_SMEM["sa_conv_implicit"] != conv.SMEM_STATIC:
        out.append(("residency", f"static tables "
                                 f"{STATIC_SMEM['sa_conv_implicit']} B != "
                                 f"the geometry's SMEM_STATIC "
                                 f"{conv.SMEM_STATIC} B"))
    one = len(lau.strips) == 1
    for (j0, j1, x0, x1), g in zip(lau.strips, lau.geoms):
        ws = w if one else x1 - x0
        what = "out" if one else f"out strip [{j0}, {j1})"
        ows = (ws - q) // stride + 1
        if (g.conv_h, g.conv_w) != (oh, ows) or \
                (g.pool_window, g.pool_stride) != (pw, ps) or \
                g.out_w < j1 - j0:
            out.append(("coverage", f"{what}: the tile is built for a "
                                    f"{g.conv_h}x{g.conv_w} conv map with a "
                                    f"{g.pool_window}/{g.pool_stride} pool "
                                    f"emitting {g.out_w} columns; the op "
                                    f"has {oh}x{ows}, {pw}/{ps}, "
                                    f"{j1 - j0}"))
        if g.pixels != conv.THREADS // g.groups * g.tpx or \
                g.bco != g.tco * g.groups:
            out.append(("coverage", f"{what}: {g.pixels} pixel slots x "
                                    f"{g.bco} channels are not the "
                                    f"{conv.THREADS} threads' {g.tpx} x "
                                    f"{g.tco} in {g.groups} groups"))
        out += _spans(f"{what} channels",
                      _tiles(co, g.bco, g.co_tiles(co)), co)
        if g.rin > conv.MAX_ROWS:
            out.append(("residency", f"{what}: rin {g.rin} > MAX_ROWS "
                                     f"{conv.MAX_ROWS}"))
        for bb in sorted({1, batch}):
            out += _conv_segments(g, bb, lau.pool, oh, ows, stride, p,
                                  f"{what} at batch {bb}")
        out += _residency("sa_conv_implicit", what,
                          _conv_smem(g, ws, ci, p, q, stride), g.smem_bytes)
    # order: one grouping of channels and taps for every strip, for the
    # unfused conv, and for the launch at every batch up to the op's
    orders = {_conv_order(g, ci, p, q, stride) for g in lau.geoms}
    plain = conv_launch(lau.op, batch, h, w, ci, p, q, co, stride, 0, 0,
                        x_kind)
    plain_orders = {_conv_order(g, ci, p, q, stride) for g in plain.geoms}
    if len(orders) != 1 or orders != plain_orders:
        out.append(("order", f"out: channel grouping {sorted(orders)} "
                             f"(fused) vs {sorted(plain_orders)} (unfused) "
                             "— fused and unfused pool would sum in "
                             "different orders"))
    for bb in range(1, batch + 1):
        other = conv_launch(lau.op, bb, h, w, ci, p, q, co, stride,
                            lau.pool[0], lau.pool[1], x_kind)
        if other.geoms != lau.geoms or other.strips != lau.strips:
            out.append(("order", f"out: the tile at batch {bb} differs from "
                                 f"batch {batch}: the tiling must come from "
                                 "the layer's shape alone"))
            break
    return out


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------
def check_pool(lau: Launch) -> list[tuple[str, str]]:
    n, h, w, c, itemsize, window, stride = lau.shape
    out: list[tuple[str, str]] = []
    oh = (h - window) // stride + 1
    ow = (w - window) // stride + 1
    if n > pool_act.MAX_IMAGES:
        out.append(("coverage", f"out: {n} images > the grid's "
                                f"{pool_act.MAX_IMAGES}"))
    for g in lau.geoms:
        what = f"out at {g.vec_bytes}-byte vectors"
        vb = g.vec_bytes
        legal = vb in (16, 8, 4) or vb == itemsize
        if not legal or (c * itemsize) % vb or vb < itemsize:
            out.append(("coverage", f"{what}: a {vb}-byte vector does not "
                                    f"divide a {c * itemsize}-byte pixel "
                                    f"of {itemsize}-byte elements"))
            continue
        vecs = c * itemsize // vb
        per_image = oh * ow * vecs
        if g.per_image != per_image or g.vecs != vecs:
            out.append(("coverage", f"{what}: {g.per_image} threads an "
                                    f"image, {per_image} outputs"))
        if g.blocks * pool_act.THREADS < per_image or \
                (g.blocks - 1) * pool_act.THREADS >= per_image:
            out.append(("coverage", f"{what}: {g.blocks} CTAs of "
                                    f"{pool_act.THREADS} threads for "
                                    f"{per_image} outputs an image"))
        vec, oy, ox = g.outputs()
        cells = (oy * ow + ox) * vecs + vec
        if len(cells) and (cells.min() < 0 or cells.max() >= per_image):
            out.append(("coverage", f"{what}: a thread writes past the "
                                    "image's outputs"))
            continue
        out += _thread_map(what, cells, per_image)
        out += _residency("pool_act", what, 0, 0)
    # order: the window's maxes run in (dp, dq) order in every launch; the
    # launch differs by batch only in its images
    for bb in range(1, n + 1):
        other = pool_launch(lau.op, bb, h, w, c, itemsize, window, stride)
        if [dataclasses.replace(g, n=n) for g in other.geoms] != \
                list(lau.geoms):
            out.append(("order", f"out: the launch at batch {bb} differs "
                                 f"from batch {n} beyond its images"))
            break
    return out


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def _flash_smem(bq: int, d: int, itemsize: int) -> int:
    """A CTA's dynamic shared memory from its tile: the Q tile in fp32 and
    two stages of K and V in the operands' type, rows padded by 4
    elements, and 8 warps' P slices of 2 x bq / 16 rows of 32 + 4 fp32."""
    return (4 * bq * (d + 4) + itemsize * 2 * 2 * attention.BKV * (d + 4)
            + 4 * 8 * (2 * bq // 16) * (32 + 4))


def _visible(rows: np.ndarray, sq: int, skv: int, causal: bool,
             window: int) -> tuple[np.ndarray, np.ndarray]:
    """(first, last) key each query row sees (last < first: none), as the
    plain version masks: causal ``kpos <= qpos``, window ``kpos > qpos -
    window``, queries aligned to the end of the keys."""
    qpos = rows + skv - sq
    last = np.minimum(skv - 1, qpos) if causal else \
        np.full_like(rows, skv - 1)
    first = np.maximum(0, qpos - window + 1) if window > 0 else \
        np.zeros_like(rows)
    return first, last


def _kv_sequences(bq: int, sq: int, skv: int, causal: bool, window: int
                  ) -> tuple[list[tuple[int, ...]], str | None]:
    """The kv tiles each query row sums (those of its tile's loop in which
    it sees a key, in loop order) at query tiles of ``bq`` rows, and the
    first row whose loop misses a tile holding a key it sees."""
    rows = np.arange(sq)
    first, last = _visible(rows, sq, skv, causal, window)
    bkv = attention.BKV
    seqs: list[tuple[int, ...]] = []
    missed = None
    for iq in range(-(-sq // bq)):
        loop = list(attention.live_tiles(iq, sq, skv, causal=causal,
                                         window=window, bq=bq))
        for r in range(iq * bq, min((iq + 1) * bq, sq)):
            need = range(first[r] // bkv, last[r] // bkv + 1) \
                if first[r] <= last[r] else range(0)
            if missed is None and not set(need) <= set(loop):
                missed = (f"query row {r} (tile {iq} of {bq}) sees keys "
                          f"[{first[r]}, {last[r]}] in kv tiles "
                          f"{list(need)}, the tile's loop runs "
                          f"{loop[:1]}..{loop[-1:]}")
            seqs.append(tuple(t for t in loop if t in need))
    return seqs, missed


def check_flash(lau: Launch) -> list[tuple[str, str]]:
    b, sq, skv, hq, hkv, d, causal, window, itemsize = lau.shape
    (g,) = lau.geoms
    out: list[tuple[str, str]] = []
    if d not in attention.HEAD_DIMS or hq % hkv or g.bq not in attention.BQ:
        out.append(("coverage", f"out: no instantiation for head dim {d}, "
                                f"{hq}/{hkv} heads, {g.bq}-row tiles"))
        return out
    if g.heads != b * hq:
        out.append(("coverage", f"out: {g.heads} (batch, head) pairs, the "
                                f"launch has {b * hq}"))
    if g.q_tiles != -(-sq // g.bq):
        out.append(("coverage", f"out rows: {g.q_tiles} query tiles of "
                                f"{g.bq} for {sq} rows"))
    # every (batch x head, query tile) once, with the launch's pairing and
    # with the other (pairing changes which CTA computes a tile, not how)
    for paired in (g.paired, not g.paired):
        pg = dataclasses.replace(g, paired=paired)
        what = f"out ({'paired' if paired else 'unpaired'} CTAs)"
        seen = np.zeros((pg.heads, pg.q_tiles), dtype=np.int64)
        for c in range(pg.ctas):
            bh, tiles = pg.cta_tiles(c)
            for t in tiles:
                if 0 <= bh < pg.heads and 0 <= t < pg.q_tiles:
                    seen[bh, t] += 1
        if (seen == 0).any():
            bh, t = np.argwhere(seen == 0)[0]
            out.append(("coverage", f"{what}: query tile {t} of (batch, "
                                    f"head) {bh} written by no CTA "
                                    f"({(seen == 0).sum()} such tiles)"))
        if (seen > 1).any():
            bh, t = np.argwhere(seen > 1)[0]
            out.append(("race", f"{what}: query tile {t} of (batch, head) "
                                f"{bh} written by more than one CTA"))
    # each thread's (row, column) of a tile: warp w rows 2 RPT w + 2 r +
    # half, lane x columns 4 (x + 16 c)
    rpt, nc4 = g.bq // 16, d // 4
    cells = []
    for t in range(256):
        wp, lane = divmod(t, 32)
        half, x = divmod(lane, 16)
        for r in range(rpt):
            row = wp * 2 * rpt + 2 * r + half
            for cc in range(-(-nc4 // 16)):
                if x + 16 * cc < nc4:
                    cells += [row * d + 4 * (x + 16 * cc) + e
                              for e in range(4)]
    out += _thread_map("out", np.asarray(cells), g.bq * d)
    out += _residency("attention", f"{g.bq}-row tiles, d {d}",
                      _flash_smem(g.bq, d, itemsize), g.smem_bytes)
    # coverage of keys and order: each row sums the same kv tiles in the
    # same order at every tile height the launch may pick
    seqs = {}
    for bq in attention.BQ:
        seqs[bq], missed = _kv_sequences(bq, sq, skv, causal, window)
        if missed:
            out.append(("coverage", f"keys: {missed} — live_tiles drops a "
                                    "visible kv tile"))
    for r in range(sq):
        if len({seqs[bq][r] for bq in attention.BQ}) > 1:
            out.append(("order", f"out row {r}: kv tiles "
                                 + ", ".join(f"{list(seqs[bq][r])} at "
                                             f"bq={bq}"
                                             for bq in attention.BQ)))
            break
    for bb in range(1, b + 1):
        other = attention.flash_geometry(bb, sq, skv, hq, hkv, d, causal,
                                         window, itemsize)
        if other.bq not in attention.BQ:
            out.append(("order", f"out: {other.bq}-row tiles at b={bb}"))
            break
    return out


CHECKS = {"sa_fc": check_fc, "sa_conv": check_gemm,
          "sa_conv_implicit": check_conv, "pool_act": check_pool,
          "attention": check_flash}


def check_launch(lau: Launch) -> list[Finding]:
    """Every launch invariant of one launch, as findings of the ``launch``
    pass whose message names the kernel, the sub-check and the operand."""
    return [Finding("launch", lau.op, f"{lau.kernel} {sub}: {msg}")
            for sub, msg in CHECKS[lau.kernel](lau)]


def verify_launches(launches, *, label: str = "launch") -> AnalysisReport:
    report = AnalysisReport(label=label)
    for lau in launches:
        report.add(check_launch(lau))
        report.checked_ops += 1
    return report


def smem_queries(lau: Launch) -> list[tuple[str, tuple, int]]:
    """(library, arguments of its exported shared-memory query, the bytes
    this pass derives) for each kernel launch of ``lau``: what phase 11 of
    chip_smoke.py asks the built kernels."""
    if lau.kernel == "sa_fc":
        _, _, _, w_kind, x_kind = lau.shape
        (fl,) = lau.geoms
        return [("sa_fc", (w_kind, x_kind, fl.rows),
                 _fc_smem(fl.rows, fl.cols, KIND_BYTES[w_kind],
                          KIND_BYTES[x_kind]))]
    if lau.kernel == "sa_conv":
        _, _, _, w_kind, x_kind = lau.shape
        return [("sa_conv", (w_kind, x_kind),
                 _gemm_smem(KIND_BYTES[w_kind], x_kind))]
    if lau.kernel == "sa_conv_implicit":
        _, _, w, ci, p, q, _, stride, x_kind = lau.shape
        out = []
        for (_, _, x0, x1), g in zip(lau.strips, lau.geoms):
            ws = w if len(lau.strips) == 1 else x1 - x0
            tile = conv.TILES.index((g.tpx, g.tco, g.groups))
            out.append(("sa_conv_implicit",
                        (tile, x_kind, ws, ci, p, q, stride, g.rin, g.ng),
                        _conv_smem(g, ws, ci, p, q, stride)))
        return out
    if lau.kernel == "pool_act":
        itemsize = lau.shape[4]
        return [("pool_act", (POOL_DTYPE[itemsize], g.vec_bytes), 0)
                for g in lau.geoms]
    b, sq, skv, hq, hkv, d, causal, window, itemsize = lau.shape
    (g,) = lau.geoms
    return [("attention", (d, g.bq, X_KIND["float32" if itemsize == 4
                                           else "bfloat16"]),
             _flash_smem(g.bq, d, itemsize))]
