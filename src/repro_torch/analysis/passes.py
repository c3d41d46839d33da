"""The four schedule-verification passes (the reference's, line for line).

Each pass takes one :class:`OpContext` — a scheduled op's key, its plan,
the :class:`~repro_torch.kernels.geometry.KernelGeometry` the plan's tiles
describe, and the policy it was planned under — and returns
:class:`~repro_torch.analysis.report.Finding`\\ s.  Nothing here executes a
kernel: the index maps are plain Python callables over integer grid
coordinates, so "symbolic evaluation over the grid" is a nested loop,
and every byte count is re-derived from first principles (the paper's
Sec. V traffic model) independently of the planner's own arithmetic.

* :func:`check_coverage` — grid x block coverage of every operand (no
  gap, no silent clamp), SUBLANE/LANE alignment, the ``MAX_TILE`` cap,
  and plan-vs-kernel tile agreement (the planner's tiles must be exactly
  what the kernel's normalization executes).
* :func:`check_residency` — VMEM working set re-derived from the block
  specs alone (double-buffered inputs, fp32 accumulator scratch, the
  planner's output-tile conventions) must equal the plan's
  ``vmem_bytes`` and fit the policy budget.
* :func:`check_races` — no two grid steps may write the same output
  block through a non-reduction ("parallel") dimension, and every
  reduction ("arbitrary") dimension must be innermost-sequential.
* :func:`check_accounting` — ``hbm_bytes`` equals the independent
  traffic replica, is never below the compulsory minimum, fused-pool
  credits are non-negative, and the FC weight stream / ``flip_batch``
  agree with :func:`~repro_torch.core.dataflow.classify_regime`.

The port's planner prices with the reference's ``TPU_V5E``, so its plans,
and these passes' findings, equal the reference's.  What the CUDA kernels
launch is checked by :mod:`repro_torch.analysis.launch`.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch

from repro_torch.analysis.report import Finding
from repro_torch.core import dataflow
from repro_torch.core.dataflow import (
    LANE,
    MAX_TILE,
    SUBLANE,
    ConvPlan,
    FCPlan,
    MatmulPlan,
    PoolSpec,
    _round_up,
)
from repro_torch.core.engine import DispatchPolicy
from repro_torch.core.schedule import ConvOpKey, OpKey
from repro_torch.kernels.geometry import KernelGeometry, fc_normalize

#: above this many grid points the enumeration passes bail with a
#: warning instead of looping for minutes (no real schedule is close)
MAX_GRID_POINTS = 1_000_000


@dataclass(frozen=True)
class OpContext:
    """One scheduled op, ready to verify: identity, plan, the launch
    geometry the kernel would execute, the logical (unpadded) extent of
    every operand, and the policy whose budget/ridge the plan answers
    to.  ``kind`` is ``'fc' | 'matmul' | 'conv'``."""
    op: str
    kind: str
    key: OpKey | ConvOpKey
    plan: FCPlan | MatmulPlan | ConvPlan
    geom: KernelGeometry
    extents: dict[str, tuple[int, ...]]
    policy: DispatchPolicy

    @property
    def act_bytes(self) -> int:
        return getattr(torch, self.key.dtype).itemsize

    @property
    def weight_bytes(self) -> int:
        return getattr(torch, self.key.weight_dtype).itemsize


def _grid_points(geom: KernelGeometry):
    return itertools.product(*(range(g) for g in geom.grid))


def _plan_tiles(ctx: OpContext) -> tuple[tuple[str, int], ...]:
    """(tile name, tile edge) of the plan — the dims MAX_TILE caps."""
    p = ctx.plan
    if ctx.kind == "fc":
        return (("bb", p.bb), ("bn", p.bn), ("bk", p.bk))
    if ctx.kind == "matmul":
        return (("bm", p.bm), ("bn", p.bn), ("bk", p.bk))
    return (("bi", p.bi), ("bj", p.bj))


# ---------------------------------------------------------------------------
# pass 1: grid coverage & tile lint
# ---------------------------------------------------------------------------
def check_coverage(ctx: OpContext) -> list[Finding]:
    out: list[Finding] = []

    def err(msg: str) -> None:
        out.append(Finding("coverage", ctx.op, msg))

    p = ctx.plan
    # -- tile caps + alignment ---------------------------------------------
    for name, tile in _plan_tiles(ctx):
        if tile > MAX_TILE:
            err(f"tile {name}={tile} exceeds MAX_TILE={MAX_TILE}")
        if tile < 1:
            err(f"tile {name}={tile} is not positive")
    if ctx.kind in ("fc", "matmul"):
        row = p.bb if ctx.kind == "fc" else p.bm
        if row % SUBLANE:
            err(f"row tile {row} not SUBLANE({SUBLANE})-aligned")
        if p.bn % LANE:
            err(f"bn={p.bn} not LANE({LANE})-aligned")
        if p.bk % LANE:
            err(f"bk={p.bk} not LANE({LANE})-aligned")
    else:
        k = ctx.key
        if p.bi % SUBLANE and p.bi != k.ci:
            err(f"bi={p.bi} neither SUBLANE-aligned nor the exact "
                f"channel count ci={k.ci}")
        if p.bj % SUBLANE and p.bj != k.co:
            err(f"bj={p.bj} neither SUBLANE-aligned nor the exact "
                f"channel count co={k.co}")

    # -- plan-vs-kernel tile agreement -------------------------------------
    if ctx.kind == "fc":
        _, nbb, nbn, nbk = fc_normalize(p.b, p.n, p.k,
                                        bb=p.bb, bn=p.bn, bk=p.bk)
        if (nbb, nbn, nbk) != (p.bb, p.bn, p.bk):
            err(f"plan tiles (bb={p.bb}, bn={p.bn}, bk={p.bk}) disagree "
                f"with the kernel's normalized tiles "
                f"({nbb}, {nbn}, {nbk}) — silent clamp drift")
        want_grid = p.grid(p.b, p.n, p.k)
    elif ctx.kind == "matmul":
        want_grid = p.grid(ctx.key.m, ctx.key.n, ctx.key.k)
    else:
        want_grid = p.grid(ctx.key.batch, ctx.key.ci, ctx.key.co)
    if ctx.geom.grid != want_grid:
        err(f"kernel grid {ctx.geom.grid} != plan grid {want_grid}")

    # -- symbolic grid coverage of every operand ---------------------------
    if ctx.geom.points > MAX_GRID_POINTS:
        out.append(Finding("coverage", ctx.op,
                           f"grid has {ctx.geom.points} points "
                           f"(> {MAX_GRID_POINTS}); coverage enumeration "
                           "skipped", severity="warning"))
        return out
    specs = list(ctx.geom.inputs) + [ctx.geom.out]
    for spec in specs:
        extent = ctx.extents.get(spec.name)
        if extent is None:
            err(f"no logical extent recorded for operand {spec.name!r}")
            continue
        if len(extent) != len(spec.block):
            err(f"operand {spec.name!r}: block rank {len(spec.block)} != "
                f"extent rank {len(extent)}")
            continue
        visited = {spec.index_map(*pt) for pt in _grid_points(ctx.geom)}
        per_dim = [sorted({v[d] for v in visited})
                   for d in range(len(spec.block))]
        for d, vals in enumerate(per_dim):
            if vals != list(range(len(vals))):
                err(f"operand {spec.name!r} dim {d}: visited block "
                    f"indices {vals} are not contiguous from 0 — "
                    "coverage gap")
        if len(visited) != math.prod(len(v) for v in per_dim):
            err(f"operand {spec.name!r}: visited {len(visited)} block "
                f"indices but the per-dim ranges span "
                f"{math.prod(len(v) for v in per_dim)} — coverage gap")
        for d, (vals, blk, ext) in enumerate(
                zip(per_dim, spec.block, extent)):
            covered = blk * len(vals)
            if covered < ext:
                err(f"operand {spec.name!r} dim {d}: grid covers "
                    f"{covered} elements < extent {ext} — silent clamp")
    return out


# ---------------------------------------------------------------------------
# pass 2: VMEM residency sanitizer
# ---------------------------------------------------------------------------
def derive_vmem_bytes(ctx: OpContext) -> int:
    """The op's resident working set, re-derived from the geometry's
    block specs alone (never from the plan's own ``vmem_bytes``), under
    the planner's charging conventions: inputs double-buffered, fp32
    scratch accumulators, fp32 output tile for the FC/conv kernels (the
    SA-CONV matmul planner historically charges no output-tile term —
    its psum flushes through the accumulator scratch it already
    charged), and the conv kernel's on-chip patch tile / tap-streaming
    temporaries.  The (1, bn) fp32 scale/bias rows are uncharged, as in
    the planner."""
    g = ctx.geom
    bi, bw = ctx.act_bytes, ctx.weight_bytes
    scratch = sum(math.prod(s) for s in g.scratch) * 4
    base = 2 * (g.input("x").elems * bi + g.input("w").elems * bw) + scratch
    if ctx.kind == "matmul":
        return base
    if ctx.kind == "fc":
        return base + math.prod(g.out.block) * 4
    # conv: pooled/full output tile + the tap-mode working set
    p, q, cbi, cbj = g.input("w").block
    rows = g.scratch[0][0]                      # oh * ow
    base += math.prod(g.out.block) * 4
    if ctx.plan.fuse_taps:
        base += rows * p * q * cbi * bi         # on-chip patch tile
    else:
        base += rows * (cbi * bi + cbj * 4)     # live view + loop temp
    return base


def check_residency(ctx: OpContext) -> list[Finding]:
    out: list[Finding] = []
    derived = derive_vmem_bytes(ctx)
    budget = ctx.policy.effective_vmem_budget
    if derived != ctx.plan.vmem_bytes:
        out.append(Finding(
            "residency", ctx.op,
            f"block-spec residency {derived} B != plan.vmem_bytes "
            f"{ctx.plan.vmem_bytes} B — plan and kernel disagree about "
            "the working set"))
    if derived > budget:
        severity = "error"
        if ctx.kind == "conv" and _conv_nothing_fits(ctx):
            # plan_conv's honest over-budget fallback: no tiling of this
            # op fits at all, the plan says so in vmem_bytes, and the
            # reference's kernel still runs in interpret mode — report,
            # don't fail.
            severity = "warning"
        out.append(Finding(
            "residency", ctx.op,
            f"resident working set {derived} B overflows the policy "
            f"VMEM budget {budget} B", severity=severity))
    return out


def _conv_nothing_fits(ctx: OpContext) -> bool:
    """True when not even the minimum conv tiling fits the budget — the
    planner's documented fallback regime."""
    k = ctx.key
    min_bi = dataflow._channel_tiles(k.ci)[0]
    min_bj = dataflow._channel_tiles(k.co)[0]
    oh = (k.h - k.p) // k.stride + 1
    ow = (k.w - k.q) // k.stride + 1
    minimal = (2 * k.h * k.w * min_bi * ctx.act_bytes
               + 2 * k.p * k.q * min_bi * min_bj * ctx.weight_bytes
               + oh * ow * min_bj * 4
               + oh * ow * min_bj * 4
               + oh * ow * (min_bi * ctx.act_bytes + min_bj * 4))
    return minimal > ctx.policy.effective_vmem_budget


# ---------------------------------------------------------------------------
# pass 3: grid write-race detector
# ---------------------------------------------------------------------------
def check_races(ctx: OpContext) -> list[Finding]:
    out: list[Finding] = []
    g = ctx.geom
    sem = g.dimension_semantics
    if len(sem) != len(g.grid):
        out.append(Finding("race", ctx.op,
                           f"{len(sem)} dimension semantics for a "
                           f"{len(g.grid)}-dim grid"))
        return out
    # reduction dims must be the innermost (trailing) suffix: a
    # sequential dim ahead of a parallel one would reorder partial
    # accumulations under compiler parallelization
    arb = [i for i, s in enumerate(sem) if s == "arbitrary"]
    if arb and arb != list(range(len(sem) - len(arb), len(sem))):
        out.append(Finding(
            "race", ctx.op,
            f"reduction dimensions {arb} of semantics {sem} are not the "
            "innermost-sequential suffix of the grid"))
    if g.points > MAX_GRID_POINTS:
        out.append(Finding("race", ctx.op,
                           f"grid has {g.points} points "
                           f"(> {MAX_GRID_POINTS}); write-race "
                           "enumeration skipped", severity="warning"))
        return out
    writers: dict[tuple[int, ...], list[tuple[int, ...]]] = {}
    for pt in _grid_points(g):
        writers.setdefault(g.out.index_map(*pt), []).append(pt)
    flagged: set[int] = set()
    for block_idx, pts in writers.items():
        if len(pts) < 2:
            continue
        for d in range(len(g.grid)):
            if len({pt[d] for pt in pts}) > 1 and sem[d] != "arbitrary" \
                    and d not in flagged:
                flagged.add(d)
                out.append(Finding(
                    "race", ctx.op,
                    f"grid dim {d} ({sem[d]!r}) takes multiple values "
                    f"among the {len(pts)} steps writing output block "
                    f"{block_idx} — a write race under parallel "
                    "execution"))
    return out


# ---------------------------------------------------------------------------
# pass 4: byte-accounting lint
# ---------------------------------------------------------------------------
def _fc_traffic(ctx: OpContext) -> tuple[int, int, int]:
    """(total traffic, weight-stream bytes, weight passes) replica of
    :func:`~repro_torch.core.dataflow.plan_fc`'s model at the plan's tiles."""
    p, bi, bw = ctx.plan, ctx.act_bytes, ctx.weight_bytes
    bp = _round_up(max(p.b, 1), SUBLANE)
    np_ = _round_up(p.n, LANE)
    kp = _round_up(p.k, LANE)
    passes = math.ceil(bp / p.bb)
    w_bytes = kp * np_ * bw * passes
    gn = math.ceil(np_ / p.bn)
    return bp * kp * bi * gn + w_bytes + bp * np_ * 4, w_bytes, passes


def _matmul_traffic(ctx: OpContext) -> int:
    p, k = ctx.plan, ctx.key
    bi, bw = ctx.act_bytes, ctx.weight_bytes
    mp = _round_up(k.m, SUBLANE)
    np_ = _round_up(k.n, LANE)
    kp = _round_up(k.k, LANE)
    gm, gn = math.ceil(mp / p.bm), math.ceil(np_ / p.bn)
    return mp * kp * bi * gn + kp * np_ * bw * gm + mp * np_ * 4


def _conv_traffic(ctx: OpContext, *, pooled: bool) -> int:
    p, k = ctx.plan, ctx.key
    bi_b, bw = ctx.act_bytes, ctx.weight_bytes
    oh = (k.h - k.p) // k.stride + 1
    ow = (k.w - k.q) // k.stride + 1
    poh, pow_ = oh, ow
    if pooled:
        poh = (oh - p.pool_window) // p.pool_stride + 1
        pow_ = (ow - p.pool_window) // p.pool_stride + 1
    gi, gj = math.ceil(k.ci / p.bi), math.ceil(k.co / p.bj)
    cip, cop = gi * p.bi, gj * p.bj
    x_passes = gj if gi > 1 else 1
    w_passes = k.batch if gi * gj > 1 else 1
    total = (k.batch * k.h * k.w * cip * bi_b * x_passes
             + k.p * k.q * cip * cop * bw * w_passes
             + k.batch * poh * pow_ * cop * 4)
    if cip != k.ci:
        total += k.batch * k.h * k.w * (k.ci + cip) * bi_b
    if cip != k.ci or cop != k.co:
        total += k.p * k.q * (k.ci * k.co + cip * cop) * bw
    if cop != k.co:
        total += k.batch * poh * pow_ * (cop + k.co) * 4
    return total


def check_accounting(ctx: OpContext) -> list[Finding]:
    out: list[Finding] = []

    def err(msg: str) -> None:
        out.append(Finding("accounting", ctx.op, msg))

    p, k = ctx.plan, ctx.key
    bi, bw = ctx.act_bytes, ctx.weight_bytes
    if not 1 <= p.case <= 4:
        err(f"plan case {p.case} outside 1..4")

    if ctx.kind == "fc":
        if (p.b, p.n, p.k) != (k.m, k.n, k.k):
            err(f"FCPlan shape ({p.b}, {p.n}, {p.k}) != op key shape "
                f"({k.m}, {k.n}, {k.k})")
        traffic, w_bytes, passes = _fc_traffic(ctx)
        if traffic != p.hbm_bytes:
            err(f"re-derived traffic {traffic} B != plan.hbm_bytes "
                f"{p.hbm_bytes} B")
        if w_bytes != p.weight_hbm_bytes:
            err(f"re-derived weight stream {w_bytes} B != "
                f"plan.weight_hbm_bytes {p.weight_hbm_bytes} B")
        if passes != p.weight_passes:
            err(f"re-derived weight passes {passes} != "
                f"plan.weight_passes {p.weight_passes}")
        if p.flops != 2 * p.b * p.n * p.k:
            err(f"plan.flops {p.flops} != 2*b*n*k "
                f"{2 * p.b * p.n * p.k}")
        floor = dataflow.compulsory_bytes(k.m, k.n, k.k, bi, 4, bw)
        if p.hbm_bytes < floor:
            err(f"hbm_bytes {p.hbm_bytes} below the compulsory minimum "
                f"{floor}")
        flip = dataflow.fc_flip_batch(p.n, p.k, bytes_in=bi, bytes_out=4,
                                      bytes_w=bw, chip=ctx.policy.chip)
        if flip != p.flip_batch:
            err(f"re-derived flip_batch {flip} != plan.flip_batch "
                f"{p.flip_batch}")
        out.extend(_check_flip_classify(ctx, flip))
        regime = ctx.policy.regime_for(k.name, k.m, k.n, k.k,
                                       act_bytes=bi, weight_bytes=bw)
        if regime != "sa_fc":
            err(f"schedule holds a batch-amortized FCPlan but the policy "
                f"assigns regime {regime!r}")
    elif ctx.kind == "matmul":
        traffic = _matmul_traffic(ctx)
        if traffic != p.hbm_bytes:
            err(f"re-derived traffic {traffic} B != plan.hbm_bytes "
                f"{p.hbm_bytes} B")
        if p.flops != 2 * k.m * k.n * k.k:
            err(f"plan.flops {p.flops} != 2*m*n*k "
                f"{2 * k.m * k.n * k.k}")
        floor = dataflow.compulsory_bytes(k.m, k.n, k.k, bi, 4, bw)
        if p.hbm_bytes < floor:
            err(f"hbm_bytes {p.hbm_bytes} below the compulsory minimum "
                f"{floor}")
        regime = ctx.policy.regime_for(k.name, k.m, k.n, k.k,
                                       act_bytes=bi, weight_bytes=bw)
        if regime == "sa_fc":
            err("policy assigns the op to sa_fc (batch-amortized FCPlan) "
                "but the schedule holds a MatmulPlan")
        elif regime != p.regime:
            err(f"plan.regime {p.regime!r} != policy regime {regime!r}")
    else:
        oh = (k.h - k.p) // k.stride + 1
        ow = (k.w - k.q) // k.stride + 1
        if (p.m, p.n, p.k) != (k.batch * oh * ow, k.co, k.p * k.q * k.ci):
            err(f"ConvPlan GEMM view ({p.m}, {p.n}, {p.k}) != derived "
                f"({k.batch * oh * ow}, {k.co}, {k.p * k.q * k.ci})")
        if p.flops != 2 * p.m * p.n * p.k:
            err(f"plan.flops {p.flops} != 2*m*n*k {2 * p.m * p.n * p.k}")
        traffic = _conv_traffic(ctx, pooled=p.fuse_pool)
        if traffic != p.hbm_bytes:
            err(f"re-derived traffic {traffic} B != plan.hbm_bytes "
                f"{p.hbm_bytes} B")
        pool = PoolSpec(p.pool_window, p.pool_stride) if p.fuse_pool \
            else None
        floor = dataflow.compulsory_conv_bytes(
            k.batch, k.h, k.w, k.ci, k.p, k.q, k.co, stride=k.stride,
            bytes_in=bi, bytes_out=4, bytes_w=bw, pool=pool)
        if p.hbm_bytes < floor:
            err(f"hbm_bytes {p.hbm_bytes} below the compulsory minimum "
                f"{floor}")
        if p.fuse_pool:
            if (p.pool_window, p.pool_stride) != (k.pool_window,
                                                  k.pool_stride):
                err(f"fused pool ({p.pool_window}, {p.pool_stride}) != "
                    f"requested ({k.pool_window}, {k.pool_stride})")
            if not PoolSpec(p.pool_window, p.pool_stride).tiles(oh, ow):
                err(f"fused pool {p.pool_window}/{p.pool_stride} does not "
                    f"tile the {oh}x{ow} OFM — the epilogue would drop a "
                    "tail")
            credit = _conv_traffic(ctx, pooled=False) - traffic
            if credit < 0:
                err(f"fused-pool byte credit is negative ({credit} B): "
                    "fusion claims to add traffic")
        regime = ctx.policy.conv_regime_for(
            k.name, k.batch, k.h, k.w, k.ci, k.p, k.q, k.co, k.stride,
            act_bytes=bi, weight_bytes=bw)
        if regime != p.regime:
            err(f"plan.regime {p.regime!r} != policy regime {regime!r}")
    return out


def _check_flip_classify(ctx: OpContext, flip: int) -> list[Finding]:
    """Cross-check the closed-form flip batch against
    :func:`~repro_torch.core.dataflow.classify_regime` itself: at ``flip`` the
    op must classify compute-bound, at ``flip - 1`` (and, when no finite
    flip exists, at any huge batch) memory-bound."""
    out: list[Finding] = []
    p, bi, bw = ctx.plan, ctx.act_bytes, ctx.weight_bytes
    chip = ctx.policy.chip

    def cls(b: int) -> str:
        return dataflow.classify_regime(b, p.n, p.k, bi, chip,
                                        bytes_w=bw, bytes_out=4)

    if flip > 0:
        if cls(flip) != "sa_conv":
            out.append(Finding(
                "accounting", ctx.op,
                f"flip_batch={flip} but classify_regime still says "
                f"{cls(flip)!r} at that batch"))
        if flip > 1 and cls(flip - 1) != "sa_fc":
            out.append(Finding(
                "accounting", ctx.op,
                f"flip_batch={flip} but classify_regime already says "
                f"{cls(flip - 1)!r} one sample earlier"))
    elif cls(1 << 30) != "sa_fc":
        out.append(Finding(
            "accounting", ctx.op,
            "flip_batch=0 (never compute-bound) but classify_regime "
            f"says {cls(1 << 30)!r} at batch 2^30"))
    return out


SCHEDULE_PASSES = (check_coverage, check_residency, check_races,
                   check_accounting)
