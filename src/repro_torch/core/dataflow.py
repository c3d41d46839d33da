"""Dataflow planning — the paper's Cases 1-4 (a copy of the JAX
package's planner, pure Python).

The planner decides, per layer, which operands stay on-chip given a buffer
budget, and returns an analytic traffic count.  In the port its plans decide
three things: which kernel runs (``regime``), whether a conv's maxpool
rides the conv kernel's epilogue (``ConvPlan.fuse_pool``), and the serving
micro-batch (``FCPlan.bb``).  Its tile fields (``bm``/``bn``/``bk``,
``bi``/``bj``, ``bb``) describe the reference's TPU tiling and are kept so
that plans compare field for field; the CUDA kernels choose their own block
geometry.  The costs come from :data:`~repro_torch.core.accelerator.TPU_V5E`,
the reference's planning model, not from the card.

Case mapping, for an (M,K) x (K,N) matmul (x = input activations,
w = weights, o = output activations):

* **Case 1** — x, o and a K x L weight tile all fit: one pass, every
  operand read once.
* **Case 2** — x and o fit; partition N, x stays resident, weights once.
* **Case 3** — x+o don't fit together; keep x resident, stream w.
* **Case 4** — nothing fits: fully tiled, the min-traffic tiling under the
  budget.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.accelerator import TPU_V5E, TPUChip

# MXU/VREG-aligned minimum tile granularity (bf16 packing: sublane 16, lane 128)
LANE = 128
SUBLANE = 16

#: Largest block edge the Pallas kernels execute.  The planner caps every
#: candidate tile here so the plan's (bm, bn, bk) — and therefore its
#: hbm_bytes / vmem_bytes accounting — are exactly what the kernel runs
#: (previously the kernels silently clamped to 512 and the executed tiling
#: could diverge from the planned one).
MAX_TILE = 512


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_down_pow2ish(x: int, m: int) -> int:
    """Largest multiple of m that is <= x (at least m)."""
    return max(m, (x // m) * m)


class PlanError(ValueError):
    """A planner search found no feasible tiling (or refused the request).

    Raised instead of a bare ``AssertionError`` so callers can react to
    *planning* failures specifically: the error carries the op identity
    (``op`` — dispatch name when the failure surfaced through an
    :class:`~repro_torch.core.engine.Engine`, else the planner entrypoint),
    the GEMM shape, and the VMEM budget that was too small, so the
    diagnostic names the exact infeasible request instead of a bare
    "budget too small"."""

    def __init__(self, message: str, *, op: str = "",
                 shape: tuple[int, ...] = (),
                 vmem_budget: int | None = None) -> None:
        self.op = op
        self.shape = tuple(shape)
        self.vmem_budget = vmem_budget
        detail = []
        if op:
            detail.append(f"op={op!r}")
        if shape:
            detail.append(f"shape={self.shape!r}")
        if vmem_budget is not None:
            detail.append(f"vmem_budget={vmem_budget}")
        super().__init__(
            f"{message} [{', '.join(detail)}]" if detail else message)

    @property
    def message(self) -> str:
        return str(self.args[0]) if self.args else ""

    def with_op(self, op: str) -> PlanError:
        """The same failure, attributed to a named dispatch site."""
        if self.op:
            return self
        base = self.message.split(" [", 1)[0]
        return PlanError(base, op=op, shape=self.shape,
                         vmem_budget=self.vmem_budget)


@dataclass(frozen=True)
class MatmulPlan:
    """Tiling decision + analytic HBM traffic for one (M,K)x(K,N) matmul."""
    case: int                       # 1..4  (paper's scenario id)
    regime: str                     # 'sa_conv' | 'sa_fc'
    bm: int
    bn: int
    bk: int
    # analytic HBM bytes (reads + writes) under this tiling
    hbm_bytes: int
    flops: int
    vmem_bytes: int                 # working set claimed (incl. double buffers)

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(1, self.hbm_bytes)

    def grid(self, m: int, n: int, k: int) -> tuple[int, int, int]:
        return (math.ceil(m / self.bm), math.ceil(n / self.bn),
                math.ceil(k / self.bk))


def classify_regime(m: int, n: int, k: int,
                    bytes_per_elem: int = 2,
                    chip: TPUChip = TPU_V5E, *,
                    bytes_w: int | None = None,
                    bytes_out: int = 4) -> str:
    """Heterogeneous-array dispatch (the SA-CONV vs SA-FC decision).

    Compulsory arithmetic intensity of the op = FLOPs / minimal bytes moved.
    Below the chip ridge point the op is HBM-bound -> weight-streaming
    (SA-FC) regime; above -> weight-stationary compute regime (SA-CONV).
    This reproduces the paper's observation that per-sample weight reuse of
    FC layers is 1 (intensity ~= 2*M) so no stationary schedule can help.

    ``bytes_w`` is the per-element width of the *weight* operand (1 for the
    paper's 8-bit fixed point / int8 :class:`~repro_torch.core.quant.QTensor`):
    narrower weights shrink the dominant k*n byte term and can lift a
    decode-sized op across the ridge.

    ``bytes_out`` is the per-element width of the output (the fp32 psum
    spill the kernels write) — the same constant :func:`plan_matmul` and
    :func:`compulsory_bytes` charge, so a near-ridge op classifies to the
    same array whose plan/roofline it is then costed with.
    """
    if bytes_w is None:
        bytes_w = bytes_per_elem
    flops = 2 * m * n * k
    min_bytes = m * k * bytes_per_elem + k * n * bytes_w + m * n * bytes_out
    intensity = flops / min_bytes
    return "sa_conv" if intensity >= chip.ridge_flops_per_byte else "sa_fc"


def plan_matmul(m: int, n: int, k: int, *,
                bytes_in: int = 2,
                bytes_out: int = 4,
                bytes_w: int | None = None,
                vmem_budget: int | None = None,
                chip: TPUChip = TPU_V5E,
                regime: str | None = None) -> MatmulPlan:
    """Pick block shapes + loop order for an (m,k)@(k,n) matmul.

    Traffic model for an output-stationary tiling with grid
    (gm, gn, gk) = (m/bm, n/bn, k/bk), K innermost:

        x bytes  = m*k*bytes_in  * gn     (x tile re-read per N block)
        w bytes  = k*n*bytes_w   * gm     (w tile re-read per M block)
        o bytes  = m*n*bytes_out          (written once; fp32 psum stays in VMEM)

    VMEM claim = 2*(bm*bk*bytes_in + bk*bn*bytes_w) (double-buffered inputs
    — the paper's 'parallel weight movement' register) + bm*bn*4 (psum SPM).

    ``bytes_w`` defaults to ``bytes_in``; pass 1 for int8 weights so the
    weight stream is costed at 1 byte/weight.  ``regime`` overrides the
    intensity classification (a :class:`~repro_torch.core.engine.DispatchPolicy`
    forcing an array).
    """
    budget = vmem_budget if vmem_budget is not None else chip.vmem_budget
    bw = bytes_w if bytes_w is not None else bytes_in
    if regime is None:
        regime = classify_regime(m, n, k, bytes_in, chip, bytes_w=bw,
                                 bytes_out=bytes_out)

    mp = _round_up(m, SUBLANE)
    np_ = _round_up(n, LANE)
    kp = _round_up(k, LANE)

    def vmem(bm: int, bn: int, bk: int) -> int:
        return 2 * (bm * bk * bytes_in + bk * bn * bw) + bm * bn * 4

    def traffic(bm: int, bn: int, bk: int) -> int:
        gm, gn = math.ceil(mp / bm), math.ceil(np_ / bn)
        return mp * kp * bytes_in * gn + kp * np_ * bw * gm \
            + mp * np_ * bytes_out

    # Candidate tilings for every scenario; the chosen plan is the
    # min-traffic feasible one (the SmartShuttle [15] objective the paper
    # adopts for Case 4, applied uniformly — a structurally "nicer" case
    # is taken only when it actually moves fewer bytes, which also makes
    # planned traffic monotone in the buffer budget: hypothesis-tested in
    # tests/test_dataflow.py).
    candidates = []                                    # (case, bm, bn, bk)

    # Case 1: whole problem resident
    if vmem(mp, np_, kp) <= budget:
        candidates.append((1, mp, np_, kp))

    # Case 2: x + full-K resident, partition N
    bn = _round_down_pow2ish(np_, LANE)
    while bn > LANE and vmem(mp, bn, kp) > budget:
        bn = _round_down_pow2ish(bn // 2, LANE)
    if vmem(mp, bn, kp) <= budget:
        candidates.append((2, mp, bn, kp))

    # Case 3: x-block resident, stream w, partition K
    bm = _round_down_pow2ish(mp, SUBLANE)
    bk = _round_down_pow2ish(kp, LANE)
    bn = LANE if regime == "sa_fc" else 2 * LANE
    while vmem(bm, bn, bk) > budget and bm > SUBLANE:
        bm = _round_down_pow2ish(bm // 2, SUBLANE)
    while vmem(bm, bn, bk) > budget and bk > LANE:
        bk = _round_down_pow2ish(bk // 2, LANE)
    if vmem(bm, bn, bk) <= budget:
        # grow bn back while it still fits (bigger N tile = fewer x re-reads)
        while vmem(bm, 2 * bn, bk) <= budget and 2 * bn <= np_:
            bn *= 2
        candidates.append((3, bm, bn, bk))

    # Case 4: exhaustive-ish search over aligned tilings.  The search space
    # is capped at MAX_TILE natively so every candidate is costed at the
    # tiling the kernel will actually run.
    best4 = None
    for bm4 in (SUBLANE * (2 ** i) for i in range(0, 12)):
        if bm4 > 2 * mp or bm4 > MAX_TILE:
            break
        for bn4 in (LANE * (2 ** i) for i in range(0, 9)):
            if bn4 > 2 * np_ or bn4 > MAX_TILE:
                break
            for bk4 in (LANE * (2 ** i) for i in range(0, 9)):
                if bk4 > 2 * kp or bk4 > MAX_TILE:
                    break
                if vmem(bm4, bn4, bk4) > budget:
                    continue
                t = traffic(min(bm4, mp), min(bn4, np_), min(bk4, kp))
                if best4 is None or t < best4[0]:
                    best4 = (t, min(bm4, mp), min(bn4, np_), min(bk4, kp))
    if best4 is None:
        raise PlanError(
            "VMEM budget too small for the minimum SA-CONV matmul tile "
            f"({vmem(SUBLANE, LANE, LANE)} bytes)",
            op="plan_matmul", shape=(m, n, k), vmem_budget=budget)
    candidates.append((4, best4[1], best4[2], best4[3]))

    # Cap every candidate at the kernels' maximum block edge so the plan's
    # tiles ARE the executed tiles (no silent clamp drift downstream); the
    # traffic/vmem accounting below therefore describes the real schedule.
    # A candidate whose tiles the cap actually changed no longer has its
    # scenario's residency structure — relabel it fully tiled (Case 4).
    def _cap(c, bm_, bn_, bk_):
        capped = (min(bm_, MAX_TILE), min(bn_, MAX_TILE), min(bk_, MAX_TILE))
        return (c if capped == (bm_, bn_, bk_) else 4,) + capped

    # capping only shrinks tiles, so every already-feasible candidate
    # stays within the budget
    candidates = [_cap(*c) for c in candidates]

    case, bm, bn, bk = min(
        candidates, key=lambda c: (traffic(c[1], c[2], c[3]), c[0]))
    return MatmulPlan(case, regime, bm, bn, bk,
                      hbm_bytes=traffic(bm, bn, bk),
                      flops=2 * m * n * k, vmem_bytes=vmem(bm, bn, bk))


def compulsory_bytes(m: int, n: int, k: int,
                     bytes_in: int = 2, bytes_out: int = 4,
                     bytes_w: int | None = None) -> int:
    """Lower bound: every operand touched exactly once."""
    bw = bytes_w if bytes_w is not None else bytes_in
    return m * k * bytes_in + k * n * bw + m * n * bytes_out


# ---------------------------------------------------------------------------
# FC planning — the batch-amortized SA-FC weight stream (paper Fig. 7D/8)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FCPlan:
    """Batch-tiled weight-streaming decision for one ``(b,k) @ (k,n)`` FC
    layer on the SA-FC array.

    Per-sample FC weight reuse is 1 (paper Sec. V-A), so the only lever on
    the dominant ``k*n`` weight stream is *batch amortization*: keep a
    ``(bb, bk)`` activation tile and a ``(bb, bn)`` fp32 accumulator
    resident and stream each weight tile once per **batch tile**, not once
    per sample.  Total weight traffic is therefore

        weight_hbm_bytes = ceil(b_padded / bb) * k_p * n_p * bytes_w

    and the planner's whole job is to pick the largest resident batch tile
    the VMEM budget allows (``weight_passes`` == 1 recovers the paper's
    "fetch the weights once only" for the entire micro-batch).

    ``flip_batch`` is the planner-pinned serving batch at which the op's
    compulsory arithmetic intensity (~``2*b`` FLOP/byte while the weight
    stream dominates) crosses the chip ridge and the layer stops being
    memory-bound — the batch where :func:`classify_regime` flips the
    layer from SA-FC to SA-CONV (0: no finite batch flips it).

    Case mapping (buffer-fit scenario analog):

    * 1 — whole problem resident, every byte once;
    * 2 — whole batch resident (``gb == 1``): weights stream exactly once;
    * 3 — one output-column pass (``gn == 1``), batch tiled;
    * 4 — fully tiled.
    """
    case: int                       # 1..4 (see above)
    regime: str                     # 'sa_fc' | 'sa_conv' (policy-forced)
    bb: int                         # resident batch tile (rows per pass)
    bn: int
    bk: int
    hbm_bytes: int                  # analytic HBM bytes under this tiling
    flops: int
    vmem_bytes: int                 # working set (incl. double buffers)
    b: int
    n: int
    k: int
    weight_hbm_bytes: int           # the streamed k*n term, all passes
    flip_batch: int                 # memory-bound -> compute-bound batch

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(1, self.hbm_bytes)

    @property
    def weight_passes(self) -> int:
        """How many times the full weight matrix crosses HBM."""
        return math.ceil(_round_up(max(self.b, 1), SUBLANE) / self.bb)

    @property
    def weight_bytes_per_sample(self) -> float:
        """The amortization headline: streamed weight bytes per sample."""
        return self.weight_hbm_bytes / max(1, self.b)

    def grid(self, b: int, n: int, k: int) -> tuple[int, int, int]:
        return (math.ceil(_round_up(max(b, 1), SUBLANE) / self.bb),
                math.ceil(n / self.bn), math.ceil(k / self.bk))


def fc_vmem_bytes(bb: int, bn: int, bk: int, *,
                  bytes_in: int, bytes_w: int,
                  bytes_out: int = 4) -> int:
    """Resident working set of the batch-tiled SA-FC kernel: the
    double-buffered activation and streamed-weight tiles (the per-PE
    'parallel weight movement' register), the fp32 accumulator SPM, and
    the output tile the flush epilogue writes, on the modeled hardware —
    what :func:`plan_fc` budgets with."""
    return (2 * (bb * bk * bytes_in + bk * bn * bytes_w)
            + bb * bn * (4 + bytes_out))


def fc_flip_batch(n: int, k: int, *,
                  bytes_in: int = 2, bytes_out: int = 4,
                  bytes_w: int | None = None,
                  chip: TPUChip = TPU_V5E) -> int:
    """Smallest batch ``b`` at which a ``(b,k) @ (k,n)`` FC layer's
    compulsory intensity reaches the chip ridge — i.e. where
    :func:`classify_regime` flips the layer off the memory-bound SA-FC
    array.  Closed form of ``2*b*n*k / (b*k*bi + k*n*bw + b*n*bo) >= R``;
    returns 0 when no finite batch flips it (the per-sample activation and
    output streams alone already exceed the compute)."""
    bw = bytes_w if bytes_w is not None else bytes_in
    r = chip.ridge_flops_per_byte
    denom = 2 * n * k - r * (k * bytes_in + n * bytes_out)
    if denom <= 0:
        return 0
    return max(1, math.ceil(r * k * n * bw / denom))


def _fc_tiles(d: int, unit: int) -> list[int]:
    """Aligned candidate tiles <= MAX_TILE plus the exact (padded) extent."""
    out = {min(d, MAX_TILE)}
    t = unit
    while t < d and t < MAX_TILE:
        out.add(t)
        t *= 2
    return sorted(out)


def plan_fc(b: int, n: int, k: int, *,
            bytes_in: int = 2,
            bytes_out: int = 4,
            bytes_w: int | None = None,
            vmem_budget: int | None = None,
            chip: TPUChip = TPU_V5E,
            regime: str | None = None) -> FCPlan:
    """Pick the batch/weight tiling for a ``(b,k) @ (k,n)`` FC layer.

    Traffic model for grid ``(gb, gn, gk)`` — batch outermost, K innermost
    so the ``(bb, bn)`` accumulator never spills:

        x bytes = b*k*bytes_in * gn     (activation tile re-read per N tile)
        w bytes = k*n*bytes_w  * gb     (weights re-streamed once per BATCH
                                         TILE — the amortization lever)
        o bytes = b*n*bytes_out         (written once)

    The min-traffic feasible tiling under ``vmem_budget`` wins (ties prefer
    the structurally nicer case, then the larger batch tile).  Because the
    weight term dominates every memory-bound FC layer, this maximizes the
    resident batch tile — the paper's batch amortization — without a
    special-cased objective."""
    budget = vmem_budget if vmem_budget is not None else chip.vmem_budget
    bw = bytes_w if bytes_w is not None else bytes_in
    if regime is None:
        regime = classify_regime(b, n, k, bytes_in, chip, bytes_w=bw,
                                 bytes_out=bytes_out)

    bp = _round_up(max(b, 1), SUBLANE)
    np_ = _round_up(n, LANE)
    kp = _round_up(k, LANE)

    def vmem(bb: int, bn: int, bk: int) -> int:
        return fc_vmem_bytes(bb, bn, bk, bytes_in=bytes_in, bytes_w=bw,
                             bytes_out=bytes_out)

    def grids(bb: int, bn: int, bk: int) -> tuple[int, int, int]:
        return (math.ceil(bp / bb), math.ceil(np_ / bn),
                math.ceil(kp / bk))

    def w_bytes(bb: int) -> int:
        return kp * np_ * bw * math.ceil(bp / bb)

    def traffic(bb: int, bn: int, bk: int) -> int:
        gb, gn, gk = grids(bb, bn, bk)
        return bp * kp * bytes_in * gn + w_bytes(bb) + bp * np_ * bytes_out

    def case(bb: int, bn: int, bk: int) -> int:
        gb, gn, gk = grids(bb, bn, bk)
        if gb == gn == gk == 1:
            return 1
        if gb == 1:
            return 2                 # batch resident: weights once, total
        if gn == 1:
            return 3
        return 4

    best = None
    for bb in _fc_tiles(bp, SUBLANE):
        for bn in _fc_tiles(np_, LANE):
            for bk in _fc_tiles(kp, LANE):
                if vmem(bb, bn, bk) > budget:
                    continue
                key = (traffic(bb, bn, bk), case(bb, bn, bk), -bb,
                       -(bn * bk))
                if best is None or key < best[0]:
                    best = (key, bb, bn, bk)
    if best is None:
        raise PlanError(
            "VMEM budget too small for the minimum SA-FC tile "
            f"({fc_vmem_bytes(SUBLANE, LANE, LANE, bytes_in=bytes_in, bytes_w=bw, bytes_out=bytes_out)} bytes)",
            op="plan_fc", shape=(b, n, k), vmem_budget=budget)
    _, bb, bn, bk = best
    return FCPlan(case(bb, bn, bk), regime, bb, bn, bk,
                  hbm_bytes=traffic(bb, bn, bk), flops=2 * b * n * k,
                  vmem_bytes=vmem(bb, bn, bk), b=b, n=n, k=k,
                  weight_hbm_bytes=w_bytes(bb),
                  flip_batch=fc_flip_batch(n, k, bytes_in=bytes_in,
                                           bytes_out=bytes_out, bytes_w=bw,
                                           chip=chip))


# ---------------------------------------------------------------------------
# CONV planning — the implicit-GEMM SA-CONV schedule (paper Fig. 5 loop nest)
# ---------------------------------------------------------------------------
#: Patch-tile element cap for the kernel's fused-tap mode: up to this many
#: elements the P*Q patch views are assembled into one on-chip tile for a
#:  single MXU pass; above it (or when the tile would blow the VMEM
#: budget) the taps stream through the accumulator one dot at a time.
#: The decision is made HERE, by the planner, and carried in
#: :attr:`ConvPlan.fuse_taps` — the kernel obeys the plan.
TAP_FUSE_ELEMS = 1 << 22

#: Activations the pooling-&-activation unit may be reordered past
#: (paper Sec. IV-D): act(maxpool(x)) == maxpool(act(x)) holds exactly for
#: monotone non-decreasing element-wise functions.  Non-monotone acts
#: (silu, gelu) make the planner decline pool fusion.
MONOTONE_ACTS = frozenset({"none", "relu", "leaky_relu"})


@dataclass(frozen=True)
class PoolSpec:
    """One maxpool stage (the paper's pooling-&-activation unit, Fig. 7F-I).
    ``stride`` defaults to ``window`` (non-overlapping)."""
    window: int
    stride: int = 0

    def __post_init__(self) -> None:
        if self.stride == 0:
            object.__setattr__(self, "stride", self.window)

    def out(self, oh: int, ow: int) -> tuple[int, int]:
        return ((oh - self.window) // self.stride + 1,
                (ow - self.window) // self.stride + 1)

    def tiles(self, oh: int, ow: int) -> bool:
        """Do the pool windows cover the OFM exactly (no VALID-mode tail
        row/column dropped)?  The fused epilogue only claims pools whose
        windows tile the accumulator tile; a pool that drops a tail falls
        back to the standalone pooling-&-activation pass."""
        return (oh >= self.window and ow >= self.window
                and (oh - self.window) % self.stride == 0
                and (ow - self.window) % self.stride == 0)


@dataclass(frozen=True)
class ConvPlan:
    """Tiling decision + analytic HBM traffic for one NHWC convolution run
    on the implicit-GEMM SA-CONV kernel.

    The kernel's grid is ``(batch, co/bj, ci/bi)`` with the input-channel
    dimension innermost ("arbitrary", psum carried in VMEM): each step holds
    one whole ``(h, w, bi)`` input slab on-chip and extracts the P*Q patch
    views *inside* the kernel (the paper's input-buffer address generator),
    so input activations cross HBM once per output-channel tile pass —
    never once per patch element as the materialized-im2col path did.

    ``fuse_taps`` is the kernel's execution mode for the patch views (one
    fused MXU pass over an on-chip patch tile vs. tap-wise streaming);
    the planner chooses it so ``vmem_bytes`` covers what actually gets
    materialized.  ``m``/``n``/``k`` record the GEMM view of the
    contraction (``batch*oh*ow`` x ``p*q*ci`` @ ``p*q*ci`` x ``co``) —
    what the systolic array actually contracts and what the dispatch trace
    reports.

    ``fuse_pool`` commits the accumulator-flush epilogue to reduce the
    maxpool windows on-chip and emit the *pooled* output block (the
    paper's Fig. 7 pooling-&-activation unit sitting after accumulation):
    the full OFM never reaches HBM, so ``hbm_bytes`` is credited with the
    eliminated OFM write + re-read and ``vmem_bytes`` charges the pooled
    output block instead of the full one.  The planner declines fusion
    (``fuse_pool=False``, engine falls back to conv -> standalone pool)
    for non-monotone activations, pools whose windows don't tile the OFM,
    and budgets that can't hold even the minimum fused working set.
    """
    case: int                       # 1..4 (buffer-fit scenario analog)
    regime: str                     # 'sa_conv' | 'sa_fc' (policy-forced)
    bi: int                         # input-channel tile
    bj: int                         # output-channel tile
    fuse_taps: bool                 # one fused patch-tile MXU pass?
    hbm_bytes: int                  # analytic HBM bytes under this tiling
    flops: int
    vmem_bytes: int                 # working set (incl. double buffers)
    m: int
    n: int
    k: int
    fuse_pool: bool = False         # pooled flush epilogue committed?
    pool_window: int = 0            # maxpool window (0 when not fused)
    pool_stride: int = 0

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(1, self.hbm_bytes)

    def grid(self, batch: int, ci: int, co: int) -> tuple[int, int, int]:
        return (batch, math.ceil(co / self.bj), math.ceil(ci / self.bi))


def classify_conv_regime(batch: int, h: int, w: int, ci: int,
                         p: int, q: int, co: int, *,
                         stride: int = 1,
                         bytes_in: int = 2, bytes_out: int = 4,
                         bytes_w: int | None = None,
                         chip: TPUChip = TPU_V5E) -> str:
    """SA-CONV vs SA-FC for a convolution, costed at *real NHWC bytes*.

    Feeding the GEMM view to :func:`classify_regime` would count the
    ``m*k = batch*oh*ow*p*q*ci`` patch-matrix bytes — the im2col blowup
    the implicit kernel never moves — and misclassify compute-bound convs
    as bandwidth-bound.  Compulsory intensity here uses
    :func:`compulsory_conv_bytes` (each NHWC/HWIO byte once), consistent
    with the :class:`ConvPlan` traffic the op is then planned with.
    """
    oh = (h - p) // stride + 1
    ow = (w - q) // stride + 1
    flops = 2 * batch * oh * ow * co * p * q * ci
    min_bytes = compulsory_conv_bytes(batch, h, w, ci, p, q, co,
                                      stride=stride, bytes_in=bytes_in,
                                      bytes_out=bytes_out, bytes_w=bytes_w)
    return "sa_conv" if flops / min_bytes >= chip.ridge_flops_per_byte \
        else "sa_fc"


def _channel_tiles(c: int) -> list[int]:
    """Aligned candidate channel tiles <= MAX_TILE, plus the exact channel
    count (padding-free — e.g. the 3-channel RGB stem)."""
    out = {min(c, MAX_TILE)}
    t = SUBLANE
    while t < c and t < MAX_TILE:
        out.add(t)
        t *= 2
    return sorted(out)


def plan_conv(batch: int, h: int, w: int, ci: int,
              p: int, q: int, co: int, *,
              stride: int = 1,
              bytes_in: int = 2,
              bytes_out: int = 4,
              bytes_w: int | None = None,
              vmem_budget: int | None = None,
              chip: TPUChip = TPU_V5E,
              regime: str | None = None,
              pool: PoolSpec | None = None,
              act: str = "none") -> ConvPlan:
    """Pick channel tiles + loop order for an NHWC x HWIO VALID conv.

    ``h``/``w`` are the *padded* input spatial dims (the caller applies
    explicit zero padding).  Traffic model for grid (batch, gj, gi) =
    (batch, co/bj, ci/bi), gi innermost:

        x bytes = batch*h*w*ci*bytes_in * gj   (slab re-read per CO tile)
        w bytes = p*q*ci*co*bytes_w * batch    (filter re-fetched per sample
                                                unless the whole filter is a
                                                single resident tile)
        o bytes = batch*oh*ow*co*bytes_out     (written once; fp32 psum
                                                stays in VMEM)

    This counts *real NHWC bytes* — the materialized-im2col path the kernel
    replaces moved ``batch*oh*ow*p*q*ci`` input-patch bytes (a kernel-area
    blowup) that no planner ever saw.

    ``pool`` requests the fused maxpool+activation flush epilogue for the
    maxpool stage that follows this conv: when the planner accepts
    (:attr:`ConvPlan.fuse_pool`), the o-bytes term above shrinks to the
    *pooled* map ``batch*poh*pow*co*bytes_out`` — the OFM write and the
    pool pass's re-read both disappear.  Fusion is declined (plan falls
    back to the unfused epilogue) when ``act`` is not in
    :data:`MONOTONE_ACTS` (the reorder act(maxpool(.)) is invalid), when
    the pool windows don't tile the OFM, or when no tiling fits the VMEM
    budget.
    """
    budget = vmem_budget if vmem_budget is not None else chip.vmem_budget
    bw = bytes_w if bytes_w is not None else bytes_in
    oh = (h - p) // stride + 1
    ow = (w - q) // stride + 1
    assert oh >= 1 and ow >= 1, (h, w, p, q, stride)
    m, n, k = batch * oh * ow, co, p * q * ci
    flops = 2 * m * n * k
    if regime is None:
        regime = classify_conv_regime(batch, h, w, ci, p, q, co,
                                      stride=stride, bytes_in=bytes_in,
                                      bytes_out=bytes_out, bytes_w=bw,
                                      chip=chip)

    fuse_pool = (pool is not None and act in MONOTONE_ACTS
                 and pool.tiles(oh, ow))
    poh, pow_ = pool.out(oh, ow) if fuse_pool else (oh, ow)

    def vmem(bi: int, bj: int, fused: bool) -> int:
        base = (2 * h * w * bi * bytes_in        # input slab, double-buffered
                + 2 * p * q * bi * bj * bw       # 'parallel weight movement'
                + oh * ow * bj * 4               # fp32 accumulator SPM
                + poh * pow_ * bj * bytes_out)   # (pooled) output tile
        if fused:
            # the on-chip (oh*ow, p*q*bi) patch tile the fused MXU pass
            # assembles (it never exists in HBM, but it IS working set)
            base += oh * ow * p * q * bi * bytes_in
        else:
            # tap-wise streaming: one live (oh*ow, bi) view plus the
            # local fp32 accumulator temp the loop carries
            base += oh * ow * (bi * bytes_in + bj * 4)
        return base

    def fuse(bi: int, bj: int) -> bool:
        return (oh * ow * p * q * bi <= TAP_FUSE_ELEMS
                and vmem(bi, bj, True) <= budget)

    def grids(bi: int, bj: int) -> tuple[int, int]:
        return math.ceil(ci / bi), math.ceil(co / bj)

    def traffic(bi: int, bj: int) -> int:
        gi, gj = grids(bi, bj)
        cip, cop = gi * bi, gj * bj
        # Pallas only re-DMAs a block when its index-map output changes:
        # with a single CI tile the slab index is constant across the CO
        # loop (one fetch per sample); likewise the filter re-streams per
        # sample only when the (j, k) sweep actually revisits tiles.
        # With fuse_pool the output term is the POOLED map (poh == oh and
        # pow_ == ow otherwise): the full OFM never crosses HBM.
        x_passes = gj if gi > 1 else 1
        w_passes = batch if gi * gj > 1 else 1
        total = (batch * h * w * cip * bytes_in * x_passes
                 + p * q * cip * cop * bw * w_passes
                 + batch * poh * pow_ * cop * bytes_out)
        # Tiles that don't divide the channel counts force materialized
        # zero-padded copies (and an output slice-back) around the kernel
        # — real HBM bytes, charged so plan == execution and the search
        # prefers dividing tiles.
        if cip != ci:
            total += batch * h * w * (ci + cip) * bytes_in
        if cip != ci or cop != co:
            total += p * q * (ci * co + cip * cop) * bw
        if cop != co:
            total += batch * poh * pow_ * (cop + co) * bytes_out
        return total

    def case(bi: int, bj: int) -> int:
        gi, gj = grids(bi, bj)
        if gi == 1 and gj == 1:
            return 1                 # everything resident, each byte once
        if gi == 1:
            return 2                 # input channels resident, CO partitioned
        if gj == 1:
            return 3                 # CO resident, contraction partitioned
        return 4                     # fully tiled

    best = None
    for bi in _channel_tiles(ci):
        for bj in _channel_tiles(co):
            fused = fuse(bi, bj)
            if vmem(bi, bj, fused) > budget:
                continue
            key = (traffic(bi, bj), case(bi, bj), not fused, -(bi * bj))
            if best is None or key < best[0]:
                best = (key, bi, bj, fused)
    if best is not None:
        _, bi, bj, fused = best
        final_case = case(bi, bj)
    else:
        # Even the minimum (h, w, bi) slab exceeds the budget (no spatial
        # tiling yet — a huge-resolution input).  Plan the smallest
        # working set rather than fail: the plan is over budget and says
        # so honestly in vmem_bytes (on CPU interpret this still runs;
        # a TPU lowering would need the future spatially-tiled schedule).
        # A requested pool fusion is declined here — the budget-overflow
        # fallback sticks to the minimal, well-trodden unfused epilogue.
        if fuse_pool:
            return plan_conv(batch, h, w, ci, p, q, co, stride=stride,
                             bytes_in=bytes_in, bytes_out=bytes_out,
                             bytes_w=bytes_w, vmem_budget=vmem_budget,
                             chip=chip, regime=regime)
        bi = _channel_tiles(ci)[0]
        bj = _channel_tiles(co)[0]
        fused = False
        final_case = 4
    return ConvPlan(final_case, regime, bi, bj, fuse_taps=fused,
                    hbm_bytes=traffic(bi, bj), flops=flops,
                    vmem_bytes=vmem(bi, bj, fused), m=m, n=n, k=k,
                    fuse_pool=fuse_pool,
                    pool_window=pool.window if fuse_pool else 0,
                    pool_stride=pool.stride if fuse_pool else 0)


def compulsory_conv_bytes(batch: int, h: int, w: int, ci: int,
                          p: int, q: int, co: int, *,
                          stride: int = 1,
                          bytes_in: int = 2, bytes_out: int = 4,
                          bytes_w: int | None = None,
                          pool: PoolSpec | None = None) -> int:
    """Lower bound for the conv: every NHWC/HWIO byte touched exactly once
    (what the paper's Fig. 5/7 reuse maximization drives toward).  With
    ``pool`` the op is the fused conv+maxpool and its irreducible output
    is the *pooled* map — the full OFM never needs to exist in HBM."""
    bw = bytes_w if bytes_w is not None else bytes_in
    oh = (h - p) // stride + 1
    ow = (w - q) // stride + 1
    if pool is not None:
        oh, ow = pool.out(oh, ow)
    return (batch * h * w * ci * bytes_in + p * q * ci * co * bw
            + batch * oh * ow * co * bytes_out)

