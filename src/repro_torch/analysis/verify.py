"""Schedule verification entry points: build an :class:`OpContext` for every
entry of a compiled :class:`~repro_torch.core.schedule.LayerSchedule`,
run the four geometry/accounting passes over it, and the ``launch`` pass
over the CUDA launch the kernels backend makes for it.

The geometry each context carries comes from
:mod:`repro_torch.kernels.geometry`, the tiling the plans describe (the
reference's kernels launch from it); the CUDA kernels pick their own
tiles, which :mod:`repro_torch.analysis.launch` builds as each wrapper
does.  No kernel is ever executed: schedules are compiled on ``meta``
tensors and the passes only walk integer grids.
"""
from __future__ import annotations

from repro_torch.analysis.determinism import lint_scheduler_sources
from repro_torch.analysis.launch import check_launch, launches_for
from repro_torch.analysis.passes import SCHEDULE_PASSES, OpContext
from repro_torch.analysis.report import (AnalysisReport, Finding,
                                         merge_reports)
from repro_torch.core.dataflow import ConvPlan, FCPlan, MatmulPlan
from repro_torch.core.schedule import ConvOpKey, LayerSchedule, OpKey
from repro_torch.kernels.geometry import (
    conv_geometry,
    fc_geometry,
    matmul_geometry,
)


def context_for(key: OpKey | ConvOpKey,
                plan: FCPlan | MatmulPlan | ConvPlan,
                policy) -> OpContext:
    """The verification context of one schedule entry: its launch
    geometry (built exactly as the kernel would) plus the logical
    operand extents the grid must cover.  Scale/bias operands are
    included unconditionally — verifying a superset of the launch is
    sound, and it keeps their row index maps covered too."""
    if isinstance(plan, ConvPlan):
        k: ConvOpKey = key
        geom = conv_geometry(k.batch, k.h, k.w, k.ci, k.p, k.q, k.co,
                             stride=k.stride, plan=plan,
                             has_scale=True, has_bias=True)
        oh = (k.h - k.p) // k.stride + 1
        ow = (k.w - k.q) // k.stride + 1
        ooh, oow = oh, ow
        if plan.fuse_pool:
            ooh = (oh - plan.pool_window) // plan.pool_stride + 1
            oow = (ow - plan.pool_window) // plan.pool_stride + 1
        extents = {"x": (k.batch, k.h, k.w, k.ci),
                   "w": (k.p, k.q, k.ci, k.co),
                   "scale": (1, k.co), "bias": (1, k.co),
                   "out": (k.batch, ooh, oow, k.co)}
        return OpContext(op=f"{k.name} [conv]", kind="conv", key=key,
                         plan=plan, geom=geom, extents=extents,
                         policy=policy)
    row_extents = {"x": (key.m, key.k), "w": (key.k, key.n),
                   "scale": (1, key.n), "bias": (1, key.n),
                   "out": (key.m, key.n)}
    if isinstance(plan, FCPlan):
        geom = fc_geometry(plan.b, plan.n, plan.k, bb=plan.bb,
                           bn=plan.bn, bk=plan.bk,
                           has_scale=True, has_bias=True)
        return OpContext(op=f"{key.name} [sa_fc]", kind="fc", key=key,
                         plan=plan, geom=geom, extents=row_extents,
                         policy=policy)
    geom = matmul_geometry(key.m, key.n, key.k, bm=plan.bm, bn=plan.bn,
                           bk=plan.bk, has_scale=True, has_bias=True)
    return OpContext(op=f"{key.name} [sa_conv]", kind="matmul", key=key,
                     plan=plan, geom=geom, extents=row_extents,
                     policy=policy)


def verify_context(ctx: OpContext) -> list[Finding]:
    """All four schedule passes over one op context, then the ``launch``
    pass over the CUDA launches the kernels backend makes for it."""
    findings: list[Finding] = []
    for check in SCHEDULE_PASSES:
        findings.extend(check(ctx))
    for lau in launches_for(ctx.key, ctx.plan):
        findings.extend(check_launch(lau))
    return findings


def verify_schedule(schedule: LayerSchedule, *,
                    label: str = "") -> AnalysisReport:
    """Statically verify every entry (matmul, FC and conv) of one
    compiled schedule against the policy it was compiled under."""
    report = AnalysisReport(label=label or f"schedule:{schedule.phase}")
    for key, plan in schedule.conv_entries.items():
        report.add(verify_context(
            context_for(key, plan, schedule.policy)))
        report.checked_ops += 1
    for key, plan in schedule.items():
        report.add(verify_context(
            context_for(key, plan, schedule.policy)))
        report.checked_ops += 1
    return report


def verify_stage_pair(stages, *, label: str = "") -> AnalysisReport:
    """Verify a (conv-stage, fc-stage) schedule pair — what one
    :meth:`~repro_torch.core.schedule.ScheduleRegistry.register` files."""
    conv_sched, fc_sched = stages
    return merge_reports(label or "stages", [
        verify_schedule(conv_sched, label=f"{label}:conv"),
        verify_schedule(fc_sched, label=f"{label}:fc"),
    ])


def verify_registry(registry, *,
                    with_determinism_lint: bool = False) -> AnalysisReport:
    """Verify every (net, dtype_tag, batch) variant filed in a
    :class:`~repro_torch.core.schedule.ScheduleRegistry`, optionally plus the
    scheduler-determinism lint."""
    reports = [verify_stage_pair(registry.stages(*key),
                                 label=f"{key[0]}/{key[1]}@b{key[2]}")
               for key in registry.keys()]
    if with_determinism_lint:
        reports.append(lint_scheduler_sources())
    return merge_reports("registry", reports)
