"""Static analysis of compiled schedules and of the CUDA kernels' launches.

This package verifies — **without executing any kernel** — that every plan
a :class:`~repro_torch.core.schedule.LayerSchedule` carries is what the
paper's traffic/residency model claims, and that the launch the port's
CUDA kernels make for it covers the op, fits the card and sums every
output in one fixed order.  Schedules are compiled on ``meta`` tensors;
the verifier walks integer grids and re-derives every byte count from
first principles, independently of the planner's and the kernels' own
arithmetic, so a planner/kernel drift bug cannot certify itself.

The first four passes are the reference's, line for line, over the
planner's tiles (:mod:`repro_torch.kernels.geometry`, the TPU launch the
plans are written for); on the same schedules they give the reference's
findings.  The CUDA kernels pick their own tiles from the op's shape, so
the fifth, ``launch``, checks what they launch.

``coverage`` — grid-coverage & tile lint
    * every plan tile (``bb``/``bm``/``bn``/``bk``/``bi``/``bj``) is
      positive and at most :data:`~repro_torch.core.dataflow.MAX_TILE`;
    * GEMM row tiles are SUBLANE(16)-aligned, column/contraction tiles
      LANE(128)-aligned; conv channel tiles are SUBLANE-aligned or equal
      to the exact channel count (the padding-free RGB stem);
    * the plan's tiles equal the TPU kernel's normalized tiles
      (:func:`~repro_torch.kernels.geometry.fc_normalize`) and that
      kernel's grid equals the plan's grid;
    * symbolically evaluating every operand's index map over the whole
      grid visits a contiguous, Cartesian-complete set of block indices
      whose blocks cover the operand's full logical extent.

``residency`` — VMEM residency sanitizer
    * the resident working set re-derived from the block specs alone
      equals the plan's ``vmem_bytes`` byte-for-byte;
    * it fits the policy's effective VMEM budget (the conv planner's
      documented over-budget fallback downgrades to a warning).

``race`` — grid write-race detector
    * the reduction ("arbitrary") grid dimensions form the
      innermost-sequential suffix of the grid;
    * no two grid steps write the same output block while differing in a
      "parallel" dimension.

``accounting`` — byte-accounting lint
    * ``hbm_bytes`` equals an independent replica of the planner's
      traffic model at the plan's tiles, and is never below the
      compulsory minimum;
    * FC: ``weight_hbm_bytes``, ``weight_passes`` and ``flip_batch`` match
      their closed forms and :func:`~repro_torch.core.dataflow.
      classify_regime`'s verdict at the flip;
    * conv: the GEMM view and ``flops`` are consistent with the layer,
      fused-pool byte credits are non-negative, a fused pool tiles its
      OFM, and the plan's regime matches the policy's classification;
    * a policy-classified SA-FC op carries an FCPlan, never a MatmulPlan.

``determinism`` — scheduler-determinism lint (AST, source-level)
    * the modeled-virtual-time code paths (``serve/zoo.py``,
      ``serve/fleet.py``, ``serve/cnn_server.py``, ``serve/faults.py``)
      contain no wall-clock reads, no unseeded randomness (stdlib
      ``random``, ``np.random.*`` without an explicit seed, torch's global
      generator, ``os.urandom``, ``uuid4``) and no iteration over
      unordered sets.

``launch`` — the CUDA kernels' launches (:mod:`repro_torch.analysis.
launch`), for every schedule entry and for flash attention at the LM
configs' shapes
    * coverage: every output element is written by exactly one CTA and
      thread; conv bands never split a pool window; SA-FC's segments
      cover k once; a query tile's kv tiles include every visible key;
    * residency: dynamic plus static shared memory fits the card's
      opt-in limit per CTA (and per SM for the CTAs an SM holds);
    * races: no two CTAs write one output; SA-FC's split-k partial slots
      and arrival counters have one writer each and its scratch is large
      enough and keyed by (device, stream);
    * summation order: each output's terms are summed in an order that
      depends only on the contraction's shape — never on the batch, ``m``,
      the CTA or the thread — over every batch from 1 to the schedule's.

Entry points: :func:`verify_schedule` / :func:`verify_registry` (and the
``python -m repro_torch.analysis`` CLI, which mirrors the zoo's
registration path for ``--all-zoo-variants``).  Debug hooks:
``ScheduleRegistry(verify=True)`` and ``Engine(verify_schedules=True)``
verify every schedule at compile/attach time and raise
:class:`ScheduleVerificationError` on the first violation.
"""
from repro_torch.analysis.determinism import lint_scheduler_sources
from repro_torch.analysis.passes import SCHEDULE_PASSES, OpContext
from repro_torch.analysis.report import (
    PASSES,
    AnalysisReport,
    Finding,
    ScheduleVerificationError,
    merge_reports,
)
from repro_torch.analysis.verify import (
    context_for,
    verify_context,
    verify_registry,
    verify_schedule,
    verify_stage_pair,
)

__all__ = [
    "PASSES",
    "SCHEDULE_PASSES",
    "AnalysisReport",
    "Finding",
    "OpContext",
    "ScheduleVerificationError",
    "context_for",
    "lint_scheduler_sources",
    "merge_reports",
    "verify_context",
    "verify_registry",
    "verify_schedule",
    "verify_stage_pair",
]
