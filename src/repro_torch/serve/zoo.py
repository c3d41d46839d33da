"""Multi-tenant model-zoo serving — one engine, many compiled models,
SLO-aware dual-array wave scheduling, and graceful degradation under
faults.

The paper's core claim is that *jointly* scheduling heterogeneous work
(CONV on SA-CONV, FC on SA-FC) beats optimizing either array in
isolation.  This module is the serving-side analogue: one engine holds
several **compiled model variants** at once (AlexNet fp32, VGG-16 fp32,
an int8 AlexNet, ...), admits a mixed stream of tagged requests into
per-tenant queues, and decides *which model's wave dispatches next* using
the planner data:

* each model's wave size is its planner-preferred micro-batch — the
  resident batch tile (:attr:`~repro_torch.core.dataflow.FCPlan.bb`) one
  streamed FC weight pass amortizes over
  (:attr:`~repro_torch.serve.cnn_server.CNNServer.preferred_microbatch`);
* each candidate wave is priced by the modeled dual-array stage costs
  (:func:`~repro_torch.core.perf_model.zoo_wave_cost` — the TPU stage-roofline
  twin of :func:`~repro_torch.core.perf_model.pipeline_makespan`), so the
  scheduler *knows* a VGG-16 wave occupies SA-CONV ~40x longer than an
  AlexNet wave and that the int8 variant's FC stream is 4x cheaper;
* a pluggable :class:`SchedulingPolicy` picks the next wave while the
  other array drains the previous one: :class:`FIFOPolicy` (arrival
  order), :class:`ShortestMakespanPolicy` (cheapest predicted wave
  first) and :class:`EDFPolicy` (earliest deadline first, with
  deadline-miss accounting).

Scheduling runs in deterministic **modeled time** (the virtual clock
advances by the wave costs above, with wave *i*'s SA-FC stage
overlapping wave *i+1*'s SA-CONV stage exactly like the pipelined
:class:`~repro_torch.serve.cnn_server.CNNServer`), so every policy
decision, latency percentile and deadline miss is a pure function of the
trace.  The port prices waves with the JAX package's cost model, TPU
constants and all (:mod:`repro_torch.core.perf_model`), so its modeled
schedules equal the reference's decision for decision; the seconds are
that model's, not the card's.  Execution is real: every scheduled wave
runs through its model's ``CNNServer`` (the per-model wave executor) on
the card's kernels, and each request's logits are **bitwise equal** to
that model's single-model unbatched forward no matter which policy or
coalescing admitted it.

Robustness layer (fault-injected, gracefully degrading)
-------------------------------------------------------
A production queue must survive what the healthy path assumes away: a
straggling array, NaN in a flush epilogue, a transient
:class:`~repro_torch.core.dataflow.PlanError` at dispatch, an overload burst.
The server therefore runs a per-model **health state machine**
(``healthy -> degraded -> failed``, :class:`ModelHealth`) fed by the
seed-era primitives in :mod:`repro_torch.distributed.fault_tolerance` — a
:class:`~repro_torch.distributed.fault_tolerance.StepMonitor` per model flags
straggler waves from their modeled-vs-actual time ratio, and a
:class:`~repro_torch.distributed.fault_tolerance.HeartbeatTracker` on the
modeled clock declares a model failed when its waves stop completing —
plus:

* **retry with capped exponential backoff** (:class:`RecoveryConfig`):
  a failed wave's requests re-enter the queue after a backoff delay;
  after ``max_retries`` they are **quarantined** as typed error results
  (:mod:`repro_torch.serve.errors`) — never silently dropped, never wedging
  the queue;
* a per-wave ``np.isfinite`` **integrity guard**: non-finite logits become
  per-request :class:`~repro_torch.serve.errors.CorruptOutputError` results
  instead of served garbage;
* **admission control** (:class:`AdmissionConfig`): bounded per-tenant
  queues, stale deadlines rejected at submit, and optional predictive
  shedding — reject what the scheduler's own cost model says cannot
  meet its deadline even if dispatched immediately;
* a **degraded mode**: eligible requests reroute from a failed or
  deadline-infeasible fp32 variant to the registered int8 variant of
  the same net (``served_by`` records the substitution).

Every shed, retry, fallback, quarantine and health transition is a
:class:`FaultEvent` on the :class:`ZooReport`; with faults disabled and
default admission the schedule is bit-identical to the healthy path.
Fault *injection* is seeded and wave-granular
(:mod:`repro_torch.serve.faults`), so chaos runs are pure functions of
their seed.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections.abc import Callable, Mapping, Sequence

import numpy as np

from repro_torch.configs.registry import ZooModelSpec, get_zoo_model
from repro_torch.core.engine import Engine
from repro_torch.core.perf_model import (ShardedWaveCost, WaveCost,
                                         sharded_wave_cost, zoo_wave_cost)
from repro_torch.core.schedule import ScheduleRegistry
from repro_torch.distributed.fault_tolerance import (HeartbeatTracker,
                                                     StepMonitor)
from repro_torch.serve.cnn_server import CNNRequest, CNNServer
from repro_torch.serve.errors import (CorruptOutputError, PlanError,
                                      RequestShedError, ServeError,
                                      StaleDeadlineError, WaveTimeoutError)
from repro_torch.serve.faults import FaultInjector, WaveFaults


@dataclasses.dataclass
class ZooRequest:
    """One tagged request of the mixed stream: which model, which tenant,
    when it arrived (virtual seconds), and optionally by when it must
    finish (``deadline_s``, absolute virtual time — the SLO).

    Every admitted request ends in exactly one terminal ``status``:
    ``"served"`` (logits delivered), ``"shed"`` (admission control
    rejected it) or ``"quarantined"`` (execution failed past the retry
    budget); ``error`` carries the typed cause for the latter two.
    ``allow_degraded`` opts the request into int8 fallback service;
    ``served_by`` records which variant actually served it; ``replica``
    records which fleet replica it was last placed on (stamped by
    :class:`~repro_torch.serve.fleet.FleetServer`; always ``None`` in a
    single-replica zoo)."""
    uid: int
    model: str
    image: np.ndarray                     # (H, W, C) of the model's server
    tenant: str = "default"
    arrival_s: float = 0.0
    deadline_s: float | None = None
    allow_degraded: bool = True
    # -- filled by the scheduler/executor ----------------------------------
    dispatch_s: float | None = None    # SA-CONV start of its final wave
    finish_s: float | None = None      # SA-FC completion of its final wave
    logits: np.ndarray | None = None
    done: bool = False
    status: str = "pending"            # -> served | shed | quarantined
    error: ServeError | None = None
    retries: int = 0
    served_by: str | None = None       # variant that served it (may degrade)
    replica: str | None = None         # fleet replica it was last placed on

    @property
    def latency_s(self) -> float | None:
        return None if self.finish_s is None \
            else self.finish_s - self.arrival_s

    @property
    def degraded(self) -> bool:
        """Served by a fallback variant instead of the requested one."""
        return self.served_by is not None and self.served_by != self.model

    @property
    def missed_deadline(self) -> bool | None:
        """None = no SLO attached; else whether the modeled completion
        blew the absolute deadline."""
        if self.deadline_s is None:
            return None
        return None if self.finish_s is None \
            else self.finish_s > self.deadline_s


@dataclasses.dataclass(frozen=True)
class WaveDecision:
    """One scheduler decision: at modeled time ``t_s`` the policy picked
    ``model``'s wave of ``batch`` requests, priced at the modeled stage
    costs below.  The ordered decision list is the deterministic policy
    log the regression gate pins.  ``fault`` annotates what the chaos
    layer did to the attempt (``"none"`` on the healthy path) and
    ``conv_s``/``fc_s`` are the *actual* modeled occupancies (stretched
    for a stall, zero for a failed dispatch)."""
    index: int
    t_s: float
    model: str
    uids: tuple[int, ...]
    batch: int
    conv_s: float
    fc_s: float
    queue_depths: tuple[tuple[str, int], ...]   # pending per model at pick
    fault: str = "none"           # none|stall|timeout|corrupt|dispatch
    stall_factor: float = 1.0

    @property
    def total_s(self) -> float:
        return self.conv_s + self.fc_s


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One robustness-plane event in modeled time: a fault firing, or the
    server's response to one (retry, quarantine, shed, degrade-reroute,
    health transition).  The ordered event list is deterministic and
    gated alongside the decision log."""
    t_s: float
    attempt: int                  # wave attempt index; -1 for admission
    model: str
    kind: str    # stall|timeout|corrupt|dispatch|retry|quarantine|shed|degrade|health
    detail: str
    uids: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission-control policy.  ``max_queue`` bounds each tenant's
    pending (not-yet-dispatched) requests — overflow is shed with a typed
    :class:`~repro_torch.serve.errors.RequestShedError`.  ``predictive_shedding``
    rejects a deadline request whose *best-case* completion (immediate
    dispatch, solo wave, the scheduler's own cost model) already misses —
    unless a degraded fallback variant would make it."""
    max_queue: int | None = None
    predictive_shedding: bool = False


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Retry, straggler and health policy for the serving plane.

    A failed wave attempt re-queues its requests after
    ``min(backoff_cap_s, backoff_s * backoff_mult**(retries-1))``;
    a request failing more than ``max_retries`` attempts is quarantined.
    A stalled wave whose stretch factor reaches ``wave_timeout_factor``
    is aborted at the timeout (occupying both arrays that long) and
    counts as a failure; milder stalls complete late and feed the
    per-model :class:`~repro_torch.distributed.fault_tolerance.StepMonitor`
    (``straggler_factor`` x running median over normalized wave times,
    after ``straggler_warmup`` observations).  ``fail_after`` consecutive
    failures — or ``heartbeat_timeout_s`` of modeled time without a
    completed wave while work is pending — mark a model ``failed``;
    ``recover_after`` clean waves walk it back to ``healthy``.
    ``allow_degraded`` enables rerouting a failed/infeasible fp32
    variant's eligible requests to the int8 variant of the same net."""
    max_retries: int = 2
    backoff_s: float = 2e-4
    backoff_mult: float = 2.0
    backoff_cap_s: float = 2e-3
    wave_timeout_factor: float = 8.0
    straggler_factor: float = 3.0
    straggler_warmup: int = 3
    straggler_window: int = 50
    fail_after: int = 2
    recover_after: int = 2
    heartbeat_timeout_s: float = 1.0
    allow_degraded: bool = True


@dataclasses.dataclass
class ModelHealth:
    """Per-model health state machine: ``healthy -> degraded -> failed``
    and back.  A straggler verdict degrades; ``fail_after`` consecutive
    wave failures (or a heartbeat timeout) fail; clean waves walk the
    state back up one level at a time (``failed -> degraded`` on the
    first clean wave, ``degraded -> healthy`` after ``recover_after``
    clean waves)."""
    model: str
    state: str = "healthy"
    consecutive_failures: int = 0
    clean_streak: int = 0
    straggler_waves: int = 0
    failed_waves: int = 0

    def on_clean(self, cfg: RecoveryConfig) -> str | None:
        old = self.state
        self.consecutive_failures = 0
        self.clean_streak += 1
        if self.state == "failed":
            self.state, self.clean_streak = "degraded", 0
        elif self.state == "degraded" \
                and self.clean_streak >= cfg.recover_after:
            self.state = "healthy"
        return self.state if self.state != old else None

    def on_straggler(self, cfg: RecoveryConfig) -> str | None:
        old = self.state
        self.straggler_waves += 1
        self.clean_streak = 0
        if self.state == "healthy":
            self.state = "degraded"
        return self.state if self.state != old else None

    def on_failure(self, cfg: RecoveryConfig) -> str | None:
        old = self.state
        self.failed_waves += 1
        self.consecutive_failures += 1
        self.clean_streak = 0
        if self.consecutive_failures >= cfg.fail_after:
            self.state = "failed"
        elif self.state == "healthy":
            self.state = "degraded"
        return self.state if self.state != old else None

    def force_failed(self) -> str | None:
        old = self.state
        self.state = "failed"
        self.consecutive_failures = 0
        self.clean_streak = 0
        return self.state if self.state != old else None


@dataclasses.dataclass
class WaveAttempt:
    """One scheduled wave attempt, as handed to the executor: the model,
    the boarding requests (wave order = row order), the injected faults
    (``None`` on the healthy path), and which uids this attempt actually
    serves (``deliver`` excludes corrupt rows; empty for failed
    attempts).  ``execute=False`` marks attempts that never ran to
    completion (dispatch failures, timeout aborts) — the executor skips
    their kernels."""
    index: int
    model: str
    requests: list[ZooRequest]
    faults: WaveFaults | None
    deliver: tuple[int, ...]
    execute: bool = True


class SchedulingPolicy:
    """Picks which model's wave dispatches next.  ``pick`` sees the
    non-empty pending queues (each in arrival order), the modeled clock,
    and a pricing callback ``cost(model, batch) -> WaveCost``; it returns
    a model name.  ``wave_order`` orders one model's queue before the
    wave is cut from its head (FIFO by arrival unless overridden)."""

    name = "base"

    def pick(self, now: float, pending: Mapping[str, list[ZooRequest]],
             cost: Callable[[str, int], WaveCost]) -> str:
        raise NotImplementedError

    def wave_order(self, reqs: list[ZooRequest]) -> list[ZooRequest]:
        return reqs

    @staticmethod
    def _head_key(q: list[ZooRequest]) -> tuple[float, int]:
        return (q[0].arrival_s, q[0].uid)


class FIFOPolicy(SchedulingPolicy):
    """Oldest head-of-queue request first — the baseline every SLO/latency
    comparison is against."""

    name = "fifo"

    def pick(self, now, pending, cost):
        return min(pending, key=lambda m: (*self._head_key(pending[m]), m))


class ShortestMakespanPolicy(SchedulingPolicy):
    """Cheapest predicted wave first: price the wave each candidate model
    would dispatch (its queue head cut at the model's micro-batch) with
    the modeled dual-array stage costs and run the smallest total.  The
    classic SJF mean-latency argument, with the planner's own cost model
    as the job-size oracle."""

    name = "smf"

    def pick(self, now, pending, cost):
        return min(pending,
                   key=lambda m: (cost(m, len(pending[m])).total_s,
                                  *self._head_key(pending[m]), m))


class EDFPolicy(SchedulingPolicy):
    """Earliest deadline first: the model owning the most urgent pending
    request dispatches next, and inside that model's queue the
    tightest-deadline requests board the wave first.  Requests without a
    deadline sort last (best effort)."""

    name = "edf"

    @staticmethod
    def _urgency(r: ZooRequest) -> tuple[float, float, int]:
        d = r.deadline_s if r.deadline_s is not None else float("inf")
        return (d, r.arrival_s, r.uid)

    def pick(self, now, pending, cost):
        return min(pending,
                   key=lambda m: (min(self._urgency(r) for r in pending[m]),
                                  m))

    def wave_order(self, reqs):
        return sorted(reqs, key=self._urgency)


POLICIES: dict[str, Callable[[], SchedulingPolicy]] = {
    "fifo": FIFOPolicy, "smf": ShortestMakespanPolicy, "edf": EDFPolicy,
}


class ZooModel:
    """One compiled model variant held by the zoo: the registry spec, its
    (possibly width-scaled) parameters, the per-model
    :class:`~repro_torch.serve.cnn_server.CNNServer` wave executor on
    ``device`` (the card unless the caller names another), and the
    modeled wave-cost pricing the scheduler consults.  The cost model
    always prices the *full-geometry* variant (``spec.weight_bytes``
    narrows the int8 FC stream) — the scheduler reasons about the model,
    not about the shrunken test instantiation executing it."""

    def __init__(self, spec: ZooModelSpec, params: list, *,
                 in_res: int | None = None, width_mult: float = 1.0,
                 max_batch: int = 8,
                 engine: Engine | None = None, device=None) -> None:
        self.spec = spec
        self.name = spec.name
        self.params = params
        self.server = CNNServer(spec.net, params, in_res=in_res,
                                width_mult=width_mult, max_batch=max_batch,
                                engine=engine, device=device)

    @property
    def microbatch(self) -> int:
        """The wave size the scheduler cuts for this model — its server's
        planner-preferred micro-batch (the FC plan's resident batch tile)."""
        return self.server.microbatch

    def sharded_microbatch(self, data: int) -> int:
        """The wave size a *cooperative* sharded wave may grow to when
        ``data`` replicas execute it together: each replica still holds
        its planner-preferred resident tile (``bb`` rows), so the fleet
        wave is ``data x microbatch`` — the only place a zoo wave is
        allowed to exceed :attr:`microbatch`."""
        if data < 1:
            raise ValueError(f"data must be >= 1, got {data}")
        return self.microbatch * data

    def wave_cost(self, batch: int) -> WaveCost:
        """Modeled dual-array stage cost of one ``batch``-sample wave of
        this variant (memoized in perf_model)."""
        return zoo_wave_cost(self.spec.net, batch,
                             bytes_w=self.spec.weight_bytes)

    def sharded_wave_cost(self, batch: int, data: int) -> ShardedWaveCost:
        """Modeled cost of one cooperative ``data``-way sharded wave of
        this variant vs. independent per-replica waves (see
        :func:`~repro_torch.core.perf_model.sharded_wave_cost`)."""
        return sharded_wave_cost(self.spec.net, batch, data,
                                 microbatch=self.microbatch,
                                 bytes_w=self.spec.weight_bytes)


def build_zoo(names: Sequence[str], *, seed: int = 0,
              in_res: Mapping[str, int] | None = None,
              width_mult: float = 1.0, max_batch: int = 8,
              engine: Engine | None = None, device=None) -> list[ZooModel]:
    """Instantiate zoo models from the registry by name (params from
    :func:`~repro_torch.models.cnn.init_cnn` at ``seed + i``; int8
    variants quantized per-channel via
    :func:`~repro_torch.core.quant.quantize_cnn_params`) on ``device``,
    the card unless the caller names another.  ``in_res`` maps net name ->
    serving resolution (default: the spec's native resolution);
    ``width_mult`` scales every model identically so tests can shrink
    execution without touching the cost model."""
    from repro_torch.core.accelerator import resolve_device
    from repro_torch.core.quant import quantize_cnn_params
    from repro_torch.models import cnn

    device = resolve_device(device)
    out = []
    for i, name in enumerate(names):
        spec = get_zoo_model(name)
        res = (in_res or {}).get(spec.net, spec.in_res)
        params = cnn.init_cnn(spec.net, seed + i, in_res=res,
                              width_mult=width_mult, device=device)
        if spec.weight_dtype == "int8":
            params = quantize_cnn_params(params)
        out.append(ZooModel(spec, params, in_res=res,
                            width_mult=width_mult, max_batch=max_batch,
                            engine=engine, device=device))
    return out


@dataclasses.dataclass(frozen=True)
class TenantStats:
    tenant: str
    n: int
    mean_latency_s: float
    p50_s: float
    p95_s: float
    p99_s: float
    deadlines: int
    misses: int
    served: int = 0
    shed: int = 0
    quarantined: int = 0
    retries: int = 0
    degraded: int = 0

    @property
    def miss_rate(self) -> float:
        return self.misses / self.deadlines if self.deadlines else 0.0

    @property
    def shed_rate(self) -> float:
        return self.shed / self.n if self.n else 0.0


@dataclasses.dataclass(frozen=True)
class ZooReport:
    """Everything one :meth:`ModelZooServer.serve` drain produced: the
    admitted requests (each in exactly one terminal status), the ordered
    policy-decision log, the robustness event log, and the modeled
    accounting (per-tenant latency percentiles, deadline misses, shed /
    quarantine / degradation counts, per-array utilization)."""
    policy: str
    requests: tuple[ZooRequest, ...]
    decisions: tuple[WaveDecision, ...]
    makespan_s: float
    conv_busy_s: float
    fc_busy_s: float
    per_tenant: tuple[TenantStats, ...]
    events: tuple[FaultEvent, ...] = ()
    health: tuple[tuple[str, str], ...] = ()   # final per-model state

    @property
    def served(self) -> tuple[ZooRequest, ...]:
        return tuple(r for r in self.requests if r.status == "served")

    @property
    def shed(self) -> tuple[ZooRequest, ...]:
        return tuple(r for r in self.requests if r.status == "shed")

    @property
    def quarantined(self) -> tuple[ZooRequest, ...]:
        return tuple(r for r in self.requests if r.status == "quarantined")

    @property
    def unaccounted(self) -> tuple[ZooRequest, ...]:
        """Admitted requests in no terminal state — ALWAYS empty (the
        zero-unaccounted guarantee); exposed so benches can gate it."""
        terminal = ("served", "shed", "quarantined")
        return tuple(r for r in self.requests if r.status not in terminal)

    @property
    def shed_rate(self) -> float:
        return len(self.shed) / len(self.requests) if self.requests else 0.0

    @property
    def retry_count(self) -> int:
        return sum(r.retries for r in self.requests)

    @property
    def degraded_served(self) -> int:
        return sum(r.degraded for r in self.served)

    @property
    def degraded_waves(self) -> int:
        """Scheduler decisions whose attempt was faulted (annotated by
        the chaos layer) — the wave-level degradation count."""
        return sum(d.fault != "none" for d in self.decisions)

    @property
    def mean_latency_s(self) -> float:
        lats = [r.latency_s for r in self.served]
        return float(np.mean(lats)) if lats else 0.0

    @property
    def deadline_misses(self) -> int:
        return sum(bool(r.missed_deadline) for r in self.requests)

    @property
    def deadline_count(self) -> int:
        return sum(r.deadline_s is not None for r in self.requests)

    @property
    def miss_rate(self) -> float:
        n = self.deadline_count
        return self.deadline_misses / n if n else 0.0

    @property
    def conv_utilization(self) -> float:
        return self.conv_busy_s / self.makespan_s if self.makespan_s else 0.0

    @property
    def fc_utilization(self) -> float:
        return self.fc_busy_s / self.makespan_s if self.makespan_s else 0.0

    def summary(self) -> str:
        lines = [f"[zoo:{self.policy}] {len(self.requests)} requests in "
                 f"{len(self.decisions)} waves, makespan "
                 f"{self.makespan_s * 1e3:.3f} ms, mean latency "
                 f"{self.mean_latency_s * 1e3:.3f} ms, misses "
                 f"{self.deadline_misses}/{self.deadline_count}, "
                 f"util conv {self.conv_utilization:.2f} / "
                 f"fc {self.fc_utilization:.2f}"]
        if self.shed or self.quarantined or self.events:
            lines.append(f"  robustness: served {len(self.served)} shed "
                         f"{len(self.shed)} quarantined "
                         f"{len(self.quarantined)}, retries "
                         f"{self.retry_count}, degraded-served "
                         f"{self.degraded_served}, faulted waves "
                         f"{self.degraded_waves}")
        for t in self.per_tenant:
            lines.append(f"  tenant {t.tenant}: n={t.n} p50 "
                         f"{t.p50_s * 1e3:.3f} ms p95 {t.p95_s * 1e3:.3f} "
                         f"ms p99 {t.p99_s * 1e3:.3f} ms "
                         f"misses {t.misses}/{t.deadlines}")
        return "\n".join(lines)


class ModelZooServer:
    """Hold several compiled models, admit a mixed tagged request stream
    into per-tenant queues, and schedule dual-array waves with a
    pluggable policy priced by the planner's own cost model.

    ``serve()`` drains everything submitted so far: it first runs the
    deterministic modeled-time schedule (policy decisions, per-request
    dispatch/finish times, utilization, fault handling), then executes
    every scheduled wave — in decision order — through the owning model's
    ``CNNServer`` so each served request carries real logits, bitwise
    equal to its serving model's unbatched forward.

    ``faults`` plugs in a seeded
    :class:`~repro_torch.serve.faults.FaultInjector`
    (chaos harness); ``admission``/``recovery`` configure shedding,
    retry, health and degraded-mode policy.  With ``faults=None`` and the
    default configs the schedule is bit-identical to the healthy path."""

    def __init__(self, models: Sequence[ZooModel], *,
                 policy: SchedulingPolicy | None = None,
                 registry: ScheduleRegistry | None = None,
                 faults: FaultInjector | None = None,
                 admission: AdmissionConfig | None = None,
                 recovery: RecoveryConfig | None = None) -> None:
        if not models:
            raise ValueError("a zoo needs at least one model")
        self.models: dict[str, ZooModel] = {}
        self.policy = policy if policy is not None else FIFOPolicy()
        self.faults = faults
        self.admission = admission if admission is not None \
            else AdmissionConfig()
        self.recovery = recovery if recovery is not None \
            else RecoveryConfig()
        # the compiled-schedule registry: one (net, dtype, batch) entry
        # per model variant at its steady-state wave size
        self.registry = registry if registry is not None \
            else ScheduleRegistry()
        for m in models:
            self.add_model(m)
        self.tenants: dict[str, list[ZooRequest]] = {}
        self._rejected: list[ZooRequest] = []
        self._uids: set = set()
        self._exec_uid = 0
        self._attempt_idx = 0

    def add_model(self, m: ZooModel) -> None:
        """Register one more compiled variant (elastic scale-up — valid
        between drains too).  Registers its stage schedules and refreshes
        the degraded-fallback routing table."""
        if m.name in self.models:
            raise ValueError(f"duplicate zoo model {m.name!r}")
        self.models[m.name] = m
        srv = m.server
        self.registry.register(
            m.spec.net, dtype_tag=m.spec.weight_dtype,
            batch=srv.microbatch, in_res=srv.in_res, in_ch=srv.in_ch,
            width_mult=srv.width_mult, dtype=srv.dtype,
            policy=srv.engine.policy, params=srv.params)
        # degraded-mode routing: fp32 variant -> int8 sibling of the SAME
        # net at the SAME serving resolution (images are interchangeable)
        self._fallbacks: dict[str, str | None] = {}
        for name, zm in self.models.items():
            alt = None
            if zm.spec.weight_dtype != "int8":
                for cand, czm in self.models.items():
                    if (cand != name and czm.spec.net == zm.spec.net
                            and czm.spec.weight_dtype == "int8"
                            and czm.server.in_res == zm.server.in_res):
                        alt = cand
                        break
            self._fallbacks[name] = alt

    # -- admission ----------------------------------------------------------
    def submit(self, req: ZooRequest) -> bool:
        """Admit one tagged request into its tenant's queue; returns
        ``True`` if queued.  Unknown model names and duplicate uids raise
        (caller bugs, the registry's lookup contract).  A deadline
        already in the past at arrival is a *policy* rejection: the
        request is shed immediately with a typed
        :class:`~repro_torch.serve.errors.StaleDeadlineError` result (it still
        appears, accounted, in the next report) and ``False`` returns."""
        if req.model not in self.models:
            raise KeyError(f"unknown zoo model {req.model!r}; "
                           f"serving: {tuple(self.models)}")
        if req.uid in self._uids:
            raise ValueError(f"duplicate request uid {req.uid}: uids are "
                             "unique per zoo lifetime")
        self._uids.add(req.uid)
        if req.deadline_s is not None and req.deadline_s <= req.arrival_s:
            self._shed(req, StaleDeadlineError(
                f"deadline {req.deadline_s:.6f}s already past at arrival "
                f"{req.arrival_s:.6f}s", uid=req.uid, model=req.model))
            self._rejected.append(req)
            return False
        self.tenants.setdefault(req.tenant, []).append(req)
        return True

    def pending_count(self) -> int:
        return sum(len(q) for q in self.tenants.values())

    @staticmethod
    def _shed(req: ZooRequest, err: ServeError) -> None:
        req.status, req.error = "shed", err

    @staticmethod
    def _quarantine(req: ZooRequest, err: ServeError) -> None:
        req.status, req.error = "quarantined", err

    # -- scheduling (deterministic modeled time) ----------------------------
    def _cost(self, model: str, queued: int) -> WaveCost:
        m = self.models[model]
        return m.wave_cost(min(queued, m.microbatch))

    def _route(self, req: ZooRequest,
               health: dict[str, ModelHealth]) -> tuple[str, str | None]:
        """Health-based routing: a request for a *failed* variant drains
        to its int8 sibling when eligible.  Returns (route, reason)."""
        primary = req.model
        if health[primary].state != "failed":
            return primary, None
        alt = self._fallbacks.get(primary)
        if (alt is not None and self.recovery.allow_degraded
                and req.allow_degraded
                and health[alt].state != "failed"):
            return alt, f"{primary} failed -> int8 fallback {alt}"
        return primary, None

    def _backoff(self, retries: int) -> float:
        rec = self.recovery
        return min(rec.backoff_cap_s,
                   rec.backoff_s * rec.backoff_mult ** (retries - 1))

    def _schedule(self, requests: list[ZooRequest]
                  ) -> tuple[list[WaveDecision], list[WaveAttempt],
                             list[FaultEvent], dict[str, ModelHealth]]:
        """The modeled-time simulation: admit by arrival (through
        admission control), pick waves with the policy whenever SA-CONV
        frees, overlap each wave's SA-FC stage with the next wave's
        SA-CONV stage (the dual-array pipeline), consult the fault
        injector once per wave attempt, and drive retry / quarantine /
        health / degradation off the outcomes.  Stamps every request's
        terminal status; pure function of the request list (and the
        injector's seed)."""
        adm, rec = self.admission, self.recovery
        undisp = sorted(requests, key=lambda r: (r.arrival_s, r.uid))
        pending: dict[str, list[ZooRequest]] = {m: [] for m in self.models}
        tenant_depth: dict[str, int] = {}
        retry_heap: list[tuple[float, int, ZooRequest]] = []
        decisions: list[WaveDecision] = []
        attempts: list[WaveAttempt] = []
        events: list[FaultEvent] = []
        health = {m: ModelHealth(m) for m in self.models}
        monitors = {m: StepMonitor(factor=rec.straggler_factor,
                                   warmup=rec.straggler_warmup,
                                   window=rec.straggler_window)
                    for m in self.models}
        beats = HeartbeatTracker([], timeout=rec.heartbeat_timeout_s,
                                 now=0.0)
        for m in self.models:            # late registration, per drain
            beats.register(m, 0.0)
        conv_free = fc_free = 0.0
        i, n = 0, len(undisp)
        terminal = 0
        seq = 0                          # retry-heap tiebreak

        def health_event(t: float, model: str, new: str | None,
                         why: str) -> None:
            if new is not None:
                events.append(FaultEvent(t_s=t, attempt=-1, model=model,
                                         kind="health",
                                         detail=f"-> {new} ({why})"))

        def admit(r: ZooRequest, now: float) -> int:
            """Admission control at the request's modeled admission
            instant; returns 1 when shed (terminal), 0 when queued."""
            route = r.model
            if adm.max_queue is not None \
                    and tenant_depth.get(r.tenant, 0) >= adm.max_queue:
                self._shed(r, RequestShedError(
                    f"tenant {r.tenant!r} queue full "
                    f"({adm.max_queue} pending)", uid=r.uid, model=r.model))
                events.append(FaultEvent(now, -1, r.model, "shed",
                                         f"queue full (tenant {r.tenant})",
                                         uids=(r.uid,)))
                return 1
            if r.deadline_s is not None and adm.predictive_shedding:
                # best case: dispatched immediately, solo wave — if even
                # that misses, scheduling it can only waste array time
                best = now + self.models[route].wave_cost(1).total_s
                if best > r.deadline_s:
                    alt = self._fallbacks.get(route)
                    alt_ok = (
                        alt is not None and rec.allow_degraded
                        and r.allow_degraded
                        and health[alt].state != "failed"
                        and now + self.models[alt].wave_cost(1).total_s
                        <= r.deadline_s)
                    if alt_ok:
                        events.append(FaultEvent(
                            now, -1, route, "degrade",
                            f"predicted miss on {route} -> {alt}",
                            uids=(r.uid,)))
                        route = alt
                    else:
                        self._shed(r, RequestShedError(
                            f"cost model predicts deadline miss: best-case "
                            f"finish {best:.6f}s > deadline "
                            f"{r.deadline_s:.6f}s", uid=r.uid,
                            model=r.model))
                        events.append(FaultEvent(
                            now, -1, r.model, "shed",
                            "predicted deadline miss", uids=(r.uid,)))
                        return 1
            if route == r.model:
                route, why = self._route(r, health)
                if why is not None:
                    events.append(FaultEvent(now, -1, r.model, "degrade",
                                             why, uids=(r.uid,)))
            r.served_by = route
            pending[route].append(r)
            tenant_depth[r.tenant] = tenant_depth.get(r.tenant, 0) + 1
            return 0

        def fail_wave(wave: list[ZooRequest], model: str, t: float,
                      kind: str, attempt: int) -> int:
            """Retry-or-quarantine every request of a failed attempt;
            returns how many went terminal."""
            nonlocal seq
            done = 0
            for r in wave:
                r.retries += 1
                if r.retries > rec.max_retries:
                    err_cls = {"timeout": WaveTimeoutError,
                               "corrupt": CorruptOutputError}.get(
                                   kind, ServeError)
                    self._quarantine(r, err_cls(
                        f"wave {kind} x{r.retries} attempts (retry budget "
                        f"{rec.max_retries} spent)", uid=r.uid,
                        model=model))
                    events.append(FaultEvent(t, attempt, model,
                                             "quarantine",
                                             f"{kind} after {r.retries} "
                                             "attempts", uids=(r.uid,)))
                    done += 1
                else:
                    delay = self._backoff(r.retries)
                    seq += 1
                    heapq.heappush(retry_heap, (t + delay, seq, r))
                    events.append(FaultEvent(t, attempt, model, "retry",
                                             f"{kind}; backoff "
                                             f"{delay * 1e6:.0f}us",
                                             uids=(r.uid,)))
            return done

        guard = 0
        max_iters = 64 + 8 * n * (rec.max_retries + 2)
        while terminal < n:
            guard += 1
            if guard > max_iters:            # never wedge, even on a bug
                raise ServeError(
                    f"scheduler exceeded {max_iters} iterations with "
                    f"{n - terminal} request(s) unresolved — scheduling "
                    "invariant broken")
            now = conv_free
            if not any(pending.values()):
                nxt = []
                if i < n:
                    nxt.append(undisp[i].arrival_s)
                if retry_heap:
                    nxt.append(retry_heap[0][0])
                if nxt:
                    now = max(now, min(nxt))    # idle until eligible work
            while i < n and undisp[i].arrival_s <= now:
                terminal += admit(undisp[i], now)
                i += 1
            while retry_heap and retry_heap[0][0] <= now:
                _, _, r = heapq.heappop(retry_heap)
                route, why = self._route(r, health)
                if why is not None:
                    events.append(FaultEvent(now, -1, r.model, "degrade",
                                             why, uids=(r.uid,)))
                r.served_by = route
                pending[route].append(r)
                tenant_depth[r.tenant] = tenant_depth.get(r.tenant, 0) + 1
            # liveness: idle models are alive by definition; a model with
            # pending work whose waves stopped completing times out
            for m, q in pending.items():
                if not q:
                    beats.beat(m, now)
            for m in beats.failed(now):
                health_event(now, m, health[m].force_failed(),
                             "heartbeat timeout")
            candidates = {m: q for m, q in pending.items() if q}
            if not candidates:
                continue                      # clock advanced; re-check
            chosen = self.policy.pick(now, candidates, self._cost)
            zm = self.models[chosen]
            queue = self.policy.wave_order(pending[chosen])
            wave, rest = queue[:zm.microbatch], queue[zm.microbatch:]
            pending[chosen] = rest
            for r in wave:
                tenant_depth[r.tenant] -= 1
            cost = zm.wave_cost(len(wave))
            attempt = self._attempt_idx
            self._attempt_idx += 1
            faults: WaveFaults | None = None
            if self.faults is not None:
                faults = self.faults.wave_faults(attempt, len(wave))
            kind = faults.kind if faults is not None else "none"
            depths = tuple(sorted((m, len(q))
                                  for m, q in candidates.items()))
            uids = tuple(r.uid for r in wave)

            if kind == "dispatch":
                # transient PlanError at dispatch: neither array occupied
                events.append(FaultEvent(now, attempt, chosen, "dispatch",
                                         "injected transient dispatch "
                                         "failure", uids=uids))
                decisions.append(WaveDecision(
                    index=len(decisions), t_s=now, model=chosen,
                    uids=uids, batch=len(wave), conv_s=0.0, fc_s=0.0,
                    queue_depths=depths, fault="dispatch"))
                attempts.append(WaveAttempt(attempt, chosen, list(wave),
                                            faults, deliver=(),
                                            execute=False))
                terminal += fail_wave(wave, chosen, now, "dispatch",
                                      attempt)
                health_event(now, chosen,
                             health[chosen].on_failure(rec), "dispatch")
                continue

            stall = faults.stall_factor if kind == "stall" else 1.0
            timed_out = stall >= rec.wave_timeout_factor
            eff = cost.scaled(min(stall, rec.wave_timeout_factor)) \
                if stall != 1.0 else cost
            conv_done = now + eff.conv_s
            fc_start = max(conv_done, fc_free)
            fc_done = fc_start + eff.fc_s
            # one-deep stage buffer, like the pipelined CNNServer: the
            # next wave's conv stage may start only once this wave's
            # features have been handed to the SA-FC array
            conv_free, fc_free = max(conv_done, fc_start), fc_done

            if timed_out:
                # aborted at the timeout: the arrays were occupied that
                # long, but nothing completed — no heartbeat, all retry
                events.append(FaultEvent(
                    now, attempt, chosen, "timeout",
                    f"stall x{stall:g} >= timeout factor "
                    f"{rec.wave_timeout_factor:g}, wave aborted",
                    uids=uids))
                decisions.append(WaveDecision(
                    index=len(decisions), t_s=now, model=chosen,
                    uids=uids, batch=len(wave), conv_s=eff.conv_s,
                    fc_s=eff.fc_s, queue_depths=depths, fault="timeout",
                    stall_factor=stall))
                attempts.append(WaveAttempt(attempt, chosen, list(wave),
                                            faults, deliver=(),
                                            execute=False))
                terminal += fail_wave(wave, chosen, fc_done, "timeout",
                                      attempt)
                health_event(fc_done, chosen,
                             health[chosen].on_failure(rec), "timeout")
                continue

            # the wave completed (cleanly, late, or with corrupt rows)
            beats.beat(chosen, fc_done)
            verdict = monitors[chosen].observe(attempt, stall)
            if verdict == "straggler":
                events.append(FaultEvent(fc_done, attempt, chosen, "stall",
                                         f"straggler verdict: x{stall:g} "
                                         "modeled wave time", uids=uids))
                health_event(fc_done, chosen,
                             health[chosen].on_straggler(rec), "straggler")

            corrupt_rows = frozenset(faults.corrupt_rows) \
                if kind == "corrupt" else frozenset()
            served = [r for j, r in enumerate(wave) if j not in corrupt_rows]
            failed = [r for j, r in enumerate(wave) if j in corrupt_rows]
            for r in served:
                r.dispatch_s, r.finish_s = now, fc_done
                r.status = "served"
            terminal += len(served)
            decisions.append(WaveDecision(
                index=len(decisions), t_s=now, model=chosen, uids=uids,
                batch=len(wave), conv_s=eff.conv_s, fc_s=eff.fc_s,
                queue_depths=depths, fault=kind, stall_factor=stall))
            attempts.append(WaveAttempt(
                attempt, chosen, list(wave), faults,
                deliver=tuple(r.uid for r in served)))
            if failed:
                events.append(FaultEvent(
                    fc_done, attempt, chosen, "corrupt",
                    f"non-finite logits in rows "
                    f"{tuple(sorted(corrupt_rows))}",
                    uids=tuple(r.uid for r in failed)))
                terminal += fail_wave(failed, chosen, fc_done, "corrupt",
                                      attempt)
                health_event(fc_done, chosen,
                             health[chosen].on_failure(rec), "corrupt")
            else:
                health_event(fc_done, chosen,
                             health[chosen].on_clean(rec), "clean wave")
        return decisions, attempts, events, health

    # -- execution (real kernels, bitwise per-request logits) ---------------
    def _execute(self, attempts: list[WaveAttempt],
                 events: list[FaultEvent]) -> None:
        """Run every scheduled attempt through its model's ``CNNServer``;
        each wave's logits are read to host numpy.  Corrupt attempts
        execute for real, then the chaos layer overwrites the faulted
        rows at the flush boundary; the per-wave ``np.isfinite``
        integrity guard then decides what is servable — it must agree
        with the modeled schedule (and also catches *genuine* non-finite
        outputs, quarantining instead of serving garbage).  Unexpected
        executor exceptions quarantine the attempt's undelivered requests
        instead of wedging the drain; both of these leave a
        ``quarantine`` event, which a run that must not fall back checks
        for."""
        for a in attempts:
            if a.faults is not None and a.faults.kind == "dispatch":
                try:
                    raise self.faults.dispatch_error(a.index, a.model)
                except PlanError:
                    continue      # scheduler already retried/quarantined
            if not a.execute:
                continue
            srv = self.models[a.model].server
            exec_uids: list[int] = []
            for r in a.requests:
                eu = self._exec_uid
                self._exec_uid += 1
                exec_uids.append(eu)
                srv.submit(CNNRequest(uid=eu, image=r.image))
            try:
                completed = {c.uid: c for c in srv.step_wave()}
            except Exception as e:      # noqa: BLE001 — never wedge
                srv.cancel(exec_uids)
                deliver = set(a.deliver)
                for r in a.requests:
                    if r.uid in deliver:
                        self._quarantine(r, ServeError(
                            f"wave execution raised {type(e).__name__}: "
                            f"{e}", uid=r.uid, model=a.model))
                        events.append(FaultEvent(
                            -1.0, a.index, a.model, "quarantine",
                            f"executor raised {type(e).__name__}",
                            uids=(r.uid,)))
                continue
            corrupt_rows = frozenset(a.faults.corrupt_rows) \
                if a.faults is not None and a.faults.kind == "corrupt" \
                else frozenset()
            deliver = set(a.deliver)
            for row, (r, eu) in enumerate(zip(a.requests, exec_uids)):
                done = completed.get(eu)
                if done is None:        # executor lost a row: typed, loud
                    if r.uid in deliver:
                        self._quarantine(r, ServeError(
                            "executor returned no completion for the "
                            "request's wave row", uid=r.uid,
                            model=a.model))
                        events.append(FaultEvent(
                            -1.0, a.index, a.model, "quarantine",
                            "executor lost a wave row", uids=(r.uid,)))
                    continue
                logits = np.asarray(done.logits)
                if row in corrupt_rows:
                    logits = FaultInjector.corrupt_array(logits)
                if not bool(np.isfinite(logits).all()):
                    if r.uid in deliver:
                        # genuine (un-injected) corruption: the guard
                        # refuses to serve garbage even when the modeled
                        # schedule expected a clean row
                        self._quarantine(r, CorruptOutputError(
                            "non-finite logits at the integrity guard",
                            uid=r.uid, model=a.model))
                        events.append(FaultEvent(
                            -1.0, a.index, a.model, "quarantine",
                            "integrity guard: genuine non-finite logits",
                            uids=(r.uid,)))
                    continue
                if r.uid in deliver:
                    r.logits, r.done = logits, True

    # -- accounting ---------------------------------------------------------
    @staticmethod
    def _tenant_stats(tenant: str, reqs: list[ZooRequest]) -> TenantStats:
        served = [r for r in reqs if r.status == "served"]
        lats = np.array([r.latency_s for r in served], dtype=np.float64)
        has = lats.size > 0
        return TenantStats(
            tenant=tenant, n=len(reqs),
            mean_latency_s=float(lats.mean()) if has else 0.0,
            p50_s=float(np.percentile(lats, 50)) if has else 0.0,
            p95_s=float(np.percentile(lats, 95)) if has else 0.0,
            p99_s=float(np.percentile(lats, 99)) if has else 0.0,
            deadlines=sum(r.deadline_s is not None for r in reqs),
            misses=sum(bool(r.missed_deadline) for r in reqs),
            served=len(served),
            shed=sum(r.status == "shed" for r in reqs),
            quarantined=sum(r.status == "quarantined" for r in reqs),
            retries=sum(r.retries for r in reqs),
            degraded=sum(r.degraded for r in served))

    def serve(self, *, execute: bool = True) -> ZooReport:
        """Drain every per-tenant queue: schedule (modeled time), execute
        (real kernels; skipped with ``execute=False`` for modeled-only
        analysis — the schedule, statuses and accounting are
        execution-independent by construction), account.  Returns the
        :class:`ZooReport`; the admitted requests are completed in
        place, each in exactly one terminal status."""
        queued = [r for q in self.tenants.values() for r in q]
        for q in self.tenants.values():
            q.clear()
        rejected, self._rejected = self._rejected, []
        requests = queued + rejected
        if not requests:
            return ZooReport(self.policy.name, (), (), 0.0, 0.0, 0.0, ())
        decisions: list[WaveDecision] = []
        attempts: list[WaveAttempt] = []
        events: list[FaultEvent] = []
        health: dict[str, ModelHealth] = {}
        for r in rejected:             # admission-time typed rejections
            events.append(FaultEvent(r.arrival_s, -1, r.model, "shed",
                                     "stale deadline at submit",
                                     uids=(r.uid,)))
        if queued:
            decisions, attempts, sched_events, health = \
                self._schedule(queued)
            events.extend(sched_events)
        if execute:
            self._execute(attempts, events)
        # the zero-unaccounted guarantee, enforced defensively: anything
        # the scheduler somehow left non-terminal becomes a typed error
        # result rather than a silent drop
        terminal = ("served", "shed", "quarantined")
        for r in requests:
            if r.status not in terminal:
                self._quarantine(r, ServeError(
                    "internal: request left non-terminal by the "
                    "scheduler", uid=r.uid, model=r.model))
                events.append(FaultEvent(-1.0, -1, r.model, "quarantine",
                                         "internal: non-terminal request",
                                         uids=(r.uid,)))
        served = [r for r in requests if r.status == "served"]
        makespan = (max(r.finish_s for r in served)
                    - min(r.arrival_s for r in requests)) if served else 0.0
        by_tenant: dict[str, list[ZooRequest]] = {}
        for r in requests:
            by_tenant.setdefault(r.tenant, []).append(r)
        return ZooReport(
            policy=self.policy.name,
            requests=tuple(sorted(requests, key=lambda r: r.uid)),
            decisions=tuple(decisions),
            makespan_s=makespan,
            conv_busy_s=sum(d.conv_s for d in decisions),
            fc_busy_s=sum(d.fc_s for d in decisions),
            per_tenant=tuple(self._tenant_stats(t, rs) for t, rs in
                             sorted(by_tenant.items())),
            events=tuple(events),
            health=tuple((m, h.state) for m, h in sorted(health.items())))
