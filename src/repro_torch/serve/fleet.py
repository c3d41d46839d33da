"""Replica-sharded serving fleet on the port — N data-parallel copies of
the model zoo behind one admission plane, surviving dead devices.

MPNA's thesis is that many parallel arrays plus the right dataflow beat
one big array; this module is the fleet-scale analogue: N **replicas**
(each a full dual-array pipeline holding every zoo model) split the
scheduled wave stream via a pluggable :class:`PlacementPolicy`, and a
**per-replica health plane** keeps the fleet serving when replicas die.

Architecture
------------
* Each replica is an independent modeled dual-array pipeline (its own
  ``conv_free``/``fc_free`` clocks — the per-replica twin of the
  :class:`~repro_torch.serve.zoo.ModelZooServer` scheduler) plus, at
  execution time, its own per-model
  :class:`~repro_torch.serve.cnn_server.CNNServer` lane on a torch device
  (every visible CUDA device round-robin, or the CPU for models built
  there; on one card every replica shares it).  **The modeled schedule
  never reads the device count** — placement is over the configured
  logical replicas — so the decision/event logs are bit-identical
  whether the host has 1 device or 8.  The scheduler is the JAX
  package's, copied: its schedules equal the reference's field for field.
* Admission (bounded tenant queues, stale deadlines, predictive
  shedding) reuses the zoo's :class:`~repro_torch.serve.zoo.AdmissionConfig`
  semantics; placed requests are stamped with their replica.
* The health plane drives the seed-era primitives per replica: a
  :class:`~repro_torch.distributed.fault_tolerance.HeartbeatTracker` on the
  modeled clock (a partitioned replica's beats are dropped, so the
  failure detector suspects it), a
  :class:`~repro_torch.distributed.fault_tolerance.StepMonitor` per replica
  (transient device stalls trip the straggler verdict), and
  :meth:`~repro_torch.distributed.fault_tolerance.HeartbeatTracker.deregister`
  drains a **dead** replica from liveness for good.
* On replica death (:class:`~repro_torch.serve.faults.ReplicaChaosConfig`
  ``kills``): queued waves **drain to surviving peers**, the in-flight
  wave fails and re-enters via retry + capped backoff (the zoo's
  :class:`~repro_torch.serve.zoo.RecoveryConfig` machinery, reused verbatim),
  and :func:`~repro_torch.distributed.elastic.replan` proposes the shrunk
  data-parallel mesh (an event in the log, like every transition).  A
  suspected (partitioned) replica drains its queue too, and **rejoins**
  when its heartbeats return.  When *no* replica survives, remaining
  requests are quarantined with typed
  :class:`~repro_torch.serve.errors.ReplicaLostError` results — the fleet
  reports, it never wedges.

* **Cooperative sharded waves** (``shard_waves=True``): when a model's
  queue exceeds its planner micro-batch, the scheduler cuts ONE wave of
  up to ``data x bb`` rows and executes it across every free healthy
  replica — rows placed on the ``("data",)`` mesh
  (:func:`~repro_torch.distributed.sharding.shard_wave_rows`) and run as
  one forward per participant of at most a micro-batch each, priced by
  :func:`~repro_torch.core.perf_model.sharded_wave_cost` (one broadcast-fed
  FC weight stream instead of per-replica HBM streams).  A participant
  dying mid-wave aborts the wave (``shard_abort``), re-deals its rows
  over the survivors (``reshard``,
  :func:`~repro_torch.distributed.elastic.reshard_wave` — the retry path
  honors the pinned assignment), and retries with the usual backoff;
  below two usable replicas the lane degrades to the per-replica path
  with a typed ``shard_fallback`` event, never an error.

Public API: :class:`FleetServer` (``submit`` / ``serve`` /
``pending_count``; knobs: ``n_replicas``, ``policy``, ``placement``,
``faults``, ``admission``, ``recovery``, ``shard_waves``,
``devices``), the :class:`PlacementPolicy` hierarchy (``PLACEMENTS``),
and the report types :class:`FleetReport` / :class:`FleetWaveDecision`
/ :class:`FleetEvent` / :class:`ReplicaStats`.

Invariants: every admitted request ends as exactly one of served /
shed / quarantined (zero unaccounted); a served request's logits are
**bitwise equal** to its model's single-device unbatched forward, no
matter which replica, how many retries, or whether the wave was
sharded over ``data=4``; the whole modeled schedule is a pure function
of (trace, configs, chaos plan) — it never reads the device count.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.accelerator import resolve_device
from repro_torch.core.engine import DispatchTrace
from repro_torch.core.perf_model import WaveCost
from repro_torch.core.quant import QTensor
from repro_torch.distributed.elastic import replan, reshard_wave
from repro_torch.distributed.fault_tolerance import HeartbeatTracker, StepMonitor
from repro_torch.serve.cnn_server import CNNRequest, CNNServer
from repro_torch.serve.errors import (CorruptOutputError, InsufficientReplicasError,
                                ReplicaLostError, RequestShedError,
                                ServeError, StaleDeadlineError,
                                WaveTimeoutError)
from repro_torch.serve.faults import ReplicaFaultInjector, ReplicaFaults
from repro_torch.distributed.sharding import Mesh, shard_wave_rows
from repro_torch.models import cnn
from repro_torch.serve.zoo import (AdmissionConfig, FIFOPolicy,
                                   ModelZooServer, RecoveryConfig,
                                   SchedulingPolicy, TenantStats, ZooModel,
                                   ZooRequest)

__all__ = ["PlacementPolicy", "LeastLoadedPlacement", "RoundRobinPlacement",
           "PLACEMENTS", "ReplicaView", "FleetWaveDecision", "FleetEvent",
           "ReplicaStats", "FleetReport", "FleetServer", "cooperative_blocks"]


def cooperative_blocks(rows: int, parts: int, cap: int) -> list[int]:
    """Row counts of the forwards that run ``rows`` rows dealt to
    ``parts`` participants on one device: contiguous near-equal parts
    (the first ``rows % parts`` one row longer), each cut into pieces of
    at most ``cap`` rows, empty parts dropped, in row order."""
    out = []
    for j in range(parts):
        n = rows // parts + (j < rows % parts)
        while n > 0:
            out.append(min(n, cap))
            n -= out[-1]
    return out


def _canonical(dev: torch.device) -> torch.device:
    """``dev`` with the index a bare ``"cuda"`` resolves to."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _params_to(params: list, device: torch.device) -> list:
    """A CNN parameter list copied to ``device`` (int8 leaves as
    :class:`~repro_torch.core.quant.QTensor`)."""
    def one(v):
        if isinstance(v, QTensor):
            return QTensor(v.q.to(device), v.scale.to(device))
        return v.to(device)
    return [{k: one(v) for k, v in p.items()} for p in params]


# ---------------------------------------------------------------------------
# placement: which replica absorbs an admitted (or drained) request
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """What a placement policy may see of one candidate replica: its id,
    stable index, queued request count, modeled backlog (queued waves
    priced by the cost model) and how far its conv array is committed
    past ``now``.  A read-only projection — policies never touch the
    scheduler's state."""
    rid: str
    index: int
    queued: int
    backlog_s: float
    busy_s: float


class PlacementPolicy:
    """Picks the replica an admitted/drained/retried request lands on.
    ``place`` sees the candidate :class:`ReplicaView` list (sorted by
    replica index; only live, non-suspect replicas unless none exist)
    and must return one of their ``rid``s, deterministically."""

    name = "base"

    def place(self, now: float, candidates: Sequence[ReplicaView],
              req: ZooRequest) -> str:
        raise NotImplementedError


class LeastLoadedPlacement(PlacementPolicy):
    """Cheapest-backlog replica first: modeled queued work plus residual
    array occupancy, ties broken by queue depth then replica index —
    the fleet twin of :class:`~repro_torch.serve.zoo.ShortestMakespanPolicy`,
    with the same cost model as the oracle."""

    name = "least-loaded"

    def place(self, now, candidates, req):
        best = min(candidates,
                   key=lambda v: (v.backlog_s + v.busy_s, v.queued, v.index))
        return best.rid


class RoundRobinPlacement(PlacementPolicy):
    """Strict rotation over the candidate replicas — the baseline the
    load-aware policy is compared against.  The rotation counter only
    advances on placement, so the assignment sequence is deterministic
    for a given trace."""

    name = "round-robin"

    def __init__(self) -> None:
        self._turn = 0

    def place(self, now, candidates, req):
        pick = candidates[self._turn % len(candidates)]
        self._turn += 1
        return pick.rid


PLACEMENTS: dict[str, Callable[[], PlacementPolicy]] = {
    "least-loaded": LeastLoadedPlacement,
    "round-robin": RoundRobinPlacement,
}


# ---------------------------------------------------------------------------
# fleet-level logs: decisions, events, per-replica accounting
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FleetWaveDecision:
    """One fleet scheduling decision: at modeled ``t_s``, ``replica``
    dispatched ``model``'s wave of ``batch`` requests at the modeled
    stage occupancies below.  ``fault`` annotates what fleet chaos did
    to the attempt (``replica_dead`` = the replica died mid-wave).
    ``shards`` is empty for a per-replica wave; for a cooperative
    sharded wave it lists every participating replica (``replica`` is
    the root whose queue the wave was cut from) and ``conv_s``/``fc_s``
    are the sharded stage terms (per-shard conv, broadcast-fed FC)."""
    index: int
    t_s: float
    replica: str
    model: str
    uids: tuple[int, ...]
    batch: int
    conv_s: float
    fc_s: float
    fault: str = "none"        # none|stall|timeout|replica_dead
    stall_factor: float = 1.0
    shards: tuple[str, ...] = ()

    @property
    def total_s(self) -> float:
        return self.conv_s + self.fc_s

    @property
    def sharded(self) -> bool:
        return bool(self.shards)


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """One fleet robustness event in modeled time.  ``kind`` is one of:
    ``kill`` (a replica died), ``replica_dead`` (its in-flight wave was
    lost), ``drain`` (a queued request moved to a peer), ``suspect`` /
    ``rejoin`` (failure-detector transitions), ``replan`` /
    ``replan_failed`` (elastic mesh proposals), ``retry`` /
    ``quarantine`` / ``shed`` (per-request outcomes), ``stall`` /
    ``timeout`` (wave-level device faults), ``shard_abort`` /
    ``reshard`` / ``shard_fallback`` (cooperative-wave lifecycle: a
    participant died mid-wave, the wave's rows were re-dealt over the
    survivors, or the mesh fell below data=2 and the wave dropped to
    the per-replica lane)."""
    t_s: float
    replica: str
    kind: str
    detail: str
    uids: tuple[int, ...] = ()
    attempt: int = -1
    model: str = ""


@dataclasses.dataclass(frozen=True)
class ReplicaStats:
    """Per-replica accounting for one drain: waves dispatched, requests
    served, modeled busy seconds, requests drained *away* from it, and
    its final state (``alive`` | ``suspect`` | ``dead``)."""
    replica: str
    waves: int
    served: int
    busy_s: float
    drained_away: int
    state: str


@dataclasses.dataclass(frozen=True)
class FleetReport:
    """Everything one :meth:`FleetServer.serve` drain produced — the
    fleet twin of :class:`~repro_torch.serve.zoo.ZooReport`, with the decision
    log carrying replica assignments, the event log carrying the fleet
    fault plane, and ``mesh_plans`` the elastic replan history
    ``(t_s, data_degree, wasted_chips, why)``."""
    placement: str
    policy: str
    n_replicas: int
    requests: tuple[ZooRequest, ...]
    decisions: tuple[FleetWaveDecision, ...]
    events: tuple[FleetEvent, ...]
    makespan_s: float
    per_replica: tuple[ReplicaStats, ...]
    per_tenant: tuple[TenantStats, ...]
    mesh_plans: tuple[tuple[float, int, int, str], ...]

    @property
    def served(self) -> tuple[ZooRequest, ...]:
        return tuple(r for r in self.requests if r.status == "served")

    @property
    def shed(self) -> tuple[ZooRequest, ...]:
        return tuple(r for r in self.requests if r.status == "shed")

    @property
    def quarantined(self) -> tuple[ZooRequest, ...]:
        return tuple(r for r in self.requests
                     if r.status == "quarantined")

    @property
    def unaccounted(self) -> tuple[ZooRequest, ...]:
        """Admitted requests in no terminal state — ALWAYS empty (the
        zero-unaccounted guarantee, fleet edition)."""
        terminal = ("served", "shed", "quarantined")
        return tuple(r for r in self.requests if r.status not in terminal)

    @property
    def throughput_rps(self) -> float:
        return len(self.served) / self.makespan_s if self.makespan_s \
            else 0.0

    @property
    def retry_count(self) -> int:
        return sum(r.retries for r in self.requests)

    @property
    def drained_uids(self) -> tuple[int, ...]:
        """Requests that were moved off a dying/suspect replica (queued
        drains plus in-flight ``replica_dead`` losses), in event order —
        the 'drain to surviving peers' audit trail."""
        out: list[int] = []
        for e in self.events:
            if e.kind in ("drain", "replica_dead"):
                out.extend(u for u in e.uids if u not in out)
        return tuple(out)

    @property
    def mean_latency_s(self) -> float:
        lats = [r.latency_s for r in self.served]
        return float(np.mean(lats)) if lats else 0.0

    def summary(self) -> str:
        lines = [f"[fleet:{self.placement}/{self.policy}] "
                 f"{self.n_replicas} replicas, {len(self.requests)} "
                 f"requests in {len(self.decisions)} waves, makespan "
                 f"{self.makespan_s * 1e3:.3f} ms, served "
                 f"{len(self.served)} shed {len(self.shed)} quarantined "
                 f"{len(self.quarantined)}, retries {self.retry_count}, "
                 f"drained {len(self.drained_uids)}"]
        for s in self.per_replica:
            lines.append(f"  {s.replica}[{s.state}]: waves={s.waves} "
                         f"served={s.served} busy "
                         f"{s.busy_s * 1e3:.3f} ms "
                         f"drained-away={s.drained_away}")
        for t_s, data, wasted, why in self.mesh_plans:
            lines.append(f"  mesh@{t_s * 1e3:.3f}ms: data={data} "
                         f"wasted={wasted} ({why})")
        return "\n".join(lines)


@dataclasses.dataclass
class FleetWaveAttempt:
    """One scheduled fleet wave attempt, as handed to the executor:
    which replica lane runs it, which uids it actually serves
    (``deliver``), and whether its kernels run at all (``execute=False``
    for timeout aborts and waves lost to a dying replica)."""
    index: int
    replica: str
    model: str
    requests: list[ZooRequest]
    faults: ReplicaFaults | None
    deliver: tuple[int, ...]
    execute: bool = True
    shards: tuple[str, ...] = ()   # participants of a cooperative wave


# ---------------------------------------------------------------------------
# per-replica modeled state (scheduler-internal)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _ReplicaState:
    rid: str
    index: int
    alive: bool = True
    suspect: bool = False
    conv_free: float = 0.0
    fc_free: float = 0.0
    busy_s: float = 0.0
    waves: int = 0
    drained_away: int = 0
    pending: dict[str, list[ZooRequest]] = dataclasses.field(
        default_factory=dict)

    def usable(self) -> bool:
        return self.alive and not self.suspect

    def pending_n(self) -> int:
        return sum(len(q) for q in self.pending.values())

    @property
    def state_name(self) -> str:
        if not self.alive:
            return "dead"
        return "suspect" if self.suspect else "alive"


class FleetServer:
    """N data-parallel replicas of the model zoo behind one admission
    plane: scheduled waves are placed on replicas by a pluggable
    :class:`PlacementPolicy`, within a replica the zoo's
    :class:`~repro_torch.serve.zoo.SchedulingPolicy` picks which model's wave
    dispatches, and a per-replica health plane (heartbeats, straggler
    monitor, drain + elastic replan) survives replica-granular chaos.

    ``serve()`` mirrors :meth:`~repro_torch.serve.zoo.ModelZooServer.serve`:
    a deterministic modeled-time schedule first (device-count
    independent), then real execution of every scheduled wave on its
    replica's lane (per-model ``CNNServer``s pinned round-robin over
    :meth:`devices`), with the same ``isfinite`` integrity guard and
    bitwise-parity contract.  ``shard_traces`` keeps the dispatch trace
    of every forward a cooperative wave ran, in order."""

    def __init__(self, models: Sequence[ZooModel], *,
                 n_replicas: int = 2,
                 policy: SchedulingPolicy | None = None,
                 placement: PlacementPolicy | None = None,
                 faults: ReplicaFaultInjector | None = None,
                 admission: AdmissionConfig | None = None,
                 recovery: RecoveryConfig | None = None,
                 devices: Sequence | None = None,
                 shard_waves: bool = False,
                 mesh_model_parallel: int = 1,
                 mesh_global_batch: int = 64,
                 mesh_pod_size: int = 64) -> None:
        if not models:
            raise ValueError("a fleet needs at least one model")
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.models: dict[str, ZooModel] = {}
        for m in models:
            if m.name in self.models:
                raise ValueError(f"duplicate fleet model {m.name!r}")
            self.models[m.name] = m
        self.n_replicas = n_replicas
        self.replica_ids = tuple(f"r{i}" for i in range(n_replicas))
        self.policy = policy if policy is not None else FIFOPolicy()
        self.placement = placement if placement is not None \
            else LeastLoadedPlacement()
        self.faults = faults
        self.admission = admission if admission is not None \
            else AdmissionConfig()
        self.recovery = recovery if recovery is not None \
            else RecoveryConfig()
        self.shard_waves = shard_waves
        self.mesh_model_parallel = mesh_model_parallel
        self.mesh_global_batch = mesh_global_batch
        self.mesh_pod_size = mesh_pod_size
        self._given_devices = tuple(devices) if devices is not None \
            else None
        self._device_list: tuple | None = None
        self._lanes: dict[str, dict[str, CNNServer]] | None = None
        self._device_params: dict[tuple[str, torch.device], list] = {}
        self.shard_traces: list[DispatchTrace] = []
        self.tenants: dict[str, list[ZooRequest]] = {}
        self._rejected: list[ZooRequest] = []
        self._uids: set = set()
        self._exec_uid = 0
        self._attempt_idx = 0

    # -- devices / execution lanes (never consulted by the scheduler) -------
    def devices(self) -> tuple[torch.device, ...]:
        """The torch devices replica lanes round-robin over: the given
        ones, else every visible CUDA device when the models live on the
        card and the CPU when they were built there.  Lazy: the modeled
        schedule never needs them, so modeled-only fleets never touch
        CUDA.  Asking for CUDA where there is none raises."""
        if self._device_list is None:
            if self._given_devices is not None:
                devs = tuple(resolve_device(d)
                             for d in self._given_devices)
            else:
                home = next(iter(self.models.values())).server.device
                if home.type == "cuda":
                    devs = tuple(torch.device("cuda", i) for i in
                                 range(torch.cuda.device_count()))
                else:
                    devs = (home,)
            if not devs:
                raise ValueError("a fleet needs at least one device")
            self._device_list = tuple(_canonical(d) for d in devs)
        return self._device_list

    def replica_device(self, index: int) -> torch.device:
        devs = self.devices()
        return devs[index % len(devs)]

    def mesh(self) -> Mesh:
        """The port's ``("data",)`` mesh over the fleet's **distinct**
        replica devices — the mesh
        :func:`~repro_torch.distributed.elastic.replan` proposals shrink.
        With fewer devices than replicas the mesh is narrower than the
        logical fleet (replicas share devices: on one card it is 1 wide);
        the modeled schedule is unaffected either way."""
        return self.shard_mesh(self.replica_ids)

    def shard_mesh(self, rids: Sequence[str]) -> Mesh:
        """The ``("data",)`` mesh a cooperative wave executes over: the
        **distinct** devices of the given (healthy) participant
        replicas.  With fewer devices than participants the mesh is
        narrower than the cooperative wave's logical ``data`` degree —
        as with :meth:`mesh`, the modeled schedule never reads it."""
        distinct = []
        for rid in rids:
            d = self.replica_device(self.replica_ids.index(rid))
            if d not in distinct:
                distinct.append(d)
        return Mesh(tuple(distinct))

    def _params_on(self, model: str, device: torch.device) -> list:
        """The model's parameters on ``device``: its own where they
        already live there, else one copy per (model, device)."""
        m = self.models[model]
        if _canonical(m.server.device) == device:
            return m.params
        key = (model, device)
        if key not in self._device_params:
            self._device_params[key] = _params_to(m.params, device)
        return self._device_params[key]

    def _lane(self, rid: str, model: str) -> CNNServer:
        """The replica's ``CNNServer`` for ``model`` on the replica's
        device, sharing the zoo model's engine and (on its device) its
        parameters."""
        if self._lanes is None:
            self._lanes = {}
        lane = self._lanes.setdefault(rid, {})
        srv = lane.get(model)
        if srv is None:
            m = self.models[model]
            device = self.replica_device(self.replica_ids.index(rid))
            srv = lane[model] = CNNServer(
                m.spec.net, self._params_on(model, device),
                in_res=m.server.in_res, width_mult=m.server.width_mult,
                max_batch=m.server.max_batch, dtype=m.server.dtype,
                engine=m.server.engine, device=device)
        return srv

    # -- admission ----------------------------------------------------------
    def submit(self, req: ZooRequest) -> bool:
        """Admit one tagged request — the zoo's submit contract: unknown
        models and duplicate uids raise; a stale deadline is shed with a
        typed result and ``False`` returns."""
        if req.model not in self.models:
            raise KeyError(f"unknown fleet model {req.model!r}; "
                           f"serving: {tuple(self.models)}")
        if req.uid in self._uids:
            raise ValueError(f"duplicate request uid {req.uid}: uids are "
                             "unique per fleet lifetime")
        self._uids.add(req.uid)
        if req.deadline_s is not None and req.deadline_s <= req.arrival_s:
            req.status = "shed"
            req.error = StaleDeadlineError(
                f"deadline {req.deadline_s:.6f}s already past at arrival "
                f"{req.arrival_s:.6f}s", uid=req.uid, model=req.model)
            self._rejected.append(req)
            return False
        self.tenants.setdefault(req.tenant, []).append(req)
        return True

    def pending_count(self) -> int:
        return sum(len(q) for q in self.tenants.values())

    # -- modeled cost helpers ------------------------------------------------
    def _cost(self, model: str, queued: int) -> WaveCost:
        m = self.models[model]
        return m.wave_cost(min(queued, m.microbatch))

    def _backlog_s(self, st: _ReplicaState) -> float:
        total = 0.0
        for model, q in st.pending.items():
            if not q:
                continue
            mb = self.models[model].microbatch
            waves = -(-len(q) // mb)
            total += waves * self._cost(model, min(len(q), mb)).total_s
        return total

    def _views(self, now: float, states: list[_ReplicaState]
               ) -> list[ReplicaView]:
        return [ReplicaView(st.rid, st.index, st.pending_n(),
                            self._backlog_s(st),
                            max(0.0, st.conv_free - now))
                for st in states]

    def _backoff(self, retries: int) -> float:
        rec = self.recovery
        return min(rec.backoff_cap_s,
                   rec.backoff_s * rec.backoff_mult ** (retries - 1))

    # -- scheduling (deterministic modeled time, device-count independent) --
    def _schedule(self, requests: list[ZooRequest]
                  ) -> tuple[list[FleetWaveDecision],
                             list[FleetWaveAttempt], list[FleetEvent],
                             dict[str, _ReplicaState],
                             list[tuple[float, int, int, str]]]:
        adm, rec = self.admission, self.recovery
        inj = self.faults
        undisp = sorted(requests, key=lambda r: (r.arrival_s, r.uid))
        states: dict[str, _ReplicaState] = {
            rid: _ReplicaState(rid, idx,
                               pending={m: [] for m in self.models})
            for idx, rid in enumerate(self.replica_ids)}
        tenant_depth: dict[str, int] = {}
        resharded: dict[int, str] = {}   # uid -> survivor pinned by reshard
        retry_heap: list[tuple[float, int, ZooRequest]] = []
        decisions: list[FleetWaveDecision] = []
        attempts: list[FleetWaveAttempt] = []
        events: list[FleetEvent] = []
        mesh_plans: list[tuple[float, int, int, str]] = []
        beats = HeartbeatTracker(list(self.replica_ids),
                                 timeout=rec.heartbeat_timeout_s, now=0.0)
        monitors = {rid: StepMonitor(factor=rec.straggler_factor,
                                     warmup=rec.straggler_warmup,
                                     window=rec.straggler_window)
                    for rid in self.replica_ids}
        kills: dict[str, float] = {}
        partitions: list[tuple[str, float, float]] = []
        if inj is not None:
            for rid in self.replica_ids:
                t_kill = inj.kill_time(rid)
                if t_kill is not None:
                    kills[rid] = t_kill
                for s, e in inj.partition_windows(rid):
                    partitions.append((rid, s, e))
        part_done = [False] * len(partitions)
        now = 0.0
        i, n = 0, len(undisp)
        terminal = 0
        seq = 0

        def partitioned(rid: str, t: float) -> bool:
            return inj is not None and inj.partitioned(rid, t)

        def candidates_for_place() -> list[_ReplicaState]:
            usable = [st for st in states.values() if st.usable()]
            if usable:
                return usable
            # every live replica is suspect: a drained fleet beats a
            # wedged one — fall back to suspects rather than dropping
            return [st for st in states.values() if st.alive]

        def place(r: ZooRequest, t: float) -> str | None:
            """Route ``r`` onto a replica queue; None = nowhere left.
            A request whose sharded wave was aborted mid-flight carries a
            :func:`~repro_torch.distributed.elastic.reshard_wave` pin — honor
            it while that survivor is usable (re-sharding moves in-flight
            state deterministically; free placement is the fallback)."""
            pinned = resharded.pop(r.uid, None)
            if pinned is not None and states[pinned].usable():
                st = states[pinned]
                r.replica = pinned
                r.served_by = r.model
                st.pending[r.model].append(r)
                tenant_depth[r.tenant] = tenant_depth.get(r.tenant, 0) + 1
                return pinned
            cands = candidates_for_place()
            if not cands:
                return None
            rid = self.placement.place(t, self._views(t, cands), r)
            st = states[rid]
            r.replica = rid
            r.served_by = r.model
            st.pending[r.model].append(r)
            tenant_depth[r.tenant] = tenant_depth.get(r.tenant, 0) + 1
            return rid

        def quarantine_lost(r: ZooRequest, t: float, why: str) -> None:
            nonlocal terminal
            r.status = "quarantined"
            r.error = ReplicaLostError(why, uid=r.uid, model=r.model,
                                       replica=r.replica or "")
            events.append(FleetEvent(t, r.replica or "-", "quarantine",
                                     why, uids=(r.uid,)))
            terminal += 1

        def do_replan(t: float, why: str) -> None:
            alive = sum(st.usable() for st in states.values())
            try:
                plan = replan(alive,
                              model_parallel=self.mesh_model_parallel,
                              global_batch=self.mesh_global_batch,
                              pod_size=self.mesh_pod_size)
            except InsufficientReplicasError as e:
                events.append(FleetEvent(t, "-", "replan_failed",
                                         f"{why}: {e.message}"))
                return
            mesh_plans.append((t, plan.data, plan.wasted_chips, why))
            events.append(FleetEvent(
                t, "-", "replan",
                f"{why}: {alive} usable -> data={plan.data} "
                f"wasted={plan.wasted_chips}"))

        def drain_queue(st: _ReplicaState, t: float, why: str) -> None:
            """Move every queued request off ``st`` to surviving peers
            (or quarantine when none remain)."""
            for model in st.pending:
                moved, st.pending[model] = st.pending[model], []
                for r in moved:
                    tenant_depth[r.tenant] -= 1
                    st.drained_away += 1
                    new_rid = place(r, t)
                    if new_rid is None:
                        quarantine_lost(
                            r, t, f"{why}; no surviving replica to "
                            "drain to")
                    else:
                        events.append(FleetEvent(
                            t, st.rid, "drain",
                            f"{why}: queued request -> {new_rid}",
                            uids=(r.uid,), model=model))

        def fire_kill(rid: str, t: float) -> None:
            st = states[rid]
            del kills[rid]
            st.alive = False
            st.suspect = False
            events.append(FleetEvent(t, rid, "kill", "replica died"))
            beats.deregister(rid)        # stop tripping liveness forever
            drain_queue(st, t, f"replica {rid} died")
            do_replan(t, f"{rid} dead")

        def fail_wave(wave: list[ZooRequest], rid: str, model: str,
                      t: float, kind: str, attempt: int) -> None:
            """Retry-or-quarantine a failed attempt's requests — the
            zoo's recovery discipline with fleet-typed terminal errors."""
            nonlocal terminal, seq
            for r in wave:
                r.retries += 1
                if r.retries > rec.max_retries:
                    err_cls = {"timeout": WaveTimeoutError,
                               "replica_dead": ReplicaLostError}.get(
                                   kind, ServeError)
                    kw = {"replica": rid} \
                        if err_cls is ReplicaLostError else {}
                    r.status = "quarantined"
                    r.error = err_cls(
                        f"wave {kind} x{r.retries} attempts (retry "
                        f"budget {rec.max_retries} spent)", uid=r.uid,
                        model=model, **kw)
                    events.append(FleetEvent(
                        t, rid, "quarantine",
                        f"{kind} after {r.retries} attempts",
                        uids=(r.uid,), attempt=attempt, model=model))
                    terminal += 1
                else:
                    delay = self._backoff(r.retries)
                    seq += 1
                    heapq.heappush(retry_heap, (t + delay, seq, r))
                    events.append(FleetEvent(
                        t, rid, "retry",
                        f"{kind}; backoff {delay * 1e6:.0f}us",
                        uids=(r.uid,), attempt=attempt, model=model))

        def admit(r: ZooRequest, t: float) -> None:
            nonlocal terminal
            if adm.max_queue is not None \
                    and tenant_depth.get(r.tenant, 0) >= adm.max_queue:
                r.status = "shed"
                r.error = RequestShedError(
                    f"tenant {r.tenant!r} queue full "
                    f"({adm.max_queue} pending)", uid=r.uid, model=r.model)
                events.append(FleetEvent(t, "-", "shed",
                                         f"queue full (tenant {r.tenant})",
                                         uids=(r.uid,), model=r.model))
                terminal += 1
                return
            if r.deadline_s is not None and adm.predictive_shedding:
                best = t + self.models[r.model].wave_cost(1).total_s
                if best > r.deadline_s:
                    r.status = "shed"
                    r.error = RequestShedError(
                        f"cost model predicts deadline miss: best-case "
                        f"finish {best:.6f}s > deadline "
                        f"{r.deadline_s:.6f}s", uid=r.uid, model=r.model)
                    events.append(FleetEvent(
                        t, "-", "shed", "predicted deadline miss",
                        uids=(r.uid,), model=r.model))
                    terminal += 1
                    return
            if place(r, t) is None:
                quarantine_lost(r, t, "no surviving replica at admission")

        mesh_plans.append((0.0, replan(
            self.n_replicas, model_parallel=self.mesh_model_parallel,
            global_batch=self.mesh_global_batch,
            pod_size=self.mesh_pod_size).data, 0, "initial"))

        guard = 0
        max_iters = (128 + 16 * n * (rec.max_retries + 2)
                     + 64 * (len(kills) + len(partitions)))
        while terminal < n:
            guard += 1
            if guard > max_iters:          # never wedge, even on a bug
                raise ServeError(
                    f"fleet scheduler exceeded {max_iters} iterations "
                    f"with {n - terminal} request(s) unresolved — "
                    "scheduling invariant broken")
            # -- next modeled instant anything can happen -------------------
            nxt: list[float] = []
            for st in states.values():
                if st.usable() and st.pending_n():
                    nxt.append(st.conv_free)
            if i < n:
                nxt.append(undisp[i].arrival_s)
            if retry_heap:
                nxt.append(retry_heap[0][0])
            for t_kill in kills.values():
                nxt.append(t_kill)
            for w, (rid, s, e) in enumerate(partitions):
                if part_done[w] or not states[rid].alive:
                    continue
                if e <= now:
                    part_done[w] = True
                    continue
                for t in (s, s + rec.heartbeat_timeout_s, e):
                    if t > now:
                        nxt.append(t)
            if not nxt:
                # nothing can ever happen again: quarantine the rest
                # (defensive — the drain paths should already have)
                for _, _, r in sorted(retry_heap):
                    if r.status == "pending":
                        quarantine_lost(r, now,
                                        "fleet idle with no live replica")
                retry_heap.clear()
                while i < n:
                    admit(undisp[i], max(now, undisp[i].arrival_s))
                    i += 1
                continue
            now = max(now, min(nxt))
            # -- replica deaths ---------------------------------------------
            for rid in [rid for rid, t in kills.items() if t <= now]:
                fire_kill(rid, kills[rid])
            # -- arrivals / retries -----------------------------------------
            while i < n and undisp[i].arrival_s <= now:
                admit(undisp[i], undisp[i].arrival_s)
                i += 1
            while retry_heap and retry_heap[0][0] <= now:
                t_r, _, r = heapq.heappop(retry_heap)
                if place(r, t_r) is None:
                    quarantine_lost(r, t_r,
                                    "no surviving replica for retry")
            # -- heartbeats: every live replica beats unless partitioned ----
            for st in states.values():
                if st.alive and not partitioned(st.rid, now):
                    beats.beat(st.rid, now)
            failed_now = beats.failed(now)
            for rid in failed_now:
                st = states[rid]
                if st.alive and not st.suspect:
                    st.suspect = True
                    events.append(FleetEvent(
                        now, rid, "suspect",
                        f"no heartbeat for > "
                        f"{rec.heartbeat_timeout_s * 1e6:.0f}us "
                        "(partitioned?)"))
                    drain_queue(st, now, f"replica {rid} suspected")
                    do_replan(now, f"{rid} suspect")
            for st in states.values():
                if st.alive and st.suspect and st.rid not in failed_now:
                    st.suspect = False
                    events.append(FleetEvent(
                        now, st.rid, "rejoin",
                        "heartbeats resumed; replica back in rotation"))
                    do_replan(now, f"{st.rid} rejoined")
            # -- dispatch one wave ------------------------------------------
            ready = [st for st in states.values()
                     if st.usable() and st.pending_n()
                     and st.conv_free <= now]
            if not ready:
                continue
            st = min(ready, key=lambda s: (s.conv_free, s.index))
            rid = st.rid
            cands = {m: q for m, q in st.pending.items() if q}
            chosen = self.policy.pick(now, cands, self._cost)
            zm = self.models[chosen]
            queue = self.policy.wave_order(st.pending[chosen])

            # -- cooperative sharded wave (the shard_waves lane) ------------
            # The fleet-wide queue of the chosen model exceeding one
            # replica's planner micro-batch is the modeled crossover
            # trigger (perf_model.fleet_shard_crossover_batch breaks
            # even one row past a full microbatch wave): instead of
            # fanning independent per-replica waves, cut ONE wave of up
            # to data x bb rows from every free healthy replica's queue
            # and run it across the mesh.  Below data=2 the lane
            # degrades to the per-replica path with a typed event,
            # never an error.
            merged: list[ZooRequest] = []
            participants: list[_ReplicaState] = []
            if self.shard_waves:
                participants = sorted(
                    (s for s in states.values()
                     if s.usable() and s.conv_free <= now),
                    key=lambda s: s.index)
                merged = self.policy.wave_order(
                    [r for p in participants for r in p.pending[chosen]])
            if self.shard_waves and len(merged) > zm.microbatch:
                if len(participants) < 2:
                    events.append(FleetEvent(
                        now, rid, "shard_fallback",
                        "mesh below data=2 "
                        f"({len(participants)} usable replica(s) free); "
                        "cooperative wave falls back to the per-replica "
                        "lane", model=chosen))
                else:
                    shard_rids = tuple(s.rid for s in participants)
                    data = len(participants)
                    cut = zm.sharded_microbatch(data)
                    wave = merged[:cut]
                    cut_ids = {id(r) for r in wave}
                    for p in participants:
                        p.pending[chosen] = [
                            r for r in p.pending[chosen]
                            if id(r) not in cut_ids]
                    for r in wave:
                        tenant_depth[r.tenant] -= 1
                    cost = zm.sharded_wave_cost(len(wave),
                                                data).as_wave_cost()
                    attempt = self._attempt_idx
                    self._attempt_idx += 1
                    faults = inj.wave_faults(st.index, attempt) \
                        if inj is not None else None
                    kind = faults.kind if faults is not None else "none"
                    uids = tuple(r.uid for r in wave)
                    stall = faults.stall_factor if kind == "stall" else 1.0
                    timed_out = stall >= rec.wave_timeout_factor
                    eff = cost.scaled(min(stall,
                                          rec.wave_timeout_factor)) \
                        if stall != 1.0 else cost
                    conv_done = now + eff.conv_s
                    fc_start = max(conv_done,
                                   max(p.fc_free for p in participants))
                    fc_done = fc_start + eff.fc_s

                    victims = [(kills[p.rid], p.rid) for p in participants
                               if p.rid in kills
                               and now < kills[p.rid] <= fc_done]
                    if victims:
                        # a participant dies mid-wave: abort the whole
                        # cooperative wave, re-shard its rows over the
                        # survivors, retry with backoff
                        t_kill, dead_rid = min(victims)
                        events.append(FleetEvent(
                            t_kill, dead_rid, "shard_abort",
                            f"participant {dead_rid} died mid-wave; "
                            f"cooperative data={data} wave aborted",
                            uids=uids, attempt=attempt, model=chosen))
                        decisions.append(FleetWaveDecision(
                            index=len(decisions), t_s=now, replica=rid,
                            model=chosen, uids=uids, batch=len(wave),
                            conv_s=eff.conv_s, fc_s=eff.fc_s,
                            fault="replica_dead", stall_factor=stall,
                            shards=shard_rids))
                        attempts.append(FleetWaveAttempt(
                            attempt, rid, chosen, list(wave), faults,
                            deliver=(), execute=False,
                            shards=shard_rids))
                        for p in participants:
                            p.waves += 1
                        fire_kill(dead_rid, t_kill)
                        survivors = [p.rid for p in participants
                                     if states[p.rid].usable()]
                        try:
                            asg = reshard_wave(uids, survivors)
                        except InsufficientReplicasError as e:
                            events.append(FleetEvent(
                                t_kill, "-", "replan_failed",
                                f"reshard: {e.message}", uids=uids,
                                attempt=attempt, model=chosen))
                        else:
                            resharded.update(
                                {u: r for r, us in asg.assignment
                                 for u in us})
                            events.append(FleetEvent(
                                t_kill, dead_rid, "reshard",
                                "in-flight wave re-sharded over "
                                f"data={asg.data}: " + " ".join(
                                    f"{r}x{len(us)}"
                                    for r, us in asg.assignment),
                                uids=uids, attempt=attempt,
                                model=chosen))
                        fail_wave(wave, dead_rid, chosen, t_kill,
                                  "replica_dead", attempt)
                        continue

                    # the cooperative wave occupies every participant
                    for p in participants:
                        p.conv_free = max(conv_done, fc_start)
                        p.fc_free = fc_done
                        p.busy_s += eff.total_s
                        p.waves += 1

                    if timed_out:
                        events.append(FleetEvent(
                            now, rid, "timeout",
                            f"stall x{stall:g} >= timeout factor "
                            f"{rec.wave_timeout_factor:g}, sharded "
                            "wave aborted", uids=uids, attempt=attempt,
                            model=chosen))
                        decisions.append(FleetWaveDecision(
                            index=len(decisions), t_s=now, replica=rid,
                            model=chosen, uids=uids, batch=len(wave),
                            conv_s=eff.conv_s, fc_s=eff.fc_s,
                            fault="timeout", stall_factor=stall,
                            shards=shard_rids))
                        attempts.append(FleetWaveAttempt(
                            attempt, rid, chosen, list(wave), faults,
                            deliver=(), execute=False,
                            shards=shard_rids))
                        fail_wave(wave, rid, chosen, fc_done,
                                  "timeout", attempt)
                        continue

                    for p in participants:
                        if not partitioned(p.rid, fc_done):
                            beats.beat(p.rid, fc_done)
                    verdict = monitors[rid].observe(attempt, stall)
                    if verdict == "straggler":
                        events.append(FleetEvent(
                            fc_done, rid, "stall",
                            f"straggler verdict: x{stall:g} modeled "
                            "sharded wave time", uids=uids,
                            attempt=attempt, model=chosen))
                    for r in wave:
                        r.dispatch_s, r.finish_s = now, fc_done
                        r.status = "served"
                        r.replica = rid
                    terminal += len(wave)
                    decisions.append(FleetWaveDecision(
                        index=len(decisions), t_s=now, replica=rid,
                        model=chosen, uids=uids, batch=len(wave),
                        conv_s=eff.conv_s, fc_s=eff.fc_s, fault=kind,
                        stall_factor=stall, shards=shard_rids))
                    attempts.append(FleetWaveAttempt(
                        attempt, rid, chosen, list(wave), faults,
                        deliver=uids, shards=shard_rids))
                    continue

            wave, rest = queue[:zm.microbatch], queue[zm.microbatch:]
            st.pending[chosen] = rest
            for r in wave:
                tenant_depth[r.tenant] -= 1
            cost = zm.wave_cost(len(wave))
            attempt = self._attempt_idx
            self._attempt_idx += 1
            faults: ReplicaFaults | None = None
            if inj is not None:
                faults = inj.wave_faults(st.index, attempt)
            kind = faults.kind if faults is not None else "none"
            uids = tuple(r.uid for r in wave)
            stall = faults.stall_factor if kind == "stall" else 1.0
            timed_out = stall >= rec.wave_timeout_factor
            eff = cost.scaled(min(stall, rec.wave_timeout_factor)) \
                if stall != 1.0 else cost
            conv_done = now + eff.conv_s
            fc_start = max(conv_done, st.fc_free)
            fc_done = fc_start + eff.fc_s

            t_kill = kills.get(rid)
            if t_kill is not None and now < t_kill <= fc_done:
                # the replica dies mid-wave: the wave is lost with it
                events.append(FleetEvent(
                    t_kill, rid, "replica_dead",
                    "replica died mid-wave; in-flight wave lost",
                    uids=uids, attempt=attempt, model=chosen))
                decisions.append(FleetWaveDecision(
                    index=len(decisions), t_s=now, replica=rid,
                    model=chosen, uids=uids, batch=len(wave),
                    conv_s=eff.conv_s, fc_s=eff.fc_s,
                    fault="replica_dead", stall_factor=stall))
                attempts.append(FleetWaveAttempt(
                    attempt, rid, chosen, list(wave), faults,
                    deliver=(), execute=False))
                st.waves += 1
                fire_kill(rid, t_kill)
                fail_wave(wave, rid, chosen, t_kill, "replica_dead",
                          attempt)
                continue

            # the wave runs to completion (cleanly, late, or aborted)
            st.conv_free = max(conv_done, fc_start)
            st.fc_free = fc_done
            st.busy_s += eff.total_s
            st.waves += 1

            if timed_out:
                events.append(FleetEvent(
                    now, rid, "timeout",
                    f"stall x{stall:g} >= timeout factor "
                    f"{rec.wave_timeout_factor:g}, wave aborted",
                    uids=uids, attempt=attempt, model=chosen))
                decisions.append(FleetWaveDecision(
                    index=len(decisions), t_s=now, replica=rid,
                    model=chosen, uids=uids, batch=len(wave),
                    conv_s=eff.conv_s, fc_s=eff.fc_s, fault="timeout",
                    stall_factor=stall))
                attempts.append(FleetWaveAttempt(
                    attempt, rid, chosen, list(wave), faults,
                    deliver=(), execute=False))
                fail_wave(wave, rid, chosen, fc_done, "timeout", attempt)
                continue

            if not partitioned(rid, fc_done):
                beats.beat(rid, fc_done)
            verdict = monitors[rid].observe(attempt, stall)
            if verdict == "straggler":
                events.append(FleetEvent(
                    fc_done, rid, "stall",
                    f"straggler verdict: x{stall:g} modeled wave time",
                    uids=uids, attempt=attempt, model=chosen))
            for r in wave:
                r.dispatch_s, r.finish_s = now, fc_done
                r.status = "served"
                r.replica = rid
            terminal += len(wave)
            decisions.append(FleetWaveDecision(
                index=len(decisions), t_s=now, replica=rid, model=chosen,
                uids=uids, batch=len(wave), conv_s=eff.conv_s,
                fc_s=eff.fc_s, fault=kind, stall_factor=stall))
            attempts.append(FleetWaveAttempt(
                attempt, rid, chosen, list(wave), faults, deliver=uids))
        return decisions, attempts, events, states, mesh_plans

    # -- execution (real kernels on replica lanes, bitwise parity) ----------
    def _execute(self, attempts: list[FleetWaveAttempt],
                 events: list[FleetEvent]) -> None:
        """Run every completed attempt through its replica's lane — the
        zoo executor lifted per replica, with the same ``isfinite``
        integrity guard and never-wedge discipline (an executor that
        raises quarantines the attempt's requests with a typed
        ``ServeError``; nothing is re-run elsewhere).  Each lane stacks
        the requests' host images and copies them to its device."""
        for a in attempts:
            if not a.execute:
                continue
            if a.shards:
                self._execute_sharded(a, events)
                continue
            srv = self._lane(a.replica, a.model)
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
                        r.status = "quarantined"
                        r.error = ServeError(
                            f"wave execution raised {type(e).__name__}: "
                            f"{e}", uid=r.uid, model=a.model)
                        events.append(FleetEvent(
                            -1.0, a.replica, "quarantine",
                            f"executor raised {type(e).__name__}",
                            uids=(r.uid,), attempt=a.index,
                            model=a.model))
                continue
            deliver = set(a.deliver)
            for r, eu in zip(a.requests, exec_uids):
                done = completed.get(eu)
                if done is None:
                    if r.uid in deliver:
                        r.status = "quarantined"
                        r.error = ServeError(
                            "executor returned no completion for the "
                            "request's wave row", uid=r.uid,
                            model=a.model)
                        events.append(FleetEvent(
                            -1.0, a.replica, "quarantine",
                            "executor lost a wave row", uids=(r.uid,),
                            attempt=a.index, model=a.model))
                    continue
                logits = np.asarray(done.logits)
                if not bool(np.isfinite(logits).all()):
                    if r.uid in deliver:
                        r.status = "quarantined"
                        r.error = CorruptOutputError(
                            "non-finite logits at the integrity guard",
                            uid=r.uid, model=a.model)
                        events.append(FleetEvent(
                            -1.0, a.replica, "quarantine",
                            "integrity guard: genuine non-finite "
                            "logits", uids=(r.uid,), attempt=a.index,
                            model=a.model))
                    continue
                if r.uid in deliver:
                    r.logits, r.done = logits, True

    def _execute_sharded(self, a: FleetWaveAttempt,
                         events: list[FleetEvent]) -> None:
        """Run one cooperative wave over the participants' mesh: the
        row batch is placed on the ``("data",)`` axis
        (:func:`~repro_torch.distributed.sharding.shard_wave_rows`, which
        pads non-divisible batches with zero rows), and each device's
        block is dealt to the participants on that device, which run one
        forward each of at most a micro-batch
        (:func:`cooperative_blocks`) — the rows a replica of a real mesh
        holds.  So every forward takes the path of an ordinary wave (an
        FC layer stays below the planner's flip batch, where one forward
        over the whole wave could cross it onto another kernel), and each
        served row stays **bitwise equal** to the single-device unbatched
        forward.  The rows are concatenated in order.  Same ``isfinite``
        guard and never-wedge discipline as the per-replica executor."""
        m = self.models[a.model]
        deliver = set(a.deliver)
        try:
            mesh = self.shard_mesh(a.shards)
            x = torch.from_numpy(np.stack([np.asarray(r.image)
                                           for r in a.requests])
                                 ).to(m.server.dtype)
            blocks, rows = shard_wave_rows(x, mesh)
            eng = m.server.engine
            outs = []
            for dev, block in zip(mesh.devices, blocks):
                parts = sum(self.replica_device(self.replica_ids.index(p))
                            == dev for p in a.shards)
                params = self._params_on(a.model, dev)
                start = 0
                for n in cooperative_blocks(len(block), parts,
                                            m.microbatch):
                    with eng.tracing() as tr, \
                            eng.tagging(stage="shard", wave=a.index):
                        y = cnn.cnn_forward(m.spec.net, params,
                                            block[start:start + n], eng=eng)
                    outs.append(y.cpu())
                    self.shard_traces.append(tr)
                    start += n
            logits = torch.cat(outs)[:rows]
            if logits.dtype == torch.bfloat16:
                logits = logits.float()
            logits = logits.numpy()
        except Exception as e:          # noqa: BLE001 — never wedge
            for r in a.requests:
                if r.uid in deliver:
                    r.status = "quarantined"
                    r.error = ServeError(
                        f"sharded wave execution raised "
                        f"{type(e).__name__}: {e}", uid=r.uid,
                        model=a.model)
                    events.append(FleetEvent(
                        -1.0, a.replica, "quarantine",
                        f"sharded executor raised {type(e).__name__}",
                        uids=(r.uid,), attempt=a.index, model=a.model))
            return
        for i, r in enumerate(a.requests):
            row = logits[i]
            if not bool(np.isfinite(row).all()):
                if r.uid in deliver:
                    r.status = "quarantined"
                    r.error = CorruptOutputError(
                        "non-finite logits at the integrity guard",
                        uid=r.uid, model=a.model)
                    events.append(FleetEvent(
                        -1.0, a.replica, "quarantine",
                        "integrity guard: genuine non-finite logits",
                        uids=(r.uid,), attempt=a.index, model=a.model))
                continue
            if r.uid in deliver:
                r.logits, r.done = row, True

    # -- drain ---------------------------------------------------------------
    def serve(self, *, execute: bool = True) -> FleetReport:
        """Drain every queue: schedule (modeled time, device-count
        independent), execute on replica lanes (``execute=False`` for
        modeled-only analysis), account.  Every admitted request ends in
        exactly one terminal status."""
        queued = [r for q in self.tenants.values() for r in q]
        for q in self.tenants.values():
            q.clear()
        rejected, self._rejected = self._rejected, []
        requests = queued + rejected
        if not requests:
            return FleetReport(self.placement.name, self.policy.name,
                               self.n_replicas, (), (), (), 0.0, (), (),
                               ())
        decisions: list[FleetWaveDecision] = []
        attempts: list[FleetWaveAttempt] = []
        events: list[FleetEvent] = []
        states: dict[str, _ReplicaState] = {}
        mesh_plans: list[tuple[float, int, int, str]] = []
        for r in rejected:
            events.append(FleetEvent(r.arrival_s, "-", "shed",
                                     "stale deadline at submit",
                                     uids=(r.uid,), model=r.model))
        if queued:
            decisions, attempts, sched_events, states, mesh_plans = \
                self._schedule(queued)
            events.extend(sched_events)
        if execute:
            self._execute(attempts, events)
        terminal = ("served", "shed", "quarantined")
        for r in requests:
            if r.status not in terminal:      # defensive zero-unaccounted
                r.status = "quarantined"
                r.error = ServeError(
                    "internal: request left non-terminal by the fleet "
                    "scheduler", uid=r.uid, model=r.model)
                events.append(FleetEvent(-1.0, r.replica or "-",
                                         "quarantine",
                                         "internal: non-terminal request",
                                         uids=(r.uid,), model=r.model))
        served = [r for r in requests if r.status == "served"]
        makespan = (max(r.finish_s for r in served)
                    - min(r.arrival_s for r in requests)) if served else 0.0
        by_tenant: dict[str, list[ZooRequest]] = {}
        for r in requests:
            by_tenant.setdefault(r.tenant, []).append(r)
        served_by_replica: dict[str, int] = {}
        for r in served:
            if r.replica is not None:
                served_by_replica[r.replica] = \
                    served_by_replica.get(r.replica, 0) + 1
        per_replica = tuple(
            ReplicaStats(replica=rid, waves=st.waves,
                         served=served_by_replica.get(rid, 0),
                         busy_s=st.busy_s, drained_away=st.drained_away,
                         state=st.state_name)
            for rid, st in sorted(states.items()))
        return FleetReport(
            placement=self.placement.name,
            policy=self.policy.name,
            n_replicas=self.n_replicas,
            requests=tuple(sorted(requests, key=lambda r: r.uid)),
            decisions=tuple(decisions),
            events=tuple(events),
            makespan_s=makespan,
            per_replica=per_replica,
            per_tenant=tuple(
                ModelZooServer._tenant_stats(t, rs)
                for t, rs in sorted(by_tenant.items())),
            mesh_plans=tuple(mesh_plans))
