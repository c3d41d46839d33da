"""Deterministic, seeded wave-level chaos harness for the zoo serving
plane.

The MPNA paper validates *execution*, not just a cost model — so the
serving plane must keep its guarantees when execution misbehaves.  This
module injects the misbehaviour, reproducibly: every fault decision is a
pure function of ``(seed, wave-attempt index)``, so a chaos run's entire
event log — which waves stall, which logits corrupt, which dispatches
fail — is pinnable in tests, exactly like the healthy schedules.  The draws are
the JAX package's (the same numpy generator on the same seeds), so the
port's chaos runs equal the reference's event for event.

Fault kinds (wave-granular, matching the serving plane's failure modes):

* ``stall`` — the wave's wall time is ``k`` x its modeled
  :func:`~repro_torch.core.perf_model.zoo_wave_cost` stage costs.  Mild ``k``
  (below the server's ``wave_timeout_factor``) serves late and trips the
  :class:`~repro_torch.distributed.fault_tolerance.StepMonitor` straggler
  verdict; hard ``k`` is aborted at the timeout and retried;
* ``corrupt`` — NaN/Inf overwrite a deterministic subset of the wave's
  logit rows at the flush boundary, exercising the per-wave
  ``np.isfinite`` integrity guard;
* ``dispatch`` — the wave raises a transient
  :class:`~repro_torch.core.dataflow.PlanError` at dispatch before occupying
  either array.

The injector never touches the scheduler's clock or queues itself — the
:class:`~repro_torch.serve.zoo.ModelZooServer` consults it once per wave
attempt and applies its own recovery policy (retry with capped backoff,
quarantine, degrade), so the same seeded fault trace can be replayed
against different recovery configurations.

Replica-granular chaos (fleet level)
------------------------------------
:class:`ReplicaChaosConfig` / :class:`ReplicaFaultInjector` lift the
same discipline one level up, to the sharded fleet
(:class:`~repro_torch.serve.fleet.FleetServer`):

* ``kills`` — a replica dies at a configured modeled instant: its
  queued waves drain to surviving peers and its in-flight wave fails
  and retries elsewhere.  A kill landing inside a *cooperative sharded
  wave* (``shard_waves=True``) aborts the whole wave, re-shards its rows
  over the sorted survivors (:func:`~repro_torch.distributed.elastic
  .reshard_wave`) and retries with the standard backoff;
* ``partitions`` — a replica's heartbeats are dropped for a modeled
  window: the failure detector declares it suspect (drain + replan),
  and when the partition heals it beats again and rejoins;
* transient device ``stall`` — seeded per ``(replica, attempt)``: the
  wave's stage times stretch ``k``x, tripping the per-replica
  :class:`~repro_torch.distributed.fault_tolerance.StepMonitor` (mild ``k``)
  or the wave timeout (hard ``k``).

Kill and partition schedules are explicit configuration (a chaos *plan*,
replayable by construction); only the stall verdict is drawn, from
``(seed, replica_index, attempt)`` — so a fleet chaos trace is exactly
as pinnable as a wave-level one.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dataflow import PlanError

__all__ = ["ChaosConfig", "WaveFaults", "FaultInjector",
           "ReplicaChaosConfig", "ReplicaFaults", "ReplicaFaultInjector"]


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Per-wave fault probabilities and shapes.  The rates partition one
    uniform draw per wave attempt (``dispatch`` first, then ``corrupt``,
    then ``stall``), so they must sum to at most 1.

    ``stall_factors`` is the menu of stall multipliers a stalled wave
    samples from — include one below the server's ``wave_timeout_factor``
    for survivable stragglers and one above it for hard timeouts.
    ``corrupt_frac`` is the fraction of the wave's rows (at least one)
    the corruption overwrites."""
    seed: int = 0
    dispatch_fail_rate: float = 0.0
    corrupt_rate: float = 0.0
    stall_rate: float = 0.0
    stall_factors: tuple[float, ...] = (4.0,)
    corrupt_frac: float = 0.5

    def __post_init__(self) -> None:
        total = self.dispatch_fail_rate + self.corrupt_rate + self.stall_rate
        if not 0.0 <= total <= 1.0:
            raise ValueError(f"fault rates must sum to [0, 1], got {total}")
        if any(r < 0 for r in (self.dispatch_fail_rate, self.corrupt_rate,
                               self.stall_rate)):
            raise ValueError("fault rates must be non-negative")
        if not self.stall_factors or min(self.stall_factors) <= 1.0:
            raise ValueError("stall_factors must all be > 1.0")
        if not 0.0 < self.corrupt_frac <= 1.0:
            raise ValueError(f"corrupt_frac must be in (0, 1], "
                             f"got {self.corrupt_frac}")


@dataclasses.dataclass(frozen=True)
class WaveFaults:
    """The injector's verdict for one wave attempt: exactly one fault
    kind (or none).  ``stall_factor`` multiplies both modeled stage
    times; ``corrupt_rows`` are the wave-local row indices whose logits
    the chaos layer overwrites with NaN/Inf."""
    attempt: int
    kind: str                               # "none"|"stall"|"corrupt"|"dispatch"
    stall_factor: float = 1.0
    corrupt_rows: tuple[int, ...] = ()

    @property
    def is_clean(self) -> bool:
        return self.kind == "none"


_CLEAN = WaveFaults(attempt=-1, kind="none")


class FaultInjector:
    """Derives each wave attempt's fault from ``(seed, attempt)`` alone.

    ``wave_faults(attempt, batch)`` is the scheduler-side oracle (modeled
    time); ``corrupt_array``/``raise_dispatch`` are the execution-side
    realizations of the same decisions — both sides consult the same
    attempt index, so the modeled schedule and the real kernels always
    agree on which waves misbehave."""

    def __init__(self, config: ChaosConfig) -> None:
        self.config = config

    def _rng(self, attempt: int) -> np.random.Generator:
        return np.random.default_rng((self.config.seed, attempt))

    def wave_faults(self, attempt: int, batch: int) -> WaveFaults:
        """The seeded fault verdict for wave ``attempt`` of ``batch``
        rows.  One uniform draw partitions the fault kinds so per-kind
        rates are exactly the configured ones."""
        c = self.config
        rng = self._rng(attempt)
        u = float(rng.random())
        if u < c.dispatch_fail_rate:
            return WaveFaults(attempt=attempt, kind="dispatch")
        u -= c.dispatch_fail_rate
        if u < c.corrupt_rate:
            k = max(1, min(batch, round(c.corrupt_frac * batch)))
            rows = tuple(sorted(int(r) for r in
                                rng.choice(batch, size=k, replace=False)))
            return WaveFaults(attempt=attempt, kind="corrupt",
                              corrupt_rows=rows)
        u -= c.corrupt_rate
        if u < c.stall_rate:
            factor = c.stall_factors[int(rng.integers(len(c.stall_factors)))]
            return WaveFaults(attempt=attempt, kind="stall",
                              stall_factor=float(factor))
        return dataclasses.replace(_CLEAN, attempt=attempt)

    # -- execution-side realizations ----------------------------------------
    @staticmethod
    def corrupt_array(logits: np.ndarray) -> np.ndarray:
        """The corruption a faulted row's logits suffer at the flush
        boundary: every entry NaN, the first +Inf (both non-finite
        species, so the guard must catch either)."""
        out = np.full_like(np.asarray(logits, dtype=np.float32), np.nan)
        if out.size:
            out.flat[0] = np.inf
        return out

    @staticmethod
    def dispatch_error(attempt: int, model: str) -> PlanError:
        """The transient dispatch failure a faulted wave raises — a real
        :class:`~repro_torch.core.dataflow.PlanError`, so the server's recovery
        path is exercised against the same exception type the planner
        itself throws."""
        return PlanError("chaos: injected transient dispatch failure",
                         op=f"zoo.wave[{model}]@attempt{attempt}")


# ---------------------------------------------------------------------------
# replica-granular chaos: the fleet-level fault plane
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ReplicaChaosConfig:
    """Fleet-level chaos plan.  ``kills`` are ``(replica_id, t_s)`` death
    instants (modeled seconds — the replica is gone for good);
    ``partitions`` are ``(replica_id, start_s, end_s)`` windows during
    which the replica's heartbeats are dropped (it keeps computing;
    the failure detector must suspect it and the fleet must survive the
    false positive).  ``stall_rate`` draws a transient device stall per
    wave attempt from ``(seed, replica_index, attempt)``;
    ``stall_factors`` is the stall-multiplier menu, exactly as in
    :class:`ChaosConfig`."""
    seed: int = 0
    stall_rate: float = 0.0
    stall_factors: tuple[float, ...] = (4.0,)
    kills: tuple[tuple[str, float], ...] = ()
    partitions: tuple[tuple[str, float, float], ...] = ()

    def __post_init__(self) -> None:
        if not 0.0 <= self.stall_rate <= 1.0:
            raise ValueError(f"stall_rate must be in [0, 1], "
                             f"got {self.stall_rate}")
        if self.stall_rate > 0 and (not self.stall_factors
                                    or min(self.stall_factors) <= 1.0):
            raise ValueError("stall_factors must all be > 1.0")
        for rid, t in self.kills:
            if t < 0:
                raise ValueError(f"kill time for {rid!r} must be >= 0, "
                                 f"got {t}")
        if len({rid for rid, _ in self.kills}) != len(self.kills):
            raise ValueError("at most one kill per replica")
        for rid, s, e in self.partitions:
            if not 0 <= s < e:
                raise ValueError(f"partition window for {rid!r} must "
                                 f"satisfy 0 <= start < end, got "
                                 f"[{s}, {e})")


@dataclasses.dataclass(frozen=True)
class ReplicaFaults:
    """The stall verdict for one wave attempt on one replica (death and
    partition are schedule-driven, not drawn — see
    :class:`ReplicaChaosConfig`)."""
    replica_index: int
    attempt: int
    kind: str                               # "none" | "stall"
    stall_factor: float = 1.0

    @property
    def is_clean(self) -> bool:
        return self.kind == "none"


class ReplicaFaultInjector:
    """Derives fleet-level faults from the chaos plan: kill/partition
    lookups are pure config reads, and the per-attempt stall verdict is a
    pure function of ``(seed, replica_index, attempt)`` — so the fleet
    scheduler's whole event log replays bit-for-bit."""

    def __init__(self, config: ReplicaChaosConfig) -> None:
        self.config = config
        self._kills = dict(config.kills)

    def _rng(self, replica_index: int, attempt: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.config.seed, replica_index, attempt))

    def wave_faults(self, replica_index: int, attempt: int) -> ReplicaFaults:
        """The seeded stall verdict for wave ``attempt`` dispatched on
        replica ``replica_index``."""
        c = self.config
        if c.stall_rate <= 0.0:
            return ReplicaFaults(replica_index, attempt, "none")
        rng = self._rng(replica_index, attempt)
        if float(rng.random()) < c.stall_rate:
            factor = c.stall_factors[int(rng.integers(len(c.stall_factors)))]
            return ReplicaFaults(replica_index, attempt, "stall",
                                 stall_factor=float(factor))
        return ReplicaFaults(replica_index, attempt, "none")

    def kill_time(self, replica_id: str) -> float | None:
        """When (if ever) this replica dies, in modeled seconds."""
        return self._kills.get(replica_id)

    def partition_windows(self, replica_id: str
                          ) -> tuple[tuple[float, float], ...]:
        """This replica's heartbeat-drop windows, in config order."""
        return tuple((s, e) for rid, s, e in self.config.partitions
                     if rid == replica_id)

    def partitioned(self, replica_id: str, t_s: float) -> bool:
        """Whether a heartbeat from this replica at ``t_s`` is dropped
        (windows are half-open: ``start <= t < end``)."""
        return any(s <= t_s < e
                   for s, e in self.partition_windows(replica_id))
