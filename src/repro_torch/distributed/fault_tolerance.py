"""Fault-tolerance primitives: straggler detection, step deadlines,
heartbeat bookkeeping.

On a real fleet these hooks attach to the launcher's control plane; the
policy logic — what counts as a straggler, when a hang becomes a restart,
which nodes survive a degraded remesh — is hardware-independent and lives
here, a copy of the JAX package's, unit-tested on the CPU.  The zoo
scheduler (:mod:`repro_torch.serve.zoo`) runs them on its modeled clock.
"""
from __future__ import annotations

import dataclasses
import time


class StepMonitor:
    """Flags steps whose wall time exceeds ``factor`` x running median."""

    def __init__(self, factor: float = 3.0, warmup: int = 5,
                 window: int = 50):
        self.factor = factor
        self.warmup = warmup
        self.window = window
        self._times: list[float] = []

    def median(self) -> float:
        if not self._times:
            return float("nan")
        s = sorted(self._times)
        return s[len(s) // 2]

    def observe(self, step: int, dt: float) -> str:
        verdict = "ok"
        if len(self._times) >= self.warmup and dt > self.factor * self.median():
            verdict = "straggler"
        else:
            self._times.append(dt)
            self._times = self._times[-self.window:]
        return verdict


@dataclasses.dataclass
class Heartbeat:
    node: str
    last_seen: float


class UnknownNodeError(KeyError):
    """A heartbeat arrived for a node the tracker was never told about.

    Raised explicitly (instead of the bare ``KeyError`` a dict miss used
    to leak) so control planes can branch on it — e.g. auto-register the
    node via :meth:`HeartbeatTracker.register` on elastic scale-up."""

    def __init__(self, node: str, known: tuple[str, ...]) -> None:
        self.node = node
        self.known = known
        super().__init__(f"unknown node {node!r}; tracked: {known} "
                         "(register() it for elastic scale-up)")

    def __str__(self) -> str:            # KeyError quotes args[0] otherwise
        return self.args[0]


class HeartbeatTracker:
    """Deadline-based liveness: a node missing **more than** ``timeout``
    seconds of heartbeats is declared failed (exactly-at-deadline is
    still alive); the surviving set feeds elastic remesh.

    ``now`` defaults to the wall clock; pass it explicitly to run the
    tracker on a modeled/virtual clock (the zoo scheduler does — every
    call site stamps deterministic modeled seconds)."""

    def __init__(self, nodes: list[str], timeout: float = 60.0,
                 now: float | None = None):
        t0 = now if now is not None else time.monotonic()
        self.timeout = timeout
        self._beats: dict[str, Heartbeat] = {
            n: Heartbeat(n, t0) for n in nodes}

    def nodes(self) -> tuple[str, ...]:
        return tuple(self._beats)

    def register(self, node: str, now: float | None = None) -> None:
        """Start tracking ``node`` (late registration — elastic
        scale-up adds replicas after the tracker exists).  Registering a
        node already tracked just refreshes its heartbeat."""
        t0 = now if now is not None else time.monotonic()
        if node in self._beats:
            self._beats[node].last_seen = t0
        else:
            self._beats[node] = Heartbeat(node, t0)

    def deregister(self, node: str) -> None:
        """Stop tracking ``node`` — the elastic scale-*down* mirror of
        :meth:`register`.  A replica that was quarantined or declared
        dead must be drained from the tracker, or it keeps tripping
        :meth:`failed` (and shrinking :meth:`survivors`) forever even
        though the control plane already acted on it.  Deregistering a
        node the tracker never knew raises :class:`UnknownNodeError`."""
        if node not in self._beats:
            raise UnknownNodeError(node, self.nodes())
        del self._beats[node]

    def beat(self, node: str, now: float | None = None) -> None:
        hb = self._beats.get(node)
        if hb is None:
            raise UnknownNodeError(node, self.nodes())
        hb.last_seen = now if now is not None else time.monotonic()

    def failed(self, now: float | None = None) -> list[str]:
        now = now if now is not None else time.monotonic()
        return [n for n, hb in self._beats.items()
                if now - hb.last_seen > self.timeout]

    def survivors(self, now: float | None = None) -> list[str]:
        dead = set(self.failed(now))
        return [n for n in self._beats if n not in dead]


class StepDeadline:
    """Converts a hung step (dead collective) into a restart decision."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self._start: float | None = None

    def begin(self) -> None:
        self._start = time.monotonic()

    def expired(self, now: float | None = None) -> bool:
        if self._start is None:
            return False
        now = now if now is not None else time.monotonic()
        return (now - self._start) > self.deadline_s
