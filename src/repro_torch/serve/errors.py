"""Typed serving-error hierarchy — the failure causes a zoo caller can
branch on.

The planner already raises a typed :class:`~repro_torch.core.dataflow.PlanError`
for *planning* failures; this module adds the serving-plane causes so a
request that cannot be served ends as a **typed error result** (attached
to the request, accounted in the :class:`~repro_torch.serve.zoo.ZooReport`)
instead of a silent drop or a wedged queue:

* :class:`ServeError` — base class; also the terminal error for repeated
  transient dispatch failures (e.g. an injected/real ``PlanError`` at
  wave dispatch) once the retry budget is spent;
* :class:`WaveTimeoutError` — the wave's wall time blew the server's
  timeout factor x the modeled :func:`~repro_torch.core.perf_model.zoo_wave_cost`
  (a hard straggler) and the retry budget is spent;
* :class:`RequestShedError` — admission control rejected the request
  (bounded per-tenant queue, or the cost model predicts the deadline
  cannot be met);
* :class:`StaleDeadlineError` — a :class:`RequestShedError` for the
  degenerate case: the deadline was already in the past at arrival;
* :class:`CorruptOutputError` — the per-wave ``np.isfinite`` integrity
  guard rejected the request's logits (NaN/Inf) and the retry budget is
  spent;
* :class:`ReplicaLostError` — the replica holding the request died (or
  every replica did) and the fleet could not re-place it within the
  retry budget: the replica-level analogue of a wave failure;
* :class:`InsufficientReplicasError` — elastic replanning found fewer
  survivors than the model-parallel degree (the sharded weights no
  longer fit), so no degraded mesh exists.  Raised by
  :func:`repro_torch.distributed.elastic.replan` — a *typed* error rather
  than a bare ``assert`` so it survives ``python -O``.

``PlanError`` is re-exported so ``from repro_torch.serve.errors import ...``
covers every failure cause one ``except`` ladder needs.
"""
from __future__ import annotations

from repro_torch.core.dataflow import PlanError

__all__ = ["ServeError", "WaveTimeoutError", "RequestShedError",
           "StaleDeadlineError", "CorruptOutputError",
           "ReplicaLostError", "InsufficientReplicasError", "PlanError"]


class ServeError(RuntimeError):
    """A request could not be served.  Carries the request uid and the
    model variant it was routed to so quarantine logs are actionable."""

    def __init__(self, message: str, *, uid: int | None = None,
                 model: str = "") -> None:
        self.uid = uid
        self.model = model
        detail = []
        if uid is not None:
            detail.append(f"uid={uid}")
        if model:
            detail.append(f"model={model!r}")
        super().__init__(
            f"{message} [{', '.join(detail)}]" if detail else message)

    @property
    def message(self) -> str:
        return str(self.args[0]) if self.args else ""


class WaveTimeoutError(ServeError):
    """The wave stalled past ``wave_timeout_factor`` x its modeled cost
    (and, as a terminal request error, the retry budget is spent)."""


class RequestShedError(ServeError):
    """Admission control rejected the request: bounded queue overflow or
    a cost-model-predicted deadline miss.  Shed requests never occupy an
    array — the typed result is the whole response."""


class StaleDeadlineError(RequestShedError):
    """The request's absolute deadline was already in the past when it
    arrived — scheduling it could only ever produce a guaranteed miss,
    so it is rejected at admission."""


class CorruptOutputError(ServeError):
    """The wave-level ``isfinite`` integrity guard found NaN/Inf in this
    request's logits; serving them would return garbage with a 200."""


class ReplicaLostError(ServeError):
    """The replica this request was placed on (or retried onto) died, and
    no surviving peer could absorb it within the retry budget — the
    fleet-level analogue of :class:`WaveTimeoutError`.  Carries the
    replica id so drain/quarantine logs are actionable."""

    def __init__(self, message: str, *, uid: int | None = None,
                 model: str = "", replica: str = "") -> None:
        self.replica = replica
        if replica:
            message = f"{message} [replica={replica}]"
        super().__init__(message, uid=uid, model=model)


class InsufficientReplicasError(ServeError):
    """Elastic replanning cannot produce any usable mesh: the survivor
    count fell below the model-parallel degree, so the sharded weights no
    longer fit.  ``survivors``/``required`` let control planes report the
    exact deficit."""

    def __init__(self, message: str, *, survivors: int | None = None,
                 required: int | None = None) -> None:
        self.survivors = survivors
        self.required = required
        super().__init__(message)
