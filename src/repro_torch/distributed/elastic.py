"""Elastic scaling on the port: re-plan the mesh after node loss and resume
(pure Python, a copy of the JAX package's ``distributed/elastic.py``).

Public API
----------
* :func:`replan` — given the surviving chip count, propose the best
  (pod, data, model) :class:`MeshPlan` that (a) keeps the
  model-parallel degree (weights must still fit), (b) keeps batch
  divisibility, and (c) wastes the fewest survivors.
* :func:`degrade_sequence` — :func:`replan` after each of a sequence of
  failure events, with the breaking event attached to the error.
* :func:`reshard_wave` / :class:`ShardAssignment` — re-shard the rows
  of an **in-flight cooperative wave** over the surviving replicas when
  the mesh shrinks mid-wave (the fleet's ``shard_waves`` lane aborts
  the wave, calls this, and retries the pinned assignment with
  backoff).  :func:`replan` proposes a *shape*; :func:`reshard_wave`
  moves the actual wave *state*.

Invariants
----------
* Elasticity is a planning problem: a plan is a shape, and the caller
  (the fleet's control plane) rebuilds what runs on it.
* When survivors fall below the model-parallel degree (or a wave has no
  surviving replica) no usable mesh exists; both :func:`replan` and
  :func:`reshard_wave` raise the typed
  :class:`~repro_torch.serve.errors.InsufficientReplicasError` (not a bare
  ``assert``, which would vanish under ``python -O``) so fleet control
  planes can branch on it.
* :func:`reshard_wave` is a pure function of (uids, survivors): the
  same inputs always produce the same row assignment, keeping the
  fleet's decision log deterministic across retries.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serve.errors import InsufficientReplicasError


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    pods: int
    data: int
    model: int
    used_chips: int
    wasted_chips: int

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.pods, self.data, self.model) if self.pods > 1 \
            else (self.data, self.model)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.pods > 1 \
            else ("data", "model")


def replan(surviving_chips: int, *, model_parallel: int = 16,
           global_batch: int = 256, pod_size: int = 256) -> MeshPlan:
    """Largest usable mesh under the survivors.

    Keeps `model` fixed (sharded weights must fit exactly as before), and
    finds the largest power-of-two data degree that divides the batch.

    Raises :class:`~repro_torch.serve.errors.InsufficientReplicasError` when
    the survivors cannot hold even one model-parallel weight shard.
    """
    if surviving_chips < model_parallel:
        raise InsufficientReplicasError(
            f"{surviving_chips} survivor(s) cannot fit the "
            f"model-parallel degree {model_parallel}: weights no longer "
            "fit on any degraded mesh",
            survivors=surviving_chips, required=model_parallel)
    pods = max(1, surviving_chips // pod_size)
    per_pod = surviving_chips // pods
    data = 1
    while (data * 2 * model_parallel <= per_pod
           and global_batch % (data * 2 * pods) == 0):
        data *= 2
    used = pods * data * model_parallel
    return MeshPlan(pods, data, model_parallel, used,
                    surviving_chips - used)


@dataclasses.dataclass(frozen=True)
class ShardAssignment:
    """A deterministic row -> replica map for one re-sharded wave.

    ``assignment`` pairs each surviving replica id with the (ordered)
    request uids it now owns; ``shards`` is the per-replica row count
    (the new ``ceil``-balanced shard sizes).  Built by
    :func:`reshard_wave`, logged verbatim in the fleet's ``reshard``
    event, and honored by the retry path instead of free placement."""
    uids: tuple
    survivors: tuple[str, ...]
    assignment: tuple[tuple[str, tuple], ...]

    @property
    def data(self) -> int:
        """The surviving data-parallel degree."""
        return len(self.survivors)

    @property
    def shards(self) -> tuple[int, ...]:
        return tuple(len(u) for _, u in self.assignment)

    def replica_of(self, uid) -> str:
        for rid, uids in self.assignment:
            if uid in uids:
                return rid
        raise KeyError(f"uid {uid!r} not in this wave")


def reshard_wave(uids, survivors) -> ShardAssignment:
    """Re-shard an in-flight wave's rows over the surviving replicas.

    Rows are dealt round-robin over the survivors in sorted-replica
    order, so the assignment is a pure function of its inputs and every
    shard is within one row of balanced.  Raises the typed
    :class:`~repro_torch.serve.errors.InsufficientReplicasError` when no
    replica survives (the caller then quarantines the wave's requests
    instead of wedging)."""
    uids = tuple(uids)
    order = tuple(sorted(survivors))
    if not uids:
        raise ValueError("reshard_wave needs at least one request uid")
    if not order:
        raise InsufficientReplicasError(
            f"no surviving replica to re-shard a {len(uids)}-row wave "
            "over", survivors=0, required=1)
    rows: dict[str, list] = {rid: [] for rid in order}
    for i, uid in enumerate(uids):
        rows[order[i % len(order)]].append(uid)
    return ShardAssignment(
        uids=uids, survivors=order,
        assignment=tuple((rid, tuple(rows[rid])) for rid in order
                         if rows[rid]))


def degrade_sequence(start_chips: int, failures: list[int],
                     **kw) -> list[MeshPlan]:
    """Plans after each failure event (failures = chips lost per event).

    When a failure event drops survivors below the model-parallel floor,
    the :class:`~repro_torch.serve.errors.InsufficientReplicasError` is
    re-raised with the event index and loss history attached so the
    caller sees *which* failure broke the fleet, not just that one did.
    """
    plans = []
    chips = start_chips
    for event, lost in enumerate(failures):
        chips -= lost
        try:
            plans.append(replan(chips, **kw))
        except InsufficientReplicasError as e:
            raise InsufficientReplicasError(
                f"failure event {event} (lost {lost} chips, {chips} "
                f"remain of {start_chips}): {e.message}",
                survivors=e.survivors, required=e.required) from e
    return plans
