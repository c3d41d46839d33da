"""The replica fleet on the port: N data-parallel replicas of the model zoo
(AlexNet fp32, VGG-16 fp32, AlexNet int8) behind one
:class:`~repro_torch.serve.fleet.FleetServer`, in the JAX package's fleet
benchmark's seven configurations — the counterpart of
``benchmarks/fleet_serve.py``, which the port may not import.

    PYTHONPATH=src python -m repro_torch.launch.fleet            # the card
    PYTHONPATH=src python -m repro_torch.launch.fleet --device cpu \\
        --width-mult 0.125 --reduced-res --max-batch 4

By default the models run at full width and native resolution (227² and
224²) on the card, waves of up to 64; the second line is the reference
benchmark's own execution geometry on the CPU.  The configurations:

* ``healthy_r1`` / ``healthy_r2`` / ``healthy_r4`` and ``round_robin_r4``
  — modeled only: throughput scaling and the load-aware placement against
  rotation; ``healthy_r1``'s decisions must equal ``ModelZooServer``'s;
* ``chaos_r4`` — executed: ``r1`` dies mid-trace, ``r2``'s heartbeats
  drop for a window, seeded stalls throughout;
* ``sharded_r4`` — executed: the trace's payloads as a ``t = 0`` burst
  with cooperative sharded waves on, each tenant's burst raised past its
  model's micro-batch and the int8 tenant's to a full ``data = 4``
  cooperative wave (:func:`burst_sizes`);
* ``sharded_chaos_r4`` — executed: the same burst with ``r2`` killed
  halfway through the first cooperative wave, the time read from
  ``sharded_r4``'s modeled decisions (:func:`shard_kill_time`).

The modeled seconds are the reference's TPU cost model (they order the
waves; they are not times of the card).  Every served row of an executed
configuration is checked bitwise against its model's unbatched forward.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.launch.zoo import (MODELS, REDUCED_RES, poisson_arrivals,
                                    seeded_payloads)
from repro_torch.models import cnn
from repro_torch.serve.faults import ReplicaChaosConfig, ReplicaFaultInjector
from repro_torch.serve.fleet import PLACEMENTS, FleetReport, FleetServer
from repro_torch.serve.zoo import (FIFOPolicy, ModelZooServer,
                                   RecoveryConfig, ZooModel, ZooRequest,
                                   build_zoo)

#: the reference benchmark's seeded compute-bound trace per tier:
#: (tenant, model, n, rate_hz)
TRACE_TIERS = {
    "fast": {"seed": 0, "tenants": [
        ("web", "alexnet", 8, 60000.0),
        ("batch", "vgg16", 8, 40000.0),
        ("rt", "alexnet-int8", 6, 50000.0)]},
    "full": {"seed": 0, "tenants": [
        ("web", "alexnet", 14, 60000.0),
        ("batch", "vgg16", 12, 40000.0),
        ("rt", "alexnet-int8", 10, 50000.0)]},
}
#: chaos_r4's replica chaos plan (ReplicaChaosConfig): r1 dies mid-trace,
#: r2's heartbeats drop for a window, seeded stalls below and above the
#: timeout factor
CHAOS = {
    "seed": 11,
    "stall_rate": 0.2,
    "stall_factors": (3.0, 24.0),
    "kills": (("r1", 2.5e-4),),
    "partitions": (("r2", 4.0e-4, 1.1e-3),),
}
#: the reference benchmark's sharded-chaos plan, tuned to its trace and
#: micro-batch 4; this launcher places the kill from the modeled
#: decisions instead (shard_kill_time)
SHARD_CHAOS = {"kills": (("r2", 3.0e-4),)}
#: the cooperative data degree of the sharded configurations
SHARD_DATA = 4
#: the reference benchmark's micro-batch (its MAX_BATCH)
REF_MICROBATCH = 4
#: recovery policy (RecoveryConfig)
RECOVERY = {
    "max_retries": 2,
    "wave_timeout_factor": 8.0,
    "heartbeat_timeout_s": 2.0e-4,
}
#: the fleet shape of every configuration
FLEET = {"mesh_model_parallel": 1, "mesh_global_batch": 64,
         "mesh_pod_size": 64}
#: the configurations that execute on the kernels
EXECUTED = ("chaos_r4", "sharded_r4", "sharded_chaos_r4")
#: the stream each configuration serves (:func:`traces`): the scaling
#: configurations a compute-bound one; chaos_r4 the reference's, to which
#: CHAOS's times are tuned; the sharded ones a burst
CONFIG_TRACE = {"healthy_r1": "dense", "healthy_r2": "dense",
                "healthy_r4": "dense", "round_robin_r4": "dense",
                "chaos_r4": "reference", "sharded_r4": "burst",
                "sharded_chaos_r4": "burst"}


def density(models: list[ZooModel]) -> int:
    """How many times denser than the reference's the trace must be to
    stay compute-bound: the models' micro-batch over the reference
    benchmark's (``REF_MICROBATCH``), so that each reference request
    becomes a micro-batch's worth of requests.  1 at the reference's own
    geometry."""
    return max(1, min(m.microbatch for m in models) // REF_MICROBATCH)


def make_trace(tier: str, res: dict[str, int], *, dense: int = 1,
               sizes: dict[str, int] | None = None) -> list[dict]:
    """The reference benchmark's seeded request stream as plain dicts
    (uid, tenant, model, arrival_s, deadline_s, image), images sized by
    ``res``, each tenant's count and rate times ``dense``; ``sizes``
    overrides tenants' counts (the seeded arrivals and payloads of a
    longer stream start with the shorter one's)."""
    cfg = TRACE_TIERS[tier]
    raw = []
    for ti, (tenant, model, n, rate) in enumerate(cfg["tenants"]):
        n = (sizes or {}).get(tenant, n * dense)
        r = res["vgg16" if model == "vgg16" else "alexnet"]
        arrivals = poisson_arrivals(n, rate * dense,
                                    seed=cfg["seed"] + ti)
        images = seeded_payloads(n, (r, r, 3), seed=300 + cfg["seed"] + ti)
        for a, img in zip(arrivals, images):
            raw.append({"tenant": tenant, "model": model, "arrival_s": a,
                        "deadline_s": None, "image": img})
    raw.sort(key=lambda q: (q["arrival_s"], q["tenant"]))
    for uid, q in enumerate(raw):
        q["uid"] = uid
    return raw


def burst_sizes(models: list[ZooModel], tier: str) -> dict[str, int]:
    """Each tenant's request count for the sharded configurations: its
    count in the dense stream, raised to one past its model's micro-batch so
    that a cooperative wave forms, and the int8 tenant's to a full
    ``SHARD_DATA`` cooperative wave (``sharded_microbatch``)."""
    by_name = {m.name: m for m in models}
    out = {}
    for tenant, model, n, _ in TRACE_TIERS[tier]["tenants"]:
        m = by_name[model]
        want = m.sharded_microbatch(SHARD_DATA) \
            if m.spec.weight_dtype == "int8" else m.microbatch + 1
        out[tenant] = max(n * density(models), want)
    return out


def traces(models: list[ZooModel], tier: str,
           res: dict[str, int]) -> dict[str, list[dict]]:
    """The three streams the configurations serve (``CONFIG_TRACE``):
    ``"dense"``, the reference's :func:`density` times over; the
    ``"reference"`` stream itself; and the ``"burst"``, the
    :func:`burst_sizes` stream collapsed to ``t = 0``."""
    return {
        "dense": make_trace(tier, res, dense=density(models)),
        "reference": make_trace(tier, res),
        "burst": [dict(q, arrival_s=0.0) for q in make_trace(
            tier, res, sizes=burst_sizes(models, tier))],
    }


def requests(trace: list[dict]) -> list[ZooRequest]:
    """Fresh :class:`ZooRequest`s for one drain of ``trace``."""
    return [ZooRequest(uid=q["uid"], model=q["model"], image=q["image"],
                       tenant=q["tenant"], arrival_s=q["arrival_s"],
                       deadline_s=q["deadline_s"]) for q in trace]


def build_fleet(models: list[ZooModel], *, n_replicas: int,
                chaos: dict | None = None,
                placement: str = "least-loaded",
                shard_waves: bool = False) -> FleetServer:
    faults = ReplicaFaultInjector(ReplicaChaosConfig(**chaos)) \
        if chaos else None
    return FleetServer(models, n_replicas=n_replicas, policy=FIFOPolicy(),
                       placement=PLACEMENTS[placement](), faults=faults,
                       recovery=RecoveryConfig(**RECOVERY),
                       shard_waves=shard_waves, **FLEET)


def run_config(models: list[ZooModel], trace: list[dict], *,
               execute: bool = False, **kw) -> FleetReport:
    """One fleet drain of ``trace`` (``kw``: :func:`build_fleet`'s)."""
    fleet = build_fleet(models, **kw)
    for r in requests(trace):
        fleet.submit(r)
    return fleet.serve(execute=execute)


def shard_kill_time(report: FleetReport) -> float:
    """Halfway through the first cooperative wave of ``report``'s modeled
    decisions: where ``sharded_chaos_r4`` kills ``r2``."""
    d = next(d for d in report.decisions if d.sharded)
    return d.t_s + d.total_s / 2


def config_kwargs(kill_s: float) -> dict[str, dict]:
    """:func:`run_config`'s arguments for each configuration (each serves
    the stream ``CONFIG_TRACE`` names)."""
    return {
        "healthy_r1": dict(n_replicas=1),
        "healthy_r2": dict(n_replicas=2),
        "healthy_r4": dict(n_replicas=4),
        "round_robin_r4": dict(n_replicas=4, placement="round-robin"),
        "chaos_r4": dict(n_replicas=4, chaos=CHAOS),
        "sharded_r4": dict(n_replicas=4, shard_waves=True),
        "sharded_chaos_r4": dict(n_replicas=4, shard_waves=True,
                                 chaos={"kills": (("r2", kill_s),)}),
    }


def zoo_witness(models: list[ZooModel], trace: list[dict]):
    """The same trace through the single-pipeline zoo scheduler,
    modeled: what ``healthy_r1`` must equal."""
    zoo = ModelZooServer(models, policy=FIFOPolicy())
    for r in requests(trace):
        zoo.submit(r)
    return zoo.serve(execute=False)


def decision_key(d) -> tuple:
    return (d.t_s, d.model, d.uids, d.batch, d.conv_s, d.fc_s,
            tuple(getattr(d, "shards", ())))


def schedule_key(report: FleetReport) -> tuple:
    """The whole modeled outcome of a drain, for replay comparisons."""
    return (report.decisions, report.events, report.mesh_plans,
            report.per_replica, report.per_tenant, report.makespan_s,
            tuple((r.uid, r.status, r.replica, r.retries)
                  for r in report.requests))


def fleet_checks(reports: dict[str, FleetReport], zoo_report,
                 replays: dict[str, FleetReport], n: dict[str, int]
                 ) -> list[tuple[str, bool, str]]:
    """The reference benchmark's checks, as (name, passed, detail):
    accounting, scaling, the zoo witness, the chaos plan's kill, drain,
    replan and partition, replay determinism, the cooperative waves and
    the mid-wave kill.  ``n`` is each configuration's request count."""
    out = []
    for name, rep in reports.items():
        out.append((f"{name}: zero unaccounted",
                    not rep.unaccounted and len(rep.requests) == n[name],
                    f"{len(rep.served)} served, {len(rep.shed)} shed, "
                    f"{len(rep.quarantined)} quarantined of {n[name]}"))
    h1, h4 = reports["healthy_r1"], reports["healthy_r4"]
    scaling = h1.makespan_s / h4.makespan_s
    out.append(("modeled throughput scales >= 1.5x from 1 to 4 replicas",
                scaling >= 1.5, f"{scaling:.4f}x"))
    out.append(("healthy_r1's decisions equal ModelZooServer's",
                [decision_key(d) for d in h1.decisions]
                == [decision_key(d) for d in zoo_report.decisions],
                f"{len(h1.decisions)} fleet, {len(zoo_report.decisions)} "
                "zoo decisions"))
    ch = reports["chaos_r4"]
    killed = dict(CHAOS["kills"])
    served = {r.uid for r in ch.served}
    drained = [u for u in ch.drained_uids if u in served]
    out.append(("chaos_r4: a request drained off the dead replica is "
                "served by a peer",
                any(e.kind == "kill" for e in ch.events) and bool(drained),
                f"drained and served {drained}"))
    late = [d for d in ch.decisions
            if d.replica in killed and d.t_s > killed[d.replica]]
    shrunk = [p for p in ch.mesh_plans[1:] if p[1] < ch.mesh_plans[0][1]]
    out.append(("chaos_r4: replan proposes a shrunk mesh, nothing "
                "dispatches on the dead replica",
                not late and bool(shrunk) and all(
                    s.state == "dead" for s in ch.per_replica
                    if s.replica in killed),
                f"mesh plans {list(ch.mesh_plans)}"))
    out.append(("chaos_r4: the partition gives a suspect and a rejoin",
                any(e.kind == "suspect" and e.replica == "r2"
                    for e in ch.events)
                and any(e.kind == "rejoin" and e.replica == "r2"
                        for e in ch.events), "r2"))
    for name, rep in replays.items():
        out.append((f"{name}: the modeled schedule replays bit-identically",
                    schedule_key(rep) == schedule_key(reports[name]), ""))
    coop = [d for d in reports["sharded_r4"].decisions if d.sharded]
    out.append(("sharded_r4: cooperative waves over 4 replicas",
                any(len(d.shards) == SHARD_DATA for d in coop),
                f"batches {[(d.model, d.batch) for d in coop]}"))
    sc = reports["sharded_chaos_r4"]
    kinds = {e.kind for e in sc.events}
    out.append(("sharded_chaos_r4: shard_abort, reshard, retries, "
                "everything served",
                {"shard_abort", "reshard", "kill", "retry"} <= kinds
                and len(sc.served) == n["sharded_chaos_r4"],
                f"events {sorted(kinds)}"))
    return out


def unbatched_logits(models: list[ZooModel], report: FleetReport,
                     cache: dict | None = None) -> dict[int, np.ndarray]:
    """uid -> the served request's model's unbatched forward (one image,
    on the model's device), fp32 numpy; ``cache`` is filled and reused."""
    by_name = {m.name: m for m in models}
    refs = {} if cache is None else cache
    for r in report.served:
        if r.uid in refs:
            continue
        m = by_name[r.model]
        x = torch.from_numpy(np.asarray(r.image)[None]).to(
            m.server.device, m.server.dtype)
        y = cnn.cnn_forward(m.spec.net, m.params, x, eng=m.server.engine)
        refs[r.uid] = y.float().cpu().numpy()[0]
    return refs


def parity_failures(report: FleetReport, refs: dict) -> list[int]:
    """Served uids whose logits are non-finite or not bitwise equal to
    their unbatched forward; and any request quarantined by the executor
    (an event stamped -1 s)."""
    bad = [r.uid for r in report.served
           if r.logits is None or not np.isfinite(r.logits).all()
           or not np.array_equal(r.logits, refs[r.uid])]
    bad += [u for e in report.events if e.t_s == -1.0 for u in e.uids]
    return bad


@torch.no_grad()
def main(argv: list[str] | None = None) -> dict[str, FleetReport]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tier", choices=sorted(TRACE_TIERS), default="fast")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="admission cap per model server")
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--reduced-res", action="store_true",
                    help="serve AlexNet at 67x67 and VGG-16 at 32x32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    res = REDUCED_RES if args.reduced_res else {"alexnet": 227,
                                                "vgg16": 224}
    models = build_zoo(MODELS, seed=0, in_res=res,
                       width_mult=args.width_mult, max_batch=args.max_batch,
                       device=args.device)
    streams = traces(models, args.tier, res)
    print(f"== the fleet ({args.tier} tier): streams "
          f"{ {k: len(v) for k, v in streams.items()} }, density "
          f"{density(models)}, bursts {burst_sizes(models, args.tier)} ==")
    for m in models:
        print(f"  {m.name:13s} micro-batch {m.microbatch}, cooperative "
              f"wave up to {m.sharded_microbatch(SHARD_DATA)} rows")
    kill = shard_kill_time(run_config(models, streams["burst"],
                                      n_replicas=4, shard_waves=True))
    print(f"  sharded_chaos_r4 kills r2 at {kill:.9g} s (modeled), halfway "
          "through the first cooperative wave")
    kwargs = config_kwargs(kill)
    reports, refs = {}, {k: {} for k in streams}
    for name, kw in kwargs.items():
        tr = CONFIG_TRACE[name]
        execute = name in EXECUTED
        t0 = time.perf_counter()
        reports[name] = rep = run_config(models, streams[tr],
                                         execute=execute, **kw)
        if execute and models[0].server.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print("\n".join("  " + line
                        for line in rep.summary().splitlines()))
        print(f"  ({name}: modeled TPU makespan "
              f"{rep.makespan_s * 1e6:.1f} us, not a card time)")
        if execute:
            print(f"  {name}: {len(rep.served)} images in {wall:.3f} s on "
                  f"the host clock = {len(rep.served) / wall:.1f} images/s "
                  f"({models[0].server.device})")
            bad = parity_failures(rep, unbatched_logits(models, rep,
                                                        refs[tr]))
            if bad:
                raise SystemExit(f"{name}: uids {bad[:8]} not bitwise "
                                 "their unbatched forward")
            print(f"  {name}: every served row finite and bitwise equal "
                  "to its model's unbatched forward")
    replays = {name: run_config(models, streams[CONFIG_TRACE[name]],
                                **kwargs[name])
               for name in ("chaos_r4", "sharded_r4")}
    n = {name: len(streams[tr]) for name, tr in CONFIG_TRACE.items()}
    checks = fleet_checks(reports, zoo_witness(models, streams["dense"]),
                          replays, n)
    failed = [c for c in checks if not c[1]]
    for name, ok, detail in checks:
        print(f"  [{'ok' if ok else 'FAILED'}] {name}"
              f"{f' ({detail})' if detail else ''}")
    if failed:
        raise SystemExit(f"{len(failed)} fleet check(s) failed")
    return reports


if __name__ == "__main__":
    main()
