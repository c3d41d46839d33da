"""Multi-tenant model-zoo serving on the port: three compiled variants
(AlexNet fp32, VGG-16 fp32, AlexNet int8) behind one
:class:`~repro_torch.serve.zoo.ModelZooServer`, one seeded three-tenant
trace replayed under each scheduling policy (fifo, smf, edf) — the
counterpart of the JAX package's ``examples/zoo_serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.zoo            # the card
    PYTHONPATH=src python -m repro_torch.launch.zoo --device cpu \\
        --width-mult 0.125 --reduced-res --per-tenant 2

By default the models run at full width and native resolution (227² and
224²) on the card; ``--device cpu`` runs the kernels' plain versions,
``--width-mult`` and ``--reduced-res`` (the example's 67² and 32²) shrink
execution.  The modeled wave costs always price the full-geometry models
on the JAX package's TPU roofline: they order the waves, they are not
times of the card.  Every request's logits are checked bitwise against
its model's own unbatched forward.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_zoo_model
from repro_torch.models import cnn
from repro_torch.serve.faults import ChaosConfig, FaultInjector
from repro_torch.serve.zoo import (POLICIES, AdmissionConfig, EDFPolicy,
                                   ModelZooServer, RecoveryConfig, ZooModel,
                                   ZooRequest, build_zoo)

MODELS = ("alexnet", "vgg16", "alexnet-int8")
#: the reference example's reduced serving resolutions
REDUCED_RES = {"alexnet": 67, "vgg16": 32}


def make_requests(per_tenant: int, res: dict[str, int], *,
                  seed: int = 0) -> list[ZooRequest]:
    """The reference example's mixed tagged stream: a VGG-16 batch tenant
    front-loading expensive waves, a deadline-tight int8 realtime tenant
    and a best-effort fp32 web tenant, images random-normal from
    ``seed``."""
    rng = np.random.default_rng(seed)
    plan = [("batch", "vgg16", "vgg16", None),
            ("rt", "alexnet-int8", "alexnet", 1.0e-3),
            ("web", "alexnet", "alexnet", 3.0e-3)]
    reqs, uid = [], 0
    for i in range(per_tenant):
        for tenant, model, net, rel_dl in plan:
            t = i * 2.0e-4 + {"batch": 0.0, "rt": 0.5e-4,
                              "web": 1.0e-4}[tenant]
            r = res[net]
            reqs.append(ZooRequest(
                uid=uid, model=model, tenant=tenant,
                image=rng.standard_normal((r, r, 3)).astype(np.float32),
                arrival_s=t,
                deadline_s=None if rel_dl is None else t + rel_dl))
            uid += 1
    return reqs


# ---------------------------------------------------------------------------
# the chaos trace: a copy of the JAX package's chaos benchmark
# (benchmarks/chaos_serve.py and benchmarks/timing.py), seed for seed
# ---------------------------------------------------------------------------
#: per tier: (tenant, model, n, rate_hz, relative deadline s | None, burst
#: start s | None); "burst" is an overload clump aimed at admission
#: control, "batch" is VGG-16 (no int8 sibling: no fallback)
CHAOS_TIERS = {
    "fast": {"seed": 0, "tenants": [
        ("web", "alexnet", 5, 6000.0, 4.0e-3, None),
        ("burst", "alexnet", 8, 60000.0, 1.6e-3, 4.0e-4),
        ("rt", "alexnet-int8", 5, 5000.0, 1.2e-3, None),
        ("batch", "vgg16", 4, 9000.0, None, None)]},
    "full": {"seed": 0, "tenants": [
        ("web", "alexnet", 10, 6000.0, 4.0e-3, None),
        ("burst", "alexnet", 14, 60000.0, 1.6e-3, 4.0e-4),
        ("rt", "alexnet-int8", 10, 5000.0, 1.2e-3, None),
        ("batch", "vgg16", 8, 9000.0, None, None)]},
}
#: the seeded fault mix (ChaosConfig): every fault kind, a stall menu
#: straddling the timeout factor (4x: a straggler; 24x: aborted, retried)
CHAOS = {"seed": 17, "dispatch_fail_rate": 0.12, "corrupt_rate": 0.14,
         "stall_rate": 0.22, "stall_factors": (4.0, 24.0),
         "corrupt_frac": 0.5}
#: the recovery policy (RecoveryConfig)
RECOVERY = {"max_retries": 2, "wave_timeout_factor": 8.0, "fail_after": 2,
            "recover_after": 2}
#: admission control of the protected configuration (AdmissionConfig)
ADMISSION = {"max_queue": 4, "predictive_shedding": True}


def seeded_payloads(n: int, shape, *, seed: int = 0) -> list[np.ndarray]:
    """``n`` standard-normal fp32 payloads of ``shape``, one PCG64 stream."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tuple(shape)).astype(np.float32)
            for _ in range(n)]


def poisson_arrivals(n: int, rate_hz: float, *,
                     seed: int = 0) -> tuple[float, ...]:
    """``n`` Poisson arrival times at ``rate_hz`` (seeded PCG64)."""
    gaps = np.random.default_rng(seed).exponential(1.0 / rate_hz, size=n)
    return tuple(float(t) for t in np.cumsum(gaps))


def burst_arrivals(n: int, rate_hz: float, *, start_s: float = 0.0,
                   seed: int = 0) -> tuple[float, ...]:
    """A Poisson clump at ``rate_hz`` whose first request lands at
    ``start_s``."""
    base = poisson_arrivals(n, rate_hz, seed=seed)
    return tuple(start_s + (t - base[0]) for t in base)


def chaos_trace(tier: str, res: dict[str, int]) -> list[ZooRequest]:
    """The chaos benchmark's seeded stream (overload burst included) plus
    one request whose deadline passed before it arrived, as requests with
    ``res``-sized images, uids in arrival order."""
    cfg = CHAOS_TIERS[tier]
    raw = []
    for ti, (tenant, model, n, rate, rel_dl, burst) in \
            enumerate(cfg["tenants"]):
        net = get_zoo_model(model).net
        if burst is None:
            arrivals = poisson_arrivals(n, rate, seed=cfg["seed"] + ti)
        else:
            arrivals = burst_arrivals(n, rate, start_s=burst,
                                      seed=cfg["seed"] + ti)
        images = seeded_payloads(n, (res[net], res[net], 3),
                                 seed=200 + cfg["seed"] + ti)
        for a, img in zip(arrivals, images):
            raw.append(dict(tenant=tenant, model=model, arrival_s=a,
                            deadline_s=None if rel_dl is None
                            else a + rel_dl, image=img))
    r = res["alexnet"]
    raw.append(dict(tenant="stale", model="alexnet", arrival_s=2.0e-4,
                    deadline_s=1.0e-4,
                    image=seeded_payloads(1, (r, r, 3), seed=999)[0]))
    raw.sort(key=lambda q: (q["arrival_s"], q["tenant"]))
    return [ZooRequest(uid=uid, **q) for uid, q in enumerate(raw)]


def chaos_server(models: list[ZooModel], *,
                 protected: bool) -> ModelZooServer:
    """EDF under the seeded fault mix with retry and degrade; admission
    control (bounded queues, predictive shedding) when ``protected``."""
    return ModelZooServer(
        models, policy=EDFPolicy(),
        faults=FaultInjector(ChaosConfig(**CHAOS)),
        admission=AdmissionConfig(**ADMISSION) if protected
        else AdmissionConfig(),
        recovery=RecoveryConfig(**RECOVERY))


def fresh(models: list[ZooModel]) -> list[ZooModel]:
    """The same variants (the same parameters, engines and devices) on new
    wave executors, for a new server to replay a trace whose uids the old
    ones have consumed."""
    return [ZooModel(m.spec, m.params, in_res=m.server.in_res,
                     width_mult=m.server.width_mult,
                     max_batch=m.server.max_batch, engine=m.server.engine,
                     device=m.server.device) for m in models]


@torch.no_grad()
def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-tenant", type=int, default=4,
                    help="requests per tenant (3 tenants)")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="admission cap per model server")
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--reduced-res", action="store_true",
                    help="serve AlexNet at 67x67 and VGG-16 at 32x32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--chaos", action="store_true",
                    help="then serve the chaos trace (full tier) under "
                         "edf with admission control, faults injected")
    args = ap.parse_args(argv)
    res = REDUCED_RES if args.reduced_res else {"alexnet": 227,
                                                "vgg16": 224}
    print("== the zoo: three compiled variants, one engine ==")
    models = build_zoo(MODELS, seed=0, in_res=res,
                       width_mult=args.width_mult, max_batch=args.max_batch,
                       device=args.device)
    for m in models:
        c = m.wave_cost(m.microbatch)
        print(f"  {m.name:13s} net={m.spec.net:8s} "
              f"weights={m.spec.weight_dtype:7s} micro-batch="
              f"{m.microbatch} modeled TPU wave (b={m.microbatch}): "
              f"conv {c.conv_s * 1e6:7.1f}us / fc {c.fc_s * 1e6:7.1f}us")

    refs = {}
    for policy_name in ("fifo", "smf", "edf"):
        print(f"\n== policy: {policy_name} ==")
        zoo = ModelZooServer(models, policy=POLICIES[policy_name]())
        reqs = make_requests(args.per_tenant, res)
        for r in reqs:
            zoo.submit(r)
        t0 = time.perf_counter()
        report = zoo.serve()
        wall = time.perf_counter() - t0
        for d in report.decisions:
            print(f"  wave {d.index}: t={d.t_s * 1e6:7.1f}us "
                  f"{d.model:13s} uids={list(d.uids)} (modeled conv "
                  f"{d.conv_s * 1e6:.0f}us, fc {d.fc_s * 1e6:.0f}us)")
        print("\n".join("  " + line
                        for line in report.summary().splitlines()))
        print(f"  served {len(report.served)} images in {wall:.3f} s on "
              f"the host clock ({len(report.served) / wall:.1f} images/s, "
              f"{models[0].server.device})")
        for r in report.requests:
            m = zoo.models[r.model]
            if r.uid not in refs:
                x = torch.from_numpy(r.image[None]).to(m.server.device)
                refs[r.uid] = cnn.cnn_forward(
                    m.spec.net, m.params, x,
                    eng=m.server.engine).cpu().numpy()[0]
            if not np.array_equal(r.logits, refs[r.uid]):
                raise SystemExit(f"uid {r.uid} logits drifted under "
                                 f"{policy_name}")
        print(f"  parity: all {len(report.requests)} requests bitwise-"
              "equal their model's unbatched forward")
        models = fresh(models)

    if args.chaos:
        print("\n== chaos: edf, admission control, seeded faults ==")
        modeled = chaos_server(fresh(models), protected=True)
        for r in chaos_trace("full", res):
            modeled.submit(r)
        want = modeled.serve(execute=False)
        zoo = chaos_server(models, protected=True)
        for r in chaos_trace("full", res):
            zoo.submit(r)
        report = zoo.serve()
        print("\n".join("  " + line
                        for line in report.summary().splitlines()))
        if outcome(report) != outcome(want):
            raise SystemExit("the executed chaos run differs from its "
                             "modeled schedule")
        print("  the executed run equals its modeled schedule: statuses, "
              "quarantines, degraded serves and events")


def outcome(report) -> tuple:
    """What a chaos drain decided, for comparing an executed run with its
    modeled schedule: statuses, quarantined uids, degraded serves, the
    event log."""
    return (tuple((r.uid, r.status, r.served_by) for r in report.requests),
            tuple(r.uid for r in report.quarantined),
            report.degraded_served, report.events)


if __name__ == "__main__":
    main()
