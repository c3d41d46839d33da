"""The fleet slice of the port on the CPU against the JAX package:
``FleetServer``'s modeled schedules equal to the reference's field for
field over the scenarios of the reference's fleet and sharded-wave tests
and the fleet benchmark's seven configurations; executed fleets bitwise
equal to the port's unbatched forward and within ``TOL_LOGITS`` of the
reference's logits; the device-facing parts (lazy devices, the mesh, lanes
sharing the zoo model's parameters and engine, the never-wedge executor);
and fault C7, a bf16 ``CNNServer`` delivering its logits.

The geometry is the reference tests': AlexNet and int8 AlexNet at width
0.0625, 67², ``max_batch=2``, seed-0 weights carried across by
``convert.py``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import Engine as REngine
from repro.models import cnn as rcnn
from repro.serve import cnn_server as rcs
from repro.serve import faults as rfaults
from repro.serve import fleet as rfleet
from repro.serve import zoo as rzoo
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_reference
from repro_torch.core.quant import quantize_cnn_params
from repro_torch.launch import fleet as tlaunch
from repro_torch.launch.zoo import MODELS, REDUCED_RES
from repro_torch.models import cnn as tcnn
from repro_torch.serve import cnn_server as tcs
from repro_torch.serve import errors as terr
from repro_torch.serve import faults as tfaults
from repro_torch.serve import fleet as tfleet
from repro_torch.serve import zoo as tzoo

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("alexnet", "alexnet-int8")
RES = {"alexnet": 67}
WIDTH = 0.0625
MAX_BATCH = 2
#: the port's plain versions against the reference's XLA backend
#: (tests/test_torch_zoo.py)
TOL_LOGITS = dict(rtol=2e-3, atol=2e-3)
#: bf16 logits: the reference's bf16 tolerance (tests/test_kernels.py)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)

REF = dict(fleet=rfleet, faults=rfaults, zoo=rzoo)
PORT = dict(fleet=tfleet, faults=tfaults, zoo=tzoo)


def plain(v):
    """A result of either package as plain nested tuples: dataclasses by
    class name and fields, containers element by element."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(
            (f.name, plain(getattr(v, f.name)))
            for f in dataclasses.fields(v))
    if isinstance(v, dict):
        return tuple(sorted((k, plain(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(plain(x) for x in v)
    return v


def outcome(rep) -> tuple:
    """Everything a fleet drain decided, as plain values."""
    reqs = tuple((r.uid, r.model, r.tenant, r.status, r.replica,
                  r.served_by, r.retries, r.dispatch_s, r.finish_s,
                  None if r.error is None else
                  (type(r.error).__name__, str(r.error)))
                 for r in rep.requests)
    return (rep.placement, rep.policy, rep.n_replicas, plain(rep.decisions),
            plain(rep.events), rep.mesh_plans, plain(rep.per_replica),
            plain(rep.per_tenant), rep.makespan_s, reqs,
            rep.drained_uids, rep.retry_count)


@pytest.fixture(scope="module")
def ref_models():
    return rzoo.build_zoo(NAMES, seed=0, in_res=RES, width_mult=WIDTH,
                          max_batch=MAX_BATCH, engine=REngine(backend="xla"))


@pytest.fixture(scope="module")
def port_models(ref_models):
    """The same variants on the CPU: fp32 weights carried across, the int8
    variant quantized by the port from the reference's own fp32 draw (bit
    for bit the reference's int8)."""
    out = []
    for i, m in enumerate(ref_models):
        if m.spec.weight_dtype == "int8":
            fp32 = rcnn.init_cnn(m.spec.net, jax.random.PRNGKey(i),
                                 in_res=RES[m.spec.net], width_mult=WIDTH)
            params = quantize_cnn_params(params_from_reference(
                fp32, device="cpu"))
        else:
            params = params_from_reference(m.params, device="cpu")
        out.append(tzoo.ZooModel(treg.get_zoo_model(m.name), params,
                                 in_res=RES[m.spec.net], width_mult=WIDTH,
                                 max_batch=MAX_BATCH, device="cpu"))
    return out


def img(seed=0, res=67):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((res, res, 3)).astype(np.float32)


def submit_n(mod, fleet, n, *, model="alexnet-int8", spacing=1e-3,
             tenant="t"):
    for k in range(n):
        fleet.submit(mod["zoo"].ZooRequest(
            uid=k, model=model, image=img(k), tenant=tenant,
            arrival_s=k * spacing))


def models_for(mod, ref_models, port_models, names=("alexnet-int8",)):
    ms = ref_models if mod is REF else port_models
    return [m for m in ms if m.name in names]


def int8(models):
    return next(m for m in models if m.name == "alexnet-int8")


def wave_s(models, batch=1):
    return int8(models).wave_cost(batch).total_s


# ---------------------------------------------------------------------------
# modeled schedules, field for field
# ---------------------------------------------------------------------------
def _fleet(mod, models, **kw):
    return mod["fleet"].FleetServer(models, policy=mod["zoo"].FIFOPolicy(),
                                    **kw)


def _chaos(mod, **cfg):
    return mod["faults"].ReplicaFaultInjector(
        mod["faults"].ReplicaChaosConfig(**cfg))


def sc_round_robin(mod, models):
    f = _fleet(mod, models, n_replicas=3,
               placement=mod["fleet"].RoundRobinPlacement())
    submit_n(mod, f, 7, spacing=0.0)
    return f


def sc_least_loaded(mod, models):
    f = _fleet(mod, models, n_replicas=2)
    submit_n(mod, f, 4, spacing=0.0)
    return f


def sc_single_replica(mod, models):
    f = _fleet(mod, models, n_replicas=1)
    for k in range(6):
        f.submit(mod["zoo"].ZooRequest(
            uid=k, model="alexnet" if k % 2 == 0 else "alexnet-int8",
            image=img(k), tenant=f"t{k % 2}", arrival_s=k * 2e-5))
    return f


def sc_kill_in_flight(mod, models):
    f = _fleet(mod, models, n_replicas=2,
               faults=_chaos(mod, kills=(("r0", 0.5 * wave_s(models)),)))
    submit_n(mod, f, 1)
    return f


def sc_kill_drains_queue(mod, models):
    f = _fleet(mod, models, n_replicas=2,
               faults=_chaos(mod, kills=(("r0", 1e-9),)))
    submit_n(mod, f, 6, spacing=0.0)
    return f


def sc_all_dead(mod, models):
    f = _fleet(mod, models, n_replicas=1,
               faults=_chaos(mod, kills=(("r0", 1e-9),)))
    submit_n(mod, f, 3, spacing=1e-4)
    return f


def sc_partition_rejoin(mod, models):
    f = _fleet(mod, models, n_replicas=2,
               faults=_chaos(mod, partitions=(("r1", 1e-4, 5e-4),)),
               recovery=mod["zoo"].RecoveryConfig(heartbeat_timeout_s=1e-4))
    submit_n(mod, f, 4, spacing=2e-4)
    return f


def sc_hard_stall(mod, models):
    f = _fleet(mod, models, n_replicas=1,
               faults=_chaos(mod, seed=5, stall_rate=1.0,
                             stall_factors=(24.0,)),
               recovery=mod["zoo"].RecoveryConfig(max_retries=1,
                                                  wave_timeout_factor=8.0))
    submit_n(mod, f, 1)
    return f


def sc_mild_stall(mod, models):
    f = _fleet(mod, models, n_replicas=1,
               faults=_chaos(mod, seed=5, stall_rate=1.0,
                             stall_factors=(3.0,)))
    submit_n(mod, f, 2)
    return f


def sc_mixed_chaos(mod, models):
    f = _fleet(mod, models, n_replicas=3,
               faults=_chaos(mod, seed=9, stall_rate=0.3,
                             stall_factors=(3.0, 24.0),
                             kills=(("r1", 3e-4),),
                             partitions=(("r0", 5e-4, 9e-4),)),
               recovery=mod["zoo"].RecoveryConfig(heartbeat_timeout_s=1e-4))
    submit_n(mod, f, 8, spacing=5e-5)
    return f


def sc_stale_deadline(mod, models):
    f = _fleet(mod, models, n_replicas=2)
    f.submit(mod["zoo"].ZooRequest(uid=0, model="alexnet-int8",
                                   image=img(0), tenant="t"))
    f.submit(mod["zoo"].ZooRequest(uid=1, model="alexnet-int8",
                                   image=img(1), tenant="t", arrival_s=2.0,
                                   deadline_s=1.0))
    return f


def sc_burst_cooperative(mod, models):
    f = _fleet(mod, models, n_replicas=4, shard_waves=True)
    submit_n(mod, f, 6, spacing=0.0)
    return f


def sc_shard_waves_off(mod, models):
    f = _fleet(mod, models, n_replicas=4)
    submit_n(mod, f, 6, spacing=0.0)
    return f


def sc_midwave_kill_reshard(mod, models):
    half = int8(models).sharded_wave_cost(6, 4).total_s / 2
    f = _fleet(mod, models, n_replicas=4, shard_waves=True,
               faults=_chaos(mod, kills=(("r2", half),)))
    submit_n(mod, f, 6, spacing=0.0)
    return f


def sc_midwave_kill_below_two(mod, models):
    half = int8(models).sharded_wave_cost(6, 2).total_s / 2
    f = _fleet(mod, models, n_replicas=2, shard_waves=True,
               faults=_chaos(mod, kills=(("r1", half),)))
    submit_n(mod, f, 6, spacing=0.0)
    return f


def sc_fallback_below_two(mod, models):
    f = _fleet(mod, models, n_replicas=1, shard_waves=True)
    submit_n(mod, f, 5, spacing=0.0)
    return f


def sc_sharded_stalls(mod, models):
    f = _fleet(mod, models, n_replicas=4, shard_waves=True,
               faults=_chaos(mod, seed=3, stall_rate=0.5,
                             stall_factors=(3.0, 24.0)))
    submit_n(mod, f, 12, spacing=0.0)
    return f


SCENARIOS = {
    "round_robin": sc_round_robin,
    "least_loaded": sc_least_loaded,
    "single_replica": sc_single_replica,
    "kill_in_flight": sc_kill_in_flight,
    "kill_drains_queue": sc_kill_drains_queue,
    "all_dead": sc_all_dead,
    "partition_rejoin": sc_partition_rejoin,
    "hard_stall": sc_hard_stall,
    "mild_stall": sc_mild_stall,
    "mixed_chaos": sc_mixed_chaos,
    "stale_deadline": sc_stale_deadline,
    "burst_cooperative": sc_burst_cooperative,
    "shard_waves_off": sc_shard_waves_off,
    "midwave_kill_reshard": sc_midwave_kill_reshard,
    "midwave_kill_below_two": sc_midwave_kill_below_two,
    "fallback_below_two": sc_fallback_below_two,
    "sharded_stalls": sc_sharded_stalls,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_modeled_fleet_schedules_equal_reference(ref_models, port_models,
                                                 scenario):
    """Decisions, events, statuses and errors, mesh plans, per-replica and
    per-tenant accounting and the makespan, equal to the reference's."""
    got, want = [], []
    for mod, out in ((REF, want), (PORT, got)):
        models = models_for(mod, ref_models, port_models, NAMES)
        out.append(outcome(SCENARIOS[scenario](mod, models).serve(
            execute=False)))
    assert got == want
    assert got[0][9], "the scenario admitted requests"


def test_scenarios_reach_their_events(port_models):
    """Each scenario exercises what it is named for in the port too."""
    kinds = {}
    for name, build in SCENARIOS.items():
        rep = build(PORT, port_models).serve(execute=False)
        assert rep.unaccounted == ()
        kinds[name] = {e.kind for e in rep.events}
    assert {"kill", "replica_dead", "retry"} <= kinds["kill_in_flight"]
    assert "drain" in kinds["kill_drains_queue"]
    assert "replan_failed" in kinds["all_dead"]
    assert {"suspect", "rejoin"} <= kinds["partition_rejoin"]
    assert "timeout" in kinds["hard_stall"]
    assert {"shard_abort", "reshard"} <= kinds["midwave_kill_reshard"]
    assert "shard_fallback" in kinds["fallback_below_two"]


def test_single_replica_fleet_equals_the_ports_zoo(port_models):
    fleet = sc_single_replica(PORT, port_models).serve(execute=False)
    zoo = tzoo.ModelZooServer(port_models, policy=tzoo.FIFOPolicy())
    for k in range(6):
        zoo.submit(tzoo.ZooRequest(
            uid=k, model="alexnet" if k % 2 == 0 else "alexnet-int8",
            image=img(k), tenant=f"t{k % 2}", arrival_s=k * 2e-5))
    zrep = zoo.serve(execute=False)
    key = lambda d: (d.t_s, d.model, d.uids, d.batch, d.conv_s, d.fc_s)
    assert [key(d) for d in fleet.decisions] == \
        [key(d) for d in zrep.decisions]
    assert fleet.makespan_s == zrep.makespan_s


def test_placements_equal_reference():
    views = [(f"r{i}", i, q, b, c) for i, (q, b, c) in
             enumerate([(2, 5e-4, 0.0), (0, 0.0, 1e-4), (1, 2e-4, 0.0),
                        (1, 1e-4, 0.0), (0, 1e-4, 0.0)])]
    for name in ("least-loaded", "round-robin"):
        picks = []
        for mod in (rfleet, tfleet):
            pol = mod.PLACEMENTS[name]()
            vs = [mod.ReplicaView(*v) for v in views]
            req = (rzoo if mod is rfleet else tzoo).ZooRequest(
                uid=0, model="m", image=None)
            picks.append([pol.place(0.0, vs[:k], req)
                          for k in (5, 2, 3, 5, 4, 1)])
        assert picks[0] == picks[1]
    assert tfleet.__all__ and set(rfleet.__all__) <= set(tfleet.__all__)


def test_fleet_constructor_and_submit_contract(port_models):
    with pytest.raises(ValueError):
        tfleet.FleetServer(port_models, n_replicas=0)
    with pytest.raises(ValueError):
        tfleet.FleetServer([])
    with pytest.raises(ValueError):
        tfleet.FleetServer(port_models + port_models[:1])
    f = tfleet.FleetServer(port_models, n_replicas=3)
    assert f.replica_ids == ("r0", "r1", "r2")
    f.submit(tzoo.ZooRequest(uid=0, model="alexnet", image=img(0)))
    with pytest.raises(KeyError):
        f.submit(tzoo.ZooRequest(uid=1, model="nope", image=img(1)))
    with pytest.raises(ValueError):
        f.submit(tzoo.ZooRequest(uid=0, model="alexnet", image=img(0)))
    assert f.pending_count() == 1
    empty = tfleet.FleetServer(port_models).serve(execute=False)
    assert empty.requests == () and empty.makespan_s == 0.0


# ---------------------------------------------------------------------------
# the launcher: the fleet benchmark's seven configurations
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fleet_bench():
    """``benchmarks/fleet_serve.py``, loaded by path with XLA_FLAGS left
    as it was (the script sets a default for a process of its own)."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    spec = importlib.util.spec_from_file_location(
        "bench_fleet_serve", ROOT / "benchmarks" / "fleet_serve.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return mod


@pytest.fixture(scope="module")
def reduced_zoo():
    """The launcher's zoo at the reference benchmark's micro-batch (4),
    the port's own seed-0 weights (the modeled schedule reads none)."""
    return tzoo.build_zoo(MODELS, seed=0, in_res=REDUCED_RES,
                          width_mult=WIDTH, max_batch=4, device="cpu")


def test_launcher_plans_are_the_benchmarks(fleet_bench, reduced_zoo):
    for name in ("TRACE_TIERS", "CHAOS", "SHARD_CHAOS", "RECOVERY",
                 "FLEET", "SHARD_DATA"):
        assert getattr(tlaunch, name) == getattr(fleet_bench, name), name
    assert tlaunch.REF_MICROBATCH == fleet_bench.MAX_BATCH
    assert tlaunch.density(reduced_zoo) == 1
    for tier in ("fast", "full"):
        want = fleet_bench.make_trace(tier)
        got = tlaunch.make_trace(tier, fleet_bench.IN_RES)
        assert [{k: v for k, v in q.items() if k != "image"} for q in got] \
            == [{k: v for k, v in q.items() if k != "image"} for q in want]
        for q, w in zip(got, want):
            np.testing.assert_array_equal(q["image"], w["image"])
        streams = tlaunch.traces(reduced_zoo, tier, REDUCED_RES)
        assert [q["uid"] for q in streams["dense"]] == \
            [q["uid"] for q in want]
        # a longer stream starts with the shorter one's arrivals
        longer = tlaunch.make_trace(tier, REDUCED_RES, sizes={"web": 30})
        web = [q["arrival_s"] for q in want if q["tenant"] == "web"]
        assert [q["arrival_s"] for q in longer
                if q["tenant"] == "web"][:len(web)] == web


@pytest.mark.parametrize("config", sorted(tlaunch.CONFIG_TRACE))
def test_launcher_configs_equal_reference_benchmark(fleet_bench,
                                                    reduced_zoo, config):
    """Each configuration's modeled drain, the port's launcher against the
    reference benchmark's ``run_config`` on the same stream and plan."""
    streams = tlaunch.traces(reduced_zoo, "fast", REDUCED_RES)
    kill = tlaunch.shard_kill_time(tlaunch.run_config(
        reduced_zoo, streams["burst"], n_replicas=4, shard_waves=True))
    kw = tlaunch.config_kwargs(kill)[config]
    trace = streams[tlaunch.CONFIG_TRACE[config]]
    got = tlaunch.run_config(reduced_zoo, trace, **kw)
    want = fleet_bench.run_config(trace, **kw)
    assert outcome(got) == outcome(want)
    assert fleet_bench._report_doc(got) == fleet_bench._report_doc(want)


def test_launcher_checks_at_micro_batch_64():
    """At the card's micro-batch the reference's stream is arrival-bound
    (one replica batches it into few waves), so the scaling
    configurations take the dense stream; every check of the launcher
    holds on the modeled schedules."""
    models = tzoo.build_zoo(MODELS, seed=0, in_res=REDUCED_RES,
                            width_mult=WIDTH, max_batch=64, device="cpu")
    assert tlaunch.density(models) == 16
    assert tlaunch.burst_sizes(models, "fast") == \
        {"web": 128, "batch": 128, "rt": 256}
    streams = tlaunch.traces(models, "fast", REDUCED_RES)
    kill = tlaunch.shard_kill_time(tlaunch.run_config(
        models, streams["burst"], n_replicas=4, shard_waves=True))
    kwargs = tlaunch.config_kwargs(kill)
    reports = {name: tlaunch.run_config(models, streams[tr], **kwargs[name])
               for name, tr in tlaunch.CONFIG_TRACE.items()}
    n = {name: len(streams[tr]) for name, tr in tlaunch.CONFIG_TRACE.items()}
    checks = tlaunch.fleet_checks(
        reports, tlaunch.zoo_witness(models, streams["dense"]), {}, n)
    assert [c for c in checks if not c[1]] == []
    reference = tlaunch.run_config(models, streams["reference"],
                                   n_replicas=1).makespan_s / \
        tlaunch.run_config(models, streams["reference"],
                           n_replicas=4).makespan_s
    assert reference < 1.5
    coop = [d for d in reports["sharded_r4"].decisions if d.sharded]
    assert ("alexnet-int8", 256) in [(d.model, d.batch) for d in coop]


def test_fleet_launcher_runs_on_the_cpu(capsys):
    reports = tlaunch.main(["--device", "cpu", "--width-mult", str(WIDTH),
                            "--reduced-res", "--max-batch", "4"])
    out = capsys.readouterr().out
    assert "FAILED" not in out
    assert out.count("bitwise equal to its model's unbatched forward") == 3
    assert set(reports) == set(tlaunch.CONFIG_TRACE)


# ---------------------------------------------------------------------------
# executed fleets: bitwise the port's unbatched forward, near the reference
# ---------------------------------------------------------------------------
def _assert_served(rep, port_models, ref_models, n):
    by_name = {m.name: m for m in port_models}
    refs = {m.name: m for m in ref_models}
    assert len(rep.served) == n and rep.unaccounted == ()
    for r in rep.served:
        m = by_name[r.model]
        one = tcnn.cnn_forward(m.spec.net, m.params,
                               torch.from_numpy(r.image[None]),
                               eng=m.server.engine).numpy()[0]
        assert r.done and np.isfinite(r.logits).all()
        np.testing.assert_array_equal(r.logits, one)
        rm = refs[r.model]
        want = np.asarray(rcnn.cnn_forward(rm.spec.net, rm.params,
                                           jnp.asarray(r.image)[None],
                                           eng=rm.server.engine))[0]
        np.testing.assert_allclose(r.logits, want, **TOL_LOGITS)


def test_executed_fleet_bitwise_across_replica_lanes(port_models,
                                                     ref_models):
    f = sc_least_loaded(PORT, port_models)
    rep = f.serve()
    assert {r.replica for r in rep.served} == {"r0", "r1"}
    _assert_served(rep, port_models, ref_models, 4)


def test_executed_kill_and_partition_serve_bitwise(port_models, ref_models):
    for build, n in ((sc_kill_drains_queue, 6), (sc_mixed_chaos, 8)):
        rep = build(PORT, port_models).serve()
        assert not [e for e in rep.events if e.t_s == -1.0]
        _assert_served(rep, port_models, ref_models,
                       len([r for r in rep.requests
                            if r.status == "served"]))
        assert len(rep.requests) == n


def test_executed_schedule_equals_modeled(port_models):
    modeled = sc_mixed_chaos(PORT, port_models).serve(execute=False)
    executed = sc_mixed_chaos(PORT, port_models).serve()
    assert outcome(executed) == outcome(modeled)


def test_lanes_share_the_zoo_models_parameters_and_engine(port_models):
    f = sc_least_loaded(PORT, port_models)
    f.serve()
    m = port_models[1]
    for rid in ("r0", "r1"):
        lane = f._lane(rid, m.name)
        assert lane.params is m.params and lane.engine is m.server.engine
        assert lane.device == torch.device("cpu")
    assert f._lane("r0", m.name) is f._lane("r0", m.name)
    assert f._device_params == {}


def test_a_lane_on_another_device_gets_one_copy_of_the_parameters(
        port_models):
    other = torch.device("cpu", 0)
    f = tfleet.FleetServer(port_models, n_replicas=2, devices=[other])
    assert f.devices() == (other,)
    for m in port_models:
        p = f._params_on(m.name, other)
        assert p is not m.params and f._params_on(m.name, other) is p
        for a, b in zip(p, m.params):
            assert a.keys() == b.keys()
            for k in a:
                pairs = zip(a[k], b[k]) if isinstance(b[k], tuple) \
                    else [(a[k], b[k])]
                assert all(torch.equal(x, y) for x, y in pairs)
    assert len(f._device_params) == len(port_models)


def test_devices_and_mesh_on_the_cpu(port_models):
    f = tfleet.FleetServer(port_models, n_replicas=4)
    assert f.devices() == (torch.device("cpu"),)
    assert f.replica_device(3) == torch.device("cpu")
    mesh = f.mesh()
    assert mesh.axis_names == ("data",) and mesh.size == 1
    assert f.shard_mesh(("r1", "r3")).devices == (torch.device("cpu"),)
    two = tfleet.FleetServer(port_models, n_replicas=4,
                             devices=["cpu", torch.device("cpu", 0)])
    assert two.mesh().size == 2
    assert [two.replica_device(i) for i in range(4)] == \
        [torch.device("cpu"), torch.device("cpu", 0)] * 2
    assert two.shard_mesh(("r0", "r2")).size == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device exists")
def test_asking_for_cuda_without_a_card_raises(port_models):
    f = tfleet.FleetServer(port_models, devices=["cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        f.devices()


def test_a_modeled_only_fleet_never_touches_cuda(port_models, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("CUDA touched by a modeled-only fleet")
    for name in ("is_available", "device_count", "current_device",
                 "_lazy_init", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for build in SCENARIOS.values():
        f = build(PORT, port_models)
        f.serve(execute=False)
        assert f._device_list is None and f._lanes is None


def test_executor_exception_is_a_typed_quarantine(port_models):
    f = sc_least_loaded(PORT, port_models)

    def boom(self):
        raise RuntimeError("kernel failed")
    orig = tcs.CNNServer.step_wave
    tcs.CNNServer.step_wave = boom
    try:
        rep = f.serve()
    finally:
        tcs.CNNServer.step_wave = orig
    assert [r.status for r in rep.requests] == ["quarantined"] * 4
    assert all(type(r.error) is terr.ServeError for r in rep.requests)
    assert {e.detail for e in rep.events} == \
        {"executor raised RuntimeError"}


def test_sharded_executor_exception_is_a_typed_quarantine(port_models,
                                                          monkeypatch):
    f = sc_burst_cooperative(PORT, port_models)

    def boom(*a, **k):
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(tfleet.cnn, "cnn_forward", boom)
    rep = f.serve()
    coop = {u for d in rep.decisions if d.sharded for u in d.uids}
    assert coop and all(r.status == "quarantined" for r in rep.requests
                        if r.uid in coop)
    assert {e.detail for e in rep.events if e.t_s == -1.0} == \
        {"sharded executor raised RuntimeError"}


# ---------------------------------------------------------------------------
# C7: a bf16 CNNServer delivers its logits
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bf16_setup(ref_models):
    rm = ref_models[0]
    images = np.stack([img(100 + k) for k in range(5)])
    return rm, params_from_reference(rm.params, device="cpu"), images


def _bf16_server(params, pipeline=True):
    return tcs.CNNServer("alexnet", params, in_res=67, width_mult=WIDTH,
                         max_batch=4, dtype=torch.bfloat16,
                         pipeline=pipeline, device="cpu")


def test_c7_bf16_cnn_server_delivers_logits_near_the_reference(bf16_setup):
    rm, params, images = bf16_setup
    srv = _bf16_server(params)
    for k, x in enumerate(images):
        srv.submit(tcs.CNNRequest(uid=k, image=x))
    done = sorted(srv.run(), key=lambda r: r.uid)
    assert [w.batch for w in srv.waves] == [4, 1]
    got = np.stack([r.logits for r in done])
    assert got.dtype == np.float32 and got.shape[0] == 5
    ref = rcs.CNNServer("alexnet", rm.params, in_res=67, width_mult=WIDTH,
                        max_batch=4, dtype=jnp.bfloat16,
                        engine=REngine(backend="xla"))
    for k, x in enumerate(images):
        ref.submit(rcs.CNNRequest(uid=k, image=x))
    want = np.stack([np.asarray(r.logits).astype(np.float32) for r in
                     sorted(ref.run(), key=lambda r: r.uid)])
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, **TOL_BF16)


def test_c7_bf16_logits_are_the_unbatched_forward_widened(bf16_setup):
    _, params, images = bf16_setup
    srv = _bf16_server(params)
    for k, x in enumerate(images):
        srv.submit(tcs.CNNRequest(uid=k, image=x))
    done = {r.uid: r.logits for r in srv.run()}
    for k, x in enumerate(images):
        one = tcnn.cnn_forward("alexnet", params,
                               torch.from_numpy(x[None]).to(torch.bfloat16),
                               eng=srv.engine)
        assert one.dtype == torch.bfloat16
        np.testing.assert_array_equal(done[k], one.float().numpy()[0])
        # the widening is exact: every delivered value is a bf16 value
        back = torch.from_numpy(done[k]).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(back, done[k])


def test_c7_bf16_pipelined_equals_sequential(bf16_setup):
    _, params, images = bf16_setup
    out = []
    for pipeline in (True, False):
        srv = _bf16_server(params, pipeline=pipeline)
        for k, x in enumerate(images):
            srv.submit(tcs.CNNRequest(uid=k, image=x))
        out.append(np.stack([r.logits for r in
                             sorted(srv.run(), key=lambda r: r.uid)]))
    np.testing.assert_array_equal(out[0], out[1])
