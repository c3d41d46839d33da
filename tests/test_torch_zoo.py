"""The zoo slice of the port on the CPU against the JAX package: the cost
model (``core/perf_model.py``), the zoo registry, the fault machinery
(``distributed/fault_tolerance.py``, ``serve/faults.py``,
``serve/errors.py``) and ``ModelZooServer``'s modeled schedules, equal to
the reference's exactly; then executed zoo serving at the reference tests'
small size, its logits within ``TOL_LOGITS`` of the reference's XLA
backend, with the port's own bitwise invariants.

The traces are the reference benchmarks' (``benchmarks/zoo_serve.py``,
``benchmarks/chaos_serve.py``, loaded by path: they are scripts, not a
package); the port's copy of the chaos trace (``launch/zoo.py``) is held
to the benchmark's, seed for seed.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.core import accelerator as racc
from repro.core import perf_model as rpm
from repro.core.engine import Engine as REngine
from repro.distributed import fault_tolerance as rft
from repro.models import cnn as rcnn
from repro.serve import errors as rerr
from repro.serve import faults as rfaults
from repro.serve import zoo as rzoo
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_reference
from repro_torch.core import accelerator as tacc
from repro_torch.core import perf_model as tpm
from repro_torch.core.dataflow import PlanError
from repro_torch.core.quant import QTensor, quantize_cnn_params
from repro_torch.core.schedule import ScheduleRegistry
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.launch import zoo as tlaunch
from repro_torch.models import cnn as tcnn
from repro_torch.serve import errors as terr
from repro_torch.serve import faults as tfaults
from repro_torch.serve import zoo as tzoo

ROOT = Path(__file__).resolve().parents[1]
NETS = ("alexnet", "vgg16")
MODELS = ("alexnet", "vgg16", "alexnet-int8")
#: the reference zoo tests' execution geometry
RES = {"alexnet": 67, "vgg16": 32}
WIDTH = 0.125
#: logits of the port's plain versions against the reference's XLA
#: backend: fp32 in both, sums in other orders, compounding over the
#: layers (chip_smoke.py's TOL_LOGITS)
TOL_LOGITS = dict(rtol=2e-3, atol=2e-3)


def _bench(name: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def zoo_bench():
    return _bench("zoo_serve")


@pytest.fixture(scope="module")
def chaos_bench():
    return _bench("chaos_serve")


def plain(v):
    """A result of either package as plain nested tuples: dataclasses by
    class name and fields (ConvPlan, LayerStats, WaveCost... have the same
    names and fields in both), containers element by element."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(
            (f.name, plain(getattr(v, f.name)))
            for f in dataclasses.fields(v))
    if isinstance(v, dict):
        return tuple(sorted((k, plain(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(plain(x) for x in v)
    return v


# ---------------------------------------------------------------------------
# the cost model, equal with ==
# ---------------------------------------------------------------------------
#: every public function of perf_model, as f(perf_model, accelerator, net)
PERF_CASES = {
    "network_cycles": lambda pm, acc, net: [
        pm.network_cycles(net, arr, fc_on=fc_on, n_conv_arrays=k)
        for arr in (acc.MPNA_PAPER.sa_conv, acc.MPNA_PAPER.sa_fc)
        for fc_on in ("sa_conv", "sa_fc") for k in (1, 2)],
    "stage_cycles": lambda pm, acc, net: [
        (pm.conv_stage_cycles(net, b), pm.fc_stage_cycles(net, b),
         pm.fc_stage_cycles(net, b, bw_limited=False))
        for b in (1, 4, 64)],
    "pipeline_makespan": lambda pm, acc, net: [
        pm.pipeline_makespan(net, b, w) for b in (1, 16) for w in (1, 8)],
    "pipeline_stage_seconds": lambda pm, acc, net: [
        pm.pipeline_stage_seconds(net, b, bytes_w=bw)
        for b in (1, 7, 64) for bw in (None, 1)],
    "zoo_wave_cost": lambda pm, acc, net: [
        pm.zoo_wave_cost(net, b, bytes_w=bw)
        for b in (1, 2, 5, 64) for bw in (None, 1)],
    "fleet_makespan": lambda pm, acc, net: [
        pm.fleet_makespan(net, 8, w, r) for w in (3, 8) for r in (1, 4)],
    "zoo_fleet_cost": lambda pm, acc, net: [
        pm.zoo_fleet_cost(net, 16, replicas=r, bytes_w=bw)
        for r in (1, 4) for bw in (None, 1)],
    "tpu_pipeline_crossover_batch": lambda pm, acc, net: [
        pm.tpu_pipeline_crossover_batch(net),
        pm.tpu_pipeline_crossover_batch(net, bytes_w=1)],
    "sharded_wave_cost": lambda pm, acc, net: [
        pm.sharded_wave_cost(net, b, d, microbatch=16, bytes_w=bw)
        for b in (16, 64) for d in (2, 4) for bw in (None, 1)],
    "fleet_shard_crossover_batch": lambda pm, acc, net: [
        pm.fleet_shard_crossover_batch(net, 4, microbatch=16)],
    "pipeline_crossover_batch": lambda pm, acc, net: [
        pm.pipeline_crossover_batch(net)],
    "fig1_fig12ab": lambda pm, acc, net: [
        pm.fig1_speedups(net), pm.fig12a_safc_speedup(net),
        pm.fig12a_safc_speedup(net, bw_limited=True),
        pm.fig12b_mpna_speedup(net)],
    "offline_layer_schedule": lambda pm, acc, net: [
        pm.offline_layer_schedule(net)],
    "layer_cycles_and_cases": lambda pm, acc, net: [
        (pm.conv_cycles(l, acc.MPNA_PAPER.sa_conv),
         pm.conv_cycles(l, acc.MPNA_PAPER.sa_conv, double_buffer=False),
         pm.fc_cycles_sa_conv(l, acc.MPNA_PAPER.sa_conv),
         pm.fc_cycles_sa_fc(l, acc.MPNA_PAPER.sa_fc),
         pm.classify_case(l, acc.MPNA_PAPER))
        for l in (rcnn if pm is rpm else tcnn).network_stats(net)],
    "traffic_and_energy": lambda pm, acc, net: [
        (t, pm.network_energy_j(net, t), pm.network_energy_j(
            net, t, conv_only=True))
        for t in (pm.mpna_traffic(net), pm.baseline_traffic(net),
                  pm.mpna_traffic(net, conv_only=True))],
    "fig12ce_table3": lambda pm, acc, net: [
        pm.fig12c_access_reduction(net),
        pm.fig12c_access_reduction(net, conv_only=False),
        pm.fig12e_energy_saving(net), pm.table3_throughput(net)],
    "pallas_traffic": lambda pm, acc, net: [
        pm.pallas_conv_traffic(net, batch=b, bytes_w=bw, fuse_pool=fp)
        for b in (1, 8) for bw in (None, 1) for fp in (True, False)] + [
        pm.pallas_fc_traffic(net, batch=b, bytes_w=bw)
        for b in (1, 8, 64) for bw in (None, 1)],
}


@pytest.mark.parametrize("case", sorted(PERF_CASES))
@pytest.mark.parametrize("net", NETS)
def test_perf_model_equals_reference(case, net):
    fn = PERF_CASES[case]
    want = plain(fn(rpm, racc, net))
    got = plain(fn(tpm, tacc, net))
    assert got == want


def test_perf_model_constants_equal_reference():
    assert plain(tacc.MPNA_PAPER) == plain(racc.MPNA_PAPER)
    assert plain(tacc.TPU_V5E) == plain(racc.TPU_V5E)
    assert tacc.ENERGY_PJ == racc.ENERGY_PJ
    assert tacc.TPU_V5E.ici_broadcast_bandwidth == \
        racc.TPU_V5E.ici_broadcast_bandwidth
    assert tpm.ICI_HOP_LATENCY_S == rpm.ICI_HOP_LATENCY_S


# ---------------------------------------------------------------------------
# registry, schedules, fault-tolerance primitives, errors, injectors
# ---------------------------------------------------------------------------
def test_zoo_registry_equals_reference():
    assert plain(treg.ZOO_MODELS) == plain(rreg.ZOO_MODELS)
    for name in treg.ZOO_MODELS:
        assert treg.get_zoo_model(name).weight_bytes == \
            rreg.get_zoo_model(name).weight_bytes
    with pytest.raises(KeyError, match="unknown zoo model 'resnet50'"):
        treg.get_zoo_model("resnet50")


def test_schedule_registry_verify_names_the_missing_checks():
    # the static checks are ported: verify=True verifies each new pair
    # (tests/test_torch_analysis.py holds what they catch)
    reg = ScheduleRegistry(verify=True)
    pair = reg.register("alexnet", dtype_tag="float32", batch=2, in_res=67,
                        width_mult=WIDTH)
    assert reg.register("alexnet", dtype_tag="float32", batch=2, in_res=67,
                        width_mult=WIDTH) == pair
    with pytest.raises(ValueError, match="conflicting re-registration"):
        reg.register("alexnet", dtype_tag="float32", batch=2, in_res=99,
                     width_mult=WIDTH)


def test_step_monitor_equals_reference():
    dts = np.random.default_rng(3).lognormal(0.0, 0.6, 300)
    dts[::17] *= 5.0
    for kw in (dict(), dict(factor=2.0, warmup=3, window=7)):
        r, t = rft.StepMonitor(**kw), tft.StepMonitor(**kw)
        assert math.isnan(t.median()) and math.isnan(r.median())
        for i, dt in enumerate(dts):
            assert t.observe(i, float(dt)) == r.observe(i, float(dt)), i
            assert t.median() == r.median()


def test_heartbeat_tracker_equals_reference():
    rng = np.random.default_rng(5)
    trackers = [m.HeartbeatTracker(["a", "b"], timeout=1.0, now=0.0)
                for m in (rft, tft)]
    now = 0.0
    for step in range(200):
        now += float(rng.exponential(0.4))
        op = int(rng.integers(5))
        node = "abcd"[int(rng.integers(4))]
        outs = []
        for tr, err in zip(trackers, (rft.UnknownNodeError,
                                      tft.UnknownNodeError)):
            try:
                if op == 0:
                    tr.register(node, now)
                elif op == 1:
                    tr.beat(node, now)
                elif op == 2 and node in tr.nodes():
                    tr.deregister(node)
                outs.append((tr.nodes(), tr.failed(now), tr.survivors(now)))
            except err as e:
                outs.append(("unknown", str(e)))
        assert outs[0] == outs[1], step


def test_step_deadline_and_errors_equal_reference():
    for mod in (rft, tft):
        d = mod.StepDeadline(1e9)
        assert not d.expired(0.0)
        d.begin()
        assert not d.expired()
    pairs = [(rerr.ServeError("x", uid=3, model="m"),
              terr.ServeError("x", uid=3, model="m")),
             (rerr.ReplicaLostError("y", uid=1, replica="r0"),
              terr.ReplicaLostError("y", uid=1, replica="r0")),
             (rerr.InsufficientReplicasError("z", survivors=1, required=2),
              terr.InsufficientReplicasError("z", survivors=1,
                                             required=2))]
    for r, t in pairs:
        assert (type(t).__name__, str(t), t.message) == \
            (type(r).__name__, str(r), r.message)
    assert issubclass(terr.StaleDeadlineError, terr.RequestShedError)
    assert terr.PlanError is PlanError
    assert [c.__name__ for c in terr.CorruptOutputError.__mro__][:3] == \
        ["CorruptOutputError", "ServeError", "RuntimeError"]


CHAOS_CONFIGS = [dict(seed=17, dispatch_fail_rate=0.12, corrupt_rate=0.14,
                      stall_rate=0.22, stall_factors=(4.0, 24.0)),
                 dict(seed=3, corrupt_rate=0.5, corrupt_frac=0.25),
                 dict(seed=0)]


@pytest.mark.parametrize("cfg", CHAOS_CONFIGS)
def test_fault_injector_draws_equal_reference(cfg):
    r = rfaults.FaultInjector(rfaults.ChaosConfig(**cfg))
    t = tfaults.FaultInjector(tfaults.ChaosConfig(**cfg))
    for attempt in range(300):
        batch = 1 + attempt % 9
        assert plain(t.wave_faults(attempt, batch)) == \
            plain(r.wave_faults(attempt, batch)), attempt
    logits = np.arange(6, dtype=np.float32)
    np.testing.assert_array_equal(t.corrupt_array(logits),
                                  np.asarray(r.corrupt_array(logits)))
    assert str(t.dispatch_error(4, "vgg16")) == \
        str(r.dispatch_error(4, "vgg16"))
    with pytest.raises(ValueError):
        tfaults.ChaosConfig(stall_rate=0.7, corrupt_rate=0.7)


def test_replica_fault_injector_equals_reference():
    cfg = dict(seed=9, stall_rate=0.3, stall_factors=(3.0, 20.0),
               kills=(("r1", 0.002),), partitions=(("r0", 0.001, 0.003),))
    r = rfaults.ReplicaFaultInjector(rfaults.ReplicaChaosConfig(**cfg))
    t = tfaults.ReplicaFaultInjector(tfaults.ReplicaChaosConfig(**cfg))
    for rep in range(3):
        for attempt in range(100):
            assert plain(t.wave_faults(rep, attempt)) == \
                plain(r.wave_faults(rep, attempt))
    for rid in ("r0", "r1", "r2"):
        assert t.kill_time(rid) == r.kill_time(rid)
        assert t.partition_windows(rid) == r.partition_windows(rid)
        for ts in (0.0, 0.001, 0.0025, 0.003):
            assert t.partitioned(rid, ts) == r.partitioned(rid, ts)


# ---------------------------------------------------------------------------
# modeled schedules: serve(execute=False), equal to the reference's
# ---------------------------------------------------------------------------
def outcome(report) -> tuple:
    """Everything a drain decided, as plain values: the decision log, the
    events, each request's terminal fields and its typed error, the
    per-tenant accounting, the utilization and the final health."""
    reqs = tuple((r.uid, r.model, r.tenant, r.status, r.served_by,
                  r.retries, r.dispatch_s, r.finish_s,
                  None if r.error is None else
                  (type(r.error).__name__, str(r.error)))
                 for r in report.requests)
    return (report.policy, plain(report.decisions), plain(report.events),
            reqs, plain(report.per_tenant), report.makespan_s,
            report.conv_busy_s, report.fc_busy_s, report.health)


def _requests(mod, trace):
    return [mod.ZooRequest(uid=q["uid"], model=q["model"], image=q["image"],
                           tenant=q["tenant"], arrival_s=q["arrival_s"],
                           deadline_s=q["deadline_s"]) for q in trace]


@pytest.fixture(scope="module")
def ref_models():
    """The reference's zoo at the tests' size, fp32 weights and the int8
    variant quantized by the reference."""
    return rzoo.build_zoo(MODELS, seed=0, in_res=RES, width_mult=WIDTH,
                          max_batch=4, engine=REngine(backend="xla"))


@pytest.fixture(scope="module")
def port_models(ref_models):
    """The same variants in the port, on the CPU: the reference's fp32
    weights passed across, the int8 variant quantized by the port from the
    reference's own fp32 draw (bit for bit the reference's int8)."""
    import jax

    out = []
    for i, m in enumerate(ref_models):
        if m.spec.weight_dtype == "int8":
            fp32 = rcnn.init_cnn(m.spec.net, jax.random.PRNGKey(i),
                                 in_res=RES[m.spec.net], width_mult=WIDTH)
            params = quantize_cnn_params(params_from_reference(
                fp32, device="cpu"))
            for p, rp in zip(params, m.params):
                for k, v in p.items():
                    if isinstance(v, QTensor):
                        np.testing.assert_array_equal(v.q.numpy(),
                                                      np.asarray(rp[k].q))
        else:
            params = params_from_reference(m.params, device="cpu")
        out.append(tzoo.ZooModel(treg.get_zoo_model(m.name), params,
                                 in_res=RES[m.spec.net], width_mult=WIDTH,
                                 max_batch=4, device="cpu"))
    return out


def _fresh_ref(models):
    return [rzoo.ZooModel(m.spec, m.params, in_res=m.server.in_res,
                          width_mult=WIDTH, max_batch=m.server.max_batch,
                          engine=m.server.engine) for m in models]


def test_zoo_microbatches_and_registry_equal_reference(ref_models,
                                                       port_models):
    for r, t in zip(ref_models, port_models):
        assert t.microbatch == r.microbatch
        assert plain(t.wave_cost(t.microbatch)) == \
            plain(r.wave_cost(r.microbatch))
        assert plain(t.sharded_wave_cost(8, 2)) == \
            plain(r.sharded_wave_cost(8, 2))
    rz = rzoo.ModelZooServer(_fresh_ref(ref_models))
    tz = tzoo.ModelZooServer(tlaunch.fresh(port_models))
    assert tz.registry.keys() == rz.registry.keys()
    assert tz._fallbacks == rz._fallbacks


@pytest.mark.parametrize("policy", ["fifo", "smf", "edf"])
@pytest.mark.parametrize("tier", ["fast", "full"])
def test_modeled_policy_schedules_equal_reference(zoo_bench, ref_models,
                                                  port_models, policy,
                                                  tier):
    trace = zoo_bench.make_trace(tier)
    got, want = [], []
    for mod, models, out in ((rzoo, _fresh_ref(ref_models), want),
                             (tzoo, tlaunch.fresh(port_models), got)):
        zoo = mod.ModelZooServer(models, policy=mod.POLICIES[policy]())
        for r in _requests(mod, trace):
            zoo.submit(r)
        out.append(outcome(zoo.serve(execute=False)))
    assert got == want


def test_port_chaos_trace_is_the_benchmarks(chaos_bench):
    for tier in ("fast", "full"):
        want = chaos_bench.make_trace(tier)
        got = tlaunch.chaos_trace(tier, chaos_bench.IN_RES)
        assert len(got) == len(want)
        for r, q in zip(got, want):
            assert (r.uid, r.tenant, r.model, r.arrival_s, r.deadline_s) \
                == (q["uid"], q["tenant"], q["model"], q["arrival_s"],
                    q["deadline_s"])
            np.testing.assert_array_equal(r.image, q["image"])
    assert tlaunch.CHAOS == chaos_bench.CHAOS
    assert tlaunch.RECOVERY == chaos_bench.RECOVERY
    assert tlaunch.ADMISSION == chaos_bench.ADMISSION


@pytest.mark.parametrize("protected", [True, False])
@pytest.mark.parametrize("tier", ["fast", "full"])
def test_modeled_chaos_schedules_equal_reference(chaos_bench, ref_models,
                                                 port_models, protected,
                                                 tier):
    trace = chaos_bench.make_trace(tier)
    want = rzoo.ModelZooServer(
        _fresh_ref(ref_models), policy=rzoo.EDFPolicy(),
        faults=rfaults.FaultInjector(rfaults.ChaosConfig(
            **chaos_bench.CHAOS)),
        admission=rzoo.AdmissionConfig(**chaos_bench.ADMISSION)
        if protected else rzoo.AdmissionConfig(),
        recovery=rzoo.RecoveryConfig(**chaos_bench.RECOVERY))
    for r in _requests(rzoo, trace):
        want.submit(r)
    got = tlaunch.chaos_server(tlaunch.fresh(port_models),
                               protected=protected)
    for r in tlaunch.chaos_trace(tier, chaos_bench.IN_RES):
        got.submit(r)
    assert outcome(got.serve(execute=False)) == \
        outcome(want.serve(execute=False))


# ---------------------------------------------------------------------------
# executed serving at the reference tests' size
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["fifo", "edf"])
def test_executed_zoo_logits_match_reference(ref_models, port_models,
                                             policy):
    """The example's three-tenant trace served by both zoos: the same
    schedule, the port's logits within TOL_LOGITS of the reference's XLA
    backend, and inside the port every request's logits bitwise its
    model's unbatched forward."""
    reqs = {}
    for mod, models in ((rzoo, _fresh_ref(ref_models)),
                        (tzoo, tlaunch.fresh(port_models))):
        zoo = mod.ModelZooServer(models, policy=mod.POLICIES[policy]())
        trace = tlaunch.make_requests(3, RES)
        for r in trace:
            zoo.submit(r if mod is tzoo else rzoo.ZooRequest(
                uid=r.uid, model=r.model, image=r.image, tenant=r.tenant,
                arrival_s=r.arrival_s, deadline_s=r.deadline_s))
        reqs[mod] = zoo.serve().requests
    assert [r.status for r in reqs[tzoo]] == ["served"] * 9
    by_name = {m.name: m for m in port_models}
    for t, r in zip(reqs[tzoo], reqs[rzoo]):
        assert (t.uid, t.dispatch_s, t.finish_s) == \
            (r.uid, r.dispatch_s, r.finish_s)
        np.testing.assert_allclose(t.logits, np.asarray(r.logits),
                                   **TOL_LOGITS)
        m = by_name[t.model]
        one = tcnn.cnn_forward(m.spec.net, m.params,
                               torch.from_numpy(t.image[None]),
                               eng=m.server.engine)
        np.testing.assert_array_equal(t.logits, one.numpy()[0])


def test_zero_rate_injector_is_bit_identical_to_none(port_models):
    reports = []
    for faults in (None, tfaults.FaultInjector(tfaults.ChaosConfig(
            seed=11))):
        zoo = tzoo.ModelZooServer(tlaunch.fresh(port_models),
                                  policy=tzoo.EDFPolicy(), faults=faults)
        for r in tlaunch.make_requests(2, RES):
            zoo.submit(r)
        reports.append(zoo.serve())
    a, b = reports
    assert outcome(a) == outcome(b) and a.events == ()
    for x, y in zip(a.requests, b.requests):
        np.testing.assert_array_equal(x.logits, y.logits)


def test_executed_chaos_equals_its_modeled_schedule(chaos_bench,
                                                    port_models):
    """Injected corruption is caught by the integrity guard exactly where
    the modeled schedule put it; no executor exception, no genuine
    non-finite row."""
    modeled = tlaunch.chaos_server(tlaunch.fresh(port_models),
                                   protected=True)
    for r in tlaunch.chaos_trace("fast", RES):
        modeled.submit(r)
    want = modeled.serve(execute=False)
    zoo = tlaunch.chaos_server(tlaunch.fresh(port_models), protected=True)
    for r in tlaunch.chaos_trace("fast", RES):
        zoo.submit(r)
    got = zoo.serve()
    assert tlaunch.outcome(got) == tlaunch.outcome(want)
    assert {e.kind for e in got.events} >= {"dispatch", "corrupt",
                                            "quarantine", "shed"}
    assert all(r.logits is not None and np.isfinite(r.logits).all()
               for r in got.served)


def test_executor_exception_is_a_quarantine_event(port_models):
    """A wave executor that raises quarantines its requests with a typed
    error and an event, which a run that must not fall back can see."""
    models = tlaunch.fresh(port_models[:1])
    zoo = tzoo.ModelZooServer(models)

    def boom():
        raise RuntimeError("kernel failed")
    models[0].server.step_wave = boom
    for r in tlaunch.make_requests(1, RES)[2:]:
        zoo.submit(r)
    rep = zoo.serve()
    assert [r.status for r in rep.requests] == ["quarantined"]
    assert [e.detail for e in rep.events] == ["executor raised RuntimeError"]


def test_zoo_launcher_runs_on_the_cpu(capsys):
    tlaunch.main(["--device", "cpu", "--width-mult", str(WIDTH),
                  "--reduced-res", "--per-tenant", "1", "--max-batch", "2",
                  "--chaos"])
    out = capsys.readouterr().out
    assert out.count("parity: all 3 requests bitwise-equal") == 3
    assert "equals its modeled schedule" in out
