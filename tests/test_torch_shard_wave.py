"""Cooperative sharded waves on the port, on the CPU against the JAX
package: ``distributed/elastic.py`` (``replan``, ``degrade_sequence``,
``reshard_wave`` and their typed errors) equal to the reference's over a
grid of inputs; ``distributed/sharding.py``'s mesh and ``shard_wave_rows``
padding as the reference pads; and executed cooperative waves, bitwise the
port's unbatched forward and within ``TOL_LOGITS`` of the reference's
logits, each forward at most a micro-batch, read from the dispatch trace.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import Engine as REngine
from repro.distributed import elastic as relastic
from repro.distributed import sharding as rsharding
from repro.models import cnn as rcnn
from repro.serve import fleet as rfleet
from repro.serve import zoo as rzoo
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_reference
from repro_torch.core.quant import quantize_cnn_params
from repro_torch.distributed import elastic as telastic
from repro_torch.distributed import sharding as tsharding
from repro_torch.models import cnn as tcnn
from repro_torch.serve import errors as terr
from repro_torch.serve import faults as tfaults
from repro_torch.serve import fleet as tfleet
from repro_torch.serve import zoo as tzoo

RES = {"alexnet": 67}
WIDTH = 0.0625
MAX_BATCH = 2
TOL_LOGITS = dict(rtol=2e-3, atol=2e-3)


def plain(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(
            (f.name, plain(getattr(v, f.name)))
            for f in dataclasses.fields(v))
    if isinstance(v, (list, tuple)):
        return tuple(plain(x) for x in v)
    return v


def result(fn, *args, **kw):
    """What a call gives: its value as plain tuples with the properties
    the fleet reads, or its error's type name, message and fields."""
    try:
        v = fn(*args, **kw)
    except Exception as e:      # noqa: BLE001 — compared, not swallowed
        return ("raises", type(e).__name__, str(e),
                getattr(e, "survivors", None), getattr(e, "required", None))
    if isinstance(v, list):
        return [result(lambda x=x: x) for x in v]
    extra = ()
    if type(v).__name__ == "MeshPlan":
        extra = (v.shape, v.axis_names)
    elif type(v).__name__ == "ShardAssignment":
        extra = (v.data, v.shards)
    return plain(v), extra


# ---------------------------------------------------------------------------
# elastic: equal to the reference, typed errors included
# ---------------------------------------------------------------------------
REPLAN_GRID = [(c, mp, gb, ps) for c in (0, 1, 2, 3, 4, 7, 16, 63, 64, 65,
                                         255, 256, 300, 512, 600)
               for mp in (1, 2, 16) for gb in (64, 96, 256)
               for ps in (64, 256)]


def test_replan_equals_reference_over_a_grid():
    for c, mp, gb, ps in REPLAN_GRID:
        kw = dict(model_parallel=mp, global_batch=gb, pod_size=ps)
        assert result(telastic.replan, c, **kw) == \
            result(relastic.replan, c, **kw), (c, kw)
    assert result(telastic.replan, 40) == result(relastic.replan, 40)


@pytest.mark.parametrize("start,failures", [
    (256, [16, 32, 64]), (64, [1, 1, 30, 16, 16]), (4, [1, 1, 1, 1]),
    (512, [256, 200, 40]), (16, [])])
@pytest.mark.parametrize("mp", [1, 16])
def test_degrade_sequence_equals_reference(start, failures, mp):
    kw = dict(model_parallel=mp, global_batch=64, pod_size=64)
    got = result(telastic.degrade_sequence, start, failures, **kw)
    assert got == result(relastic.degrade_sequence, start, failures, **kw)


@pytest.mark.parametrize("uids,survivors", [
    ((5, 3, 9, 1, 7), ("r2", "r0", "r3")), ((5, 3, 9, 1, 7), ("r3",)),
    ((7,), ("r0", "r1", "r2")), (tuple(range(16)), ("r1", "r0", "r3")),
    ((1, 2), ()), ((), ("r0",)), (tuple(range(9)), ("r9", "r10", "r2"))])
def test_reshard_wave_equals_reference(uids, survivors):
    got = result(telastic.reshard_wave, uids, survivors)
    assert got == result(relastic.reshard_wave, uids, survivors)
    if got[0] != "raises":
        a = telastic.reshard_wave(uids, survivors)
        assert a.replica_of(uids[0]) == \
            relastic.reshard_wave(uids, survivors).replica_of(uids[0])
        with pytest.raises(KeyError):
            a.replica_of(-1)


def test_elastic_raises_the_ports_typed_error():
    with pytest.raises(terr.InsufficientReplicasError) as ei:
        telastic.replan(3, model_parallel=4)
    assert ei.value.survivors == 3 and ei.value.required == 4
    with pytest.raises(terr.InsufficientReplicasError, match="failure "
                       "event 1"):
        telastic.degrade_sequence(8, [2, 4], model_parallel=4)


# ---------------------------------------------------------------------------
# the mesh and shard_wave_rows
# ---------------------------------------------------------------------------
CPU0 = torch.device("cpu", 0)


def test_mesh_is_distinct_devices_on_one_data_axis():
    m = tsharding.Mesh(("cpu", CPU0))
    assert m.devices == (torch.device("cpu"), CPU0)
    assert m.axis_names == ("data",) and m.size == 2
    assert tsharding.dp_axes(m) == ("data",) and tsharding.dp_size(m) == 2
    with pytest.raises(ValueError, match="distinct"):
        tsharding.Mesh(("cpu", "cpu"))
    with pytest.raises(ValueError):
        tsharding.Mesh(())
    with pytest.raises(ValueError):
        tsharding.Mesh(("cpu",), axis_names=("data", "model"))
    sh = tsharding.wave_sharding(m)
    assert sh.axes == ("data",)
    assert sh.blocks(6) == ((torch.device("cpu"), slice(0, 3)),
                            (CPU0, slice(3, 6)))
    with pytest.raises(ValueError):
        sh.blocks(5)


@pytest.mark.parametrize("rows", [1, 4, 5, 7, 8])
def test_shard_wave_rows_pads_as_the_reference(rows):
    """The reference's rows on its one-device mesh, and the zero padding
    to a multiple of the data degree on a two-device mesh, block i on
    device i."""
    x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
    rmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    want, wrows = rsharding.shard_wave_rows(jnp.asarray(x), rmesh)
    got, grows = tsharding.shard_wave_rows(x, tsharding.Mesh(("cpu",)))
    assert grows == wrows == rows and len(got) == 1
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    two, rows2 = tsharding.shard_wave_rows(torch.from_numpy(x),
                                           tsharding.Mesh(("cpu", CPU0)))
    padded = np.concatenate([x, np.zeros(((-rows) % 2, 3), np.float32)])
    assert rows2 == rows and len(two) == 2
    half = len(padded) // 2
    np.testing.assert_array_equal(two[0].numpy(), padded[:half])
    np.testing.assert_array_equal(two[1].numpy(), padded[half:])
    with pytest.raises(ValueError):
        tsharding.shard_wave_rows(np.zeros((0, 3)), tsharding.Mesh(("cpu",)))


@pytest.mark.parametrize("rows,parts,cap,want", [
    (256, 4, 64, [64] * 4), (65, 4, 64, [17, 16, 16, 16]),
    (6, 4, 2, [2, 2, 1, 1]), (3, 4, 2, [1, 1, 1]),
    (300, 1, 64, [64, 64, 64, 64, 44]), (200, 3, 64, [64, 3, 64, 3, 64, 2])])
def test_cooperative_blocks(rows, parts, cap, want):
    got = tfleet.cooperative_blocks(rows, parts, cap)
    assert got == want and sum(got) == rows and max(got) <= cap


# ---------------------------------------------------------------------------
# executed cooperative waves
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_models():
    return rzoo.build_zoo(("alexnet-int8", "alexnet"), seed=0, in_res=RES,
                          width_mult=WIDTH, max_batch=MAX_BATCH,
                          engine=REngine(backend="xla"))


@pytest.fixture(scope="module")
def port_models(ref_models):
    out = []
    for i, m in enumerate(ref_models):
        if m.spec.weight_dtype == "int8":
            fp32 = rcnn.init_cnn(m.spec.net, jax.random.PRNGKey(i),
                                 in_res=67, width_mult=WIDTH)
            params = quantize_cnn_params(params_from_reference(
                fp32, device="cpu"))
        else:
            params = params_from_reference(m.params, device="cpu")
        out.append(tzoo.ZooModel(treg.get_zoo_model(m.name), params,
                                 in_res=67, width_mult=WIDTH,
                                 max_batch=MAX_BATCH, device="cpu"))
    return out


def img(seed, res=67):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((res, res, 3)).astype(np.float32)


def burst(fleet, n, model="alexnet-int8", uid0=0):
    for k in range(n):
        fleet.submit(tzoo.ZooRequest(uid=uid0 + k, model=model,
                                     image=img(uid0 + k), tenant="t"))


def _assert_bitwise(rep, port_models, ref_models, n):
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


def _forward_rows(trace) -> set[int]:
    return {r.conv_shape[0] if r.conv_shape is not None else r.m
            for r in trace}


@pytest.mark.parametrize("model", ["alexnet-int8", "alexnet"])
def test_executed_cooperative_wave_bitwise_in_forwards_of_a_microbatch(
        port_models, ref_models, model):
    """A full data=4 cooperative wave (4 x microbatch rows) runs one
    forward per participant, each of one micro-batch on the dispatch
    trace, and serves every row bitwise the unbatched forward."""
    m = next(x for x in port_models if x.name == model)
    mb = m.microbatch
    fleet = tfleet.FleetServer(port_models, n_replicas=4,
                               policy=tzoo.FIFOPolicy(), shard_waves=True)
    burst(fleet, 4 * mb, model=model)
    rep = fleet.serve()
    coop = [d for d in rep.decisions if d.sharded]
    assert [(d.batch, len(d.shards)) for d in coop] == [(4 * mb, 4)]
    assert len(fleet.shard_traces) == 4
    for tr in fleet.shard_traces:
        assert _forward_rows(tr) == {mb}
        assert len(tr) == 8 and {r.stage for r in tr} == {"shard"}
        assert {r.wave for r in tr} == {0}
        assert {r.regime for r in tr if r.fc_plan is not None} == {"sa_fc"}
    _assert_bitwise(rep, port_models, ref_models, 4 * mb)


def test_executed_uneven_cooperative_wave_and_mixed_models(port_models,
                                                           ref_models):
    fleet = tfleet.FleetServer(port_models, n_replicas=4,
                               policy=tzoo.FIFOPolicy(), shard_waves=True)
    burst(fleet, 6)
    burst(fleet, 5, model="alexnet", uid0=6)
    rep = fleet.serve()
    coop = [d for d in rep.decisions if d.sharded]
    assert sorted(d.batch for d in coop) == [5, 6]
    assert max(max(_forward_rows(tr)) for tr in fleet.shard_traces) <= \
        MAX_BATCH
    _assert_bitwise(rep, port_models, ref_models, 11)


def test_executed_midwave_kill_resharded_retry_bitwise(port_models,
                                                       ref_models):
    half = port_models[0].sharded_wave_cost(6, 4).total_s / 2
    fleet = tfleet.FleetServer(
        port_models, n_replicas=4, policy=tzoo.FIFOPolicy(),
        faults=tfaults.ReplicaFaultInjector(tfaults.ReplicaChaosConfig(
            kills=(("r2", half),))), shard_waves=True)
    burst(fleet, 6)
    rep = fleet.serve()
    assert {"shard_abort", "reshard"} <= {e.kind for e in rep.events}
    assert all(r.replica != "r2" for r in rep.served)
    assert not [e for e in rep.events if e.t_s == -1.0]
    _assert_bitwise(rep, port_models, ref_models, 6)


def test_executed_cooperative_waves_equal_the_references_schedule(
        port_models, ref_models):
    """The same burst through both fleets: the port's executed schedule is
    the reference's modeled one."""
    reports = []
    for mod, models in ((rfleet, ref_models), (tfleet, port_models)):
        zoo = rzoo if mod is rfleet else tzoo
        fleet = mod.FleetServer(models, n_replicas=4,
                                policy=zoo.FIFOPolicy(), shard_waves=True)
        for k in range(7):
            fleet.submit(zoo.ZooRequest(uid=k, model="alexnet-int8",
                                        image=img(k), tenant="t"))
        reports.append(fleet.serve(execute=mod is tfleet))
    want, got = reports
    assert plain(got.decisions) == plain(want.decisions)
    assert plain(got.events) == plain(want.events)
    assert [r.status for r in got.requests] == \
        [r.status for r in want.requests]
