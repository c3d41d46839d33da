"""The port's planner, schedules and quantization against the JAX
package's, field for field.

Plans involve shapes only, so every AlexNet and VGG-16 layer is checked at
full size.  Quantization must give the same int8 values and scales bit for
bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataflow as rdf
from repro.core import quant as rquant
from repro.core import schedule as rsched
from repro.models import cnn as rcnn
from repro_torch.core import dataflow as tdf
from repro_torch.core import quant as tquant
from repro_torch.core import schedule as tsched
from repro_torch.core.engine import DispatchPolicy
from repro_torch.models import cnn as tcnn

BATCHES = (1, 13, 64)


def _same(a, b) -> None:
    """Two plans (or keys) of the two packages hold equal fields."""
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _layers(net: str):
    """(kind, padded conv geometry or fc (k, n), pool) per layer of ``net``
    at full size, walked from the spec."""
    spec, res = tcnn.NETWORKS[net]
    ch, out = 3, []
    for i, s in enumerate(spec):
        if s.kind == "conv":
            h = res + 2 * s.pad
            nxt = spec[i + 1] if i + 1 < len(spec) else None
            pool = (nxt.kernel, nxt.stride) if nxt is not None and \
                nxt.kind == "pool" else None
            out.append(("conv", (h, h, ch, s.kernel, s.kernel, s.out_ch,
                                 s.stride), pool))
            res = (h - s.kernel) // s.stride + 1
            ch = s.out_ch
        elif s.kind == "pool":
            res = (res - s.kernel) // s.stride + 1
        else:
            k = res * res * ch if res > 1 else ch
            out.append(("fc", (k, s.out_ch), None))
            res, ch = 1, s.out_ch
    return out


@pytest.mark.parametrize("net", ["alexnet", "vgg16"])
@pytest.mark.parametrize("bytes_w", [4, 1])
def test_layer_plans_equal_reference(net, bytes_w):
    for kind, geo, pool in _layers(net):
        for b in BATCHES:
            if kind == "fc":
                k, n = geo
                assert tdf.classify_regime(b, n, k, 4, bytes_w=bytes_w) == \
                    rdf.classify_regime(b, n, k, 4, bytes_w=bytes_w)
                _same(tdf.plan_fc(b, n, k, bytes_in=4, bytes_w=bytes_w),
                      rdf.plan_fc(b, n, k, bytes_in=4, bytes_w=bytes_w))
                _same(tdf.plan_matmul(b, n, k, bytes_in=4, bytes_w=bytes_w),
                      rdf.plan_matmul(b, n, k, bytes_in=4, bytes_w=bytes_w))
                assert tdf.fc_flip_batch(n, k, bytes_in=4, bytes_w=bytes_w) \
                    == rdf.fc_flip_batch(n, k, bytes_in=4, bytes_w=bytes_w)
                continue
            h, w, ci, p, q, co, stride = geo
            kw = dict(stride=stride, bytes_in=4, bytes_w=bytes_w)
            assert tdf.classify_conv_regime(b, h, w, ci, p, q, co, **kw) == \
                rdf.classify_conv_regime(b, h, w, ci, p, q, co, **kw)
            for act in ("relu", "silu"):
                tp = tdf.PoolSpec(*pool) if pool else None
                rp = rdf.PoolSpec(*pool) if pool else None
                _same(tdf.plan_conv(b, h, w, ci, p, q, co, pool=tp, act=act,
                                    **kw),
                      rdf.plan_conv(b, h, w, ci, p, q, co, pool=rp, act=act,
                                    **kw))
            assert tdf.compulsory_conv_bytes(b, h, w, ci, p, q, co, **kw) == \
                rdf.compulsory_conv_bytes(b, h, w, ci, p, q, co, **kw)


def test_plan_errors_and_budgets_equal_reference():
    with pytest.raises(tdf.PlanError) as te:
        tdf.plan_fc(16, 256, 256, bytes_in=4, vmem_budget=1024)
    with pytest.raises(rdf.PlanError) as re_:
        rdf.plan_fc(16, 256, 256, bytes_in=4, vmem_budget=1024)
    assert str(te.value) == str(re_.value)
    _same(tdf.plan_fc(256, 4096, 9216, bytes_in=4, vmem_budget=400 * 1024),
          rdf.plan_fc(256, 4096, 9216, bytes_in=4, vmem_budget=400 * 1024))
    _same(tdf.plan_conv(1, 21, 21, 64, 3, 3, 128, bytes_in=4, bytes_w=4,
                        vmem_budget=64 * 1024, pool=tdf.PoolSpec(3, 2),
                        act="relu"),
          rdf.plan_conv(1, 21, 21, 64, 3, 3, 128, bytes_in=4, bytes_w=4,
                        vmem_budget=64 * 1024, pool=rdf.PoolSpec(3, 2),
                        act="relu"))
    assert tdf.compulsory_bytes(64, 4096, 9216, 4) == \
        rdf.compulsory_bytes(64, 4096, 9216, 4)


def _ref_params(net: str, int8: bool):
    def make():
        p = rcnn.init_cnn(net, jax.random.PRNGKey(0))
        return rquant.quantize_cnn_params(p) if int8 else p
    return jax.eval_shape(make)


def _port_params(net: str, int8: bool):
    params = [{} if kind == "pool" else
              {"f" if kind == "conv" else "w":
               torch.empty(shape, device="meta"),
               "b": torch.empty(shape[-1], device="meta")}
              for kind, shape in tcnn.param_shapes(net)]
    return tquant.quantize_cnn_params(params) if int8 else params


@pytest.mark.parametrize("net", ["alexnet", "vgg16"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("int8", [False, True])
def test_compile_cnn_stages_equal_reference(net, batch, int8):
    """Both stage schedules at full size: the same op keys, the same plans."""
    tpair = tsched.LayerSchedule.compile_cnn_stages(
        net, batch=batch, params=_port_params(net, int8))
    rpair = rsched.LayerSchedule.compile_cnn_stages(
        net, batch=batch, params=_ref_params(net, int8))
    for t, r in zip(tpair, rpair):
        assert len(t) == len(r)
        assert len(t.conv_entries) == len(r.conv_entries)
        for (tk, tp), (rk, rp) in zip(t.items(), r.items()):
            _same(tk, rk)
            _same(tp, rp)
        for (tk, tp), (rk, rp) in zip(t.conv_entries.items(),
                                      r.conv_entries.items()):
            _same(tk, rk)
            _same(tp, rp)
        assert t.table() == r.table()


def test_compile_cnn_is_memoized_and_small_config_equals_reference():
    tsched.clear_schedule_cache()
    a = tsched.LayerSchedule.compile_cnn("alexnet", batch=2, in_res=67,
                                         width_mult=0.125)
    assert tsched.LayerSchedule.compile_cnn("alexnet", batch=2, in_res=67,
                                            width_mult=0.125) is a
    r = rsched.LayerSchedule.compile_cnn("alexnet", batch=2, in_res=67,
                                         width_mult=0.125)
    assert a.table() == r.table()
    assert sum(p.fuse_pool for p in a.conv_entries.values()) == 3


def test_schedule_registry_conflicts_raise():
    reg = tsched.ScheduleRegistry()
    pair = reg.register("alexnet", batch=2, in_res=67, width_mult=0.125)
    assert reg.register("alexnet", batch=2, in_res=67,
                        width_mult=0.125) is pair
    assert ("alexnet", "float32", 2) in reg and len(reg) == 1
    with pytest.raises(ValueError, match="conflicting"):
        reg.register("alexnet", batch=2, in_res=67, width_mult=0.25)
    with pytest.raises(KeyError):
        reg.stages("vgg16", "float32", 2)


def test_policy_forcing_equals_reference():
    from repro.core.engine import DispatchPolicy as RPolicy
    for force in ("sa_conv", "sa_fc"):
        t = DispatchPolicy(force_regime=force)
        r = RPolicy(force_regime=force)
        assert t.regime_for("fc1", 64, 4096, 9216, act_bytes=4) == \
            r.regime_for("fc1", 64, 4096, 9216, act_bytes=4)
    with pytest.raises(ValueError):
        DispatchPolicy(force_regime="mxu")


@pytest.mark.parametrize("shape,batch_dims", [
    ((11, 11, 3, 96), 0), ((9216, 512), 0), ((300, 200), 0),
    ((3, 3, 6, 24), 0), ((4, 64, 32), 1)])
def test_quantize_bit_for_bit(shape, batch_dims):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.05
         ).astype(np.float32)
    w[..., 0] = 0.0                              # an all-zero channel
    r = rquant.quantize(jnp.asarray(w), batch_dims=batch_dims)
    t = tquant.quantize(torch.from_numpy(w), batch_dims=batch_dims)
    assert t.q.dtype == torch.int8
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(r.q))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(r.scale))
    np.testing.assert_array_equal(
        tquant.dequantize(t, torch.float32).numpy(),
        np.asarray(rquant.dequantize(r, jnp.float32)))
