"""``repro_torch.core.roofline`` against the JAX package's
``repro.core.roofline``: every schedule-derived function on the planner's
chip (``TPU_V5E``) for the AlexNet and VGG-16 schedules, fp32 and int8,
equal to the reference's; the H100's terms against hand arithmetic; and
the meta-device count on small known workloads."""
from __future__ import annotations

import math

import jax
import pytest
import torch

from repro.core import quant as rquant
from repro.core import roofline as rroof
from repro.core import schedule as rsched
from repro.core.accelerator import TPU_V5E as R_TPU
from repro.models import cnn as rcnn
from repro_torch.core import quant as tquant
from repro_torch.core import roofline as troof
from repro_torch.core import schedule as tsched
from repro_torch.core.accelerator import H100_SXM, TPU_V5E
from repro_torch.core.engine import Engine
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.models import cnn as tcnn

CASES = [(net, int8, batch) for net in ("alexnet", "vgg16")
         for int8 in (False, True) for batch in (1, 16)]


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


def _terms(t) -> tuple:
    return (t.flops_per_chip, t.hbm_bytes_per_chip, t.wire_bytes_per_chip,
            t.chips, t.model_flops)


@pytest.mark.parametrize("net,int8,batch", CASES,
                         ids=[f"{n}-{'int8' if q else 'fp32'}-b{b}"
                              for n, q, b in CASES])
def test_schedule_roofline_equals_reference(net, int8, batch):
    """terms_from_schedule (and every term of it on TPU_V5E), the fused
    pool and FC batch traffic reports and the dual-array overlap report
    are the reference's, float for float."""
    t = tsched.LayerSchedule.compile_cnn(net, batch=batch,
                                         params=_port_params(net, int8))
    r = rsched.LayerSchedule.compile_cnn(net, batch=batch,
                                         params=_ref_params(net, int8))
    for chips, mf in ((1, 0.0), (4, 1.5e12)):
        tt = troof.terms_from_schedule(t, chips, mf)
        rt = rroof.terms_from_schedule(r, chips, mf)
        assert _terms(tt) == _terms(rt)
        assert tt.compute_s(TPU_V5E) == rt.compute_s(R_TPU)
        assert tt.memory_s(TPU_V5E) == rt.memory_s(R_TPU)
        assert tt.collective_s(TPU_V5E) == rt.collective_s(R_TPU)
        assert tt.bound_s(TPU_V5E) == rt.bound_s(R_TPU)
        assert tt.dominant(TPU_V5E) == rt.dominant(R_TPU)
        if mf:
            assert tt.useful_flops_fraction() == rt.useful_flops_fraction()
            assert tt.roofline_fraction(TPU_V5E) == \
                rt.roofline_fraction(R_TPU)
    assert troof.fused_pool_traffic_from_schedule(t) == \
        rroof.fused_pool_traffic_from_schedule(r)
    assert troof.fc_batch_traffic_from_schedule(t) == \
        rroof.fc_batch_traffic_from_schedule(r)
    tc, tf = tsched.LayerSchedule.compile_cnn_stages(
        net, batch=batch, params=_port_params(net, int8))
    rc, rf = rsched.LayerSchedule.compile_cnn_stages(
        net, batch=batch, params=_ref_params(net, int8))
    for waves in (1, 7):
        assert troof.pipeline_overlap_from_schedule(
            tc, tf, waves=waves, chip=TPU_V5E) == \
            rroof.pipeline_overlap_from_schedule(rc, rf, waves=waves,
                                                 chip=R_TPU)
    assert troof.model_flops_train(7, 11) == rroof.model_flops_train(7, 11)
    assert troof.model_flops_decode(7, 11) == rroof.model_flops_decode(7, 11)


def test_wire_factors_equal_reference():
    for kind, f in troof.WIRE_FACTOR.items():
        for g in (2, 4, 16, 256):
            assert f(g) == rroof._WIRE_FACTOR[kind](g)


def test_h100_terms_by_hand():
    """The H100's rates: bf16 and fp32 peaks, HBM, NVLink inside an
    8-GPU node and the NIC outside it, each term by hand."""
    assert H100_SXM.peak_flops("bfloat16") == 989e12
    assert H100_SXM.peak_flops("float32") == 67e12
    assert H100_SXM.hbm_bandwidth == 3.35e12 and \
        H100_SXM.hbm_bytes == 80 * 10**9
    mesh = AbstractMesh((2, 4), ("data", "model"))      # 8 GPUs: one node
    pod = AbstractMesh((16, 16), ("data", "model"))     # 256: model > 8
    small = AbstractMesh((4, 2), ("data", "model"))
    assert H100_SXM.link_bandwidth(mesh, "model") == 450e9
    assert H100_SXM.link_bandwidth(mesh, "data") == 450e9
    assert H100_SXM.link_bandwidth(pod, "model") == 50e9
    assert H100_SXM.link_bandwidth(pod, "data") == 50e9
    assert H100_SXM.link_bandwidth(small, "model") == 450e9
    assert H100_SXM.link_bandwidth(None) == 50e9
    t = troof.RooflineTerms(flops_per_chip=2e12, hbm_bytes_per_chip=6.7e9,
                            wire_bytes_per_chip=1.5e9, chips=256,
                            model_flops=256e12, dtype="bfloat16",
                            wire_bytes_by_axis={"data": 1e9, "model": 5e8},
                            mesh=pod)
    assert t.compute_s(H100_SXM) == 2e12 / 989e12
    assert t.memory_s(H100_SXM) == 6.7e9 / 3.35e12
    assert t.collective_s(H100_SXM) == 1e9 / 50e9 + 5e8 / 50e9
    assert t.dominant(H100_SXM)[0] == "collective"
    assert t.bound_s(H100_SXM) == 0.03
    assert math.isclose(t.roofline_fraction(H100_SXM),
                        1e12 / (0.03 * 989e12), rel_tol=1e-15)
    assert t.useful_flops_fraction() == 256e12 / (2e12 * 256)
    f32 = troof.RooflineTerms(67e9, 0.0, 0.0, 1, dtype="float32")
    assert f32.compute_s(H100_SXM) == 1e-3
    assert f32.collective_s(H100_SXM) == 0.0
    # on the planner's chip every dtype takes the reference's bf16 peak
    assert f32.compute_s(TPU_V5E) == 67e9 / 197e12
    one = troof.RooflineTerms(0.0, 0.0, 4e9, 8, wire_bytes_by_axis={
        "data": 3e9, "model": 1e9}, mesh=mesh)
    assert one.collective_s(H100_SXM) == 3e9 / 450e9 + 1e9 / 450e9


def test_meta_count_by_hand():
    """A known chain on meta: the matmul-like ops' operations, op-level
    bytes, the kernel calls from the engine's log and the peak of live
    bytes."""
    x = torch.empty((8, 32), device="meta")
    w = torch.empty((32, 16), device="meta")
    eng = Engine(backend="kernels")
    with troof.MetaCount() as mc:
        y = x @ w                                       # aten.mm
        z = torch.bmm(y.reshape(2, 4, 16), torch.empty((2, 16, 5),
                                                       device="meta"))
        k = eng.matmul(x, w, name="attn.q")            # a kernel call
        del z
    assert mc.rows["aten.mm"].flops == 2 * 8 * 32 * 16
    assert mc.rows["aten.bmm"].flops == 2 * 2 * 4 * 16 * 5
    assert mc.rows["aten.mm"].nbytes == 4 * (8 * 32 + 32 * 16 + 8 * 16)
    assert [c.kernel for c in mc.calls] == ["sa_fc_matmul"]
    call = mc.calls[0]
    assert (call.name, call.role, call.shape, call.flops) == \
        ("attn.q", "forward", (8, 32, 16), 2 * 8 * 32 * 16)
    assert mc.kernel_flops() == 2 * 8 * 32 * 16
    assert mc.rows["attn.q forward [sa_fc_matmul]"].count == 1
    # y (512 B) with the bmm's second operand (640 B) and result (160 B);
    # the operand is gone (a temporary) when the kernel's output (512 B)
    # comes, so 512 + 160 + 512 is the most then
    assert mc.peak_live_bytes == 512 + 640 + 160
    assert mc.live_bytes == 512 + 512          # y and k; z deleted
    assert tuple(k.shape) == (8, 16) and k.device.type == "meta"
    flops, nbytes = mc.total()
    assert flops == 2 * 8 * 32 * 16 * 2 + 2 * 2 * 4 * 16 * 5
    top = troof.top_cost_lines(mc, 2, by="flops")
    assert [r[2] for r in top] == ["aten.mm", "attn.q forward [sa_fc_matmul]"]
    tr = troof.terms_from_trace(mc, 1, 1e6, divisor=lambda key: 2,
                                wire_bytes_by_axis={"model": 100.0},
                                mesh=AbstractMesh((1, 2), ("data", "model")),
                                dtype="float32")
    assert tr.flops_per_chip == flops / 2 and tr.hbm_bytes_per_chip == \
        nbytes / 2 and tr.wire_bytes_per_chip == 100.0
    assert tr.compute_s(H100_SXM) == flops / 2 / 67e12


def test_kernel_calls_log_every_role():
    """The count sees every call of the engine's kernel operators on meta
    tensors: a matmul with a non-linear activation calls its forward, and
    in the backward its ``pre``, ``dx`` (the forward's kernel) and ``dw``
    (the GEMM); flash calls its forward, costed over the visible pairs
    (causal: sq (sq + 1) / 2 pairs; a window of 16 over 32: 392); nothing
    launches, and no other op is taken for a kernel call."""
    eng = Engine(backend="kernels")
    x = torch.empty((256, 64), device="meta", requires_grad=True)
    w = torch.empty((64, 96), device="meta", requires_grad=True)
    q = torch.empty((2, 32, 4, 16), device="meta")
    with troof.MetaCount() as mc:
        y = eng.matmul(x, w, act="silu", name="mlp.gate")
        y.sum().backward()
        out = eng.attention(q, q, q, window=16, name="attn")
    log = mc.calls
    assert [(c.kernel, c.role, c.shape) for c in log] == [
        ("sa_fc_matmul", "forward", (256, 64, 96)),   # k = 64: SA-FC
        ("sa_fc_matmul", "pre", (256, 64, 96)),
        ("sa_fc_matmul", "dx", (256, 96, 64)),
        ("sa_conv_matmul", "dw", (64, 256, 96)),
        ("flash_attention", "forward", (2, 32, 32, 4, 4, 16, True, 16))]
    assert all(c.flops == 2 * 256 * 64 * 96 for c in log[:4])
    assert log[0].nbytes == 4 * (256 * 64 + 64 * 96 + 256 * 96)
    assert troof.visible_pairs(32, 32, True, 16) == 392
    assert troof.visible_pairs(512, 512, True, 0) == 512 * 513 // 2
    assert troof.visible_pairs(16, 1024, False, 0) == 16 * 1024
    assert log[4].flops == 4 * 2 * 4 * 16 * 392
    assert log[4].key == "attn forward [flash_attention]"
    assert out.device.type == "meta"
    assert sum(r.count for k, r in mc.rows.items()
               if not k.startswith("aten.")) == len(log)
