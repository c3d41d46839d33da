"""The port's CNN slice end to end on the CPU against the JAX package: the
forward, the server's waves and traces, the bitwise invariants inside the
port, the no-fallback rules and the import boundary."""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as rquant
from repro.core.engine import DispatchPolicy as RPolicy
from repro.core.engine import Engine as REngine
from repro.models import cnn as rcnn
from repro.serve.cnn_server import CNNRequest as RRequest
from repro.serve.cnn_server import CNNServer as RServer
from repro_torch.convert import params_from_reference
from repro_torch.core.dataflow import PoolSpec
from repro_torch.core.engine import DispatchPolicy, Engine
from repro_torch.core.quant import QTensor, quantize_cnn_params
from repro_torch.kernels import ref
from repro_torch.models import cnn
from repro_torch.serve.cnn_server import CNNRequest, CNNServer

RES, WIDTH = 67, 0.125
# logits through eight layers: fp32 in both packages, sums in other orders
TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref_params():
    return rcnn.init_cnn("alexnet", jax.random.PRNGKey(0), in_res=RES,
                         width_mult=WIDTH)


@pytest.fixture(scope="module")
def params(ref_params):
    return params_from_reference(ref_params, device="cpu")


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, RES, RES, 3)).astype(np.float32)


def _server(params, **kw):
    return CNNServer("alexnet", params, in_res=RES, width_mult=WIDTH,
                     device="cpu", **kw)


def _fields(rec) -> dict:
    d = dataclasses.asdict(rec)
    d.pop("backend")
    return d


# ---------------------------------------------------------------------------
# the forward against the reference
# ---------------------------------------------------------------------------
def test_forward_matches_reference_xla(ref_params, params):
    x = _images(3)
    want = rcnn.cnn_forward("alexnet", ref_params, jnp.asarray(x),
                            backend="xla")
    got = cnn.cnn_forward("alexnet", params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_matches_reference_pallas_interpret(ref_params, params):
    x = _images(1, seed=5)
    want = rcnn.cnn_forward("alexnet", ref_params, jnp.asarray(x),
                            backend="pallas", interpret=True)
    got = cnn.cnn_forward("alexnet", params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_forward_matches_reference(ref_params, params):
    x = _images(2, seed=6)
    want = rcnn.cnn_forward("alexnet", rquant.quantize_cnn_params(ref_params),
                            jnp.asarray(x), backend="xla")
    q = quantize_cnn_params(params)
    assert isinstance(q[0]["f"], QTensor) and q[1] == {}
    got = cnn.cnn_forward("alexnet", q, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the converter carries reference int8 leaves across unchanged
    carried = params_from_reference(rquant.quantize_cnn_params(ref_params),
                                    device="cpu")
    assert torch.equal(carried[0]["f"].q, q[0]["f"].q)
    assert torch.equal(carried[0]["f"].scale, q[0]["f"].scale)
    # and the int8 variant serves: int8 keys in every record, same logits
    srv = _server(q, max_batch=8)
    for i in range(2):
        srv.submit(CNNRequest(uid=i, image=x[i]))
    done = srv.run()
    assert [r.weight_dtype for r in srv.waves[0].trace] == ["int8"] * 8
    assert srv.waves[0].schedule_hits == 8
    for i, r in enumerate(done):
        assert np.array_equal(r.logits, got.numpy()[i])


# ---------------------------------------------------------------------------
# the server against the reference server
# ---------------------------------------------------------------------------
def test_waves_and_traces_equal_reference(ref_params, params):
    """Same waves, and every dispatch record equal field for field except
    the backend name."""
    x = _images(5, seed=1)
    srv = _server(params, max_batch=4)
    rsrv = RServer("alexnet", ref_params, in_res=RES, width_mult=WIDTH,
                   max_batch=4, engine=REngine(backend="xla"))
    assert srv.microbatch == rsrv.microbatch == 4
    for i in range(5):
        srv.submit(CNNRequest(uid=i, image=x[i]))
        rsrv.submit(RRequest(uid=i, image=x[i]))
    done = srv.run()
    rdone = rsrv.run()
    assert [w.uids for w in srv.waves] == [w.uids for w in rsrv.waves]
    for tw, rw in zip(srv.waves, rsrv.waves):
        assert tw.schedule_hits == rw.schedule_hits == len(tw.trace) == 8
        assert len(tw.trace) == len(rw.trace)
        for a, b in zip(tw.trace, rw.trace):
            assert _fields(a) == _fields(b)
            assert a.backend == "kernels"
    assert [r.uid for r in done] == [r.uid for r in rdone] == list(range(5))
    np.testing.assert_allclose(np.stack([r.logits for r in done]),
                               np.stack([r.logits for r in rdone]), **TOL)


@pytest.mark.parametrize("max_batch,budget", [(8, None), (64, None),
                                              (64, 200 * 1024)])
def test_microbatch_equals_reference(ref_params, params, max_batch, budget):
    srv = _server(params, max_batch=max_batch,
                  engine=Engine(backend="kernels",
                                policy=DispatchPolicy(vmem_budget=budget)))
    rsrv = RServer("alexnet", ref_params, in_res=RES, width_mult=WIDTH,
                   max_batch=max_batch,
                   engine=REngine(backend="xla",
                                  policy=RPolicy(vmem_budget=budget)))
    assert srv.preferred_microbatch == rsrv.preferred_microbatch
    assert srv.microbatch == rsrv.microbatch


# ---------------------------------------------------------------------------
# bitwise invariants inside the port
# ---------------------------------------------------------------------------
def test_batched_pipelined_sequential_and_unbatched_bitwise(params):
    x = _images(5, seed=2)
    pipe = _server(params, max_batch=8)
    seq = _server(params, max_batch=8, pipeline=False)
    for s in (pipe, seq):
        s.microbatch = 2
        for i in range(5):
            s.submit(CNNRequest(uid=i, image=x[i]))
    done = pipe.run()
    seq_done = seq.run()
    assert [w.batch for w in pipe.waves] == [w.batch for w in seq.waves] \
        == [2, 2, 1]
    assert [r.uid for r in done] == [r.uid for r in seq_done] == \
        [0, 1, 2, 3, 4]
    for w in pipe.waves:
        assert [r.wave for r in w.trace] == [w.wave] * 8
        assert [r.stage for r in w.trace] == ["conv"] * 5 + ["fc"] * 3
    for a, b in zip(done, seq_done):                 # pipelined == sequential
        assert np.array_equal(a.logits, b.logits)
    for i, r in enumerate(done):                     # batched == unbatched
        single = cnn.cnn_forward("alexnet", params,
                                 torch.from_numpy(x[i:i + 1].copy()))
        assert np.array_equal(single.numpy()[0], r.logits)


def test_fused_equals_unfused_inside_the_port():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 15, 15, 8)).astype(
        np.float32))
    f = torch.from_numpy((rng.standard_normal((3, 3, 8, 16)) * 0.2).astype(
        np.float32))
    eng = Engine(backend="kernels")
    for act in ("relu", "leaky_relu", "none"):
        fused = eng.conv2d(x, f, act=act, pool=PoolSpec(3, 2))
        unfused = eng.pool(eng.conv2d(x, f, act=act), window=3, stride=2)
        assert torch.equal(fused, unfused)


def test_plain_call_counts_skip_schedule_compilation(params):
    """On the CPU a wave's kernel wrappers run the plain versions once per
    dispatch (the fused pools inside the conv's); the schedule compiled on
    meta tensors on the way counts no plain calls."""
    ref.reset_counts()
    srv = _server(params, max_batch=2)
    srv.submit(CNNRequest(uid=0, image=_images(1)[0]))
    srv.run()
    c = ref.counts()
    assert c == {"matmul_bias_act": 3, "conv2d": 5, "maxpool2d": 3,
                 "attention": 0}


# ---------------------------------------------------------------------------
# server API
# ---------------------------------------------------------------------------
def test_duplicate_uids_are_rejected(params):
    srv = _server(params)
    img = _images(1)[0]
    srv.submit(CNNRequest(uid=0, image=img))
    with pytest.raises(ValueError, match="duplicate request uid 0"):
        srv.submit(CNNRequest(uid=0, image=img))
    srv.run()
    with pytest.raises(ValueError, match="duplicate request uid 0"):
        srv.submit(CNNRequest(uid=0, image=img))
    with pytest.raises(ValueError, match="image shape"):
        srv.submit(CNNRequest(uid=1, image=np.zeros((5, 5, 3), np.float32)))


def test_step_wave_cancel_drain_and_empty_queue(params):
    srv = _server(params, max_batch=4)
    assert srv.run() == [] and srv.step_wave() == [] and srv.drain() == []
    srv.microbatch = 2
    x = _images(5, seed=4)
    for i in range(5):
        srv.submit(CNNRequest(uid=i, image=x[i]))
    assert [r.uid for r in srv.step_wave()] == [0, 1]
    assert [r.uid for r in srv.cancel([3, 99])] == [3]
    assert [r.uid for r in srv.drain()] == [2, 4]
    assert [w.batch for w in srv.waves] == [2, 2]


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------
def test_default_device_entry_points_raise_without_cuda(ref_params, params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults are valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CNNServer("alexnet", params, in_res=RES, width_mult=WIDTH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn.init_cnn("alexnet", 0, in_res=RES, width_mult=WIDTH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_reference(ref_params)


def test_unported_routes_raise(params):
    """The sa_conv route now runs (the SA-CONV GEMM kernel's plain version
    here) and matches the reference; the matmul's backward runs too and
    equals the plain version's; conv2d's backward (the reference has none)
    and unknown backends still raise."""
    eng = Engine(backend="kernels",
                 policy=DispatchPolicy(force_regime="sa_conv"))
    rng = np.random.default_rng(0)
    xn = rng.standard_normal((4, 32)).astype(np.float32)
    wn = rng.standard_normal((32, 16)).astype(np.float32)
    with eng.tracing() as tr:
        got = eng.matmul(torch.from_numpy(xn), torch.from_numpy(wn),
                         name="fc")
    want = REngine(backend="pallas", interpret=True,
                   policy=RPolicy(force_regime="sa_conv")).matmul(
        jnp.asarray(xn), jnp.asarray(wn), name="fc")
    assert tr[0].regime == "sa_conv"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)
    grads = []
    for backend in ("kernels", "torch"):
        x = torch.from_numpy(xn).requires_grad_()
        w = torch.from_numpy(wn).requires_grad_()
        y = Engine(backend=backend).matmul(x, w, act="relu", name="fc")
        grads.append(torch.autograd.grad((y * y).sum(), (x, w)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    with pytest.raises(NotImplementedError, match="no backward for conv2d"):
        Engine(backend="kernels").conv2d(
            torch.zeros(1, 5, 5, 2, requires_grad=True),
            torch.zeros(3, 3, 2, 4), name="conv")
    with pytest.raises(ValueError, match="backend"):
        Engine(backend="pallas")


def test_init_cnn_is_seeded_and_shaped_like_reference(ref_params):
    a = cnn.init_cnn("alexnet", 7, in_res=RES, width_mult=WIDTH,
                     device="cpu")
    b = cnn.init_cnn("alexnet", 7, in_res=RES, width_mult=WIDTH,
                     device="cpu")
    for pa, pb, pr in zip(a, b, ref_params):
        assert sorted(pa) == sorted(pr)
        for k in pa:
            assert tuple(pa[k].shape) == tuple(pr[k].shape)
            assert torch.equal(pa[k], pb[k])
    fc1 = a[cnn.conv_stage_len("alexnet")]["w"]
    assert fc1.abs().max() <= 3 * fc1.shape[0] ** -0.5 + 1e-6
    assert [s.ofm for s in cnn.network_stats("alexnet")] == \
        [s.ofm for s in rcnn.network_stats("alexnet")]


# ---------------------------------------------------------------------------
# the import boundary
# ---------------------------------------------------------------------------
def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    port = ROOT / "src" / "repro_torch"
    assert {port / m for m in (
        "optim/adamw.py", "optim/grad_compress.py", "data/pipeline.py",
        "train/train_step.py", "train/trainer.py", "checkpoint/checkpoint.py",
        "launch/train.py", "core/tree.py")} <= set(files)
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "benchmarks",
                               "timing"), (path, name)
