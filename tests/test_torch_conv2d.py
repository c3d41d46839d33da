"""The last modules of the CNN package against the JAX package, on the CPU:
``models/cnn.py``'s ``fc_head``, ``init_fc_head`` and ``fc_head_forward``,
``kernels/conv2d.py``'s ``conv2d_mpna`` and ``conv2d_im2col``, and
``kernels/ops.py``.

Inputs are made with numpy from a seed and handed to both packages; the
reference runs its Pallas kernels in interpret mode, as its own tests do.
Tolerances are the reference's (``tests/test_kernels.py``): 3e-4 for fp32
matmuls, 2e-3 for convolutions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import Engine as REngine
from repro.kernels import conv2d as rconv
from repro.kernels import ops as rops
from repro.models import cnn as rcnn
from repro_torch.convert import params_from_reference
from repro_torch.core.engine import Engine
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels.sa_conv import sa_conv_matmul
from repro_torch.models import cnn as tcnn

TOL_FC = dict(rtol=3e-4, atol=3e-4)
TOL_CONV = dict(rtol=2e-3, atol=2e-3)


def _np(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# fc_head, init_fc_head, fc_head_forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [
    ("alexnet", {}), ("vgg16", {}), ("alexnet", dict(width_mult=0.25)),
    ("vgg16", dict(width_mult=1 / 64)), ("alexnet", dict(in_res=195)),
    ("vgg16", dict(in_res=64, in_ch=1))])
def test_fc_head_equals_reference(name, kw):
    assert tcnn.fc_head(name, **kw) == rcnn.fc_head(name, **kw)


def test_fc_head_of_alexnet_is_its_classifier():
    assert tcnn.fc_head("alexnet") == [(9216, 4096, "relu"),
                                       (4096, 4096, "relu"),
                                       (4096, 1000, "none")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_fc_head_shapes_and_seed(dtype):
    head = tcnn.fc_head("alexnet", width_mult=1 / 32)
    params = tcnn.init_fc_head(head, 0, dtype=dtype, device="cpu")
    again = tcnn.init_fc_head(head, torch.Generator().manual_seed(0),
                              dtype=dtype, device="cpu")
    assert len(params) == len(head)
    for (fan_in, fan_out, _), p, q in zip(head, params, again):
        assert p["w"].shape == (fan_in, fan_out) and p["w"].dtype == dtype
        assert p["b"].shape == (fan_out,) and not p["b"].any()
        assert torch.equal(p["w"], q["w"])
        # truncated normal at +-3 sigma, scaled by fan_in^-0.5
        assert p["w"].float().abs().max() <= 3 * fan_in ** -0.5 * 1.01
    other = tcnn.init_fc_head(head, 1, dtype=dtype, device="cpu")
    assert not torch.equal(params[0]["w"], other[0]["w"])


@pytest.mark.parametrize("name,width,batch", [("alexnet", 1 / 32, 5),
                                               ("vgg16", 1 / 64, 3)])
def test_fc_head_forward_matches_reference(name, width, batch):
    """The reference's head parameters carried across; both run every
    layer as an engine matmul named fc1.. on their kernels (the reference's
    Pallas kernels in interpret mode), with the same plans."""
    head = rcnn.fc_head(name, width_mult=width)
    rp = rcnn.init_fc_head(head, jax.random.PRNGKey(0))
    tp = params_from_reference(rp, device="cpu")
    x = _np(3, (batch, head[0][0]))
    reng = REngine(backend="pallas", interpret=True)
    with reng.tracing() as rtr:
        want = rcnn.fc_head_forward(head, rp, jnp.asarray(x), eng=reng)
    eng = Engine(backend="kernels")
    with eng.tracing() as tr:
        got = tcnn.fc_head_forward(head, tp, torch.from_numpy(x), eng=eng)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_FC)
    assert [r.name for r in tr] == [r.name for r in rtr] == \
        [f"fc{i}" for i in range(1, len(head) + 1)]
    assert [(r.regime, r.m, r.n, r.k) for r in tr] == \
        [(r.regime, r.m, r.n, r.k) for r in rtr]


def test_fc_head_forward_defaults_to_the_kernels_backend():
    head = tcnn.fc_head("alexnet", width_mult=1 / 64)
    params = tcnn.init_fc_head(head, 0, device="cpu")
    x = torch.from_numpy(_np(4, (2, head[0][0])))
    before = ref.matmul_bias_act.calls
    eng = Engine(backend="torch")
    with eng.tracing() as tr, eng.activate():
        got = tcnn.fc_head_forward(head, params, x)
    assert {r.backend for r in tr} == {"kernels"}
    assert ref.matmul_bias_act.calls == before + len(head)
    torch.testing.assert_close(got, tcnn.fc_head_forward(
        head, params, x, backend="torch"), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# conv2d_im2col and conv2d_mpna
# ---------------------------------------------------------------------------
CONV_CASES = [(2, 16, 16, 3, 3, 3, 32, 1), (1, 27, 27, 48, 5, 5, 64, 1),
              (2, 15, 15, 8, 3, 3, 16, 2), (1, 35, 35, 3, 11, 11, 16, 4)]


def _conv_inputs(n, h, w, i, p, q, j):
    return _np(0, (n, h, w, i)), _np(1, (p, q, i, j), 0.1), _np(2, (j,))


@pytest.mark.parametrize("n,h,w,i,p,q,j,s", CONV_CASES)
def test_conv2d_im2col_matches_reference(n, h, w, i, p, q, j, s):
    x, f, b = _conv_inputs(n, h, w, i, p, q, j)
    want = rconv.conv2d_im2col(jnp.asarray(x), jnp.asarray(f),
                               jnp.asarray(b), stride=s, act="relu")
    got = tconv.conv2d_im2col(torch.from_numpy(x), torch.from_numpy(f),
                              torch.from_numpy(b), stride=s, act="relu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_CONV)


@pytest.mark.parametrize("n,h,w,i,p,q,j,s", CONV_CASES)
def test_conv2d_mpna_matches_reference(n, h, w, i, p, q, j, s):
    x, f, b = _conv_inputs(n, h, w, i, p, q, j)
    reng = REngine(backend="xla")
    with reng.tracing() as rtr, reng.activate():
        want = rconv.conv2d_mpna(jnp.asarray(x), jnp.asarray(f),
                                 jnp.asarray(b), stride=s, act="relu")
    eng = Engine(backend="torch")
    with eng.tracing() as tr, eng.activate():
        got = tconv.conv2d_mpna(torch.from_numpy(x), torch.from_numpy(f),
                                torch.from_numpy(b), stride=s, act="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_CONV)
    (rec,), (rrec,) = list(tr), list(rtr)
    assert rec.name == rrec.name == "conv2d_mpna" and rec.backend == "kernels"
    assert (rec.regime, rec.m, rec.n, rec.k, rec.conv_shape) == \
        (rrec.regime, rrec.m, rrec.n, rrec.k, rrec.conv_shape)


@pytest.mark.parametrize("n,h,w,i,p,q,j,s", CONV_CASES)
def test_conv2d_im2col_equals_conv2d_mpna(n, h, w, i, p, q, j, s):
    x, f, b = (torch.from_numpy(a) for a in _conv_inputs(n, h, w, i, p, q, j))
    torch.testing.assert_close(
        tconv.conv2d_im2col(x, f, b, stride=s, act="relu"),
        tconv.conv2d_mpna(x, f, b, stride=s, act="relu"), **TOL_CONV)


def test_im2col_orders_features_as_the_reference():
    """(I, P, Q) features, as ``conv_general_dilated_patches`` gives them,
    exactly."""
    x = _np(5, (2, 9, 8, 3))
    want = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (3, 2), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tconv.im2col(torch.from_numpy(x), 3, 2, 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(got.shape))


def test_conv2d_im2col_runs_one_gemm():
    """The patch matrix goes through the SA-CONV GEMM wrapper once (its
    plain version on the CPU)."""
    x, f, b = (torch.from_numpy(a) for a in _conv_inputs(1, 9, 9, 4, 3, 3, 8))
    before = ref.matmul_bias_act.calls
    tconv.conv2d_im2col(x, f, b)
    assert ref.matmul_bias_act.calls == before + 1


def test_ops_reexports_the_kernel_api():
    assert tops.__all__ == rops.__all__
    assert tops.conv2d_im2col is tconv.conv2d_im2col
    assert tops.sa_conv_matmul is sa_conv_matmul and tops.ref is ref
