"""The port's training slice on the CPU against the JAX package: the
kernels backend's matmul and attention VJPs, ``loss_fn``, the train
schedule, AdamW, gradient compression, the data pipeline, the train step,
checkpoints, the trainer and the launcher.

Inputs come from numpy seeds or from the reference's ``init_params`` and
batches, carried across as numpy.  The matmul VJPs are held against
``jax.grad`` through the reference's Pallas path in interpret mode (its
custom VJPs), at its own tolerances (``tests/test_engine_api.py``: 3e-4 in
fp32, 3e-2 in bf16); train steps against the reference's jitted XLA step,
which is how the reference trains.  On the CPU the port's kernel wrappers
take their plain versions.
"""
from __future__ import annotations

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.core import quant as rquant
from repro.core import schedule as rsched
from repro.core.engine import DispatchPolicy as RPolicy
from repro.core.engine import Engine as REngine
from repro.data import pipeline as rdata
from repro.kernels import ref as rref
from repro.models import transformer as RT
from repro.optim import adamw as radamw
from repro.optim import grad_compress as rgc
from repro.train import train_step as RTS
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import schedule as tsched
from repro_torch.core import tree
from repro_torch.core.engine import DispatchPolicy, Engine
from repro_torch.core.quant import QTensor
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import ref
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, grad_compress
from repro_torch.train import train_step as TS
from repro_torch.train import trainer

TOL = {"float32": dict(rtol=3e-4, atol=3e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}

# the tiny config of tests/test_train.py
_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
             param_dtype="float32", compute_dtype="float32")
RCFG = rbase.ModelConfig(**_TINY)
TCFG = tbase.ModelConfig(**_TINY)
KERNELS = Engine(backend="kernels")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy() \
            if t.dtype == torch.bfloat16 else t.detach().numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(got, want, **tol) -> None:
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _pair(a: np.ndarray, dtype: str):
    """(jax array, torch tensor) of the same values in ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t


def _tiny_params(cfg=RCFG, seed=0):
    rp = RT.init_params(cfg, jax.random.PRNGKey(seed))
    return rp, lm_params_from_reference(rp, device="cpu")


def _ref_batch(cfg, batch: int, seq: int, step: int = 0) -> dict:
    return rdata.SyntheticLM(rdata.DataConfig(cfg.vocab_size, seq, batch,
                                              seed=1), cfg).batch_at(step)


def _port_batch(rb: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}


# ---------------------------------------------------------------------------
# the matmul VJPs (tests/test_engine_api.py:201,246,262)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("regime", ["sa_fc", "sa_conv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu"])
def test_matmul_vjp_matches_reference(regime, dtype, bias, act):
    rng = np.random.default_rng(0)
    xn = rng.standard_normal((8, 64)).astype(np.float32)
    wn = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    bn = rng.standard_normal(48).astype(np.float32)
    cot = rng.standard_normal((8, 48)).astype(np.float32)
    (xj, xt), (wj, wt), (bj, bt) = (_pair(a, dtype) for a in (xn, wn, bn))
    reng = REngine(backend="pallas", interpret=True,
                   policy=RPolicy(force_regime=regime))

    def rloss(*args):
        y = reng.matmul(args[0], args[1], args[2] if bias else None,
                        act=act)
        return jnp.sum(y.astype(jnp.float32) * cot)

    argnums = (0, 1, 2) if bias else (0, 1)
    want = jax.grad(rloss, argnums=argnums)(xj, wj, bj)
    live = [t.requires_grad_() for t in (xt, wt, bt)[:len(argnums)]]
    eng = Engine(backend="kernels", policy=DispatchPolicy(
        force_regime=regime))
    with eng.tracing() as tr:
        y = eng.matmul(live[0], live[1], live[2] if bias else None, act=act)
    got = torch.autograd.grad((y.float() * torch.from_numpy(cot)).sum(),
                              live)
    assert len(tr) == 1 and tr[0].regime == regime      # backward: no records
    for g, w, t in zip(got, want, live):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, **TOL[dtype])


@pytest.mark.parametrize("regime", ["sa_fc", "sa_conv"])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_quantized_matmul_vjp_matches_reference(regime, act):
    """int8 weights stay frozen: gradients reach x and bias only, dx
    streams the raw int8 transpose with the scale folded into dpre."""
    rng = np.random.default_rng(1)
    xn = (rng.standard_normal((8, 256)) * 0.5).astype(np.float32)
    wn = (rng.standard_normal((256, 128)) * 0.1).astype(np.float32)
    bn = rng.standard_normal(128).astype(np.float32)
    qt = rquant.quantize(jnp.asarray(wn))
    reng = REngine(backend="pallas", interpret=True,
                   policy=RPolicy(force_regime=regime))
    want = jax.grad(lambda a, c: jnp.sum(
        reng.matmul(a, qt, c, act=act) ** 2), argnums=(0, 1))(
        jnp.asarray(xn), jnp.asarray(bn))
    tq = QTensor(torch.from_numpy(np.array(qt.q)),
                 torch.from_numpy(np.array(qt.scale)))
    x = torch.from_numpy(xn).requires_grad_()
    b = torch.from_numpy(bn).requires_grad_()
    y = Engine(backend="kernels", policy=DispatchPolicy(
        force_regime=regime)).matmul(x, tq, b, act=act)
    got = torch.autograd.grad((y ** 2).sum(), (x, b))
    for g, w in zip(got, want):
        _close(g, w, **TOL["float32"])


def test_matmul_backward_launches_the_forward_kernels(monkeypatch):
    """Backward runs the forward's kernels (the wrappers' plain versions on
    the CPU): dx on the regime's kernel, dw on the SA-CONV GEMM, and the
    pre-activation again only where the activation is not linear."""
    from repro_torch.core import engine as eng_mod
    calls = []
    real = {n: getattr(eng_mod, n) for n in ("sa_fc_matmul",
                                             "sa_conv_matmul")}
    for name, fn in real.items():
        monkeypatch.setattr(eng_mod, name, lambda *a, _n=name, _f=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    x = torch.randn(4, 32, requires_grad=True)
    w = torch.randn(32, 16, requires_grad=True)
    for act, want in (("none", ["sa_fc_matmul", "sa_fc_matmul",
                                "sa_conv_matmul"]),
                      ("silu", ["sa_fc_matmul", "sa_fc_matmul",
                                "sa_fc_matmul", "sa_conv_matmul"])):
        calls.clear()
        y = Engine(backend="kernels", policy=DispatchPolicy(
            force_regime="sa_fc")).matmul(x, w, act=act)
        y.sum().backward()
        assert calls == want, (act, calls)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hq,hkv,window,softcap", [
    (4, 4, 0, 0.0), (4, 2, 8, 0.0), (4, 2, 0, 5.0)])
def test_attention_grads_match_reference(hq, hkv, window, softcap):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 20, h, 16)).astype(np.float32)
               for h in (hq, hkv, hkv))
    cot = rng.standard_normal((2, 20, hq, 16)).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(rref.attention(
        a, b, c, causal=True, window=window, softcap=softcap) * cot),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    live = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ref.reset_counts()
    out = KERNELS.attention(*live, window=window, softcap=softcap)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), live)
    # the forward (the flash wrapper's plain version here) and the plain
    # backward's recompute
    assert ref.counts()["attention"] == 2
    for g, w in zip(got, want):
        _close(g, w, **TOL["float32"])


# ---------------------------------------------------------------------------
# loss and schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_loss_fn_matches_reference(masked):
    rp, tp = _tiny_params()
    rb = _ref_batch(RCFG, 4, 16)
    if masked:
        rb["loss_mask"] = jnp.asarray(np.random.default_rng(3).integers(
            0, 2, (4, 16)).astype(np.float32))
    want, wparts = jax.jit(lambda p, b: RT.loss_fn(RCFG, p, b))(rp, rb)
    got, parts = T.loss_fn(TCFG, tp, _port_batch(rb))
    assert abs(float(got) - float(want)) <= 1e-5
    assert abs(float(parts["ce"]) - float(wparts["ce"])) <= 1e-5
    assert float(parts["aux"]) == float(wparts["aux"]) == 0.0


def test_tied_loss_trains_embed_not_its_copy():
    """A tied model's head comes from ``embed`` in the loss: the gradient
    of ``embed`` is the reference's (embedding + head), and ``embed_t``
    is not read."""
    kw = dict(param_dtype="float32", compute_dtype="float32")
    rcfg = rbase.reduced(rreg.get_config("olmo-1b"), **kw)
    tcfg = tbase.reduced(treg.get_config("olmo-1b"), **kw)
    rp, tp = _tiny_params(rcfg)
    rb = _ref_batch(rcfg, 2, 16)
    want = jax.jit(jax.grad(lambda p: RT.loss_fn(rcfg, p, rb)[0]))(
        rp)["embed"]
    tp = {**tp, "embed_t": torch.full_like(tp["embed_t"], float("nan"))}
    _, grads = TS.value_and_grad(lambda p, b: T.loss_fn(tcfg, p, b),
                                 T.trainable(tp), _port_batch(rb))
    assert "embed_t" not in grads
    _close(grads["embed"], want, **TOL["float32"])


def test_train_schedule_equals_reference_tiny():
    """The tiny config's train schedule, at the full batch and at a
    microbatch, equals the reference's field for field."""
    for batch in (8, 2):
        r = rsched.LayerSchedule.compile(RCFG, "train", batch=batch, seq=32)
        t = tsched.LayerSchedule.compile(TCFG, "train", batch=batch, seq=32)
        assert t.phase == "train" and len(t) == len(r) == 8
        assert {(dataclasses.astuple(k), dataclasses.astuple(v))
                for k, v in t.items()} == \
            {(dataclasses.astuple(k), dataclasses.astuple(v))
             for k, v in r.items()}


# ---------------------------------------------------------------------------
# AdamW and gradient compression
# ---------------------------------------------------------------------------
def _trees(seed: int, shapes=((8, 8), (5,), (3, 4, 6))):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    rt = {"b": [jnp.asarray(arrs[0]), {"c": jnp.asarray(arrs[1])}],
          "a": jnp.asarray(arrs[2])}
    tt = {"b": [torch.from_numpy(arrs[0]), {"c": torch.from_numpy(arrs[1])}],
          "a": torch.from_numpy(arrs[2])}
    return rt, tt


def _assert_trees(got, want, **tol) -> None:
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(np.shape(w))
        _close(g, w, **tol)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_apply_matches_reference(moment_dtype):
    tc = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=1.0,
              moment_dtype=moment_dtype)
    rtc, ttc = rbase.TrainConfig(**tc), tbase.TrainConfig(**tc)
    rp, tp = _trees(0)
    rs, ts = radamw.init(rp, rtc), adamw.init(tp, ttc)
    for step in range(4):
        rg, tg = _trees(10 + step)
        rp, rs, rm = radamw.apply(rp, rg, rs, rtc)
        tp, ts, tm = adamw.apply(tp, tg, ts, ttc)
        assert int(ts.step) == int(rs.step) == step + 1
        for key in ("lr", "grad_norm"):
            assert abs(float(tm[key]) - float(rm[key])) <= \
                1e-6 * abs(float(rm[key]))
        _assert_trees(tp, rp, rtol=1e-5, atol=1e-6)
        tol = dict(rtol=1e-5, atol=1e-7) if moment_dtype == "float32" \
            else dict(rtol=1e-2, atol=1e-7)
        _assert_trees(ts.m, rs.m, **tol)
        _assert_trees(ts.v, rs.v, **tol)
        assert all(t.dtype == getattr(torch, moment_dtype)
                   for t in tree.leaves(ts.m) + tree.leaves(ts.v))


def test_lr_schedule_matches_reference():
    tc = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    rtc, ttc = rbase.TrainConfig(**tc), tbase.TrainConfig(**tc)
    got = [float(adamw.lr_schedule(ttc, torch.tensor(s, dtype=torch.int32)))
           for s in range(100)]
    want = [float(radamw.lr_schedule(rtc, jnp.int32(s))) for s in range(100)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] < got[9] <= 1e-3 + 1e-9 and got[99] < got[50] < got[15]


def test_grad_clip_matches_reference():
    g = {"w": torch.ones(4, 4) * 100.0}
    clipped, gn = adamw.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(400.0)
    assert float(clipped["w"].norm()) == pytest.approx(1.0, rel=1e-5)
    rg, tg = _trees(4)
    rc, rn = radamw.clip_by_global_norm(rg, 0.5)
    tc, tn = adamw.clip_by_global_norm(tg, 0.5)
    assert abs(float(tn) - float(rn)) <= 1e-6 * float(rn)
    _assert_trees(tc, rc, rtol=1e-6, atol=1e-7)


def _distinct(seed: int, shape) -> np.ndarray:
    """Values of distinct magnitudes (no ties for top-k to order)."""
    n = int(np.prod(shape))
    rng = np.random.default_rng(seed)
    mags = rng.permutation(np.linspace(0.01, 3.0, n))
    signs = rng.choice([-1.0, 1.0], n)
    return (mags * signs).reshape(shape).astype(np.float32)


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_grad_compress_matches_reference(scheme):
    """Five steps with error feedback: the roundtripped grads and the
    residuals equal the reference's."""
    shapes = {"w": (40, 30), "b": (7,)}
    rstate = rgc.init({k: jnp.zeros(s) for k, s in shapes.items()})
    tstate = grad_compress.init({k: torch.zeros(s)
                                 for k, s in shapes.items()})
    for step in range(5):
        arrs = {k: _distinct(10 * step + i, s)
                for i, (k, s) in enumerate(shapes.items())}
        rout, rstate = rgc.compress_grads(
            {k: jnp.asarray(a) for k, a in arrs.items()}, rstate, scheme)
        tout, tstate = grad_compress.compress_grads(
            {k: torch.from_numpy(a) for k, a in arrs.items()}, tstate,
            scheme)
        _assert_trees(tout, rout, rtol=1e-6, atol=1e-6)
        _assert_trees(tstate.error, rstate.error, rtol=1e-5, atol=1e-6)
    same, st = grad_compress.compress_grads({"w": torch.ones(3)}, tstate,
                                            "none")
    assert st is tstate and torch.equal(same["w"], torch.ones(3))


def test_wire_bytes_match_reference():
    rp = {"w": jnp.zeros((1000, 1000)), "b": [jnp.zeros(7)]}
    tp = {"w": torch.zeros(1000, 1000), "b": [torch.zeros(7)]}
    for scheme in ("none", "int8", "topk"):
        assert grad_compress.wire_bytes(tp, scheme) == \
            rgc.wire_bytes(rp, scheme)
    full = grad_compress.wire_bytes(tp, "none")
    assert grad_compress.wire_bytes(tp, "int8") < 0.3 * full
    assert grad_compress.wire_bytes(tp, "topk") < 0.05 * full


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_data_pipeline_deterministic_resumable_structured():
    dc = tdata.DataConfig(vocab_size=97, seq_len=16, global_batch=4, seed=7)
    a, b = tdata.SyntheticLM(dc), tdata.SyntheticLM(dc)
    ta = a.batch_at(5)["tokens"]
    assert ta.dtype == torch.int64 and ta.shape == (4, 16)
    assert torch.equal(ta, b.batch_at(5)["tokens"])
    assert not torch.equal(ta, a.batch_at(6)["tokens"])
    it = iter(a)
    assert all(torch.equal(next(it)["tokens"], a.batch_at(s)["tokens"])
               for s in range(3))
    # every odd position repeats (prev * 2 + 1) mod V of the one before
    assert torch.equal(ta[:, 1::2], (ta[:, 0::2] * 2 + 1) % 97)
    s0 = tdata.SyntheticLM(dataclasses.replace(dc, n_shards=2, shard=0))
    s1 = tdata.SyntheticLM(dataclasses.replace(dc, n_shards=2, shard=1))
    assert s0.local_batch == 2
    assert not torch.equal(s0.batch_at(0)["tokens"], s1.batch_at(0)["tokens"])
    # the Zipf marginal: the same probabilities as the reference's, and
    # the most frequent token at even positions is token 0
    rprobs = np.asarray(rdata.SyntheticLM(rdata.DataConfig(
        97, 16, 4, seed=7))._probs)
    np.testing.assert_allclose(tdata.zipf_probs(97).numpy(), rprobs,
                               rtol=1e-6)
    big = tdata.SyntheticLM(tdata.DataConfig(97, 64, 64)).batch_at(0)
    even = big["tokens"][:, 0::2].reshape(-1)
    assert int(torch.bincount(even, minlength=97).argmax()) == 0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _ref_step_losses(rcfg, tc, rp, batches) -> list[float]:
    step = jax.jit(RTS.make_train_step(rcfg, tc))
    opt = radamw.init(rp, tc)
    cs = rgc.CompressState(error=jax.tree.map(
        lambda p: jnp.zeros((), jnp.float32), rp))
    out = []
    for b in batches:
        rp, opt, cs, m = step(rp, opt, cs, b)
        out.append(float(m["loss"]))
    return out


def _port_losses(tcfg, tc, tp, batches, engine=KERNELS) -> list[float]:
    step = TS.make_train_step(tcfg, tc, engine=engine)
    tr = T.trainable(tp)
    opt = adamw.init(tr, tc)
    cs = grad_compress.CompressState(error=tree.map_leaves(
        lambda p: torch.zeros(()), tr))
    out = []
    for b in batches:
        tp, opt, cs, m = step(tp, opt, cs, _port_batch(b))
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_five_train_steps_match_reference(dtype):
    """From the same weights and the reference's batches, five steps of the
    port (kernels backend, remat by block) follow the reference's jitted
    XLA steps: 1e-4 of loss in fp32, 3e-2 in bf16."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    rcfg = dataclasses.replace(RCFG, **kw)
    tcfg = dataclasses.replace(TCFG, **kw)
    tc = dict(global_batch=4, seq_len=32, total_steps=5, lr=3e-3,
              warmup_steps=2, remat="block")
    rp, tp = _tiny_params(rcfg)
    batches = [_ref_batch(rcfg, 4, 32, s) for s in range(5)]
    want = _ref_step_losses(rcfg, rbase.TrainConfig(**tc), rp, batches)
    got = _port_losses(tcfg, tbase.TrainConfig(**tc), tp, batches)
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert np.max(np.abs(np.array(got) - np.array(want))) <= tol, \
        (got, want)
    assert want[-1] < want[0]


def test_train_step_dispatches_only_schedule_hits():
    _, tp = _tiny_params()
    tc = tbase.TrainConfig(global_batch=4, seq_len=16, total_steps=2,
                           remat="block")
    step = TS.make_train_step(TCFG, tc, engine=KERNELS)
    tr = T.trainable(tp)
    opt = adamw.init(tr, tc)
    cs = grad_compress.init(tr)
    with KERNELS.tracing() as trace:
        step(tp, opt, cs, _port_batch(_ref_batch(RCFG, 4, 16)))
    # one record per forward matmul (7 a layer and the head) and attention:
    # the recompute of remat and the backward record nothing
    assert len(trace) == TCFG.n_layers * 8 + 1
    assert {r.schedule for r in trace if r.regime != "attention"} == {"hit"}


def test_microbatch_grads_match_full_batch():
    """Gradient accumulation is exact (not an approximation)."""
    _, tp = _tiny_params()
    batch = _port_batch(_ref_batch(RCFG, 8, 16))
    full = TS.make_grad_fn(TCFG, tbase.TrainConfig(microbatch=0),
                           engine=KERNELS)
    micro = TS.make_grad_fn(TCFG, tbase.TrainConfig(microbatch=2),
                            engine=KERNELS)
    (l1, g1), (l2, g2) = full(tp, batch), micro(tp, batch)
    assert abs(float(l1) - float(l2)) <= 1e-5 * abs(float(l1))
    assert all(g.dtype == torch.float32 for g in tree.leaves(g2))
    for a, b in zip(tree.leaves(g1), tree.leaves(g2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("remat", ["block", "dots"])
def test_remat_block_equals_none_bitwise(remat):
    """Remat by block, or keeping the products and recomputing the rest
    ("dots"), gives the loss and the gradients of no remat, bitwise."""
    _, tp = _tiny_params()
    batch = _port_batch(_ref_batch(RCFG, 4, 16))
    grads, counts = {}, {}
    for r in ("none", remat):
        ref.reset_counts()
        grads[r] = TS.make_grad_fn(TCFG, tbase.TrainConfig(remat=r),
                                   engine=KERNELS)(tp, batch)
        counts[r] = ref.counts()
    assert torch.equal(grads["none"][0], grads[remat][0])
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(grads["none"][1]), tree.leaves(grads[remat][1])))
    # both rerun each period's attention in the backward pass (the plain
    # version once more in attention's backward); "block" its 7 matmuls a
    # layer too, "dots" none of them
    n = TCFG.n_layers
    assert counts["none"]["attention"] == 2 * n
    assert counts[remat]["attention"] == 3 * n
    assert counts[remat]["matmul_bias_act"] - \
        counts["none"]["matmul_bias_act"] == (7 * n if remat == "block"
                                              else 0)


def test_tied_head_copy_follows_embed_after_a_step():
    kw = dict(param_dtype="float32", compute_dtype="float32")
    tcfg = tbase.reduced(treg.get_config("olmo-1b"), **kw)
    tc = tbase.TrainConfig(global_batch=2, seq_len=16, total_steps=2,
                           lr=1e-2, warmup_steps=1)
    params, opt, cs = TS.init_train_state(tcfg, tc, 0, device="cpu")
    assert "embed_t" in params and "embed_t" not in opt.m
    assert "embed_t" not in cs.error
    new, opt, cs, _ = TS.make_train_step(tcfg, tc, engine=KERNELS)(
        params, opt, cs, tdata.SyntheticLM(tdata.DataConfig(
            tcfg.vocab_size, 16, 2)).batch_at(0))
    assert not torch.equal(new["embed"], params["embed"])
    assert new["embed_t"].is_contiguous()
    assert torch.equal(new["embed_t"], new["embed"].t())


# ---------------------------------------------------------------------------
# checkpoints (tests/test_checkpoint.py:24-60, on the port's trees)
# ---------------------------------------------------------------------------
def _tree(seed=0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 8, generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32)}}


def _equal_trees(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(3, t, extra={"loss": 1.5})
    out, step, extra = ck.restore(t)
    assert step == 3 and extra["loss"] == 1.5
    assert _equal_trees(out, t)


def test_checkpoint_async_save_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s), async_save=True)
    ck.wait()
    assert ck.steps() == [3, 4]
    out, step, _ = ck.restore(_tree())
    assert step == 4 and _equal_trees(out, _tree(4))


def test_checkpoint_atomic_no_partial_visible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert ck.latest_step() == 1


def test_checkpoint_structure_mismatch_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    with pytest.raises(ValueError, match="structure"):
        ck.restore({"only": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"a": torch.zeros(4, 4), "b": {"c": torch.zeros(5)}})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(_tree())


def test_checkpoint_bf16_and_train_state_roundtrip_bitwise(tmp_path):
    """bf16 leaves travel as their uint16 bits (NaN payloads, signed zeros
    and infinities included); a whole train state comes back bitwise, in
    the reference's leaf order."""
    bits = torch.from_numpy(np.array([0x7FC1, 0xFF80, 0x8000, 0x0001, 0x3F80],
                                     dtype=np.uint16).view(np.int16)
                            ).view(torch.bfloat16)
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    tcfg = tbase.reduced(treg.get_config("olmo-1b"), **kw)
    tc = tbase.TrainConfig(grad_compress="int8", moment_dtype="bfloat16")
    params, opt, cs = TS.init_train_state(tcfg, tc, 3, device="cpu")
    state = ({**T.trainable(params), "odd": bits}, opt, cs)
    ck = Checkpointer(str(tmp_path))
    ck.save(7, state, async_save=True)
    ck.wait()
    fresh = tree.map_leaves(torch.zeros_like, state)
    out, step, _ = ck.restore(fresh)
    assert step == 7
    for x, y in zip(tree.leaves(out), tree.leaves(state)):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.bfloat16:
            assert torch.equal(x.view(torch.int16), y.view(torch.int16))
        else:
            assert torch.equal(x, y)
    # the leaf order is the reference's for the same tree
    rstate = jax.tree.map(lambda t: np.zeros(tuple(t.shape)), state,
                          is_leaf=lambda t: isinstance(t, torch.Tensor))
    paths = [p for p, _ in tree.flatten_with_paths(state)]
    rpaths = [".".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in kp)
        for kp, _ in jax.tree_util.tree_flatten_with_path(rstate)[0]]
    assert paths == rpaths


# ---------------------------------------------------------------------------
# the trainer and the launcher
# ---------------------------------------------------------------------------
def test_trainer_loss_decreases():
    tc = tbase.TrainConfig(global_batch=8, seq_len=32, total_steps=25,
                           lr=3e-3, warmup_steps=5)
    rep = trainer.run(TCFG, tc, data=tdata.SyntheticLM(tdata.DataConfig(
        TCFG.vocab_size, 32, 8, seed=1)), device="cpu", log=lambda s: None)
    assert rep.steps_run == 25 and rep.resumed_from is None
    assert rep.losses[-1] < rep.losses[0] * 0.8, rep.losses[::6]


def test_trainer_resume_equals_uninterrupted_bitwise(tmp_path):
    tc = tbase.TrainConfig(global_batch=4, seq_len=16, total_steps=4,
                           lr=3e-3, warmup_steps=1)
    quiet = dict(device="cpu", log=lambda s: None, ckpt_every=2)
    whole = trainer.run(TCFG, tc, ckpt_dir=str(tmp_path / "a"), **quiet)
    # the interrupted run: stopped after step 2's checkpoint
    shutil.copytree(tmp_path / "a" / "step_00000002",
                    tmp_path / "b" / "step_00000002")
    resumed = trainer.run(TCFG, tc, ckpt_dir=str(tmp_path / "b"), **quiet)
    assert resumed.resumed_from == 2 and resumed.steps_run == 2
    assert resumed.losses == whole.losses[2:]
    params, opt, cs = TS.init_train_state(TCFG, tc, 0, device="cpu")
    like = (T.trainable(params), opt, cs)
    a, sa, _ = Checkpointer(str(tmp_path / "a")).restore(like)
    b, sb, _ = Checkpointer(str(tmp_path / "b")).restore(like)
    assert sa == sb == 4 and _equal_trees(a, b)


@pytest.mark.parametrize("total,saved", [(4, [2, 4]), (3, [2, 3])])
def test_trainer_writes_each_checkpoint_once(tmp_path, monkeypatch, total,
                                             saved):
    """A checkpoint every ``ckpt_every`` steps and one at the end, each
    step written once: a last step on ``ckpt_every`` is not written again
    at the end (its async write is joined before ``run`` returns)."""
    steps = []
    real = Checkpointer.save

    def save(self, step, *a, **k):
        steps.append(step)
        return real(self, step, *a, **k)

    monkeypatch.setattr(Checkpointer, "save", save)
    tc = tbase.TrainConfig(global_batch=2, seq_len=16, total_steps=total,
                           lr=3e-3, warmup_steps=1)
    trainer.run(TCFG, tc, ckpt_dir=str(tmp_path), ckpt_every=2,
                device="cpu", log=lambda s: None)
    assert steps == saved
    assert Checkpointer(str(tmp_path)).steps() == saved


def test_train_launcher_runs_on_the_cpu(capsys):
    tlaunch.main(["--arch", "olmo-1b", "--device", "cpu", "--reduced",
                  "--steps", "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "kernels backend" in out and "[train] loss" in out
