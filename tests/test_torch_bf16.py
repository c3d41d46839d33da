"""bf16 activations in the port against the JAX package, on the CPU.

The reference computes every kernel in its input's dtype: w rounded to x's
dtype, products summed in fp32, the epilogue in fp32, the output written
as ``out_dtype`` (x's by default); flash attention widens q, k and v to
fp32 and writes q's dtype.  The same numpy inputs from a seed go through
the reference's Pallas kernels (interpret mode, as ``tests/test_kernels.py``
runs them) and through the port's wrappers, which take their plain
versions for CPU tensors.  Tolerance: the reference's own bf16 kernel
tolerance, 3e-2 (``tests/test_kernels.py``).  The reduced OLMo-family
``ServeEngine`` in bf16 is held to the spread between the reference's bf16
and fp32 logits: the port may differ from the reference by summation
order, which may cost no more than bf16 rounding itself.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.core.quant import quantize as rquantize
from repro.kernels import ref as rref
from repro.kernels.attention import flash_attention as rflash
from repro.kernels.sa_conv import sa_conv_matmul as rgemm
from repro.kernels.sa_fc import sa_fc_matmul as rfc
from repro.models import transformer as RT
from repro.serve import engine as rserve
from repro.serve import serve_step as rstep
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels import ref
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.sa_conv import sa_conv_matmul
from repro_torch.kernels.sa_fc import sa_fc_matmul
from repro_torch.launch import serve as tlaunch
from repro_torch.serve.engine import Request, ServeEngine

TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
JBF, TBF = jnp.bfloat16, torch.bfloat16


def _np(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _f32(a) -> np.ndarray:
    """A JAX or torch array as fp32 numpy (numpy has no bf16)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# C5: the plain matmul rounds w to x's dtype
# ---------------------------------------------------------------------------
PORT_MATMULS = {"sa_fc_matmul": sa_fc_matmul,
                "sa_conv_matmul": sa_conv_matmul,
                "matmul_bias_act": ref.matmul_bias_act}
REF_MATMULS = {"sa_fc_matmul": rfc, "sa_conv_matmul": rgemm,
               "matmul_bias_act": rref.matmul_bias_act}


@pytest.mark.parametrize("fn", list(PORT_MATMULS))
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (2, 8, 3)])
def test_bf16_x_rounds_fp32_w_first(fn, m, k, n):
    """x = 1 in bf16, w = 1 + 2^-10 in fp32, fp32 out: w rounds to 1 in
    bf16, so every output is exactly k, as the reference gives (before the
    repair the port widened w and gave k * (1 + 2^-10))."""
    x = np.ones((m, k), np.float32)
    w = np.full((k, n), 1 + 2.0 ** -10, np.float32)
    want = np.asarray(REF_MATMULS[fn](jnp.asarray(x, JBF), jnp.asarray(w),
                                      out_dtype=jnp.float32))
    got = PORT_MATMULS[fn](torch.from_numpy(x).to(TBF), torch.from_numpy(w),
                           out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, np.full((m, n), k, np.float32))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fp32_x_keeps_its_exact_widening():
    """fp32 x with bf16 or int8 w: the weights widen exactly, as before."""
    x = torch.from_numpy(_np(0, (3, 40)))
    w = torch.from_numpy(_np(1, (40, 5))).to(TBF)
    got = ref.matmul_bias_act(x, w)
    want = torch.cat([x[i:i + 1] @ w.float() for i in range(3)])
    assert got.dtype == torch.float32 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# C4: SA-FC and the SA-CONV GEMM with bf16 activations
# ---------------------------------------------------------------------------
def _operands(m: int, k: int, n: int, wdtype: str):
    """(x, w, scale, bias) as numpy fp32 (x, bias rounded to bf16 later)
    and the int8 pair of the reference's quantize for ``"int8"``."""
    x, w, b = _np(0, (m, k)), _np(1, (k, n), k ** -0.5), _np(2, (n,))
    scale = None
    if wdtype == "int8":
        qt = rquantize(jnp.asarray(w))
        w, scale = np.array(qt.q), np.array(qt.scale)
    return x, w, scale, b


def _ref_w(w: np.ndarray, wdtype: str):
    a = jnp.asarray(w)
    return a.astype(JBF) if wdtype == "bf16" else a


def _port_w(w: np.ndarray, wdtype: str) -> torch.Tensor:
    t = torch.from_numpy(w)
    return t.to(TBF) if wdtype == "bf16" else t


@pytest.mark.parametrize("kernel,shape", [("sa_fc", (8, 300, 700)),
                                          ("sa_conv", (100, 300, 200))])
@pytest.mark.parametrize("wdtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("out", ["bf16", "fp32"])
def test_bf16_matmul_kernels_match_reference(kernel, shape, wdtype, out):
    m, k, n = shape
    x, w, scale, b = _operands(m, k, n, wdtype)
    rout, tout = (JBF, TBF) if out == "bf16" else (jnp.float32,
                                                   torch.float32)
    rfn, tfn = (rfc, sa_fc_matmul) if kernel == "sa_fc" else \
        (rgemm, sa_conv_matmul)
    want = rfn(jnp.asarray(x, JBF), _ref_w(w, wdtype), jnp.asarray(b),
               act="silu", out_dtype=rout,
               w_scale=None if scale is None else jnp.asarray(scale))
    got = tfn(torch.from_numpy(x).to(TBF), _port_w(w, wdtype),
              torch.from_numpy(b), act="silu", out_dtype=tout,
              w_scale=None if scale is None else torch.from_numpy(scale))
    assert got.dtype == tout and want.dtype == rout
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL_BF16)


@pytest.mark.parametrize("kernel", ["sa_fc", "sa_conv"])
def test_bf16_matmul_defaults_to_x_dtype_and_widens_bf16_bias(kernel):
    """No ``out_dtype``: the output is x's dtype (bf16); a bf16 bias and
    scale are widened for the fp32 epilogue, as the reference does."""
    x, w, scale, b = _operands(16, 96, 80, "int8")
    rfn, tfn = (rfc, sa_fc_matmul) if kernel == "sa_fc" else \
        (rgemm, sa_conv_matmul)
    want = rfn(jnp.asarray(x, JBF), jnp.asarray(w), jnp.asarray(b, JBF),
               act="relu", w_scale=jnp.asarray(scale, JBF))
    got = tfn(torch.from_numpy(x).to(TBF), torch.from_numpy(w),
              torch.from_numpy(b).to(TBF), act="relu",
              w_scale=torch.from_numpy(scale).to(TBF))
    assert got.dtype == TBF and want.dtype == JBF
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL_BF16)


# ---------------------------------------------------------------------------
# C4: flash attention in bf16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,sq,hq,hkv,d,window", [
    (2, 64, 4, 4, 32, 0),       # causal
    (1, 96, 4, 4, 64, 24),      # sliding window
    (2, 64, 4, 1, 64, 0),       # GQA, 4 query heads on one kv head
    (1, 64, 2, 2, 128, 0)])     # OLMo's head dim
def test_bf16_flash_attention_matches_reference(b, sq, hq, hkv, d, window):
    q, k, v = _np(0, (b, sq, hq, d)), _np(1, (b, sq, hkv, d)), \
        _np(2, (b, sq, hkv, d))
    want = rflash(*(jnp.asarray(a, JBF) for a in (q, k, v)), window=window,
                  bq=32, bkv=32)
    got = flash_attention(*(torch.from_numpy(a).to(TBF) for a in (q, k, v)),
                          window=window)
    assert got.dtype == TBF and want.dtype == JBF
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL_BF16)


# ---------------------------------------------------------------------------
# C4: a reduced OLMo-family ServeEngine in bf16
# ---------------------------------------------------------------------------
def _olmo(dtype: str):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (rbase.reduced(rreg.get_config("olmo-1b"), **kw),
            tbase.reduced(treg.get_config("olmo-1b"), **kw))


def _teacher_forced(rcfg, rp, prompt, output, max_seq: int, cache_dtype):
    """The reference's per-step logits of one request, fed ``output``."""
    prefill = jax.jit(lambda p, t: rstep.prefill_step(
        rcfg, p, {"tokens": t}, max_seq, cache_dtype=cache_dtype))
    decode = jax.jit(lambda p, c, t, i: rstep.decode_step(rcfg, p, c, t, i))
    rl, rc = prefill(rp, jnp.asarray(prompt)[None])
    rows = [_f32(rl[0])]
    for i in range(1, len(output)):
        rl, rc = decode(rp, rc, jnp.asarray(output[i - 1:i])[None],
                        jnp.int32(len(prompt) + i - 1))
        rows.append(_f32(rl[0]))
    return np.stack(rows)


def test_bf16_serve_engine_matches_reference_within_the_bf16_spread():
    """OLMo-1B as published (bf16 params, compute and cache), reduced: the
    port's ``ServeEngine`` on the kernels backend against the reference's
    on XLA, teacher-forced with the port's tokens.  The port's logits may
    differ from the reference's bf16 logits by no more than the
    reference's bf16 logits differ from its fp32 logits on the same
    weights (max |difference| over every request and step of the run).
    The two differ in where bf16 rounds, not in what they compute: the
    reference's XLA attention rounds the probabilities to bf16 before P V,
    the port's kernels (as the reference's Pallas kernel) keep them fp32."""
    rcfg, tcfg = _olmo("bfloat16")
    rcfg32 = dataclasses.replace(rcfg, param_dtype="float32",
                                 compute_dtype="float32")
    assert tcfg.param_dtype == tcfg.compute_dtype == "bfloat16"
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    rp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), rp)
    tp = lm_params_from_reference(rp, device="cpu")
    assert tp["embed"].dtype == TBF
    prompts = [np.random.default_rng(30 + i).integers(
        0, tcfg.vocab_size, (6,)).astype(np.int32) for i in range(3)]
    srv = ServeEngine(tcfg, tp, batch_size=2, max_seq=24,
                      cache_dtype=TBF)
    assert srv.engine.backend == "kernels"
    for i, p in enumerate(prompts):
        srv.submit(Request(uid=i, prompt=p, max_new=4))
    with srv.engine.tracing() as tr:
        done = srv.run()
    mm = [r for r in tr if r.regime in ("sa_conv", "sa_fc")]
    assert mm and all(r.schedule == "hit" and r.dtype == "bfloat16"
                      for r in mm)
    ref_srv = rserve.ServeEngine(rcfg, rp, batch_size=2, max_seq=24,
                                 cache_dtype=JBF)
    for i, p in enumerate(prompts):
        ref_srv.submit(rserve.Request(uid=i, prompt=p, max_new=4))
    ref_done = {r.uid: r for r in ref_srv.run()}
    assert len(done) == len(ref_done) == 3
    diff = spread = 0.0
    for r in done:
        assert np.isfinite(r.logits).all()
        want = _teacher_forced(rcfg, rp, r.prompt, r.output, 24, JBF)
        fp32 = _teacher_forced(rcfg32, rp32, r.prompt, r.output, 24,
                               jnp.float32)
        diff = max(diff, float(np.abs(r.logits - want).max()))
        spread = max(spread, float(np.abs(want - fp32).max()))
        # the port's tokens are the reference's own wherever the
        # reference's top-2 margin is wider than bf16 rounding can move
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * float(np.abs(want - fp32).max())
        np.testing.assert_array_equal(r.output[clear],
                                      want.argmax(-1)[clear])
        np.testing.assert_array_equal(ref_done[r.uid].output[clear],
                                      want.argmax(-1)[clear])
    assert 0.0 < diff <= spread, (diff, spread)


def test_bf16_serve_launcher_runs_on_the_cpu(capsys):
    tlaunch.main(["--arch", "olmo-1b", "--device", "cpu", "--dtype",
                  "bfloat16", "--requests", "3", "--max-new", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["req 0", "req 1", "req 2"]


# ---------------------------------------------------------------------------
# the bf16 kernels' launch geometry (mirrored from csrc/ in Python)
# ---------------------------------------------------------------------------
#: the most shared memory a Hopper CTA may opt into, and an SM holds
SMEM_OPTIN, SMEM_PER_SM = 232448, 233472


@pytest.mark.parametrize("w_kind", [0, 1, 2])
def test_bf16_gemm_shared_memory_fits_one_cta_per_sm(w_kind):
    """With bf16 x the GEMM runs on the tensor cores: a ring of at least 4
    stages of 32 KB (bf16 x and w tiles of 64 k), raw w stages for fp32
    and int8 weights; one CTA fits an SM, two do not."""
    from repro_torch.kernels import sa_conv as tgemm
    g = tgemm.gemm_geometry(2048, 2048, 2048, w_kind, 2)
    assert g.tensor_cores and g.per_sm == 1 and g.stages >= 4
    assert g.smem_bytes >= 4 * 32768 and g.smem_bytes <= SMEM_OPTIN
    assert g.smem_bytes + 1024 <= SMEM_PER_SM < 2 * (g.smem_bytes + 1024)
    assert g.smem_bytes % 16 == 0 and g.x_copy == 16
    assert g.producer == ("tma" if w_kind == 2 else "cp.async")


@pytest.mark.parametrize("k,x_copy", [(2048, 16), (300, 4), (302, 4),
                                      (301, 0)])
def test_bf16_gemm_x_copies_narrow_for_odd_rows(k, x_copy):
    """cp.async pieces of 16 bytes where x's rows allow, else 4 (8-byte
    rows too), else elements; TMA only where they are 16-byte rows."""
    from repro_torch.kernels import sa_conv as tgemm
    g = tgemm.gemm_geometry(100, 64, k, 2, 2)
    assert g.x_copy == x_copy
    assert g.producer == ("tma" if x_copy == 16 else "cp.async")


def test_bf16_flash_shared_memory_is_smaller():
    """bf16 runs on the tensor cores: two Q tiles and a 3-stage K/V ring in
    bf16 rows of d rounded up to 64 (128-byte swizzle atoms), 1024 bytes of
    alignment and 8 mbarriers, no fp32 Q or P.  At the served head dims 64
    and 128 a CTA takes less than fp32's; every tiling fits a Hopper CTA."""
    from repro_torch.kernels import attention as tattn
    for d in tattn.HEAD_DIMS:
        dp = 64 if d <= 64 else 128
        for bq in tattn.BQ:
            assert tattn.smem_bytes(bq, d, 2) == 1024 + 4 * bq * dp + \
                3 * 4 * tattn.BKV * dp + 8 * 8 <= SMEM_OPTIN
            if d in (64, 128):
                assert tattn.smem_bytes(bq, d, 2) < tattn.smem_bytes(bq, d)
    full = tattn.flash_geometry(4, 512, 512, 16, 16, 128, True, 0, 2)
    assert full.smem_bytes <= SMEM_OPTIN and full.tensor_cores
    assert (full.bq, full.paired, full.threads) == (128, True, 256)
    lone = tattn.flash_geometry(1, 512, 512, 16, 16, 128, True, 0, 2)
    assert (lone.bq, lone.paired, lone.threads) == (64, False, 128)