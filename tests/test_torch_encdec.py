"""The port's encoder-decoder and vision-prefix families on the CPU against
the JAX package: cross-attention, the encoder, the frontends, prefill,
decode, the cache and ``greedy_generate(..., extra=...)``.

Reduced seamless-m4t-large-v2 (2 encoder and 2 decoder layers, 16 audio
frames) and llava-next-34b (2 layers, 8 vision tokens, GQA 4/2).  The
reference's parameters are carried across by
:func:`repro_torch.convert.lm_params_from_reference`; token and frontend
inputs are made from a seed with numpy.  The reference runs on its XLA
backend, and in Pallas interpret mode where marked.  Tolerances: 3e-4 for
one attention (the reference's flash tolerance), 5e-4 through the stack
(the reference's serving tolerance, ``tests/test_archs.py``), both sides
fp32; bf16 cases at the reference's bf16 tolerance, 3e-2.
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
from repro.core import schedule as rsched
from repro.core.engine import Engine as REngine
from repro.models import attention as rattn
from repro.models import transformer as RT
from repro.serve import kvcache as RKC
from repro.serve import serve_step as rstep
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import schedule as tsched
from repro_torch.core import tree
from repro_torch.core.engine import Engine
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as T
from repro_torch.serve import kvcache as KC
from repro_torch.serve import serve_step as tstep
from repro_torch.serve.engine import ServeEngine

SEAMLESS, LLAVA = "seamless-m4t-large-v2", "llava-next-34b"
ARCHS = (SEAMLESS, LLAVA)
TOL_ATTN = dict(rtol=3e-4, atol=3e-4)
TOL = dict(rtol=5e-4, atol=5e-4)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
B, S = 2, 8
KERNELS = Engine(backend="kernels")
XLA = REngine(backend="xla")
PALLAS = REngine(backend="pallas", interpret=True)
_SETUP: dict = {}


def _setup(arch: str, dtype: str = "float32"):
    """(ref cfg, port cfg, ref params, port params), made once."""
    key = (arch, dtype)
    if key not in _SETUP:
        kw = dict(param_dtype=dtype, compute_dtype=dtype)
        rcfg = rbase.reduced(rreg.get_config(arch), **kw)
        tcfg = tbase.reduced(treg.get_config(arch), **kw)
        rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
        _SETUP[key] = (rcfg, tcfg, rp,
                       lm_params_from_reference(rp, device="cpu"))
    return _SETUP[key]


def _np(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(cfg, s: int = S, seed: int = 0, vision: bool = True):
    """(reference batch, port batch): tokens and the config's frontend
    embeddings (audio frames for enc-dec; vision tokens unless
    ``vision`` is False), in the compute dtype."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, s)).astype(np.int32)
    rb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks.astype(np.int64))}
    key = None
    if cfg.enc_dec:
        key, n = "audio_embeds", cfg.audio_frames
    elif cfg.vision_tokens and vision:
        key, n = "vision_embeds", cfg.vision_tokens
    if key:
        e = _np(seed + 1, (B, n, cfg.frontend_dim))
        rb[key] = jnp.asarray(e).astype(jnp.dtype(cfg.compute_dtype))
        tb[key] = torch.from_numpy(e).to(getattr(torch, cfg.compute_dtype))
    return rb, tb


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol=TOL) -> None:
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def _path(path) -> str:
    """A reference tree path as the port's dotted path."""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _layer(tree_, i: int = 0):
    """Leaf ``i`` of every stacked leaf (a block's parameters)."""
    if isinstance(tree_, dict):
        return {k: _layer(v, i) for k, v in tree_.items()}
    return tree_[i]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_equals_the_reference(arch):
    """The port's ``init_params`` tree has the reference's paths and
    shapes (``frontend``; seamless: ``encoder`` whose blocks carry no
    ``lnx``/``xattn``, and ``lnx``/``xattn`` on every decoder block), and
    the converted tree carries every reference leaf."""
    rcfg, tcfg, rp, tp = _setup(arch)
    rleaves = [(_path(path), leaf.shape)
               for path, leaf in jax.tree_util.tree_leaves_with_path(rp)]
    mine = T.init_params(tcfg, 0, device="cpu")
    got = [(path, tuple(t.shape))
           for path, t in tree.flatten_with_paths(mine) if path != "embed_t"]
    assert sorted(got) == sorted(rleaves)
    conv = dict(tree.flatten_with_paths(tp))
    for path, leaf in jax.tree_util.tree_leaves_with_path(rp):
        np.testing.assert_array_equal(conv[_path(path)].numpy(),
                                      np.asarray(leaf))
    assert "frontend" in mine
    if tcfg.enc_dec:
        assert {"lnx", "xattn"} <= set(mine["blocks"][0])
        assert not {"lnx", "xattn"} & set(mine["encoder"]["blocks"])
        assert mine["encoder"]["blocks"]["attn"]["wq"].shape[0] == \
            tcfg.n_enc_layers
    else:
        assert "encoder" not in mine and "lnx" not in mine["blocks"][0]


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend,use_rope,sq", [
    ("xla", False, 8), ("xla", True, 20), ("pallas", False, 20),
    ("pallas", True, 8)])
def test_attn_forward_with_x_kv_matches_the_reference(backend, use_rope, sq):
    """Cross-attention of sq queries to 16 encoder frames, non-causal
    (fewer and more queries than keys), its output and its k/v, against the
    reference on its XLA backend and its flash kernel in interpret mode."""
    rcfg, tcfg, rp, tp = _setup(SEAMLESS)
    x, x_kv = _np(0, (B, sq, tcfg.d_model)), _np(1, (B, 16, tcfg.d_model))
    pos = np.arange(sq)[None, :]
    kw = dict(causal=False, use_rope=use_rope, return_kv=True)
    with (XLA if backend == "xla" else PALLAS).activate():
        want, (wk, wv) = rattn.attn_forward(
            rcfg, _layer(rp["blocks"][0]["xattn"]), jnp.asarray(x),
            jnp.asarray(pos), x_kv=jnp.asarray(x_kv), **kw)
    with KERNELS.activate():
        got, (k, v) = tattn.attn_forward(
            tcfg, _layer(tp["blocks"][0]["xattn"]), torch.from_numpy(x),
            torch.from_numpy(pos), x_kv=torch.from_numpy(x_kv), **kw)
    _close(got, want, TOL_ATTN)
    _close(k, wk, TOL_ATTN)
    _close(v, wv, TOL_ATTN)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_decode_with_cross_kv_matches_the_reference(dtype):
    """One query token against the encoder's k/v: no rope, every frame
    valid, the cache returned untouched."""
    rcfg, tcfg, rp, tp = _setup(SEAMLESS, dtype)
    tol = TOL_ATTN if dtype == "float32" else TOL_BF16
    x = _np(0, (B, 1, tcfg.d_model))
    k, v = (_np(s, (B, 16, tcfg.n_kv_heads, tcfg.hd)) for s in (1, 2))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    with XLA.activate():
        want, rcache = rattn.attn_decode(
            rcfg, _layer(rp["blocks"][0]["xattn"]), jnp.asarray(x, jd), 5,
            None, cross_kv=(jnp.asarray(k, jd), jnp.asarray(v, jd)))
    cache = {"k": torch.zeros(1)}
    with KERNELS.activate():
        got, out_cache = tattn.attn_decode(
            tcfg, _layer(tp["blocks"][0]["xattn"]),
            torch.from_numpy(x).to(td), 5, cache,
            cross_kv=(torch.from_numpy(k).to(td),
                      torch.from_numpy(v).to(td)))
    assert rcache is None and out_cache is cache
    assert got.dtype == td
    _close(got, want, tol)


# ---------------------------------------------------------------------------
# the encoder and the forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_the_reference(dtype):
    rcfg, tcfg, rp, tp = _setup(SEAMLESS, dtype)
    rb, tb = _inputs(tcfg)
    with XLA.activate():
        want = RT.encode(rcfg, rp, rb["audio_embeds"])
    with KERNELS.activate():
        got = T.encode(tcfg, tp, tb["audio_embeds"])
    assert got.shape == (B, tcfg.audio_frames, tcfg.d_model)
    _close(got, want, TOL if dtype == "float32" else TOL_BF16)


FORWARD_CASES = [(SEAMLESS, "train", True, "xla", "float32"),
                 (SEAMLESS, "prefill", True, "xla", "float32"),
                 (SEAMLESS, "prefill", True, "pallas", "float32"),
                 (SEAMLESS, "prefill", True, "xla", "bfloat16"),
                 (LLAVA, "train", True, "xla", "float32"),
                 (LLAVA, "prefill", True, "xla", "float32"),
                 (LLAVA, "prefill", False, "xla", "float32"),
                 (LLAVA, "prefill", True, "xla", "bfloat16")]


@pytest.mark.parametrize("arch,mode,vision,backend,dtype", FORWARD_CASES)
def test_forward_matches_the_reference(arch, mode, vision, backend, dtype):
    """Logits over the vision tokens and the text (llava, with and without
    ``vision_embeds``) or the text cross-attending the encoder (seamless),
    and in prefill every cache entry: k/v, and seamless's cross ``xk``/
    ``xv`` of (B, frames, hkv, hd).  bf16 logits and cache entries may
    differ from the reference's by sqrt(2) times the reference's own
    bf16-vs-fp32 spread (max |difference| over the tensor), as chip_smoke.py
    holds them: two bf16 computations that sum in other orders round
    independently."""
    rcfg, tcfg, rp, tp = _setup(arch, dtype)
    rb, tb = _inputs(tcfg, vision=vision)
    with (XLA if backend == "xla" else PALLAS).activate():
        want, _, wc = RT.forward(rcfg, rp, rb, mode=mode)
    vt = tcfg.vision_tokens if "vision_embeds" in tb else 0
    pairs = [("logits", want)]
    if dtype == "bfloat16":
        rcfg32, _, rp32, _ = _setup(arch)
        rb32 = {k: v.astype(jnp.float32) if k != "tokens" else v
                for k, v in rb.items()}
        with XLA.activate():
            want32, _, wc32 = RT.forward(rcfg32, rp32, rb32, mode=mode)
    with KERNELS.activate():
        got, _, gc = T.forward(tcfg, tp, tb, mode=mode)
    assert got.shape == (B, vt + S, tcfg.vocab_size)
    got_leaves = [("logits", got)] + (
        [] if gc is None else list(tree.flatten_with_paths(gc)))
    if mode == "prefill":
        pairs += [(_path(p), w)
                  for p, w in jax.tree_util.tree_leaves_with_path(wc)]
    else:
        assert gc is None
    assert [p for p, _ in got_leaves] == [p for p, _ in pairs]
    for i, ((path, t), (_, w)) in enumerate(zip(got_leaves, pairs)):
        assert tuple(t.shape) == w.shape, path
        if dtype == "float32":
            _close(t, w)
            continue
        w32 = want32 if i == 0 else \
            jax.tree_util.tree_leaves(wc32)[i - 1]
        diff = float(np.abs(_f32(t) - _f32(w)).max())
        spread = float(np.abs(_f32(w) - _f32(w32)).max())
        assert diff <= 2 ** 0.5 * spread, (path, diff, spread)
    if gc is None:
        return
    entry = gc["main"][0]
    assert ("xk" in entry) == tcfg.enc_dec
    if tcfg.enc_dec:
        assert tuple(entry["xk"].shape) == (tcfg.n_layers, B,
                                            tcfg.audio_frames,
                                            tcfg.n_kv_heads, tcfg.hd)


# ---------------------------------------------------------------------------
# the cache, decode and greedy_generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_and_cache_from_prefill_match_the_reference(arch):
    rcfg, tcfg, rp, tp = _setup(arch)
    enc = tcfg.audio_frames if tcfg.enc_dec else 0
    want = RKC.init_cache(rcfg, B, 24, enc_len=enc, dtype=jnp.float32)
    got = KC.init_cache(tcfg, B, 24, enc_len=enc, dtype=torch.float32,
                        device="cpu")
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = list(tree.flatten_with_paths(got))
    assert len(wl) == len(gl)
    for (path, t), (_, w) in zip(gl, wl):
        assert tuple(t.shape) == w.shape and not t.any(), path
    if tcfg.enc_dec:
        assert tuple(got["main"][0]["xv"].shape) == (
            tcfg.n_layers, B, enc, tcfg.n_kv_heads, tcfg.hd)
    rb, tb = _inputs(tcfg)
    with XLA.activate():
        _, _, wc = RT.forward(rcfg, rp, rb, mode="prefill")
    wc = RKC.cache_from_prefill(rcfg, wc, 24, dtype=jnp.bfloat16)
    with KERNELS.activate():
        _, _, gc = T.forward(tcfg, tp, tb, mode="prefill")
    gc = KC.cache_from_prefill(tcfg, gc, 24, dtype=torch.bfloat16)
    for (path, t), (_, w) in zip(tree.flatten_with_paths(gc),
                                 jax.tree_util.tree_leaves_with_path(wc)):
        assert tuple(t.shape) == w.shape and t.dtype == torch.bfloat16, path
        _close(t, w, TOL_BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_the_reference_and_the_forward(arch):
    """Prefill of S - 1 tokens, then decode token S - 1 at position
    vt + S - 1: against the reference's decode step and against the
    port's own forward over all S tokens (the reference's
    ``test_decode_matches_forward``); the cross entries survive the step
    untouched, and the returned cache holds the same tensors."""
    rcfg, tcfg, rp, tp = _setup(arch)
    rb, tb = _inputs(tcfg)
    vt = tcfg.vision_tokens
    pre_r = {**rb, "tokens": rb["tokens"][:, :S - 1]}
    pre_t = {**tb, "tokens": tb["tokens"][:, :S - 1]}
    with XLA.activate():
        _, _, wc = RT.forward(rcfg, rp, pre_r, mode="prefill")
        wc = RKC.cache_from_prefill(rcfg, wc, vt + S + 4, dtype=jnp.float32)
        want, _ = RT.decode_step(rcfg, rp, wc, rb["tokens"][:, S - 1:],
                                 jnp.int32(vt + S - 1))
    with KERNELS.activate():
        full, _, _ = T.forward(tcfg, tp, tb)
        _, _, gc = T.forward(tcfg, tp, pre_t, mode="prefill")
        gc = KC.cache_from_prefill(tcfg, gc, vt + S + 4, dtype=torch.float32)
        before = [t.clone() for _, t in tree.flatten_with_paths(gc)]
        leaves = [t for _, t in tree.flatten_with_paths(gc)]
        got, out = T.decode_step(tcfg, tp, gc, tb["tokens"][:, S - 1:],
                                 vt + S - 1)
    assert got.shape == (B, 1, tcfg.vocab_size)
    _close(got, want)
    _close(got[:, 0], full[:, -1])
    after = list(tree.flatten_with_paths(out))
    assert all(a is t for (_, a), t in zip(after, leaves))
    for (path, t), b in zip(after, before):
        if path[-1] in ("xk", "xv"):
            assert torch.equal(t, b), path


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_with_extra_matches_the_reference(arch):
    """``greedy_generate(..., extra=...)`` against the reference's greedy
    loop (its ``prefill_step``, then ``decode_step`` at vt + S + i on the
    argmax of the step before, as its ``greedy_generate`` runs them): the
    same tokens, and the port's logits of every step within 5e-4 of the
    reference's."""
    rcfg, tcfg, rp, tp = _setup(arch)
    rb, tb = _inputs(tcfg)
    n = 4
    vt = tcfg.vision_tokens
    ms = vt + S + n
    with XLA.activate():
        wl, wc = rstep.prefill_step(rcfg, rp, rb, ms, cache_dtype=jnp.float32)
        want, toks = [wl], [np.asarray(jnp.argmax(wl, -1))]
        for i in range(n - 1):
            wl, wc = rstep.decode_step(rcfg, rp, wc,
                                       jnp.asarray(toks[-1][:, None]),
                                       jnp.int32(vt + S + i))
            want.append(wl)
            toks.append(np.asarray(jnp.argmax(wl, -1)))
    extra = {k: v for k, v in tb.items() if k != "tokens"}
    got_toks = tstep.greedy_generate(tcfg, tp, tb["tokens"], n, extra=extra,
                                     engine=KERNELS)
    np.testing.assert_array_equal(got_toks.numpy(), np.stack(toks, 1))
    with KERNELS.activate():
        gl, gc = tstep.prefill_step(tcfg, tp, tb, ms,
                                    cache_dtype=torch.float32)
        got = [gl]
        for i in range(n - 1):
            gl, gc = tstep.decode_step(tcfg, tp, gc, got_toks[:, i:i + 1],
                                       vt + S + i)
            got.append(gl)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B, tcfg.vocab_size), i
        _close(g, w)


# ---------------------------------------------------------------------------
# what stays refused, and llava's text-only schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("phase", ["train", "prefill", "decode"])
def test_encdec_schedules_serve_engine_and_launcher_refuse(phase):
    """An enc-dec config has no compiled schedule (the reference's cannot
    compile one), so ``ServeEngine`` and the serving launcher refuse both
    frontend families and name ``greedy_generate``."""
    _, tcfg, _, tp = _setup(SEAMLESS)
    with pytest.raises(NotImplementedError, match="greedy_generate"):
        tsched.LayerSchedule.compile(tcfg, phase, batch=1, seq=8)
    arch = SEAMLESS if phase == "decode" else LLAVA
    _, cfg, _, params = _setup(arch)
    with pytest.raises(NotImplementedError, match="greedy_generate"):
        ServeEngine(cfg, params)
    with pytest.raises(SystemExit, match="greedy_generate"):
        tlaunch.main(["--arch", arch, "--device", "cpu"])


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_llava_schedules_are_text_only_as_the_reference(phase):
    rcfg, tcfg, _, _ = _setup(LLAVA)
    want = rsched.LayerSchedule.compile(rcfg, phase, batch=2, seq=8,
                                        max_seq=32, cache_dtype=jnp.float32)
    got = tsched.LayerSchedule.compile(tcfg, phase, batch=2, seq=8,
                                       max_seq=32, cache_dtype=torch.float32)
    assert sorted(dataclasses.astuple(k) for k in got) == \
        sorted(dataclasses.astuple(k) for k in want)
    assert {key.m for key in got} == {2 * 8 if phase == "prefill" else 2}
