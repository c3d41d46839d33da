"""The port's LM serving slice on the CPU against the JAX package: configs,
schedules, the forward, prefill and decode, the ring cache, ``ServeEngine``
and the launcher.

Parameters are made once by the reference (``jax.random``) and carried
across as numpy (:func:`repro_torch.convert.lm_params_from_reference`);
token inputs are made with numpy.  The reference runs on its XLA backend,
as ``tests/test_serve.py`` runs it; the port runs on its ``"kernels"``
backend, whose wrappers take their plain versions for CPU tensors.
Tolerance: 5e-4, the reference's own serving tolerance
(``tests/test_serve.py``): both sides are fp32, summing in other orders.
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
from repro.core.engine import DispatchPolicy as RPolicy
from repro.core.engine import Engine as REngine
from repro.models import transformer as RT
from repro.serve import engine as rserve
from repro.serve import serve_step as rstep
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import schedule as tsched
from repro_torch.core import tree
from repro_torch.core.engine import DispatchPolicy, Engine
from repro_torch.kernels import ref
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as tlaunch_train
from repro_torch.models import transformer as T
from repro_torch.serve import kvcache as KC
from repro_torch.serve import serve_step as tstep
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import train_step as TS
from repro_torch.train.train_step import init_train_state

TOL = dict(rtol=5e-4, atol=5e-4)

# the local:global config of tests/test_serve.py (window 8: rings wrap)
_LOCAL = dict(name="tiny", family="dense", n_layers=4, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
              sliding_window=8, param_dtype="float32",
              compute_dtype="float32")


def _configs(name: str):
    """(reference config, port config) of one test configuration."""
    if name == "olmo":
        kw = dict(param_dtype="float32", compute_dtype="float32")
        return (rbase.reduced(rreg.get_config("olmo-1b"), **kw),
                tbase.reduced(treg.get_config("olmo-1b"), **kw))
    return (rbase.ModelConfig(layer_pattern=(rbase.ATTN_LOCAL,
                                             rbase.ATTN_GLOBAL), **_LOCAL),
            tbase.ModelConfig(layer_pattern=(tbase.ATTN_LOCAL,
                                             tbase.ATTN_GLOBAL), **_LOCAL))


CONFIGS = ("olmo", "local")
_PARAMS: dict = {}


def _setup(name: str):
    """(ref cfg, port cfg, ref params, port params), made once."""
    if name not in _PARAMS:
        rcfg, tcfg = _configs(name)
        rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
        _PARAMS[name] = (rcfg, tcfg, rp,
                         lm_params_from_reference(rp, device="cpu"))
    return _PARAMS[name]


def _tokens(cfg, shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


KERNELS = Engine(backend="kernels")


_JIT: dict = {}


def _ref_steps(rcfg, max_seq: int):
    """The reference's prefill and decode steps, jitted once per config."""
    key = (rcfg, max_seq)
    if key not in _JIT:
        _JIT[key] = (
            jax.jit(lambda p, t: rstep.prefill_step(
                rcfg, p, {"tokens": t}, max_seq, cache_dtype=jnp.float32)),
            jax.jit(lambda p, c, t, i: rstep.decode_step(rcfg, p, c, t, i)))
    return _JIT[key]


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------
def test_lm_configs_equal_reference():
    assert treg.ARCH_IDS == rreg.ARCH_IDS
    for arch in rreg.all_lm_configs():
        r, t = rreg.get_config(arch), treg.get_config(arch)
        assert dataclasses.asdict(r) == dataclasses.asdict(t), arch
        assert dataclasses.asdict(rbase.reduced(r)) == \
            dataclasses.asdict(tbase.reduced(t)), arch
        assert (r.n_params(), r.pattern, r.block_kinds()) == \
            (t.n_params(), t.pattern, t.block_kinds())


@pytest.mark.parametrize("name", CONFIGS)
def test_converted_and_initialised_trees_match_reference(name):
    rcfg, tcfg, rp, tp = _setup(name)
    rleaves = jax.tree_util.tree_leaves_with_path(rp)
    assert {"embed_t", "head"} & set(tp) == \
        ({"embed_t"} if tcfg.tie_embeddings else {"head"})
    for path, leaf in rleaves:
        node = tp
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    if tcfg.tie_embeddings:
        assert tp["embed_t"].is_contiguous()
        assert torch.equal(tp["embed_t"], tp["embed"].t())
    a = T.init_params(tcfg, 7, device="cpu")
    b = T.init_params(tcfg, 7, device="cpu")
    fa = tsched._params_fingerprint(a)
    assert fa == tsched._params_fingerprint(tp)
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(tree.flatten_with_paths(a), tree.flatten_with_paths(b)))
    wq = a["blocks"][0]["attn"]["wq"]
    assert wq.abs().max() <= 3 * tcfg.d_model ** -0.5 + 1e-6


@pytest.mark.parametrize("arch,extra", [
    ("seamless-m4t-large-v2", "audio_embeds"),
    ("llava-next-34b", "vision_embeds")])
def test_frontend_families_are_supported(arch, extra):
    """The encoder-decoder and vision-prefix families init and run a
    forward (tests/test_torch_encdec.py holds them to the reference)."""
    cfg = tbase.reduced(treg.get_config(arch), param_dtype="float32",
                        compute_dtype="float32")
    T.check_supported(cfg)
    params = T.init_params(cfg, 0, device="cpu")
    n = cfg.audio_frames or cfg.vision_tokens
    emb = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, n, cfg.frontend_dim)).astype(np.float32))
    with KERNELS.activate():
        logits, _, _ = T.forward(cfg, params, {
            "tokens": _t(_tokens(cfg, (1, 8))), extra: emb})
    assert logits.shape == (1, 8 + cfg.vision_tokens, cfg.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch,extra", [
    ("seamless-m4t-large-v2", "audio_embeds"),
    ("llava-next-34b", "vision_embeds")])
def test_frontend_families_train(arch, extra, capsys):
    """Encoder-decoder and vision configs train through ``make_grad_fn``
    and the launcher: the loss over the text (behind llava's vision
    prefix) and every gradient are finite, and one SGD step changes the
    loss.  llava's train schedule is its text-only one; seamless has none
    in either package (its compile refuses), so its steps run with no
    schedule (tests/test_torch_train_encdec.py holds both to the
    reference)."""
    cfg = tbase.reduced(treg.get_config(arch), param_dtype="float32",
                        compute_dtype="float32")
    T.check_supported(cfg)
    params = T.trainable(T.init_params(cfg, 0, device="cpu"))
    n = cfg.audio_frames or cfg.vision_tokens
    batch = {"tokens": _t(_tokens(cfg, (2, 32))),
             extra: torch.from_numpy(np.random.default_rng(1).standard_normal(
                 (2, n, cfg.frontend_dim)).astype(np.float32))}
    if cfg.enc_dec:
        with pytest.raises(NotImplementedError, match="training"):
            tsched.LayerSchedule.compile(cfg, "train", batch=2, seq=32)
    loss, grads = TS.make_grad_fn(cfg, tbase.TrainConfig(),
                                  engine=KERNELS)(params, batch)
    tlaunch_train.main(["--arch", arch, "--device", "cpu", "--reduced",
                        "--steps", "2", "--batch", "2", "--seq", "16"])
    assert "[train] loss" in capsys.readouterr().out
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in tree.leaves(grads))
    assert float(grads["frontend"].abs().sum()) > 0
    stepped = tree.map_leaves(lambda p, g: p - 0.1 * g, params, grads)
    loss2, _ = T.loss_fn(cfg, stepped, batch)
    assert torch.isfinite(loss2) and float(loss2) != float(loss)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-maverick-400b-a17b",
                                  "mamba2-130m", "zamba2-2.7b"])
def test_decoder_only_families_train(arch):
    """MoE, Mamba2 and shared-attention configs train (tests/test_archs.py's
    check on the port): the loss and every gradient are finite, the train
    schedule compiles, and one SGD step changes the loss
    (tests/test_torch_train_families.py holds them to the reference)."""
    cfg = tbase.reduced(treg.get_config(arch), param_dtype="float32",
                        compute_dtype="float32")
    T.check_supported(cfg)
    params = T.trainable(T.init_params(cfg, 0, device="cpu"))
    batch = {"tokens": _t(_tokens(cfg, (2, 32)))}
    loss, grads = TS.make_grad_fn(cfg, tbase.TrainConfig(),
                                  engine=KERNELS)(params, batch)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in tree.leaves(grads))
    assert len(tsched.LayerSchedule.compile(cfg, "train", batch=2, seq=32))
    stepped = tree.map_leaves(lambda p, g: p - 0.1 * g, params, grads)
    loss2, _ = T.loss_fn(cfg, stepped, batch)
    assert torch.isfinite(loss2) and float(loss2) != float(loss)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults are valid")
    _, tcfg, rp, _ = _setup("olmo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(tcfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_params_from_reference(rp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KC.init_cache(tcfg, 1, 8)
    assert ServeEngine(tcfg, _setup("olmo")[3]).engine.backend == "kernels"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch_train.main(["--arch", "olmo-1b", "--reduced", "--steps",
                            "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(tcfg, tbase.TrainConfig(), 0)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def _entries(sched) -> dict:
    return {tuple(dataclasses.astuple(k)): (type(v).__name__,
                                            dataclasses.asdict(v))
            for k, v in sched.items()}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("phase", ["train", "prefill", "decode"])
@pytest.mark.parametrize("force", [None, "sa_conv"])
def test_lm_schedules_equal_reference(name, phase, force):
    rcfg, tcfg, _, tp = _setup(name)
    r = rsched.LayerSchedule.compile(rcfg, phase, batch=2, seq=12,
                                     max_seq=40, cache_dtype=jnp.float32,
                                     policy=RPolicy(force_regime=force))
    t = tsched.LayerSchedule.compile(tcfg, phase, batch=2, seq=12,
                                     max_seq=40, cache_dtype=torch.float32,
                                     policy=DispatchPolicy(
                                         force_regime=force))
    assert len(t) == len(r) > 0 and t.phase == phase
    assert _entries(t) == _entries(r)
    if force:
        assert {p.regime for p in t.values()} == {"sa_conv"}
    # memoized; and the real parameter tree gives the same schedule
    assert tsched.LayerSchedule.compile(
        tcfg, phase, batch=2, seq=12, max_seq=40, cache_dtype=torch.float32,
        policy=DispatchPolicy(force_regime=force)) is t
    with_params = tsched.LayerSchedule.compile(
        tcfg, phase, batch=2, seq=12, max_seq=40, cache_dtype=torch.float32,
        policy=DispatchPolicy(force_regime=force), params=tp)
    assert _entries(with_params) == _entries(t)


@pytest.mark.parametrize("phase,batch,seq,regime", [
    ("train", 4, 512, "sa_conv"), ("prefill", 4, 512, "sa_conv"),
    ("prefill", 1, 512, "sa_fc"), ("decode", 4, 1, "sa_fc")])
def test_full_width_olmo_schedules_equal_reference(phase, batch, seq, regime):
    """OLMo-1B at full width: a 4 x 512 train step's loss and a full
    wave's prefill (m = 2048) put every projection in the SA-CONV regime, a
    lone request's (m = 512) and decode in SA-FC.  Shapes only: nothing is
    allocated."""
    kw = dict(param_dtype="float32", compute_dtype="float32")
    rcfg = dataclasses.replace(rreg.get_config("olmo-1b"), **kw)
    tcfg = dataclasses.replace(treg.get_config("olmo-1b"), **kw)
    r = rsched.LayerSchedule.compile(rcfg, phase, batch=batch, seq=seq,
                                     max_seq=640, cache_dtype=jnp.float32)
    t = tsched.LayerSchedule.compile(tcfg, phase, batch=batch, seq=seq,
                                     max_seq=640, cache_dtype=torch.float32)
    assert _entries(t) == _entries(r)
    assert {p.regime for p in t.values()} == {regime}
    # 7 projections shared by the 16 layers, and the head
    assert len(t) == 8


def test_train_schedules_wait_for_the_training_slice():
    """The training slice is here: the train phase compiles, equal to the
    reference's; an unknown phase still raises."""
    rcfg, tcfg, _, _ = _setup("olmo")
    t = tsched.LayerSchedule.compile(tcfg, "train")
    assert t.phase == "train" and len(t) == 8
    assert _entries(t) == _entries(rsched.LayerSchedule.compile(rcfg,
                                                                "train"))
    with pytest.raises(ValueError, match="phase"):
        tsched.LayerSchedule.compile(tcfg, "serve")


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_reference(name):
    rcfg, tcfg, rp, tp = _setup(name)
    toks = _tokens(tcfg, (2, 20))
    want, _, _ = RT.forward(rcfg, rp, {"tokens": jnp.asarray(toks)})
    with KERNELS.activate():
        got, aux, caches = T.forward(tcfg, tp, {"tokens": _t(toks)})
    assert got.dtype == torch.float32 and caches is None
    assert float(aux) == 0.0
    _close(got, want)
    with Engine(backend="torch").activate():
        plain, _, _ = T.forward(tcfg, tp, {"tokens": _t(toks)})
    assert torch.equal(plain, got)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_reference(name):
    """Prefill a 10-token prompt, then decode 14 tokens teacher-forced: the
    local config's 8-slot rings wrap on the way."""
    rcfg, tcfg, rp, tp = _setup(name)
    toks = _tokens(tcfg, (2, 24), seed=1)
    S, ms = 10, 28
    prefill, decode = _ref_steps(rcfg, ms)
    rl, rc = prefill(rp, jnp.asarray(toks[:, :S]))
    with KERNELS.activate():
        tl, tc = tstep.prefill_step(tcfg, tp, {"tokens": _t(toks[:, :S])}, ms,
                                    cache_dtype=torch.float32)
        _close(tl, rl)
        rleaves = jax.tree_util.tree_leaves(rc)
        tleaves = tree.leaves(tc)
        assert [tuple(t.shape) for t in tleaves] == \
            [tuple(x.shape) for x in rleaves]
        for t, x in zip(tleaves, rleaves):
            np.testing.assert_allclose(t.numpy(), np.asarray(x), **TOL)
        for pos in range(S, 24):
            rl, rc = decode(rp, rc, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.int32(pos))
            tl, tc = tstep.decode_step(tcfg, tp, tc, _t(toks[:, pos:pos + 1]),
                                       pos)
            _close(tl, rl)


def test_incremental_decode_matches_full_forward():
    """Inside the port: decoding token by token past the prompt reproduces
    teacher forcing, through ring caches that wrap (the reference's
    invariant, tests/test_serve.py)."""
    _, tcfg, _, tp = _setup("local")
    toks = _t(_tokens(tcfg, (2, 24), seed=2))
    with KERNELS.activate():
        full, _, _ = T.forward(tcfg, tp, {"tokens": toks})
        _, cache = tstep.prefill_step(tcfg, tp, {"tokens": toks[:, :8]}, 28,
                                      cache_dtype=torch.float32)
        for pos in range(8, 24):
            logits, cache = tstep.decode_step(tcfg, tp, cache,
                                              toks[:, pos - 1:pos], pos - 1)
            np.testing.assert_allclose(logits.numpy(),
                                       full[:, pos - 1].numpy(), **TOL)


def test_ring_cache_fill_alignment_and_bounded_bytes():
    _, tcfg, _, tp = _setup("local")
    S = 20
    toks = _t(_tokens(tcfg, (1, S), seed=3))
    with KERNELS.activate():
        full, _, _ = T.forward(tcfg, tp, {"tokens": toks})
        _, cache = tstep.prefill_step(tcfg, tp, {"tokens": toks[:, :S - 1]},
                                      S + 2, cache_dtype=torch.float32)
        logits, _ = tstep.decode_step(tcfg, tp, cache, toks[:, S - 1:S],
                                      S - 1)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), **TOL)
    big = KC.init_cache(tcfg, 1, 4096, dtype=torch.bfloat16, device="meta")
    assert big["main"][0]["attn"]["k"].shape[2] == tcfg.sliding_window
    assert big["main"][1]["attn"]["k"].shape[2] == 4096
    assert KC.cache_bytes(big) == 2 * 2 * (8 + 4096) * 2 * 16 * 2


def _records(tr) -> list[dict]:
    return [{k: v for k, v in dataclasses.asdict(r).items()
             if k != "backend"} for r in tr]


def test_prefill_and_decode_records_equal_reference_per_call():
    """One eager prefill and one decode call under compiled schedules
    record the same dispatches, field for field, in both packages: every
    matmul a schedule hit, attention recorded as its own regime.  The
    reference's ``lax.scan`` records the stacked period once per trace; the
    port's loop records it once per period, so the reference's period
    records repeat ``reps`` times."""
    rcfg, tcfg, rp, tp = _setup("local")
    reps, rem = tcfg.stack_shape()
    assert rem == 0
    toks = _tokens(tcfg, (2, 12), seed=4)
    reng, rrec = REngine(backend="xla"), {}
    rps = rsched.LayerSchedule.compile(rcfg, "prefill", batch=2, seq=12,
                                       max_seq=16, cache_dtype=jnp.float32)
    rds = rsched.LayerSchedule.compile(rcfg, "decode", batch=2, max_seq=16,
                                       cache_dtype=jnp.float32)
    with reng.tracing() as tr, reng.with_schedule(rps).activate():
        _, rc = rstep.prefill_step(rcfg, rp, {"tokens": jnp.asarray(toks)},
                                   16, jnp.float32)
    rrec["prefill"] = _records(tr)
    with reng.tracing() as tr, reng.with_schedule(rds).activate():
        rstep.decode_step(rcfg, rp, rc, jnp.asarray(toks[:, :1]),
                          jnp.int32(12))
    rrec["decode"] = _records(tr)

    tps = tsched.LayerSchedule.compile(tcfg, "prefill", batch=2, seq=12,
                                       max_seq=16, cache_dtype=torch.float32)
    tds = tsched.LayerSchedule.compile(tcfg, "decode", batch=2, max_seq=16,
                                       cache_dtype=torch.float32)
    for phase, sched in (("prefill", tps), ("decode", tds)):
        with KERNELS.tracing() as tr, KERNELS.with_schedule(sched).activate():
            if phase == "prefill":
                _, tc = tstep.prefill_step(tcfg, tp, {"tokens": _t(toks)},
                                           16, torch.float32)
            else:
                tstep.decode_step(tcfg, tp, tc, _t(toks[:, :1]), 12)
        got = _records(tr)
        want = rrec[phase]
        assert want[-1]["name"] == "lm_head"
        assert got == want[:-1] * reps + want[-1:]
        mm = [r for r in got if r["regime"] in ("sa_conv", "sa_fc")]
        assert len(mm) == 7 * tcfg.n_layers + 1
        assert all(r["schedule"] == "hit" for r in mm)
        attn = [r["m"] for r in got if r["regime"] == "attention"]
        assert attn == ([12] * tcfg.n_layers if phase == "prefill" else [])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _reference_logits(rcfg, rp, prompt: np.ndarray, output: np.ndarray,
                      max_seq: int) -> np.ndarray:
    """The reference's logits for each output step of one request,
    teacher-forced with the port's tokens."""
    prefill, decode = _ref_steps(rcfg, max_seq)
    S = len(prompt)
    rl, rc = prefill(rp, jnp.asarray(prompt)[None])
    rows = [np.asarray(rl[0])]
    for i in range(1, len(output)):
        rl, rc = decode(rp, rc, jnp.asarray(output[i - 1:i])[None],
                        jnp.int32(S + i - 1))
        rows.append(np.asarray(rl[0]))
    return np.stack(rows)


def _check_tokens(logits_ref: np.ndarray, output: np.ndarray) -> None:
    """The port's tokens are the reference's argmax wherever the reference's
    top-2 margin exceeds the logits tolerance (elsewhere two correct
    implementations may pick either)."""
    top2 = np.sort(logits_ref, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2e-3
    assert clear.sum() >= len(output) // 2
    np.testing.assert_array_equal(output[clear],
                                  logits_ref.argmax(-1)[clear])


@pytest.mark.parametrize("name", CONFIGS)
def test_serve_engine_matches_reference(name):
    """Waves of equal prompt length (2, 2 and 1 of 4-long prompts, then a
    6-long prompt), every request against the reference teacher-forced with
    the port's tokens, plus the reference's own same-prompt-same-output
    check on both engines."""
    rcfg, tcfg, rp, tp = _setup(name)
    prompts = [_tokens(tcfg, (4,), seed=10 + i) for i in range(5)] + \
        [_tokens(tcfg, (6,), seed=20)]
    srv = ServeEngine(tcfg, tp, batch_size=2, max_seq=32)
    assert srv.engine.backend == "kernels"
    ref_srv = rserve.ServeEngine(rcfg, rp, batch_size=2, max_seq=32)
    for i, p in enumerate(prompts):
        srv.submit(Request(uid=i, prompt=p, max_new=5))
        ref_srv.submit(rserve.Request(uid=i, prompt=p, max_new=5))
    with srv.engine.tracing() as tr:
        done = srv.run()
    ref_done = {r.uid: r for r in ref_srv.run()}
    assert [r.uid for r in done] == [0, 1, 2, 3, 4, 5]
    mm = [r for r in tr if r.regime in ("sa_conv", "sa_fc")]
    assert mm and all(r.schedule == "hit" for r in mm)
    for r in done:
        assert r.done and r.output.shape == (5,) and r.logits.shape == \
            (5, tcfg.vocab_size)
        want = _reference_logits(rcfg, rp, r.prompt, r.output, 32)
        np.testing.assert_allclose(r.logits, want, **TOL)
        _check_tokens(want, r.output)
        _check_tokens(want, ref_done[r.uid].output)
    one = ServeEngine(tcfg, tp, batch_size=1, max_seq=32)
    one.submit(Request(uid=9, prompt=prompts[0], max_new=5))
    (r1,) = one.run()
    np.testing.assert_array_equal(r1.output, done[0].output)


def test_greedy_generate_matches_reference():
    rcfg, tcfg, rp, tp = _setup("local")
    prompt = _tokens(tcfg, (2, 6), seed=5)
    got = tstep.greedy_generate(tcfg, tp, _t(prompt), 5, engine=KERNELS)
    assert got.shape == (2, 5)
    for b in range(2):
        want = _reference_logits(rcfg, rp, prompt[b], got[b].numpy(), 11)
        _check_tokens(want, got[b].numpy())
    assert torch.equal(got, tstep.greedy_generate(tcfg, tp, _t(prompt), 5))


def test_plain_calls_count_and_meta_compiles_do_not():
    _, tcfg, _, tp = _setup("olmo")
    tsched.clear_schedule_cache()
    ref.reset_counts()
    srv = ServeEngine(tcfg, tp, batch_size=2, max_seq=16)
    srv.submit(Request(uid=0, prompt=_tokens(tcfg, (4,)), max_new=3))
    srv.run()
    layers = tcfg.n_layers
    assert ref.counts() == {"matmul_bias_act": 3 * (7 * layers + 1),
                            "conv2d": 0, "maxpool2d": 0,
                            "attention": layers}


def test_serve_launcher_runs_on_the_cpu(capsys):
    tlaunch.main(["--arch", "olmo-1b", "--device", "cpu", "--requests", "3",
                  "--max-new", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["req 0", "req 1", "req 2"]
