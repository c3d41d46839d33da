"""The port's MoE, Mamba2/SSD and zamba2 shared-attention stacks on the
CPU against the JAX package: reduced mixtral, llama4 (without and with its
shared expert), mamba2 and zamba2 through ``forward``, prefill, decode and
``ServeEngine``, int8 experts, the dispatch records, and the published
configs' schedules compiled on meta.  The blocks themselves are held in
``tests/test_torch_moe_ssm.py``.

Parameters are made by the reference (``jax.random``) and carried across as
numpy; inputs are made with numpy.  The reference runs on its XLA backend;
the port on its ``"kernels"`` backend, whose wrappers take their plain
versions for CPU tensors.  Tolerance: 5e-4, the reference's serving
tolerance (``tests/test_serve.py``), row by row; see :func:`_match` for
the rows where the reference itself is ill-conditioned.
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
from repro.core.quant import quantize_params
from repro.models import transformer as RT
from repro.serve import engine as rserve
from repro.serve import serve_step as rstep
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import schedule as tsched
from repro_torch.core import tree
from repro_torch.core.engine import Engine
from repro_torch.core.quant import QTensor
from repro_torch.models import transformer as T
from repro_torch.serve import kvcache as KC
from repro_torch.serve import serve_step as tstep
from repro_torch.serve.engine import Request, ServeEngine

TOL = dict(rtol=5e-4, atol=5e-4)
KERNELS = Engine(backend="kernels")

# ---------------------------------------------------------------------------
# the stacks: reduced configs through forward, prefill, decode, serving
# ---------------------------------------------------------------------------
_ARCHS = {"mixtral": ("mixtral-8x7b", {}),
          "llama4": ("llama4-maverick-400b-a17b", {}),
          "llama4-shared": ("llama4-maverick-400b-a17b", {"shared": True}),
          "mamba2": ("mamba2-130m", {}),
          "zamba2": ("zamba2-2.7b", {"n_layers": 14})}
CONFIGS = tuple(_ARCHS)
_PARAMS: dict = {}


def _configs(name: str):
    """(reference config, port config): ``reduced()`` in fp32; llama4 also
    with its shared expert every other layer (which ``reduced`` drops),
    zamba2 two periods deep with a two-block Mamba tail."""
    arch, extra = _ARCHS[name]
    out = []
    for base, reg in ((rbase, rreg), (tbase, treg)):
        kw = dict(param_dtype="float32", compute_dtype="float32")
        if extra.get("shared"):
            kw["moe"] = base.MoEConfig(4, 1, 1.25, shared_expert=True,
                                       moe_every=2)
        if "n_layers" in extra:
            kw["n_layers"] = extra["n_layers"]
        out.append(base.reduced(reg.get_config(arch), **kw))
    return tuple(out)


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


def _ti(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


#: at an ill-conditioned row, how far the port's output may lie from the
#: reference's, in multiples of the reference's own move there when its
#: embedding moves by an ulp (see :func:`_match`)
SPREAD = 4.0


def _nudged(params: dict, seed: int, wrap=jnp.asarray) -> dict:
    """``params`` with every entry of ``embed`` moved by at most one fp32
    ulp (times 1 +- 2^-23, rounded), each direction drawn from ``seed``."""
    e = np.asarray(params["embed"], dtype=np.float64)
    sign = np.random.default_rng(seed).choice([-1.0, 1.0], e.shape)
    return {**params, "embed": wrap((e * (1 + sign * 2.0 ** -23)).astype(
        np.float32))}


def _rows(a: np.ndarray) -> np.ndarray:
    """``a`` as rows along its last axis (a token's logits, a head's key,
    a conv tail's channels, a state's N entries)."""
    return np.asarray(a, dtype=np.float64).reshape(-1, max(a.shape[-1:],
                                                           default=1))


def _match(got: list, want: list, nudged_runs) -> dict:
    """Each of ``got`` within TOL of the same output of ``want``, row by
    row (:func:`_rows`).  A row may miss TOL only where it is
    ill-conditioned: in the SSM stacks rmsnorm of ``y * silu(z)`` blows a
    rounding up at a token where that product is near zero, and the SSM
    state carries it to the tokens after it, so there the reference's own
    row moves by more than TOL's atol when its embedding moves by an ulp
    (the largest move over ``nudged_runs()``, the same run on two nudged
    embeddings).  At such a row each element must lie within SPREAD times
    that row's move.  Returns what was seen: the number of rows, of
    ill-conditioned rows, and the (output, row) of each row that needed
    the fallback (reduced zamba2: the second sequence of the forward, from
    its first token on, and 2 of the 7214 rows of prefill and decode)."""
    got = [_rows(np.asarray(g)) for g in got]
    want = [_rows(np.asarray(w)) for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    within = [np.abs(g - w) <= TOL["atol"] + TOL["rtol"] * np.abs(w)
              for g, w in zip(got, want)]
    seen = dict(rows=sum(len(w) for w in want), ill=0, fallback=[])
    if all(ok.all() for ok in within):
        return seen
    runs = [[_rows(np.asarray(a)) for a in run] for run in nudged_runs()]
    for i, (g, w, ok) in enumerate(zip(got, want, within)):
        move = np.max([np.abs(run[i] - w).max(-1) for run in runs], axis=0)
        ill = move > TOL["atol"]
        seen["ill"] += int(ill.sum())
        for r in np.flatnonzero(~ok.all(-1)):
            diff = np.abs(g[r] - w[r]).max()
            assert ill[r], (
                f"output {i} row {r}: max|d| {diff:.3g} outside {TOL} at a "
                f"well-conditioned row (the reference moves {move[r]:.3g} "
                f"there under a one-ulp nudge)")
            assert (ok[r] | (np.abs(g[r] - w[r]) <= SPREAD * move[r])).all(), (
                f"output {i} row {r}: max|d| {diff:.3g} > {SPREAD} x the "
                f"reference's own move {move[r]:.3g} there")
            seen["fallback"].append((i, int(r)))
    return seen


@pytest.fixture
def report(request, record_testsuite_property):
    """``report(cfg, seen)``: record what :func:`_match` saw under the
    test's name in the JUnit report; only an SSM stack may need the
    fallback (the MoE stacks hold TOL at every row)."""
    def put(cfg, seen: dict) -> None:
        for key in ("rows", "ill", "fallback"):
            record_testsuite_property(f"{request.node.name}.{key}",
                                      seen[key])
        assert cfg.ssm is not None or not seen["fallback"], seen
    return put


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


@pytest.mark.parametrize("name", CONFIGS)
def test_trees_match_reference(name):
    """The converted tree holds the reference's leaves; the port's own
    ``init_params`` makes the same paths, shapes and dtypes (``shared``
    for zamba2, ``moe.shared`` for llama4's shared expert)."""
    rcfg, tcfg, rp, tp = _setup(name)
    want = {p: (tuple(x.shape), str(x.dtype)) for p, x in
            tree.flatten_with_paths(jax.tree.map(np.asarray, rp))}
    got = {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in tree.flatten_with_paths(T.init_params(tcfg, 3,
                                                             device="cpu"))
           if p != "embed_t"}
    assert got == want
    for path, leaf in tree.flatten_with_paths(rp):
        node = dict(tree.flatten_with_paths(tp))[path]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert ("shared" in tp) == (name == "zamba2")
    assert any(".moe.shared." in p for p in want) == (name == "llama4-shared")


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_reference(name, report):
    """Train-mode logits and the MoE aux loss (summed over blocks) against
    the reference's; the kernels backend equals the torch backend on the
    CPU, bitwise."""
    rcfg, tcfg, rp, tp = _setup(name)
    toks = _tokens(tcfg, (2, 20))
    want, waux, _ = RT.forward(rcfg, rp, {"tokens": jnp.asarray(toks)})
    with KERNELS.activate():
        got, aux, caches = T.forward(tcfg, tp, {"tokens": _ti(toks)})
    assert got.dtype == torch.float32 and caches is None
    seen = _match([got], [want], lambda: [
        [RT.forward(rcfg, _nudged(rp, s), {"tokens": jnp.asarray(toks)})[0]]
        for s in (1, 2)])
    report(tcfg, seen)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)
    assert (float(aux) > 0) == (tcfg.moe is not None)
    with Engine(backend="torch").activate():
        plain, _, _ = T.forward(tcfg, tp, {"tokens": _ti(toks)})
    assert torch.equal(plain, got)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_reference(name, report):
    """Prefill a 10-token prompt (logits, every cache leaf: K/V, conv tails
    and SSM states), then decode 14 tokens teacher-forced: mixtral's
    16-slot rings wrap on the way."""
    rcfg, tcfg, rp, tp = _setup(name)
    toks = _tokens(tcfg, (2, 24), seed=1)
    S_, ms = 10, 28
    prefill, decode = _ref_steps(rcfg, ms)

    def reference(params):
        rl, rc = prefill(params, jnp.asarray(toks[:, :S_]))
        out = [rl, *jax.tree_util.tree_leaves(rc)]
        for pos in range(S_, 24):
            rl, rc = decode(params, rc, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.int32(pos))
            out.append(rl)
        return out + jax.tree_util.tree_leaves(rc)

    want = reference(rp)
    with KERNELS.activate():
        tl, tc = tstep.prefill_step(tcfg, tp, {"tokens": _ti(toks[:, :S_])},
                                    ms, cache_dtype=torch.float32)
        got = [tl.clone(), *(t.clone() for t in tree.leaves(tc))]
        for pos in range(S_, 24):
            tl, tc = tstep.decode_step(tcfg, tp, tc,
                                       _ti(toks[:, pos:pos + 1]), pos)
            got.append(tl)
    got += tree.leaves(tc)
    assert [(tuple(t.shape), str(t.dtype)) for t in got] == \
        [(x.shape, f"torch.{x.dtype}") for x in want]
    report(tcfg, _match(got, want, lambda: [reference(_nudged(rp, s))
                                            for s in (1, 2)]))


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_incremental_decode_matches_full_forward(name, report):
    """Inside the port: decoding token by token past the prompt reproduces
    teacher forcing through the conv tails and SSM states (the reference's
    invariant, tests/test_serve.py).  Without MoE, where capacity makes a
    token's output depend on the tokens beside it."""
    _, tcfg, _, tp = _setup(name)
    toks = _ti(_tokens(tcfg, (2, 24), seed=2))

    def forward(params):
        with KERNELS.activate():
            full = T.forward(tcfg, params, {"tokens": toks})[0]
        return [full[:, pos] for pos in range(7, 24)]

    got = []
    with KERNELS.activate():
        logits, cache = tstep.prefill_step(tcfg, tp, {"tokens": toks[:, :8]},
                                           28, cache_dtype=torch.float32)
        got.append(logits)
        for pos in range(8, 24):
            logits, cache = tstep.decode_step(tcfg, tp, cache,
                                              toks[:, pos:pos + 1], pos)
            got.append(logits)
    report(tcfg, _match(got, forward(tp), lambda: [
        forward(T.with_head_copy(tcfg, _nudged(tp, s, torch.from_numpy)))
        for s in (1, 2)]))


def test_cache_layout_and_bytes():
    """zamba2: a conv tail and an fp32 state per Mamba position (stacked
    over the periods, unstacked in the tail), one global K/V per shared
    attention application; the conv tail takes the cache dtype."""
    _, tcfg, _, _ = _setup("zamba2")
    c = KC.init_cache(tcfg, 2, 32, dtype=torch.bfloat16, device="meta")
    s = tcfg.ssm
    di, ns, nh = s.d_inner(64), s.d_state, s.n_heads(64)
    conv = (2, 2, s.conv_width - 1, di + 2 * ns)
    assert [tuple(e["conv"].shape) for e in c["main"][:5]] == [conv] * 5
    assert c["main"][0]["conv"].dtype == torch.bfloat16
    assert c["main"][0]["h"].dtype == torch.float32
    assert tuple(c["main"][0]["h"].shape) == (2, 2, nh, s.head_dim, ns)
    assert tuple(c["main"][5]["attn"]["k"].shape) == (2, 2, 32, 2, 16)
    assert [tuple(e["h"].shape) for e in c["tail"]] == \
        [(2, nh, s.head_dim, ns)] * 2
    per_mamba = 2 * 3 * (di + 2 * ns) * 2 + 2 * nh * s.head_dim * ns * 4
    assert KC.cache_bytes(c) == 12 * per_mamba + 2 * 2 * 2 * 32 * 2 * 16 * 2


def _reference_logits(rcfg, rp, prompt: np.ndarray, output: np.ndarray,
                      max_seq: int) -> np.ndarray:
    """The reference's logits for each output step of one request,
    teacher-forced with the port's tokens."""
    prefill, decode = _ref_steps(rcfg, max_seq)
    S_ = len(prompt)
    rl, rc = prefill(rp, jnp.asarray(prompt)[None])
    rows = [np.asarray(rl[0])]
    for i in range(1, len(output)):
        rl, rc = decode(rp, rc, jnp.asarray(output[i - 1:i])[None],
                        jnp.int32(S_ + i - 1))
        rows.append(np.asarray(rl[0]))
    return np.stack(rows)


def _check_tokens(logits_ref: np.ndarray, output: np.ndarray) -> None:
    """The tokens are the reference's argmax wherever its top-2 margin
    exceeds the logits tolerance."""
    top2 = np.sort(logits_ref, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2e-3
    assert clear.sum() >= len(output) // 2
    np.testing.assert_array_equal(output[clear],
                                  logits_ref.argmax(-1)[clear])


@pytest.mark.parametrize("name", CONFIGS)
def test_serve_engine_matches_reference(name, report):
    """Waves of 2, 2 and 1 four-token prompts and a lone six-token one: a
    wave shorter than the batch routes its own tokens only.  Every request
    against the reference teacher-forced with the port's tokens (prompts
    this short fill no expert past its capacity, so a request's logits do
    not depend on its wave), and the reference ``ServeEngine``'s tokens
    against the same logits."""
    rcfg, tcfg, rp, tp = _setup(name)
    prompts = [_tokens(tcfg, (4,), seed=10 + i) for i in range(5)] + \
        [_tokens(tcfg, (6,), seed=20)]
    srv = ServeEngine(tcfg, tp, batch_size=2, max_seq=32)
    ref_srv = rserve.ServeEngine(rcfg, rp, batch_size=2, max_seq=32)
    for i, p in enumerate(prompts):
        srv.submit(Request(uid=i, prompt=p, max_new=5))
        ref_srv.submit(rserve.Request(uid=i, prompt=p, max_new=5))
    with srv.engine.tracing() as tr:
        done = srv.run()
    ref_done = {r.uid: r for r in ref_srv.run()}
    assert [r.uid for r in done] == [0, 1, 2, 3, 4, 5]
    mm = [r for r in tr if r.regime in ("sa_conv", "sa_fc")
          and not r.name.endswith(".experts")]
    assert mm and all(r.schedule == "hit" for r in mm)
    routers = [r for r in tr if r.name == "moe.router"]
    assert bool(routers) == (tcfg.moe is not None)
    assert all(r.m <= 2 * 6 for r in routers)
    seen = dict(rows=0, ill=0, fallback=[])
    for r in done:
        assert r.output.shape == (5,) and r.logits.shape == \
            (5, tcfg.vocab_size)
        want = _reference_logits(rcfg, rp, r.prompt, r.output, 32)
        one = _match([r.logits], [want], lambda: [
            [_reference_logits(rcfg, _nudged(rp, s), r.prompt, r.output, 32)]
            for s in (1, 2)])
        seen["rows"] += one["rows"]
        seen["ill"] += one["ill"]
        seen["fallback"] += [(r.uid, row) for _, row in one["fallback"]]
        _check_tokens(want, r.output)
        _check_tokens(want, ref_done[r.uid].output)
    report(tcfg, seen)


def test_int8_experts_cross_over():
    """The reference's ``quantize_params`` on reduced mixtral (int8
    attention, router-free expert and head weights): the QTensors cross
    over as the port's, per-expert scales and all, and the forward equals
    the reference's on them."""
    rcfg, tcfg, rp, _ = _setup("mixtral")
    qp = quantize_params(rp)
    tq = lm_params_from_reference(qp, device="cpu")
    moe = tq["blocks"][0]["moe"]
    assert isinstance(moe["wg"], QTensor) and moe["wg"].q.dtype == torch.int8
    assert tuple(moe["wg"].scale.shape) == (2, 4, 1, tcfg.d_ff)
    assert moe["router"].dtype == torch.float32
    toks = _tokens(tcfg, (2, 12), seed=6)
    want, waux, _ = RT.forward(rcfg, qp, {"tokens": jnp.asarray(toks)})
    with KERNELS.activate():
        got, aux, _ = T.forward(tcfg, tq, {"tokens": _ti(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)


def _records(tr) -> list[dict]:
    return [{k: v for k, v in dataclasses.asdict(r).items()
             if k != "backend"} for r in tr]


@pytest.mark.parametrize("name", ["mixtral", "zamba2"])
def test_prefill_and_decode_records_equal_reference_per_call(name):
    """One prefill and one decode call under compiled schedules record the
    same dispatches, field for field, in both packages: the router, the
    experts (``moe.experts``, no plan), the Mamba projections and the
    shared attention.  The reference's ``lax.scan`` records a period once
    per trace, the port once per period."""
    rcfg, tcfg, rp, tp = _setup(name)
    reps, _ = tcfg.stack_shape()
    assert reps >= 2
    toks = _tokens(tcfg, (2, 12), seed=4)
    reng, want = REngine(backend="xla"), {}
    rps = rsched.LayerSchedule.compile(rcfg, "prefill", batch=2, seq=12,
                                       max_seq=16, cache_dtype=jnp.float32)
    rds = rsched.LayerSchedule.compile(rcfg, "decode", batch=2, max_seq=16,
                                       cache_dtype=jnp.float32)
    with reng.tracing() as tr, reng.with_schedule(rps).activate():
        _, rc = rstep.prefill_step(rcfg, rp, {"tokens": jnp.asarray(toks)},
                                   16, jnp.float32)
    want["prefill"] = _records(tr)
    with reng.tracing() as tr, reng.with_schedule(rds).activate():
        rstep.decode_step(rcfg, rp, rc, jnp.asarray(toks[:, :1]),
                          jnp.int32(12))
    want["decode"] = _records(tr)
    for phase in ("prefill", "decode"):
        sched = tsched.LayerSchedule.compile(
            tcfg, phase, batch=2, seq=12 if phase == "prefill" else 1,
            max_seq=16, cache_dtype=torch.float32)
        with KERNELS.tracing() as tr, KERNELS.with_schedule(sched).activate():
            if phase == "prefill":
                _, tc = tstep.prefill_step(tcfg, tp, {"tokens": _ti(toks)},
                                           16, torch.float32)
            else:
                tstep.decode_step(tcfg, tp, tc, _ti(toks[:, :1]), 12)
        got, w = _records(tr), want[phase]
        # the stacked period's records, then the tail's, then the head's
        per = (len(got) - len(w)) // (reps - 1)
        assert got == w[:per] * reps + w[per:]
        names = {r["name"] for r in got}
        if name == "mixtral":
            assert {"moe.router", "moe.experts"} <= names
        else:
            assert {"ssm.in_proj", "ssm.out_proj", "attn.q"} <= names


# ---------------------------------------------------------------------------
# the published configs compile on meta
# ---------------------------------------------------------------------------
def _entries(sched) -> dict:
    return {tuple(dataclasses.astuple(k)): (type(v).__name__,
                                            dataclasses.asdict(v))
            for k, v in sched.items()}


@pytest.mark.parametrize("arch,n", [
    ("mixtral-8x7b", {"moe.router": 8}),
    ("llama4-maverick-400b-a17b", {"moe.router": 128}),
    ("mamba2-130m", {"ssm.in_proj": 2 * 1536 + 2 * 128 + 24}),
    ("zamba2-2.7b", {"ssm.in_proj": 10448, "attn.q": 32 * 80})])
def test_published_schedules_compile_on_meta(arch, n):
    """Each family as published, one pattern period deep: a full wave's
    prefill (4 x 512) and a decode step at b = 4 compile on meta tensors
    to the reference's schedules, with the router at n = E and Mamba's
    in_proj at 2 di + 2 ns + nh."""
    rcfg = rreg.get_config(arch)
    tcfg = treg.get_config(arch)
    rcfg = dataclasses.replace(rcfg, n_layers=len(rcfg.pattern))
    tcfg = dataclasses.replace(tcfg, n_layers=len(tcfg.pattern))
    T.check_supported(tcfg)
    for phase, batch, seq in (("prefill", 4, 512), ("decode", 4, 1)):
        r = rsched.LayerSchedule.compile(rcfg, phase, batch=batch, seq=seq,
                                         max_seq=640,
                                         cache_dtype=jnp.bfloat16)
        t = tsched.LayerSchedule.compile(tcfg, phase, batch=batch, seq=seq,
                                         max_seq=640,
                                         cache_dtype=torch.bfloat16)
        assert len(t) > 0 and _entries(t) == _entries(r)
        got = {k.name: k.n for k in t}
        assert {k: got[k] for k in n} == n
