"""Training the encoder-decoder and vision-prefix families on the port, on
the CPU against the JAX package: reduced seamless-m4t-large-v2 (2 encoder
and 2 decoder layers, 16 audio frames) and llava-next-34b (2 layers, 8
vision tokens) through ``loss_fn`` and its gradients (the vision loss's
offset, the encoder under remat), the embedding streams of
``SyntheticLM``, the dispatch records and launches of a step, and the
trainer's resume.

Parameters are made by the reference (``jax.random``) and carried across
as numpy, in fp32; inputs are the reference's own ``SyntheticLM`` batches
(tokens and frontend embeddings), passed as numpy.  The port runs on its
``"kernels"`` backend (on the CPU its wrappers take their plain versions),
the reference on XLA.  Tolerances are ``tests/test_torch_train.py``'s:
1e-5 on a loss, 3e-4 on a gradient.  Both train through
``make_train_step``: llava's schedule is text-only, as the reference
compiles it, so its matmuls miss it and are planned on the fly; seamless
has no train schedule in either package, so its steps run with none.
Steps against the reference's are in
``tests/test_torch_train_encdec_steps.py``.
"""
from __future__ import annotations

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.core.engine import Engine as REngine
from repro.data import pipeline as rdata
from repro.models import transformer as RT
from repro.train import train_step as RTS
from repro_torch.analysis import launch as tlaunch
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import engine as eng_mod
from repro_torch.core import tree
from repro_torch.core.engine import Engine
from repro_torch.core.schedule import LayerSchedule
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import ref
from repro_torch.models import transformer as T
from repro_torch.train import train_step as TS
from repro_torch.train import trainer

SEAMLESS, LLAVA = "seamless-m4t-large-v2", "llava-next-34b"
ARCHS = (SEAMLESS, LLAVA)
TOL = dict(rtol=3e-4, atol=3e-4)
KERNELS = Engine(backend="kernels")
B, S = 2, 32
_SETUP: dict = {}


def setup(arch: str):
    """(ref cfg, port cfg, ref params, port params): ``reduced()`` in fp32,
    made once."""
    if arch not in _SETUP:
        kw = dict(param_dtype="float32", compute_dtype="float32")
        rcfg = rbase.reduced(rreg.get_config(arch), **kw)
        tcfg = tbase.reduced(treg.get_config(arch), **kw)
        rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
        _SETUP[arch] = (rcfg, tcfg, rp,
                        lm_params_from_reference(rp, device="cpu"))
    return _SETUP[arch]


def ref_batches(rcfg, n: int = 1, b: int = B, s: int = S) -> list[dict]:
    """The reference's ``SyntheticLM`` batches of steps 0 .. n - 1 (seed
    1): tokens and the config's frontend embeddings, as numpy."""
    data = rdata.SyntheticLM(rdata.DataConfig(rcfg.vocab_size, s, b, seed=1),
                             rcfg)
    return [{k: np.asarray(v) for k, v in data.batch_at(i).items()}
            for i in range(n)]


def port_batch(batch: dict) -> dict:
    """A numpy batch as the port's tensors (tokens int64)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.int64 if k == "tokens"
                                         else v.dtype))
            for k, v in batch.items()}


def with_mask(batch: dict, seed: int = 3) -> dict:
    """``batch`` with a random 0/1 ``loss_mask`` over its text tokens."""
    mask = np.random.default_rng(seed).integers(
        0, 2, batch["tokens"].shape).astype(np.float32)
    return {**batch, "loss_mask": mask}


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch, masked):
    """``loss_fn`` and the gradient of every leaf, from the same parameters
    and the reference's batch, against ``jax.value_and_grad`` of the
    reference's ``loss_fn``: llava's loss read behind its vision prefix
    (a given mask whole), seamless's encoder reached through 2
    cross-attentions, the frontend's projection in both."""
    rcfg, tcfg, rp, tp = setup(arch)
    (batch,) = ref_batches(rcfg)
    if masked:
        batch = with_mask(batch)
    (want, wparts), wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(rcfg, p, b), has_aux=True))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, parts = T.loss_fn(tcfg, tp, port_batch(batch))
    assert abs(float(got) - float(want)) <= 1e-5
    assert abs(float(parts["ce"]) - float(wparts["ce"])) <= 1e-5
    loss, grads = TS.make_grad_fn(tcfg, tbase.TrainConfig(),
                                  engine=KERNELS)(tp, port_batch(batch))
    assert abs(float(loss) - float(want)) <= 1e-5
    gl = list(tree.flatten_with_paths(grads))
    wl = [w for _, w in jax.tree_util.tree_flatten_with_path(wgrads)[0]]
    assert len(gl) == len(wl)
    for (path, g), w in zip(gl, wl):
        assert tuple(g.shape) == tuple(np.shape(w)), path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=path)
    names = dict(gl)
    assert float(names["frontend"].abs().sum()) > 0
    if tcfg.enc_dec:
        for p in ("encoder.blocks.attn.wq", "blocks.0.xattn.wk"):
            assert float(names[p].abs().sum()) > 0, p


def test_vision_loss_reads_the_logits_behind_the_prefix():
    """llava's loss is the cross entropy of logits ``vt - 1 .. vt + S - 2``
    against every text token (the last vision position predicts the first
    token); without vision embeddings it is the text-only loss, and a
    mask over the text is taken whole with them and from token 1
    without."""
    _, tcfg, _, tp = setup(LLAVA)
    (batch,) = ref_batches(setup(LLAVA)[0])
    tb = port_batch(with_mask(batch))
    vt = tcfg.vision_tokens
    with KERNELS.activate():
        logits, _, _ = T.forward(tcfg, tp, tb)
    lp = torch.log_softmax(logits[:, vt - 1:vt + S - 1], -1)
    ll = lp.gather(-1, tb["tokens"][..., None])[..., 0]
    mask = tb["loss_mask"]
    want = -(ll * mask).sum() / mask.sum()
    got, _ = T.loss_fn(tcfg, tp, tb)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    text = {"tokens": tb["tokens"], "loss_mask": mask}
    with KERNELS.activate():
        tl, _, _ = T.forward(tcfg, tp, text)
    lp = torch.log_softmax(tl[:, :-1], -1)
    ll = lp.gather(-1, tb["tokens"][:, 1:, None])[..., 0]
    want = -(ll * mask[:, 1:]).sum() / mask[:, 1:].sum()
    torch.testing.assert_close(T.loss_fn(tcfg, tp, text)[0], want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_block_equals_none_bitwise(arch):
    """Recomputing each decoder period and each encoder block in the
    backward pass gives the loss and every gradient of the run without
    remat, bitwise; the recompute launches the blocks' matmuls again and
    records nothing (the engine's records are one forward's)."""
    _, tcfg, _, tp = setup(arch)
    batch = port_batch(ref_batches(setup(arch)[0])[0])
    out, counts, records = {}, {}, {}
    for remat in ("none", "block"):
        ref.reset_counts()
        with KERNELS.tracing() as tr:
            out[remat] = TS.make_grad_fn(tcfg, tbase.TrainConfig(
                remat=remat), engine=KERNELS)(tp, batch)
        counts[remat] = ref.counts()
        records[remat] = [(r.name, r.m, r.n, r.k, r.regime) for r in tr]
    assert torch.equal(out["none"][0], out["block"][0])
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(out["none"][1]), tree.leaves(out["block"][1])))
    assert records["block"] == records["none"]
    assert counts["block"]["matmul_bias_act"] > \
        counts["none"]["matmul_bias_act"]
    # every attention runs again in the recompute (encoder's and decoder's)
    per = tcfg.n_layers * (2 if tcfg.enc_dec else 1) + tcfg.n_enc_layers
    assert counts["none"]["attention"] == 2 * per       # forward, backward
    assert counts["block"]["attention"] == 3 * per


# ---------------------------------------------------------------------------
# the step's records and launches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("microbatch", [0, 1])
def test_llava_dispatch_records_equal_reference(microbatch):
    """The distinct dispatch records (name, m, n, k, dtype, schedule state)
    of a llava train step equal the reference's ``make_train_step``'s: the
    schedule is text-only in both packages, so every matmul over the
    vision prefix and the text misses it."""
    rcfg, tcfg, rp, tp = setup(LLAVA)
    (batch,) = ref_batches(rcfg)
    kw = dict(global_batch=B, seq_len=S, microbatch=microbatch,
              remat="block")
    reng = REngine(backend="xla")
    rtc = rbase.TrainConfig(**kw)
    rstate = RTS.init_train_state(rcfg, rtc, jax.random.PRNGKey(0))
    with reng.tracing() as rtr:
        jax.jit(RTS.make_train_step(rcfg, rtc, engine=reng))(
            *rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    ttc = tbase.TrainConfig(**kw)
    tstate = TS.init_train_state(tcfg, ttc, 0, device="cpu")
    with KERNELS.tracing() as ttr:
        TS.make_train_step(tcfg, ttc, engine=KERNELS)(*tstate,
                                                      port_batch(batch))

    def distinct(tr):
        return {(r.name, r.m, r.n, r.k, r.regime, r.dtype, r.schedule)
                for r in tr}

    got, want = distinct(ttr), distinct(rtr)
    assert got == want
    m = (microbatch or B) * (S + tcfg.vision_tokens)
    assert {r[1] for r in got if r[4] != "attention"} == {m}
    assert {r[-1] for r in got if r[4] != "attention"} == {"miss"}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_launches_what_the_launch_pass_checks(arch, monkeypatch):
    """Every kernel call of a train step (forward, recompute, ``pre``,
    ``dx``, ``dw``, flash) has a shape that the launch pass builds for the
    config's train shape (``lm_launches``: :func:`traced_entries` over the
    frames or the vision prefix, ``backward_launches``,
    ``attention_shapes``: the encoder's, the cross-attention's and the
    decoder's), and those launches verify with no finding."""
    rcfg, tcfg, _, tp = setup(arch)
    seen = set()
    for kname, shape_of in (
            ("sa_fc_matmul", lambda x, w: ("sa_fc", (x.shape[0], x.shape[1],
                                                     w.shape[1]))),
            ("sa_conv_matmul", lambda x, w: ("sa_conv", (
                x.shape[0], w.shape[1], x.shape[1])))):
        real = getattr(eng_mod, kname)
        monkeypatch.setattr(eng_mod, kname, lambda x, w, *a, _f=real,
                            _s=shape_of, **k: seen.add(_s(x, w)) or
                            _f(x, w, *a, **k))
    real_flash = eng_mod.flash_attention

    def flash(q, k, v, *, causal=True, window=0, **kw):
        seen.add(("attention", (q.shape[0], q.shape[1], k.shape[1],
                                q.shape[2], k.shape[2], q.shape[3], causal,
                                window, q.element_size())))
        return real_flash(q, k, v, causal=causal, window=window, **kw)

    monkeypatch.setattr(eng_mod, "flash_attention", flash)
    tc = tbase.TrainConfig(global_batch=B, seq_len=S, remat="block")
    TS.make_train_step(tcfg, tc, engine=KERNELS)(
        *TS.init_train_state(tcfg, tc, 0, device="cpu"),
         port_batch(ref_batches(rcfg)[0]))
    launches = [lau for lau in tlaunch.lm_launches(
        {arch: tcfg}, shapes=(("train", B, S),))
        if lau.op.startswith(f"{arch} train b{B}x{S}:")]
    checked = {(lau.kernel, lau.shape if lau.kernel == "attention"
                else lau.shape[:3]) for lau in launches}
    assert seen == checked
    kinds = {lau.op.split(": ")[1] for lau in launches
             if lau.kernel == "attention"}
    assert kinds == ({"attn window 0 [attention]", "encoder attn [attention]",
                      "cross attn [attention]"} if tcfg.enc_dec
                     else {"attn window 0 [attention]"})
    report = tlaunch.verify_launches(launches)
    assert report.ok, report.summary()


# ---------------------------------------------------------------------------
# the data, the unscheduled steps, the trainer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_lm_makes_the_frontend_streams(arch):
    """``SyntheticLM`` with a frontend config adds its embeddings (vision
    tokens or audio frames x frontend_dim, fp32 standard normals) after the
    same tokens as without it, deterministic in (seed, step, shard)."""
    _, tcfg, _, _ = setup(arch)
    key, n = ("audio_embeds", tcfg.audio_frames) if tcfg.enc_dec else \
        ("vision_embeds", tcfg.vision_tokens)
    dc = tdata.DataConfig(tcfg.vocab_size, S, 4, seed=5, n_shards=2,
                          shard=1)
    data = tdata.SyntheticLM(dc, tcfg)
    b = data.batch_at(3)
    assert set(b) == {"tokens", key}
    e = b[key]
    assert e.shape == (2, n, tcfg.frontend_dim) and e.dtype == torch.float32
    assert abs(float(e.mean())) < 0.1 and abs(float(e.std()) - 1) < 0.1
    again = tdata.SyntheticLM(dc, tcfg).batch_at(3)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert torch.equal(b["tokens"], tdata.SyntheticLM(dc).batch_at(3)
                       ["tokens"])
    for other in (data.batch_at(4), tdata.SyntheticLM(
            dataclasses.replace(dc, shard=0), tcfg).batch_at(3),
            tdata.SyntheticLM(dataclasses.replace(dc, seed=6),
                              tcfg).batch_at(3)):
        assert not torch.equal(other[key], e)


def test_encdec_steps_run_with_no_schedule_and_accumulate_microbatches():
    """Neither package compiles an enc-dec train schedule (the compile
    refuses), so ``make_grad_fn`` runs seamless with no schedule attached,
    even on an engine that carries one: every matmul record is
    unscheduled (state ``""``).  Accumulating microbatches gives the full
    batch's loss and gradients."""
    rcfg, tcfg, _, tp = setup(SEAMLESS)
    batch = port_batch(ref_batches(rcfg)[0])
    with pytest.raises(NotImplementedError, match="no compiled schedule"):
        LayerSchedule.compile(tcfg, "train", batch=B, seq=S)
    carrying = KERNELS.with_schedule(LayerSchedule.compile(
        setup(LLAVA)[1], "train", batch=B, seq=S))
    with carrying.tracing() as tr:
        full = TS.make_grad_fn(tcfg, tbase.TrainConfig(),
                               engine=carrying)(tp, batch)
    assert {r.schedule for r in tr if r.regime != "attention"} == {""}
    micro = TS.make_grad_fn(tcfg, tbase.TrainConfig(microbatch=1),
                            engine=KERNELS)(tp, batch)
    assert abs(float(micro[0]) - float(full[0])) <= 1e-5
    for a, b in zip(tree.leaves(micro[1]), tree.leaves(full[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_resume_equals_uninterrupted_bitwise(arch, tmp_path):
    """``trainer.run`` over the config's own ``SyntheticLM`` stream (its
    embeddings drawn each step), both through the default step: resuming from the step-2 checkpoint gives
    the uninterrupted run's losses bitwise."""
    _, tcfg, _, _ = setup(arch)
    tc = tbase.TrainConfig(global_batch=2, seq_len=16, total_steps=4,
                           lr=3e-3, warmup_steps=1, remat="block")
    quiet = dict(device="cpu", log=lambda s: None, ckpt_every=2)
    whole = trainer.run(tcfg, tc, ckpt_dir=str(tmp_path / "a"), **quiet)
    shutil.copytree(tmp_path / "a" / "step_00000002",
                    tmp_path / "b" / "step_00000002")
    resumed = trainer.run(tcfg, tc, ckpt_dir=str(tmp_path / "b"), **quiet)
    assert resumed.resumed_from == 2 and resumed.steps_run == 2
    assert resumed.losses == whole.losses[2:]
    assert all(np.isfinite(whole.losses))
