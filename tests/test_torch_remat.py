"""``remat="dots"`` on the port, on the CPU against the JAX package: each
stacked pattern period keeps its matrix products (the kernels' forward
calls and the plain products) and recomputes the rest in the backward
pass, the port's reading of the reference's ``checkpoint_dots``.

Parameters are made by the reference (``jax.random``) and carried across
as numpy, in fp32; tokens come from a numpy seed.  The port runs on its
``"kernels"`` backend (on the CPU its wrappers take their plain versions),
the reference on XLA.  Tolerances are those of the ``"none"`` and
``"block"`` comparisons (``tests/test_torch_train.py``,
``tests/test_torch_train_families.py``): 1e-5 on a loss, 3e-4 on a
gradient, and for reduced zamba2, whose SSM stack is ill-conditioned, that
file's ``_match`` rule.  Within the port, ``"dots"`` gives the loss and
every gradient of ``"none"`` bitwise, launches the forward's matmuls as
often as ``"none"`` and the flash kernel as often as ``"block"``.
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
from repro.models import transformer as RT
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import engine as eng_mod
from repro_torch.core import roofline, tree
from repro_torch.core.engine import Engine
from repro_torch.data import pipeline as tdata
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, grad_compress
from repro_torch.train import train_step as TS
from repro_torch.train import trainer
from test_torch_train_families import TOL, _match, _nudged

KERNELS = Engine(backend="kernels")
#: the four configs held against the reference, and the rest of the
#: families the port trains
REFERENCE_ARCHS = ("olmo-1b", "mixtral-8x7b", "zamba2-2.7b",
                   "seamless-m4t-large-v2")
ARCHS = REFERENCE_ARCHS + ("mamba2-130m", "llava-next-34b")
REMATS = ("none", "block", "dots")
B, S = 2, 32
_SETUP: dict = {}
_RUNS: dict = {}


def setup(arch: str):
    """(ref cfg, port cfg, ref params, port params, port batch, ref batch):
    ``reduced()`` in fp32, an MoE config at ``tests/test_archs.py``'s
    capacity factor of 4.0; the batch's tokens (and a frontend config's
    embeddings) from a numpy seed.  Made once."""
    if arch not in _SETUP:
        cfgs = []
        for base, reg in ((rbase, rreg), (tbase, treg)):
            cfg = base.reduced(reg.get_config(arch), param_dtype="float32",
                               compute_dtype="float32")
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=4.0))
            cfgs.append(cfg)
        rcfg, tcfg = cfgs
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, tcfg.vocab_size, (B, S))}
        if tcfg.enc_dec:
            batch["audio_embeds"] = rng.standard_normal(
                (B, tcfg.audio_frames, tcfg.frontend_dim)).astype(np.float32)
        if tcfg.vision_tokens:
            batch["vision_embeds"] = rng.standard_normal(
                (B, tcfg.vision_tokens, tcfg.frontend_dim)
            ).astype(np.float32)
        rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
        _SETUP[arch] = (rcfg, tcfg, rp,
                        lm_params_from_reference(rp, device="cpu"),
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        {k: jnp.asarray(v) for k, v in batch.items()})
    return _SETUP[arch]


def runs(arch: str) -> dict:
    """{remat: ((loss, grads), kernel calls)} of one ``make_grad_fn`` pass
    on the kernels backend under each policy, the calls logged by
    :class:`repro_torch.core.roofline.MetaCount` (the recompute's kept
    products are handed back, so they log no call).  Made once."""
    if arch not in _RUNS:
        _, tcfg, _, tp, batch, _ = setup(arch)
        out = {}
        for remat in REMATS:
            with roofline.MetaCount() as count:
                got = TS.make_grad_fn(tcfg, tbase.TrainConfig(remat=remat),
                                      engine=KERNELS)(tp, batch)
            out[remat] = (got, count.calls)
        _RUNS[arch] = out
    return _RUNS[arch]


def _bitwise(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _calls(calls, kernel=None, role=None) -> int:
    return sum((kernel is None or c.kernel == kernel) and
               (role is None or c.role == role) for c in calls)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_dots_matches_reference(arch):
    """``make_grad_fn`` under ``"dots"`` against ``jax.value_and_grad`` of
    the reference's ``loss_fn(..., remat="dots")``: the loss within 1e-5,
    every gradient leaf within 3e-4 (reduced zamba2 by ``_match``'s rule
    at its ill-conditioned rows)."""
    rcfg, tcfg, rp, _, _, rbatch = setup(arch)
    ref_fn = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(rcfg, p, b, remat="dots"), has_aux=True))
    (want, _), wgrads = ref_fn(rp, rbatch)
    got, grads = runs(arch)["dots"][0]
    assert abs(float(got) - float(want)) <= 1e-5
    gl = list(tree.flatten_with_paths(grads))
    wl = [w for _, w in jax.tree_util.tree_flatten_with_path(wgrads)[0]]
    assert len(gl) == len(wl)
    for (path, g), w in zip(gl, wl):
        assert tuple(g.shape) == tuple(np.shape(w)), path
        assert torch.isfinite(g).all(), path

    def nudged_runs():
        return [jax.tree.leaves(ref_fn(_nudged(rp, seed), rbatch)[1])
                for seed in (1, 2)]

    fell_back = _match([g.numpy() for _, g in gl], wl, nudged_runs)
    assert tcfg.ssm is not None or not fell_back, fell_back


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_dots_equals_none_bitwise(arch):
    """The loss and every gradient under ``"dots"`` are those without
    remat, bitwise (the kept products are the forward's own tensors; the
    rest reruns the same kernels on the same inputs)."""
    r = runs(arch)
    assert torch.equal(r["dots"][0][0], r["none"][0][0])
    assert _bitwise(r["dots"][0][1], r["none"][0][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_dispatches_per_grad(arch):
    """One grad pass's kernel calls: under ``"dots"`` the matmul kernels'
    forward-role calls equal ``"none"``'s (no product is recomputed; an
    encoder-decoder config's encoder, which ``"dots"`` runs as
    ``"block"``, runs its products again), its ``pre``, ``dx`` and ``dw``
    calls equal ``"none"``'s, and the flash calls equal ``"block"``'s
    (attention is recomputed)."""
    r = runs(arch)
    _, tcfg, _, tp, batch, _ = setup(arch)
    calls = {remat: r[remat][1] for remat in REMATS}
    fwd = {remat: _calls(c, role="forward") - _calls(c, "flash_attention")
           for remat, c in calls.items()}
    enc = 0
    if tcfg.enc_dec:            # the encoder's blocks, recomputed as "block"
        with torch.no_grad(), KERNELS.activate(), \
                roofline.MetaCount() as count:
            T.encode(tcfg, tp, batch["audio_embeds"])
        enc = _calls(count.calls, role="forward") - \
            _calls(count.calls, "flash_attention")
        assert enc > 0
    assert fwd["dots"] == fwd["none"] + enc < fwd["block"]
    for role in ("pre", "dx", "dw"):
        assert _calls(calls["dots"], role=role) == \
            _calls(calls["none"], role=role), role
    assert _calls(calls["dots"], "flash_attention") == \
        _calls(calls["block"], "flash_attention")
    if _calls(calls["none"], "flash_attention"):     # mamba2 has none
        assert _calls(calls["block"], "flash_attention") > \
            _calls(calls["none"], "flash_attention")


def test_dots_hands_back_the_forwards_own_products(monkeypatch):
    """In the backward's recompute every forward matmul of a stacked
    period returns the very tensor the forward produced: the same storage,
    period by period in the backward's order."""
    _, tcfg, _, tp, batch, _ = setup("olmo-1b")
    real = eng_mod._kernel_matmul
    seen: list = []

    def logged(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append((kwargs.get("role", "forward"), kwargs.get("name"),
                     out.untyped_storage().data_ptr()))
        return out

    monkeypatch.setattr(eng_mod, "_kernel_matmul", logged)
    TS.make_grad_fn(tcfg, tbase.TrainConfig(remat="dots"),
                    engine=KERNELS)(tp, batch)
    fwd = [s for s in seen if s[0] == "forward"]
    per = 7                                  # q, k, v, o, gate, up, down
    n = per * tcfg.n_layers
    periods = [fwd[i:i + per] for i in range(0, n, per)]
    assert [name for _, name, _ in fwd[n:n + 1]] == ["lm_head"]
    # the backward recomputes the last period first
    assert fwd[n + 1:] == [c for p in reversed(periods) for c in p]
    assert len({ptr for *_, ptr in fwd[:n]}) == n


@pytest.mark.parametrize("donate,microbatch", [(False, 0), (True, 1)],
                         ids=["functional", "donated_micro"])
@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x7b", "zamba2-2.7b"])
def test_dots_train_step_equals_none_bitwise(arch, donate, microbatch):
    """Two steps of ``make_train_step`` (functional, or donated with
    microbatches of one sequence) under ``"dots"`` give the losses and the
    state of ``"none"``, bitwise."""
    _, tcfg, _, tp, batch, _ = setup(arch)
    out = {}
    for remat in ("none", "dots"):
        tc = tbase.TrainConfig(global_batch=B, seq_len=S, total_steps=2,
                               warmup_steps=1, lr=1e-2, remat=remat,
                               microbatch=microbatch)
        params = tree.map_leaves(torch.clone, tp)
        opt = adamw.init(T.trainable(params), tc)
        cs = grad_compress.init(T.trainable(params))
        step = TS.make_train_step(tcfg, tc, engine=KERNELS, donate=donate)
        losses = []
        for _ in range(2):
            params, opt, cs, m = step(params, opt, cs, batch)
            losses.append(float(m["loss"]))
        out[remat] = losses, (params, opt)
    assert out["dots"][0] == out["none"][0]
    assert _bitwise(out["dots"][1], out["none"][1])


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llava-next-34b",
                                  "mamba2-130m"])
def test_dots_trainer_run_equals_none(arch):
    """``trainer.run`` under ``"dots"`` takes the losses of ``"none"``,
    bitwise, on its own ``SyntheticLM`` batches."""
    _, tcfg, *_ = setup(arch)
    losses = {}
    for remat in ("none", "dots"):
        tc = tbase.TrainConfig(global_batch=B, seq_len=16, total_steps=2,
                               warmup_steps=1, remat=remat)
        run = trainer.run(tcfg, tc, data=tdata.SyntheticLM(tdata.DataConfig(
            tcfg.vocab_size, 16, B, seed=1), tcfg), device="cpu",
            log=lambda s: None)
        losses[remat] = run.losses
    assert len(losses["dots"]) == 2 and losses["dots"] == losses["none"]


@pytest.mark.parametrize("remat", ["full", "selective"])
def test_other_remat_policies_are_refused(remat):
    """The port takes ``none``, ``block`` and ``dots``; anything else,
    ``"full"`` included (which the reference runs as ``"none"``: no branch
    of its stack takes it), is a ``ValueError`` naming the three."""
    _, tcfg, _, tp, batch, _ = setup("olmo-1b")
    with pytest.raises(ValueError, match="none.*block.*dots"):
        TS.make_grad_fn(tcfg, tbase.TrainConfig(remat=remat),
                        engine=KERNELS)(tp, batch)

