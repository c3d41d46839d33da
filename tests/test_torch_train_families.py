"""Training the decoder-only families on the port, on the CPU against the
JAX package: reduced mixtral-8x7b, llama4-maverick (without and with its
shared expert every other layer), mamba2-130m and zamba2-2.7b (two
periods of five Mamba blocks and the shared attention block, and a Mamba
tail) through ``loss_fn`` and its gradients, the train schedule, remat,
checkpoints and the trainer; and the SSD backward's overflow, which the
port repairs and the reference keeps.

Parameters are made by the reference (``jax.random``) and carried across
as numpy, in fp32 at ``tests/test_archs.py``'s capacity factor of 4.0.
The port runs on its ``"kernels"`` backend (on the CPU its wrappers take
their plain versions), the reference on XLA, which is how it trains.
Tolerances are ``tests/test_torch_train.py``'s: 1e-5 on a loss, 3e-4 on a
gradient, 1e-4 on five steps' losses.  Reduced zamba2 is ill-conditioned
(``tests/test_torch_moe_ssm_stacks.py::_match``): 29 of its 67 gradient
leaves hold 3e-4 only at rows where the reference's own gradient moves by
less than that under a one-ulp nudge of its embedding, and elsewhere lie
within 4x that move; every other stack's gradients hold 3e-4 outright.
The five-step losses are in ``tests/test_torch_train_families_steps.py``.
"""
from __future__ import annotations

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.core import schedule as rsched
from repro.models import ssm as rssm
from repro.models import transformer as RT
from repro_torch.analysis import launch as tlaunch
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import engine as eng_mod
from repro_torch.core import schedule as tsched
from repro_torch.core import tree
from repro_torch.core.engine import Engine
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import ref
from repro_torch.launch import train as tlaunch_train
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS
from repro_torch.train import trainer

TOL = dict(rtol=3e-4, atol=3e-4)
KERNELS = Engine(backend="kernels")
#: fp32 exp overflows above this
EXP_MAX = float(np.log(np.finfo(np.float32).max))

_ARCHS = {"mixtral": ("mixtral-8x7b", {}),
          "llama4": ("llama4-maverick-400b-a17b", {}),
          "llama4-shared": ("llama4-maverick-400b-a17b", {"shared": True}),
          "mamba2": ("mamba2-130m", {}),
          "zamba2": ("zamba2-2.7b", {"n_layers": 14})}
CONFIGS = tuple(_ARCHS)
_PARAMS: dict = {}


def configs(name: str):
    """(reference config, port config): ``reduced()`` in fp32 at capacity
    factor 4.0; llama4 also with its shared expert every other layer
    (which ``reduced`` drops); zamba2 two periods deep with a two-block
    Mamba tail."""
    arch, extra = _ARCHS[name]
    out = []
    for base, reg in ((rbase, rreg), (tbase, treg)):
        kw = dict(param_dtype="float32", compute_dtype="float32")
        if "n_layers" in extra:
            kw["n_layers"] = extra["n_layers"]
        cfg = base.reduced(reg.get_config(arch), **kw)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=4.0,
                **({"shared_expert": True, "moe_every": 2}
                   if extra.get("shared") else {})))
        out.append(cfg)
    return tuple(out)


def setup(name: str):
    """(ref cfg, port cfg, ref params, port params), made once."""
    if name not in _PARAMS:
        rcfg, tcfg = configs(name)
        rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
        _PARAMS[name] = (rcfg, tcfg, rp,
                         lm_params_from_reference(rp, device="cpu"))
    return _PARAMS[name]


def _tokens(cfg, shape=(2, 32), seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


#: at an ill-conditioned row, how far the port's gradient may lie from the
#: reference's, in multiples of the reference's own move there when its
#: embedding moves by an ulp (``tests/test_torch_moe_ssm_stacks.py``)
SPREAD = 4.0


def _nudged(params: dict, seed: int) -> dict:
    """``params`` with every entry of ``embed`` moved by at most one fp32
    ulp (times 1 +- 2^-23, rounded), each direction drawn from ``seed``."""
    e = np.asarray(params["embed"], dtype=np.float64)
    sign = np.random.default_rng(seed).choice([-1.0, 1.0], e.shape)
    return {**params, "embed": jnp.asarray(
        (e * (1 + sign * 2.0 ** -23)).astype(np.float32))}


def _rows(a) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64)
    return a.reshape(-1, max(a.shape[-1:], default=1))


def _match(got: list, want: list, nudged_runs) -> list[int]:
    """``tests/test_torch_moe_ssm_stacks.py::_match``'s rule on gradient
    leaves: each leaf within TOL of the reference's, row by row (rows
    along the last axis).  A row may miss TOL only where the reference's
    own row moves by more than TOL's atol when its embedding moves by an
    ulp (the largest move over ``nudged_runs()``), and then each element
    lies within SPREAD times that move.  Returns the indices of the leaves
    with a row that needed the fallback."""
    got, want = [_rows(g) for g in got], [_rows(w) for w in want]
    within = [np.abs(g - w) <= TOL["atol"] + TOL["rtol"] * np.abs(w)
              for g, w in zip(got, want)]
    if all(ok.all() for ok in within):
        return []
    runs = [[_rows(a) for a in run] for run in nudged_runs()]
    fell_back = []
    for i, (g, w, ok) in enumerate(zip(got, want, within)):
        if ok.all():
            continue
        move = np.max([np.abs(run[i] - w).max(-1) for run in runs], axis=0)
        for r in np.flatnonzero(~ok.all(-1)):
            diff = np.abs(g[r] - w[r]).max()
            assert move[r] > TOL["atol"], (
                f"leaf {i} row {r}: max|d| {diff:.3g} outside {TOL} at a "
                f"well-conditioned row (the reference moves {move[r]:.3g})")
            assert (ok[r] | (np.abs(g[r] - w[r]) <= SPREAD * move[r])).all(), (
                f"leaf {i} row {r}: max|d| {diff:.3g} > {SPREAD} x the "
                f"reference's own move {move[r]:.3g}")
        fell_back.append(i)
    return fell_back


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_every_gradient_match_reference(name,
                                                record_testsuite_property):
    """``loss_fn`` (ce + 0.01 aux) and the gradient of every leaf, from the
    same parameters and tokens, against ``jax.value_and_grad`` of the
    reference's ``loss_fn``: the MoE router through the stable sort's
    gather and ``aux``'s ``mean(gates)``, Mamba's ``a_log``, ``dt_bias``,
    conv and gated norm, zamba2's shared block summed over its
    applications.  A gradient row may miss 3e-4 only in an SSM stack and
    only where the reference is ill-conditioned (:func:`_match`); the
    leaves that needed it are recorded in the JUnit report."""
    rcfg, tcfg, rp, tp = setup(name)
    toks = _tokens(rcfg)
    ref_fn = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(rcfg, p, b), has_aux=True))
    (want, wparts), wgrads = ref_fn(rp, {"tokens": jnp.asarray(toks)})
    got, parts = T.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert abs(float(got) - float(want)) <= 1e-5
    assert abs(float(parts["ce"]) - float(wparts["ce"])) <= 1e-5
    assert abs(float(parts["aux"]) - float(wparts["aux"])) <= 1e-5
    assert (float(parts["aux"]) > 0) == (tcfg.moe is not None)
    _, grads = TS.make_grad_fn(tcfg, tbase.TrainConfig(remat="none"),
                               engine=KERNELS)(tp, {"tokens":
                                                    torch.from_numpy(toks)})
    gl = list(tree.flatten_with_paths(grads))
    wl = [w for _, w in jax.tree_util.tree_flatten_with_path(wgrads)[0]]
    assert len(gl) == len(wl)
    for (path, g), w in zip(gl, wl):
        assert tuple(g.shape) == tuple(np.shape(w)), path
        assert torch.isfinite(g).all(), path

    def nudged_runs():
        return [jax.tree.leaves(ref_fn(_nudged(rp, seed),
                                       {"tokens": jnp.asarray(toks)})[1])
                for seed in (1, 2)]

    fell_back = _match([g.numpy() for _, g in gl], wl, nudged_runs)
    record_testsuite_property(f"{name}.gradient_rows_fallback",
                              [gl[i][0] for i in fell_back])
    assert tcfg.ssm is not None or not fell_back, fell_back
    names = {p for p, _ in gl}
    if tcfg.moe is not None:
        assert any(p.endswith("moe.router") for p in names)
    if tcfg.ssm is not None:
        assert {"blocks.0.mamba.a_log", "blocks.0.mamba.dt_bias",
                "blocks.0.mamba.conv_w", "blocks.0.mamba.norm_w"} <= names
        assert float(grads["blocks"][0]["mamba"]["a_log"].abs().sum()) > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_train_schedule_equals_reference(name):
    """The train schedule at the full batch and at a microbatch equals the
    reference's field for field (the router's rows in fp32, the expert
    products recorded but not scheduled)."""
    rcfg, tcfg, _, _ = setup(name)
    for batch in (8, 2):
        r = rsched.LayerSchedule.compile(rcfg, "train", batch=batch, seq=32)
        t = tsched.LayerSchedule.compile(tcfg, "train", batch=batch, seq=32)
        assert t.phase == "train" and len(t) == len(r) > 0
        assert {(dataclasses.astuple(k), dataclasses.astuple(v))
                for k, v in t.items()} == \
            {(dataclasses.astuple(k), dataclasses.astuple(v))
             for k, v in r.items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_remat_block_equals_none_bitwise(name):
    """Recomputing each period in the backward pass (the router picking
    the same experts again, the SSD and the shared block rerun) gives the
    loss and every gradient of the run without remat, bitwise; the
    periods' matmuls run again in the recompute."""
    _, tcfg, _, tp = setup(name)
    batch = {"tokens": torch.from_numpy(_tokens(tcfg))}
    counts = {}
    grads = {}
    for remat in ("none", "block"):
        ref.reset_counts()
        grads[remat] = TS.make_grad_fn(
            tcfg, tbase.TrainConfig(remat=remat), engine=KERNELS)(tp, batch)
        counts[remat] = ref.counts()["matmul_bias_act"]
    assert torch.equal(grads["none"][0], grads["block"][0])
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(grads["none"][1]), tree.leaves(grads["block"][1])))
    assert counts["block"] > counts["none"]
    if "shared" in grads["block"][1]:              # zamba2's shared block
        assert float(grads["block"][1]["shared"]["attn"]["wq"].abs().sum()) > 0


@pytest.mark.parametrize("name", ["mixtral", "mamba2", "zamba2"])
def test_train_step_launches_what_the_launch_pass_checks(name, monkeypatch):
    """Every kernel call of a train step (forward, recompute, ``pre``,
    ``dx``, ``dw``) has a shape that the launch pass builds from the train
    schedule (``analysis/launch.py``: ``schedule_launches`` and
    ``backward_launches``), so the pass covers the backward's launches."""
    _, tcfg, _, tp = setup(name)
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
    tc = tbase.TrainConfig(remat="block")
    TS.make_grad_fn(tcfg, tc, engine=KERNELS)(
        tp, {"tokens": torch.from_numpy(_tokens(tcfg))})
    sched = tsched.LayerSchedule.compile(tcfg, "train", batch=2, seq=32)
    checked = {(lau.kernel, lau.shape[:3])
               for lau in tlaunch.schedule_launches(sched) + [
                   lau for key, plan in sched.items()
                   for lau in tlaunch.backward_launches(key, plan)]}
    assert seen == checked
    report = tlaunch.verify_launches(tlaunch.schedule_launches(sched) + [
        lau for key, plan in sched.items()
        for lau in tlaunch.backward_launches(key, plan)])
    assert report.ok, report.summary()


# ---------------------------------------------------------------------------
# a donated step: the state updated in place
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_donated_adamw_apply_is_bitwise_the_functional_one(param_dtype,
                                                           moment_dtype):
    """``adamw.apply(donate=True)`` writes, into the tensors it was given,
    bitwise the parameters, moments and clipped gradients that the
    functional update returns (a clip that scales, and one that does
    not), over three steps."""
    tc = tbase.TrainConfig(lr=1e-2, warmup_steps=1, total_steps=6,
                           moment_dtype=moment_dtype)
    dt = getattr(torch, param_dtype)
    rng = np.random.default_rng(0)

    def tree_of(scale):
        return {"a": torch.from_numpy(rng.standard_normal((7, 5)).astype(
            np.float32) * scale).to(dt),
            "b": [torch.from_numpy(rng.standard_normal(9).astype(
                np.float32) * scale).to(dt)]}

    params = tree_of(1.0)
    state = adamw.init(params, tc)
    mine = tree.map_leaves(torch.clone, params)
    mstate = adamw.AdamWState(state.step.clone(),
                              tree.map_leaves(torch.clone, state.m),
                              tree.map_leaves(torch.clone, state.v))
    for scale in (10.0, 1e-3, 1.0):                 # clipped, not, not
        grads = tree_of(scale)
        donated = tree.map_leaves(torch.clone, grads)
        params, state, want = adamw.apply(params, grads, state, tc)
        ids = [id(t) for t in tree.leaves((mine, mstate.m, mstate.v))]
        mine, mstate, got = adamw.apply(mine, donated, mstate, tc,
                                        donate=True)
        assert [id(t) for t in tree.leaves((mine, mstate.m, mstate.v))] \
            == ids
        assert torch.equal(got["grad_norm"], want["grad_norm"])
        for a, b in zip(tree.leaves((mine, mstate.m, mstate.v)),
                        tree.leaves((params, state.m, state.v))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        clipped, _ = adamw.clip_by_global_norm(grads, tc.grad_clip)
        assert all(torch.equal(a, b) for a, b in zip(
            tree.leaves(donated), tree.leaves(clipped)))


def test_donated_train_step_is_bitwise_the_functional_one():
    """Two steps of reduced mixtral with ``make_train_step(donate=True)``
    give the functional step's losses, parameters and moments bitwise."""
    _, tcfg, _, _ = setup("mixtral")
    tc = tbase.TrainConfig(global_batch=2, seq_len=16, total_steps=2,
                           lr=1e-2, warmup_steps=1, remat="block")
    data = tdata.SyntheticLM(tdata.DataConfig(tcfg.vocab_size, 16, 2))
    out = []
    for donate in (False, True):
        state = TS.init_train_state(tcfg, tc, 0, device="cpu")
        step = TS.make_train_step(tcfg, tc, engine=KERNELS, donate=donate)
        losses = []
        for s in range(2):
            *state, m = step(*state, data.batch_at(s))
            losses.append(float(m["loss"]))
        out.append((losses, state))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(out[0][1][:2]), tree.leaves(out[1][1][:2])))


# ---------------------------------------------------------------------------
# checkpoints, the trainer, the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIGS)
def test_checkpoint_roundtrip_of_the_train_state(name, tmp_path):
    """A train state after one step (MoE expert stacks and router, Mamba's
    ``a_log``, ``dt_bias``, conv and norm, zamba2's shared block, and
    their AdamW moments) comes back bitwise from an async checkpoint."""
    _, tcfg, _, _ = setup(name)
    tc = tbase.TrainConfig(global_batch=2, seq_len=16, total_steps=2,
                           lr=1e-2, warmup_steps=1, remat="block")
    params, opt, cs = TS.init_train_state(tcfg, tc, 0, device="cpu")
    params, opt, cs, _ = TS.make_train_step(tcfg, tc, engine=KERNELS)(
        params, opt, cs, tdata.SyntheticLM(tdata.DataConfig(
            tcfg.vocab_size, 16, 2)).batch_at(0))
    state = (T.trainable(params), opt, cs)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state, async_save=True)
    ck.wait()
    out, step, _ = ck.restore(tree.map_leaves(torch.zeros_like, state))
    assert step == 1
    paths = [p for p, _ in tree.flatten_with_paths(state[0])]
    for key in ({"moe.router", "moe.wg", "moe.wd"} if tcfg.moe else
                {"mamba.a_log", "mamba.dt_bias", "mamba.conv_w"}):
        assert any(p.endswith(key) for p in paths), key
    for x, y in zip(tree.leaves(out), tree.leaves(state)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    key = "moe.wg" if tcfg.moe else "mamba.a_log"
    assert all(float(m.abs().sum()) > 0 for p, m in
               tree.flatten_with_paths(opt.m) if p.endswith(key))


@pytest.mark.parametrize("name", ["mixtral", "zamba2"])
def test_trainer_resume_equals_uninterrupted_bitwise(name, tmp_path):
    _, tcfg, _, _ = setup(name)
    tc = tbase.TrainConfig(global_batch=2, seq_len=16, total_steps=4,
                           lr=3e-3, warmup_steps=1)
    quiet = dict(device="cpu", log=lambda s: None, ckpt_every=2)
    whole = trainer.run(tcfg, tc, ckpt_dir=str(tmp_path / "a"), **quiet)
    shutil.copytree(tmp_path / "a" / "step_00000002",
                    tmp_path / "b" / "step_00000002")
    resumed = trainer.run(tcfg, tc, ckpt_dir=str(tmp_path / "b"), **quiet)
    assert resumed.resumed_from == 2 and resumed.steps_run == 2
    assert resumed.losses == whole.losses[2:]
    assert all(np.isfinite(whole.losses))


class _WriteAtJoin:
    """A thread that runs its target only when it is joined: an async
    save's write then reads its leaves after the steps that follow it."""

    def __init__(self, target, daemon=None):
        self._target = target

    def start(self):
        pass

    def join(self):
        self._target()


@pytest.mark.parametrize("name", ["mixtral", "mamba2"])
def test_donated_trainer_checkpoint_restores_bitwise(name, tmp_path,
                                                      monkeypatch):
    """``trainer.run`` with a donated step (the state updated in place on
    the host) and an async checkpoint every 2 steps: the step-2
    checkpoint, written only after steps 3 and 4 have updated the state,
    restores bitwise the state of step 2."""
    from types import SimpleNamespace
    from repro_torch.checkpoint import checkpoint as ckpt_mod
    monkeypatch.setattr(ckpt_mod, "threading",
                        SimpleNamespace(Thread=_WriteAtJoin))
    _, tcfg, _, _ = setup(name)
    tc = tbase.TrainConfig(global_batch=2, seq_len=16, total_steps=4,
                           lr=1e-2, warmup_steps=1, remat="block")
    step_fn = TS.make_train_step(tcfg, tc, engine=KERNELS, donate=True)
    saved = []

    def stepping(params, opt, cs, batch):
        out = step_fn(params, opt, cs, batch)
        if len(saved) == 0 and int(out[1].step) == 2:
            saved.append(tree.map_leaves(
                torch.clone, (T.trainable(out[0]), out[1], out[2])))
        return out

    trainer.run(tcfg, tc, ckpt_dir=str(tmp_path), ckpt_every=2,
                train_step_fn=stepping, data=tdata.SyntheticLM(
                    tdata.DataConfig(tcfg.vocab_size, 16, 2)),
                device="cpu", log=lambda s: None)
    out, step, _ = Checkpointer(str(tmp_path)).restore(
        tree.map_leaves(torch.zeros_like, saved[0]), step=2)
    assert step == 2
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
        tree.leaves(out), tree.leaves(saved[0])))


def test_train_launcher_runs_mamba2_on_the_cpu(capsys):
    tlaunch_train.main(["--arch", "mamba2-130m", "--device", "cpu",
                        "--reduced", "--steps", "3", "--batch", "2",
                        "--seq", "16"])
    out = capsys.readouterr().out
    assert "kernels backend" in out and "[train] loss" in out


# ---------------------------------------------------------------------------
# the SSD backward: the overflow the reference keeps and the port repairs
# ---------------------------------------------------------------------------
def _ssd_inputs(S=64, H=2, D=4, N=3, seed=0):
    """x, dt, a, b, c where ``dt * |a|`` is about 2 a step, so a 64-step
    chunk spans ~126 > 88.72 above its diagonal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, S, H, D)).astype(np.float32)
    dt = rng.uniform(0.9, 1.1, (1, S, H)).astype(np.float32)
    a = -rng.uniform(1.8, 2.2, (H,)).astype(np.float32)
    b, c = (rng.standard_normal((1, S, N)).astype(np.float32)
            for _ in range(2))
    return x, dt, a, b, c


def _literal_ssd_chunked(x, dt, a, b, c, *, chunk, init_state=None):
    """The port's ``ssd_chunked`` before the repair, kept to pin the
    forward: the reference's ``where(mask, exp(rel), 0)``, which takes
    ``exp`` of the entries above the diagonal too."""
    Bt, S, H, D = x.shape
    N = b.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, b, c = (F.pad(t, (0, 0, 0, pad)) for t in (dt, b, c))
    nc = (S + pad) // chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(Bt, nc, chunk, H, D)
    dtc = dt.to(f32).reshape(Bt, nc, chunk, H)
    bc = b.to(f32).reshape(Bt, nc, chunk, N)
    cc = c.to(f32).reshape(Bt, nc, chunk, N)
    dA = dtc * a.to(f32)[None, None, None, :]
    cum = torch.cumsum(dA, dim=2)
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    decay = torch.where(mask[None, None, :, :, None], torch.exp(rel),
                        torch.zeros((), dtype=f32))
    cb = torch.einsum("bztn,bzsn->bzts", cc, bc)
    dx = dtc[..., None] * xc
    y = torch.einsum("bzts,bztsh,bzshd->bzthd", cb, decay, dx)
    edge = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bzsh,bzshd,bzsn->bzhdn", edge, dx, bc)
    total = torch.exp(cum[:, :, -1, :])
    h = (torch.zeros((Bt, H, D, N), dtype=f32) if init_state is None
         else init_state.to(f32))
    entering = []
    for z in range(nc):
        entering.append(h)
        h = h * total[:, z, :, None, None] + states[:, z]
    h_prev = torch.stack(entering, 1)
    inflow = torch.exp(cum)
    y = y + torch.einsum("bztn,bzth,bzhdn->bzthd", cc, inflow, h_prev)
    return y.reshape(Bt, nc * chunk, H, D)[:, :S].to(x.dtype), h


def test_reference_ssd_backward_overflows_where_the_port_is_finite():
    """At a 64-step chunk with ``dt * |a|`` ~ 2, the reference's
    ``jax.grad`` through ``ssd_chunked`` is NaN (``0 * inf`` above the
    diagonal); the port's is finite and equals the reference's gradient
    at chunk 8, where nothing overflows (the SSD's value does not depend
    on the chunk), within 1e-4 relative L2."""
    x, dt, a, b, c = _ssd_inputs()
    cum = np.cumsum(dt * -a[None, None, :], axis=1)
    assert (cum[0, -1] - cum[0, 0]).max() > EXP_MAX     # the hazard is hit
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)

    def rgrads(chunk):
        return jax.jit(jax.grad(lambda *t: jnp.sum(rssm.ssd_chunked(
            *t, chunk=chunk) * cot), argnums=(0, 1, 2, 3, 4)))(
            *(jnp.asarray(t) for t in (x, dt, a, b, c)))

    assert not all(np.isfinite(np.asarray(g)).all() for g in rgrads(64))
    want = rgrads(8)
    assert all(np.isfinite(np.asarray(g)).all() for g in want)
    live = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a, b, c)]
    y = tssm.ssd_chunked(*live, chunk=64)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), live)
    for g, w, n in zip(got, want, "x dt a b c".split()):
        assert torch.isfinite(g).all(), n
        w = np.asarray(w)
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= 1e-4, (n, rel)


@pytest.mark.parametrize("chunk,S,scale", [(64, 64, 1.0), (64, 60, 1.0),
                                            (16, 60, 0.05), (8, 37, 0.05),
                                            (256, 300, 1.0)])
def test_ssd_forward_bitwise_the_literal_form(chunk, S, scale):
    """The repair moves no forward value: ``ssd_chunked``'s output and
    final state, from an initial state, equal the literal
    ``where(mask, exp(rel), 0)`` form's bitwise, on inputs whose chunks
    overflow above the diagonal and on ordinary ones, with sequences that
    are not a multiple of the chunk."""
    x, dt, a, b, c = (torch.from_numpy(t) for t in _ssd_inputs(S=S))
    dt = dt * scale
    h0 = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (1, 2, 4, 3)).astype(np.float32))
    got = tssm.ssd_chunked(x, dt, a, b, c, chunk=chunk, init_state=h0,
                           return_state=True)
    want = _literal_ssd_chunked(x, dt, a, b, c, chunk=chunk, init_state=h0)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, w)


def test_published_mamba_init_overflows_a_chunk_and_trains_finite():
    """mamba2-130m's own init (``a_log``, ``dt_bias`` at the published
    widths' head count) spans more than 88.72 in a 256-step chunk for
    some heads: a reduced stack at the published chunk, with those heads'
    parameters, gives a finite loss and finite gradients on the port."""
    cfg = tbase.reduced(treg.get_config("mamba2-130m"),
                        param_dtype="float32", compute_dtype="float32")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk=256))
    params = T.init_params(cfg, 0, device="cpu")
    full = treg.get_config("mamba2-130m")
    pub = tssm.init_mamba(full, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    span = (torch.nn.functional.softplus(pub["dt_bias"]) *
            torch.exp(pub["a_log"]) * 255)
    assert int((span > EXP_MAX).sum()) > 0
    nh = cfg.ssm.n_heads(cfg.d_model)
    worst = torch.argsort(span, descending=True)[:nh]
    m = params["blocks"][0]["mamba"]
    m["dt_bias"] = pub["dt_bias"][worst].expand_as(m["dt_bias"]).clone()
    m["a_log"] = pub["a_log"][worst].expand_as(m["a_log"]).clone()
    batch = {"tokens": torch.from_numpy(_tokens(cfg, (1, 256)))}
    loss, grads = TS.make_grad_fn(cfg, tbase.TrainConfig(), engine=KERNELS)(
        params, batch)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in tree.leaves(grads))
