"""Training step factory: remat, microbatch gradient accumulation,
gradient compression, AdamW — the JAX package's
``repro.train.train_step`` on the port.

The step runs under an explicit :class:`repro_torch.core.engine.Engine`
carrying the compiled, memoized train-phase
:class:`repro_torch.core.schedule.LayerSchedule` at the per-pass shape, so
every named matmul of the loss resolves its array by lookup.  On the
``"kernels"`` backend (the default) the forward and backward matmuls run
on SA-FC and the SA-CONV GEMM, attention's forward on the flash kernel.

Microbatches run as a Python loop (the reference's ``lax.scan``), their
gradients summed in fp32 and averaged: the same gradient as the full
batch, not an approximation.  The schedule is compiled on the tokens
alone, as the reference compiles it: a vision config's matmuls, which
also run over the vision prefix, miss it and are planned on the fly.  An
encoder-decoder config has no train schedule (neither package can compile
one without the audio frames): its steps run on the engine with no
schedule attached, every matmul planned on the fly.  A
tied model trains ``embed`` alone; its serving copy ``embed_t`` is
derived again after every update
(:func:`repro_torch.models.transformer.with_head_copy`).
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import tree
from repro_torch.core.engine import Engine
from repro_torch.core.schedule import LayerSchedule
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, grad_compress


def _split_microbatches(batch: dict, nm: int) -> list[dict]:
    b = batch["tokens"].shape[0]
    if b % nm:
        raise ValueError(f"batch {b} does not split into {nm} microbatches")
    return [{k: v[i * (b // nm):(i + 1) * (b // nm)]
             for k, v in batch.items()} for i in range(nm)]


def make_loss(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    def loss(params, batch):
        return T.loss_fn(cfg, params, batch, remat=tc.remat)
    return loss


def value_and_grad(loss: Callable, params, batch) -> tuple:
    """(loss, grads) of ``loss(params, batch)``: grads a tree like
    ``params``, the loss detached."""
    live = [p.detach().requires_grad_() for p in tree.leaves(params)]
    with torch.enable_grad():
        value, _ = loss(tree.unflatten(params, live), batch)
        grads = torch.autograd.grad(value, live, allow_unused=True,
                                    materialize_grads=True)
    return value.detach(), tree.unflatten(params, list(grads))


def _on_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_grad_fn(cfg: ModelConfig, tc: TrainConfig, *,
                 engine: Engine | None = None) -> Callable:
    """``grads_of(params, batch) -> (loss, grads)`` of the trained leaves,
    under the memoized train schedule at the per-pass shape (the
    microbatch when accumulating, the batch otherwise); an
    encoder-decoder config runs with no schedule."""
    loss = make_loss(cfg, tc)
    eng = engine if engine is not None else Engine(backend="kernels")

    def grads_of(params, batch):
        tp = T.trainable(params)
        batch = _on_device(batch, tree.leaves(tp)[0].device)
        b, s = batch["tokens"].shape
        micro = bool(tc.microbatch) and tc.microbatch < b
        sched = None if cfg.enc_dec else LayerSchedule.compile(
            cfg, "train", batch=tc.microbatch if micro else b, seq=s,
            policy=eng.policy, params=tp)
        with eng.with_schedule(sched).activate():
            if not micro:
                return value_and_grad(loss, tp, batch)
            nm = b // tc.microbatch
            g_acc = tree.map_leaves(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), tp)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for part in _split_microbatches(batch, nm):
                value, g = value_and_grad(loss, tp, part)
                g_acc = tree.map_leaves(
                    lambda a, gg: a + gg.to(torch.float32), g_acc, g)
                lsum = lsum + value
            inv = 1.0 / nm
            return lsum * inv, tree.map_leaves(lambda a: a * inv, g_acc)

    return grads_of


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *,
                    engine: Engine | None = None,
                    donate: bool = False) -> Callable:
    """``train_step(params, opt_state, cstate, batch) -> (params, opt_state,
    cstate, metrics)``; ``batch`` may hold tensors or numpy arrays.
    ``donate`` hands the parameters and moments to the optimizer to
    update in place (:func:`repro_torch.optim.adamw.apply`): the same
    values, with one copy of the state on the device instead of two."""
    grads_of = make_grad_fn(cfg, tc, engine=engine)

    def train_step(params, opt_state, cstate, batch):
        value, grads = grads_of(params, batch)
        grads, cstate = grad_compress.compress_grads(grads, cstate,
                                                     tc.grad_compress)
        tp, opt_state, om = adamw.apply(T.trainable(params), grads,
                                        opt_state, tc, donate=donate)
        return (T.with_head_copy(cfg, tp), opt_state, cstate,
                {"loss": value, **om})

    return train_step


def init_train_state(cfg: ModelConfig, tc: TrainConfig, seed: int, *,
                     device=None) -> tuple:
    """(params, AdamW state, compression state) from a seed, on ``device``
    (the card unless the caller names another).  The optimizer and
    compression states cover the trained leaves only."""
    params = T.init_params(cfg, seed, device=device)
    tp = T.trainable(params)
    opt_state = adamw.init(tp, tc)
    cstate = (grad_compress.init(tp) if tc.grad_compress != "none"
              else grad_compress.CompressState(error=tree.map_leaves(
                  lambda p: torch.zeros((), dtype=torch.float32,
                                        device=p.device), tp)))
    return params, opt_state, cstate
