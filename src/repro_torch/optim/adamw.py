"""AdamW with a chosen moment dtype, cosine schedule and global-norm clip —
the JAX package's ``repro.optim.adamw`` on the port's parameter trees
(nested dicts and lists of tensors, :mod:`repro_torch.core.tree`).

Every update runs in fp32 and is rounded once to the leaf's dtype; the
moments are kept in ``TrainConfig.moment_dtype``.  The update runs in
place: on the caller's tensors where it donates them (``donate=True``,
JAX's ``donate_argnums``), so a step holds one leaf's temporaries instead
of a second copy of the whole state; otherwise on copies, and the
functions return new tensors, as the reference does."""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import tree


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar: updates applied so far
    m: Any
    v: Any


def init(params, tc: TrainConfig) -> AdamWState:
    mdt = getattr(torch, tc.moment_dtype)
    first = tree.leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=tree.map_leaves(zeros, params),
                      v=tree.map_leaves(zeros, params))


def lr_schedule(tc: TrainConfig, step) -> torch.Tensor:
    """Linear warm-up to ``tc.lr``, then a cosine decay to a tenth of it;
    fp32, on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, tc.warmup_steps), max=1.0)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(1, tc.total_steps - tc.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tc.lr * warm * (0.1 + 0.9 * cos)


def clip_by_global_norm(grads, max_norm: float, *, donate: bool = False):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before scaling), the norm in fp32; ``donate`` scales ``grads`` in
    place, else a copy of them."""
    if not donate:
        grads = tree.map_leaves(torch.clone, grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in tree.leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in tree.leaves(grads):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.to(torch.float32) * scale)
    return grads, gn


@torch.no_grad()
def apply(params, grads, state: AdamWState, tc: TrainConfig, *,
          donate: bool = False) -> tuple[Any, AdamWState, dict]:
    """One AdamW update: (new params, new state, {"lr", "grad_norm"}).
    ``donate`` updates ``params``, ``state``'s moments and ``grads`` in
    place and returns those trees; otherwise copies of them."""
    if not donate:
        params, grads, state = tree.map_leaves(torch.clone,
                                               (params, grads, state))
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip, donate=True)
    step = state.step + 1
    lr = lr_schedule(tc, state.step)
    b1, b2, eps = tc.beta1, tc.beta2, tc.eps
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        """``p``, ``m`` and ``v`` updated in their own storage (through an
        fp32 copy where they are narrower, rounded once), temporaries
        reused in place."""
        gf = g.to(torch.float32)
        mf = m.to(torch.float32)
        mf.mul_(b1).add_((1 - b1) * gf)
        vf = v.to(torch.float32)
        vf.mul_(b2).add_((1 - b2) * gf * gf)
        step_ = mf / bc1
        den = (vf / bc2).sqrt_().add_(eps)
        step_.div_(den)
        del den
        pf = p.to(torch.float32)
        step_.add_(tc.weight_decay * pf).mul_(lr)
        pf.sub_(step_)
        for t, tf in ((p, pf), (m, mf), (v, vf)):
            if tf is not t:
                t.copy_(tf)

    for leaf in zip(tree.leaves(params), tree.leaves(grads),
                    tree.leaves(state.m), tree.leaves(state.v)):
        upd(*leaf)
    return (params, AdamWState(step, state.m, state.v),
            {"lr": lr, "grad_norm": gnorm})
