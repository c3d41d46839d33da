"""AdamW with a chosen moment dtype, cosine schedule and global-norm clip —
the JAX package's ``repro.optim.adamw`` on the port's parameter trees
(nested dicts and lists of tensors, :mod:`repro_torch.core.tree`).

Every update runs in fp32 and is rounded once to the leaf's dtype; the
moments are kept in ``TrainConfig.moment_dtype``.  Functions return new
tensors, as the reference does."""
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


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before scaling), the norm in fp32."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in tree.leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree.map_leaves(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn


@torch.no_grad()
def apply(params, grads, state: AdamWState,
          tc: TrainConfig) -> tuple[Any, AdamWState, dict]:
    """One AdamW update: (new params, new state, {"lr", "grad_norm"})."""
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    step = state.step + 1
    lr = lr_schedule(tc, state.step)
    b1, b2, eps = tc.beta1, tc.beta2, tc.eps
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        mf = b1 * m.to(torch.float32) + (1 - b1) * gf
        vf = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        mhat = mf / bc1
        vhat = vf / bc2
        pf = p.to(torch.float32)
        pf = pf - lr * (mhat / (torch.sqrt(vhat) + eps)
                        + tc.weight_decay * pf)
        return pf.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    out = [upd(*leaf) for leaf in zip(tree.leaves(params),
                                      tree.leaves(grads),
                                      tree.leaves(state.m),
                                      tree.leaves(state.v))]
    new_p, new_m, new_v = ([o[i] for o in out] for i in range(3))
    return (tree.unflatten(params, new_p),
            AdamWState(step, tree.unflatten(state.m, new_m),
                       tree.unflatten(state.v, new_v)),
            {"lr": lr, "grad_norm": gnorm})
