"""Plain PyTorch decoder-only language model and its training step: the
reference the training cells are judged by.  It imports nothing of the
program and computes in float32 with TF32 off; a control computes every
matrix product in fp8 instead.

The model follows OLMo (arXiv:2402.00838) as a configuration file's
``model`` group states it: token embedding; per block a non-parametric
LayerNorm (eps 1e-5, biased variance), causal multi-head attention with
rotary positions (theta ``rope_theta``, the two halves of each head
rotated as pairs, scale hd^-0.5), a residual, a second LayerNorm, a SwiGLU
MLP (``silu(x wg) * (x wu)) wd``) and a residual; a final LayerNorm and the
tied head (``x @ embed.T``); next-token cross entropy, the mean over every
predicted position.  No biases, no dropout.  Departures from the published
model: none in the equations; the weights are the benchmark's random ones.

The step clips the gradient to a global L2 norm, then applies AdamW
(decoupled weight decay on every weight, bias-corrected moments) at the
configuration's rate: a linear warm-up to the peak, then a cosine to a
tenth of it.  A batch is computed one sequence at a time and the
gradients summed, so the step fits beside the state.

Weights: ``embed`` (V, d) and, stacked over the layers, ``wq``, ``wk``,
``wv`` (L, d, h hd), ``wo`` (L, h hd, d), ``wg``, ``wu`` (L, d, ff), ``wd``
(L, ff, d).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LEAVES = ("embed", "wq", "wk", "wv", "wo", "wg", "wu", "wd")


def plain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to the fp8 ``dtype`` under one scale for the tensor
    (its largest magnitude to the type's largest), back in fp32."""
    big = torch.finfo(dtype).max
    scale = t.abs().amax().clamp(min=1e-30) / big
    return (t / scale).to(dtype).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to e4m3 and, in the backward,
    the incoming gradient to e5m2, as fp8 training computes its products;
    sums in fp32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        return (torch.matmul(qg, qb.transpose(-1, -2)),
                torch.matmul(qa.transpose(-1, -2), qg))


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


def _ln(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (s, h, hd); position i rotates pair (j, j + hd/2) by i theta^(-j/(hd/2))."""
    s, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def sequence_loss(m: dict, w: dict, tokens: torch.Tensor, *, mm=plain_mm
                  ) -> torch.Tensor:
    """Mean next-token cross entropy of one sequence ``tokens`` (s,)."""
    s = tokens.shape[0]
    h = m["n_heads"]
    hd = m["d_model"] // h
    mask = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()
    x = w["embed"][tokens]
    for layer in range(m["n_layers"]):
        a = _ln(x)
        q = _rope(mm(a, w["wq"][layer]).reshape(s, h, hd), m["rope_theta"])
        k = _rope(mm(a, w["wk"][layer]).reshape(s, h, hd), m["rope_theta"])
        v = mm(a, w["wv"][layer]).reshape(s, h, hd)
        sc = mm(q.transpose(0, 1), k.permute(1, 2, 0)) * hd ** -0.5
        p = torch.softmax(sc.masked_fill(~mask, -math.inf), dim=-1)
        o = mm(p, v.transpose(0, 1)).transpose(0, 1).reshape(s, h * hd)
        x = x + mm(o, w["wo"][layer])
        a = _ln(x)
        x = x + mm(F.silu(mm(a, w["wg"][layer])) * mm(a, w["wu"][layer]),
                   w["wd"][layer])
    logits = mm(_ln(x), w["embed"].t())
    return F.cross_entropy(logits[:-1], tokens[1:])


def loss_and_grads(m: dict, w: dict, tokens: torch.Tensor, *, mm=plain_mm,
                   rows=None) -> tuple[float, dict]:
    """(loss, gradients) of a batch ``tokens`` (b, s): the mean over the
    batch's sequences (``rows`` of them when given), each computed alone
    and its gradient summed into the total."""
    rows = range(tokens.shape[0]) if rows is None else rows
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    live = {k: v.detach().requires_grad_() for k, v in w.items()}
    total = 0.0
    for r in rows:
        with torch.enable_grad():
            loss = sequence_loss(m, live, tokens[r], mm=mm) / len(rows)
            g = torch.autograd.grad(loss, [live[k] for k in LEAVES])
        for k, gk in zip(LEAVES, g):
            grads[k] += gk
        total += float(loss.detach())
    return total, grads


def lr_at(opt: dict, step: int) -> float:
    """The rate of update ``step`` (0-based)."""
    warm = min((step + 1) / max(1, opt["warmup_steps"]), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(1, opt["total_steps"] - opt["warmup_steps"]), 0.0),
               1.0)
    return opt["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def adamw_step(w: dict, grads: dict, state: dict, step: int,
               opt: dict) -> dict:
    """Clip ``grads`` to the global norm ``grad_clip`` (in place), then one
    AdamW update of ``w`` and the moments in ``state`` (in place).
    Returns the clipped gradients."""
    gn = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
    scale = min(1.0, opt["grad_clip"] / max(gn, 1e-9))
    lr, b1, b2 = lr_at(opt, step), opt["beta1"], opt["beta2"]
    bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    with torch.no_grad():
        for k in LEAVES:
            g = grads[k].mul_(scale)
            mk, vk = state["m"][k], state["v"][k]
            mk.mul_(b1).add_(g, alpha=1 - b1)
            vk.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (mk / bc1) / ((vk / bc2).sqrt_().add_(opt["eps"]))
            upd.add_(w[k], alpha=opt["weight_decay"])
            w[k].sub_(upd, alpha=lr)
    return grads


def train(m: dict, w: dict, batches: list, opt: dict, *, mm=plain_mm,
          rows=None, on_first_grads=None) -> list[float]:
    """``len(batches)`` steps from the weights ``w`` (fp32, updated in
    place).  ``on_first_grads(grads)`` sees the first step's clipped
    gradients.  Returns the loss of each step, before its update."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        state = {"m": {k: torch.zeros_like(v) for k, v in w.items()},
                 "v": {k: torch.zeros_like(v) for k, v in w.items()}}
        losses = []
        for step, tokens in enumerate(batches):
            loss, grads = loss_and_grads(m, w, tokens, mm=mm, rows=rows)
            grads = adamw_step(w, grads, state, step, opt)
            if step == 0 and on_first_grads is not None:
                on_first_grads(grads)
            del grads
            losses.append(loss)
        return losses
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
