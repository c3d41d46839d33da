"""Elementary model layers (norms, RoPE, embeddings, inits) of the port.

All dense projections go through the active
:class:`repro_torch.core.engine.Engine` (``engine.current().matmul``), so
the SA-CONV/SA-FC dispatch and any compiled
:class:`~repro_torch.core.schedule.LayerSchedule` see every matmul.  The
functions are the JAX package's (``repro.models.layers``), on tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def truncated_normal(shape: tuple[int, ...], std: float, gen: torch.Generator,
                     dtype, device) -> torch.Tensor:
    """N(0, 1) truncated to [-3, 3], times ``std``, drawn on ``device`` from
    ``gen`` (a generator of that device)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, a=-3.0, b=3.0, generator=gen)
    return t.mul_(std).to(dtype)


def dense_init(gen: torch.Generator, fan_in: int, fan_out: int, dtype,
               device, lead: tuple[int, ...] = ()) -> torch.Tensor:
    """(``*lead``, fan_in, fan_out) weights, truncated normal / sqrt(fan_in);
    ``lead`` stacks independent layers."""
    return truncated_normal((*lead, fan_in, fan_out), fan_in ** -0.5, gen,
                            dtype, device)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    # d^-0.5 keeps tied-head logits O(1)
    return truncated_normal((vocab, d), d ** -0.5, gen, dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor | None,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    nrm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if w is not None:
        nrm = nrm * (1.0 + w.to(torch.float32))
    return nrm.to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor | None,
              b: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """Statistics in fp32, the biased variance."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        out = out * w.to(torch.float32)
    if b is not None:
        out = out + b.to(torch.float32)
    return out.to(x.dtype)


def norm(cfg, p: dict | None, x: torch.Tensor) -> torch.Tensor:
    """cfg.norm selects rmsnorm / layernorm / olmo's non-parametric LN."""
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["w"] if p else None)
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"] if p else None, p["b"] if p else None)
    if cfg.norm == "nonparam_ln":      # olmo: LN without learnable params
        return layernorm(x, None, None)
    raise ValueError(cfg.norm)


def norm_params(cfg, d: int, device, lead: tuple[int, ...] = ()) -> dict:
    if cfg.norm == "rmsnorm":
        return {"w": torch.zeros((*lead, d), device=device)}
    if cfg.norm == "layernorm":
        return {"w": torch.ones((*lead, d), device=device),
                "b": torch.zeros((*lead, d), device=device)}
    return {}                           # nonparam_ln


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (b, s, h, d) with even d; positions: (b, s) or (s,).  Angles in
    fp32; the two halves of d rotate as pairs."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs     # (b, s, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------
def embed(params: dict, tokens: torch.Tensor, *, scale: bool, d: int,
          dtype) -> torch.Tensor:
    x = params["embed"][tokens].to(dtype)
    if scale:                           # gemma family scales by sqrt(d)
        x = x * torch.tensor(d ** 0.5, dtype=dtype)
    return x


def head_weight(cfg, params: dict) -> torch.Tensor:
    """The (d, V) output projection.  Tied models keep ``embed_t``, a
    contiguous copy of ``embed.T`` made once with the parameters: the GEMM
    kernels take row-major (k, n) weights, and a strided read of the
    transposed view would scatter SA-FC's weight stream.  A tree without
    ``embed_t`` (the trained leaves, as the loss sees them) computes the
    head from ``embed`` itself, so its gradient flows into ``embed``."""
    if not cfg.tie_embeddings:
        return params["head"]
    if "embed_t" in params:
        return params["embed_t"]
    return params["embed"].t().contiguous()


def unembed(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    logits = engine.current().matmul(x, head_weight(cfg, params),
                                     name="lm_head", out_dtype=torch.float32)
    if cfg.logit_softcap > 0.0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
