"""Serving steps: prefill and decode, run eagerly — the JAX package's
``repro.serve.serve_step`` on tensors (no jit: each call dispatches its
kernels as it goes)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import Engine
from repro_torch.models import transformer as T
from repro_torch.serve import kvcache as KC


def prefill_step(cfg: ModelConfig, params: dict, batch: dict, max_seq: int,
                 cache_dtype=torch.bfloat16):
    """Returns (last-position logits (B, V), decode cache)."""
    logits, _, pcache = T.forward(cfg, params, batch, mode="prefill")
    cache = KC.cache_from_prefill(cfg, pcache, max_seq, dtype=cache_dtype)
    return logits[:, -1], cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int):
    """tokens (B, 1), pos the absolute position -> (logits (B, V), cache);
    the cache is updated in place."""
    logits, cache = T.decode_step(cfg, params, cache, tokens, pos)
    return logits[:, 0], cache


def greedy_generate(cfg: ModelConfig, params: dict, prompt: torch.Tensor,
                    n_steps: int, *, max_seq: int | None = None,
                    extra: dict | None = None,
                    cache_dtype=torch.float32,
                    engine: Engine | None = None) -> torch.Tensor:
    """Greedy sampling loop.  prompt: (B, S) -> (B, n_steps) tokens.

    ``extra`` holds the stubbed frontends' inputs: ``"audio_embeds"`` (B,
    frames, frontend_dim) for an enc-dec config, ``"vision_embeds"`` (B,
    vision_tokens, frontend_dim) for a vision config, whose positions come
    before the prompt's.  This is the port's entry point for those
    families (:class:`~repro_torch.serve.engine.ServeEngine` takes tokens
    only).  ``engine`` (optional) runs the loop under an explicit
    :class:`~repro_torch.core.engine.Engine`: its backend, policy, schedule
    and trace apply to every projection in prefill and decode."""
    B, S = prompt.shape
    vt = cfg.vision_tokens if (extra and "vision_embeds" in extra) else 0
    max_seq = max_seq or (S + vt + n_steps)
    batch = {"tokens": prompt, **(extra or {})}

    def generate():
        last_logits, cache = prefill_step(cfg, params, batch, max_seq,
                                          cache_dtype)
        tok = last_logits.argmax(-1)[:, None]
        toks = [tok]
        for i in range(n_steps - 1):
            logits, cache = decode_step(cfg, params, cache, tok, S + vt + i)
            tok = logits.argmax(-1)[:, None]
            toks.append(tok)
        return torch.cat(toks, dim=1)

    if engine is None:
        return generate()
    with engine.activate():
        return generate()
