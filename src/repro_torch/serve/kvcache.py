"""Decode-cache construction and the prefill -> decode hand-off — the JAX
package's ``repro.serve.kvcache`` on tensors.

Cache layout mirrors the stack: ``{'main': [per-pattern-position entry
stacked over reps], 'tail': [unstacked entries]}``.  Per position kind:

* global attention — ``{"attn": {"k", "v"}}``, full ``(B, max_seq, hkv,
  hd)`` K/V (zamba2's shared attention: one such entry per application);
* local attention  — a **ring** of ``min(window, max_seq)`` slots;
* mamba            — ``{"conv", "h"}``: the depthwise conv's ``(B, cw-1,
  ch)`` tail in the cache dtype and the ``(B, H, D, N)`` SSM state in fp32;
* enc-dec          — adds ``"xk"``/``"xv"``, the cross-attention K/V
  ``(B, enc_len, hkv, hd)`` projected from the encoder's output at
  prefill, which decode reads and never writes.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN_LOCAL, MAMBA, ModelConfig
from repro_torch.core import tree
from repro_torch.core.accelerator import resolve_device
from repro_torch.models.attention import init_kv_cache
from repro_torch.models.ssm import init_mamba_cache


def _window(cfg: ModelConfig, attn_kind: str) -> int:
    return cfg.sliding_window if attn_kind == ATTN_LOCAL else 0


def _position_proto(cfg: ModelConfig, attn_kind: str, batch: int,
                    max_seq: int, enc_len: int, dtype, device,
                    lead: tuple[int, ...] = ()) -> dict:
    if attn_kind == MAMBA:
        return init_mamba_cache(cfg, batch, dtype, device, lead)
    entry = {"attn": init_kv_cache(cfg, batch, max_seq,
                                   _window(cfg, attn_kind), dtype, device,
                                   lead)}
    if cfg.enc_dec:
        shape = (*lead, batch, enc_len, cfg.n_kv_heads, cfg.hd)
        entry["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        entry["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return entry


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               enc_len: int = 0, dtype=torch.bfloat16, device=None) -> dict:
    """An empty cache on ``device`` (the card unless the caller names
    another); an enc-dec config's cross entries hold ``enc_len`` frames."""
    device = resolve_device(device)
    kinds = cfg.block_kinds()
    reps, rem = cfg.stack_shape()
    main = [_position_proto(cfg, ak, batch, max_seq, enc_len, dtype, device,
                            (reps,))
            for ak, _ in kinds]
    tail = [_position_proto(cfg, kinds[i][0], batch, max_seq, enc_len,
                            dtype, device)
            for i in range(rem)]
    return {"main": main, "tail": tail}


def cache_bytes(cache) -> int:
    return sum(a.numel() * a.element_size() for a in tree.leaves(cache))


# ---------------------------------------------------------------------------
# prefill -> decode cache
# ---------------------------------------------------------------------------
def _ring_fill(kv: torch.Tensor, window: int) -> torch.Tensor:
    """kv: (..., S, h, d) full prefill keys -> (..., window, h, d) ring laid
    out so that decode's ``slot = pos % window`` indexing continues
    seamlessly at pos = S."""
    S = kv.shape[-3]
    w = min(window, S)
    last = kv[..., S - w:, :, :]
    slots = torch.arange(S - w, S, device=kv.device) % window
    out = kv.new_zeros(kv.shape[:-3] + (window,) + kv.shape[-2:])
    out[..., slots, :, :] = last
    return out


def _convert_position(cfg, attn_kind: str, entry: dict, max_seq: int,
                      dtype) -> dict:
    if attn_kind == MAMBA:
        # the decode step writes into these tensors: a fresh conv tail
        # (``to`` may return the prefill's own) and the fp32 state, which
        # the prefill made for the cache alone
        return {"conv": entry["conv"].to(dtype, copy=True), "h": entry["h"]}
    window = _window(cfg, attn_kind)
    k, v = entry["k"].to(dtype), entry["v"].to(dtype)
    S = k.shape[-3]
    if window > 0:
        size = min(window, max_seq)
        k, v = _ring_fill(k, size), _ring_fill(v, size)
    else:
        pad = (0, 0, 0, 0, 0, max_seq - S)      # the seq axis, from the end
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    out = {"attn": {"k": k, "v": v}}
    if cfg.enc_dec:
        out["xk"] = entry["xk"].to(dtype)
        out["xv"] = entry["xv"].to(dtype)
    return out


def cache_from_prefill(cfg: ModelConfig, prefill_caches: dict, max_seq: int,
                       dtype=torch.bfloat16) -> dict:
    """prefill_caches: ``stack_apply(mode='prefill')`` output."""
    kinds = cfg.block_kinds()
    main = [_convert_position(cfg, kinds[i][0], entry, max_seq, dtype)
            for i, entry in enumerate(prefill_caches["main"])]
    tail = [_convert_position(cfg, kinds[i][0], entry, max_seq, dtype)
            for i, entry in enumerate(prefill_caches["tail"])]
    return {"main": main, "tail": tail}
