"""Attention blocks of the port: GQA, sliding window (ring KV cache),
logit softcap, cross-attention (enc-dec) — the JAX package's
``repro.models.attention`` on tensors.

Train/prefill attention goes through the active
:class:`repro_torch.core.engine.Engine` (the flash kernel or its plain
version).  Decode attends one query token against the cache with an
explicit validity mask (plain PyTorch, fp32 accumulation): global layers
keep a full-length cache, ``ATTN_LOCAL`` layers a ring of ``window`` slots,
and cross-attention attends the encoder's precomputed K/V.

The reference's sharding constraints sit at the same sites
(:func:`repro_torch.distributed.sharding.constrain`: the port has no
partitioner, so they return their input), and inside an activation mesh
with a model axis the query heads are padded to a multiple of its size
as the reference pads them (:func:`_pad_heads`): the dry run traces that
layout.  Outside a mesh nothing of this runs.
"""
from __future__ import annotations

import torch

import torch.nn.functional as F

from repro_torch.core import engine
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import dense_init, rope


def init_attn(cfg, gen: torch.Generator, dtype, device,
              lead: tuple[int, ...] = ()) -> dict:
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, device, lead),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device, lead),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device, lead),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, device, lead),
    }


def _proj_qkv(cfg, p: dict, x: torch.Tensor,
              x_kv: torch.Tensor | None = None):
    """q from ``x``; k and v from ``x_kv`` when given (cross-attention),
    else from ``x``."""
    eng = engine.current()
    b, s, _ = x.shape
    hd = cfg.hd
    xkv = x if x_kv is None else x_kv
    skv = xkv.shape[1]
    q = eng.matmul(x, p["wq"], name="attn.q").reshape(b, s, cfg.n_heads, hd)
    k = eng.matmul(xkv, p["wk"], name="attn.k").reshape(
        b, skv, cfg.n_kv_heads, hd)
    v = eng.matmul(xkv, p["wv"], name="attn.v").reshape(
        b, skv, cfg.n_kv_heads, hd)
    # pin head sharding across the reshape (see sharding.constrain)
    q = _constrain_q(cfg, q)
    k = _constrain_kv(cfg, k)
    v = _constrain_kv(cfg, v)
    return q, k, v


def _pad_heads(cfg, q: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Inside an activation mesh, pad the query heads with zero heads to a
    multiple of the TP degree (llava: 56 -> 64, llama4: 40 -> 48) so the
    head axis shards; the padded heads' outputs are sliced off before
    ``wo``.  The GQA group stays integral because hkv divides the padded
    count (else no padding).  Returns (q, the real head count)."""
    mesh = SH.active_mesh()
    hq = q.shape[2]
    if mesh is None:
        return q, hq
    tp = SH.tp_size(mesh)
    if hq % tp == 0 or tp == 1:
        return q, hq
    hpad = ((hq + tp - 1) // tp) * tp
    hkv = cfg.n_kv_heads
    if hkv and hpad % hkv != 0:
        hpad = ((hpad + hkv - 1) // hkv) * hkv     # keep GQA group integral
        if hpad % tp:
            return q, hq                           # give up: fall back
    return F.pad(q, (0, 0, 0, hpad - hq)), hq


def _constrain_q(cfg, q: torch.Tensor) -> torch.Tensor:
    """Heads over TP when divisible; else the query sequence over TP
    (context parallelism)."""
    mesh = SH.active_mesh()
    if mesh is None:
        return q
    tp = SH.tp_size(mesh)
    if q.shape[2] % tp == 0:
        return constrain(q, ("dp", None, "tp", None))
    if q.shape[1] % tp == 0 and q.shape[1] > 1:
        return constrain(q, ("dp", "tp", None, None))
    return constrain(q, ("dp", None, None, None))


def _constrain_kv(cfg, k: torch.Tensor) -> torch.Tensor:
    mesh = SH.active_mesh()
    if mesh is None:
        return k
    tp = SH.tp_size(mesh)
    if k.shape[2] % tp == 0:
        return constrain(k, ("dp", None, "tp", None))
    return constrain(k, ("dp", None, None, None))


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_mask: torch.Tensor, *, softcap: float = 0.0,
                     scale: float | None = None) -> torch.Tensor:
    """Decode attention: q (b, 1, hq, d) against cache k/v (b, S, hkv, d)
    with an explicit per-slot validity mask ((S,) or (b, S)); slot order is
    irrelevant once RoPE is burned into the cached keys.  fp32
    accumulation; the probabilities are rounded to ``v``'s dtype before
    they multiply it, as the reference rounds them."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, sq, hkv, g, d).to(torch.float32)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                          k.to(torch.float32)) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    if kv_mask.dim() == 1:
        kv_mask = kv_mask[None]
    logits = torch.where(kv_mask[:, None, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    pmax = logits.amax(-1, keepdim=True)
    un = torch.exp(logits - pmax)
    # the probabilities meet v in v's dtype, as in the reference (a no-op
    # for fp32; rounded to bf16 against a bf16 cache); the sum stays fp32
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       un.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    den = un.sum(-1).permute(0, 3, 1, 2)[..., None]         # (b, q, h, g, 1)
    out = out / torch.clamp(den, min=1e-30)
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attn_forward(cfg, p: dict, x: torch.Tensor, pos_ids: torch.Tensor, *,
                 window: int = 0, use_rope: bool = True, causal: bool = True,
                 x_kv: torch.Tensor | None = None,
                 softcap: float | None = None, return_kv: bool = False):
    """Full-sequence (train / prefill) attention: self-attention, or
    cross-attention of ``x`` to ``x_kv`` (whose keys, when roped, take the
    positions ``0 .. x_kv.shape[1] - 1``)."""
    eng = engine.current()
    b, s, _ = x.shape
    q, k, v = _proj_qkv(cfg, p, x, x_kv)
    if use_rope:
        q = rope(q, pos_ids, cfg.rope_theta)
        k = rope(k, pos_ids if x_kv is None else
                 torch.arange(x_kv.shape[1], device=x.device),
                 cfg.rope_theta)
    sc = cfg.attn_softcap if softcap is None else softcap
    q, hq = _pad_heads(cfg, q)
    q = _constrain_q(cfg, q)
    out = eng.attention(q, k, v, causal=causal, window=window, softcap=sc)
    if out.shape[2] != hq:
        out = out[:, :, :hq, :]                  # drop padded heads
    out = eng.matmul(out.reshape(b, s, -1), p["wo"], name="attn.o")
    if return_kv:
        return out, (k, v)
    return out


def init_kv_cache(cfg, batch: int, max_seq: int, window: int, dtype,
                  device, lead: tuple[int, ...] = ()) -> dict:
    size = min(window, max_seq) if window > 0 else max_seq
    shape = (*lead, batch, size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(cfg, p: dict, x: torch.Tensor, pos: int,
                cache: dict | None, *, window: int = 0,
                cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                softcap: float | None = None):
    """One-token decode step.  x: (b, 1, d); pos: the absolute position.

    Self-attention projects k/v for the new token, writes them into the
    (ring) cache and attends against every valid slot.  The write goes
    into the cache tensors in place (the reference's
    ``dynamic_update_slice`` returns a new cache): the returned cache holds
    the same tensors, updated.  Cross-attention (``cross_kv``) attends the
    encoder's precomputed k/v, every slot valid, the query unroped, and
    returns ``cache`` untouched."""
    eng = engine.current()
    b = x.shape[0]
    hd = cfg.hd
    sc = cfg.attn_softcap if softcap is None else softcap

    q = eng.matmul(x, p["wq"], name="attn.q").reshape(b, 1, cfg.n_heads, hd)

    if cross_kv is not None:
        k, v = cross_kv
        kv_mask = torch.ones(k.shape[1], dtype=torch.bool, device=x.device)
        out = masked_attention(q, k, v, kv_mask, softcap=sc)
        out = eng.matmul(out.reshape(b, 1, -1), p["wo"], name="attn.o")
        return out, cache

    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k_new = eng.matmul(x, p["wk"], name="attn.k").reshape(
        b, 1, cfg.n_kv_heads, hd)
    v_new = eng.matmul(x, p["wv"], name="attn.v").reshape(
        b, 1, cfg.n_kv_heads, hd)
    k_new = rope(k_new, posv, cfg.rope_theta)

    kc, vc = cache["k"], cache["v"]
    size = kc.shape[1]
    # the reference clamps an out-of-range slot as dynamic_update_slice does
    slot = pos % size if window > 0 else min(pos, size - 1)
    kc[:, slot] = k_new[:, 0].to(kc.dtype)
    vc[:, slot] = v_new[:, 0].to(vc.dtype)
    idx = torch.arange(size, device=x.device)
    kv_mask = torch.ones(size, dtype=torch.bool, device=x.device) \
        if pos >= size else idx <= pos
    out = masked_attention(q, kc, vc, kv_mask, softcap=sc)
    out = eng.matmul(out.reshape(b, 1, -1), p["wo"], name="attn.o")
    return out, {"k": kc, "v": vc}
