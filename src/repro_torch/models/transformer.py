"""LM assembly of the port: decoder-only stacks of global and
sliding-window attention blocks with dense or MoE MLPs, Mamba2 blocks,
zamba2's shared attention, the encoder-decoder stack (seamless-m4t:
cross-attention to a non-causal encoder over stubbed audio frames) and the
vision prefix (llava-next: stubbed patch embeddings projected in front of
the text) — the JAX package's ``repro.models.transformer`` on tensors.

Parameters keep the reference's stacked layout: ``params["blocks"][i]``
holds pattern position *i* of every period, each leaf with a leading
``reps`` axis, and a non-dividing remainder of the pattern runs as the
unstacked ``params["tail"]``.  The reference's ``lax.scan`` over periods is
a Python loop over index *r* of the stacked tensors (``a[r]`` of a
contiguous stacked tensor is a contiguous view, so nothing is copied).
A ``SHARED_ATTN`` position holds no weights of its own: every one of them
applies ``params["shared"]``, one unstacked attention + dense MLP block.

Modes:
* ``train``   — full-sequence forward, returns logits and the MoE
  auxiliary loss; :func:`loss_fn` is the training loss, differentiable on
  both backends, with ``remat="block"`` recomputing each pattern period in
  the backward pass and ``remat="dots"`` recomputing all of it but its
  matrix products.
* ``prefill`` — forward that also emits per-layer K/V and SSM state for the
  decode cache.
* ``decode``  — one-token step against the cache (:func:`decode_step`).

Tied models train one matrix: :func:`trainable` is the tree of trained
leaves, without the serving copy ``embed_t``, so the loss computes the head
from ``embed``; :func:`with_head_copy` derives ``embed_t`` again after an
optimizer step.  Every supported config trains: a vision config predicts
its text from the logits behind the vision prefix, and an encoder-decoder
config's encoder recomputes each block under ``remat="block"`` (and under
``"dots"``, as the reference's encoder does).
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, MAMBA,
                                      SHARED_ATTN, ModelConfig)
from repro_torch.core import engine, tree
from repro_torch.core.accelerator import resolve_device
from repro_torch.core.quant import QTensor
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod

MODES = ("train", "prefill")
#: sequence-shard the residual carried between periods over TP
#: (Megatron-SP) in training: the reference's capacity lever for >100B
#: trains, which its dry run turns on; a constraint, so on the port it
#: only marks the site (the dry run sets it as the reference's does)
SP_CARRY = {"on": False}
#: ``remat`` policies: none; each pattern period recomputed in the
#: backward pass (the reference's ``jax.checkpoint`` of its scan body); or
#: each period's matrix products kept and the rest recomputed (its
#: ``checkpoint_dots`` policy)
REMATS = ("none", "block", "dots")


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` -> ``torch.float32`` (the configs spell dtypes as the
    JAX package does)."""
    return getattr(torch, name)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config the port cannot run: an unknown block kind."""
    for ak, mk in cfg.block_kinds():
        if ak not in (ATTN_GLOBAL, ATTN_LOCAL, MAMBA, SHARED_ATTN):
            raise ValueError(f"{cfg.name}: unknown block kind {ak!r}")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def _init_block(cfg: ModelConfig, gen: torch.Generator, device,
                lead: tuple[int, ...], attn_kind: str = ATTN_GLOBAL,
                mlp_kind: str = "dense", cross: bool = True) -> dict:
    """One block's parameters; an enc-dec config's blocks carry
    cross-attention (``lnx``, ``xattn``) unless ``cross`` is False (the
    encoder's)."""
    dt = torch_dtype(cfg.param_dtype)
    d, ff = cfg.d_model, cfg.d_ff
    if attn_kind == MAMBA:
        return {"ln1": L.norm_params(cfg, d, device, lead),
                "mamba": ssm_mod.init_mamba(cfg, gen, dt, device, lead)}
    if attn_kind == SHARED_ATTN:
        return {}                       # weights live in params["shared"]
    p = {"ln1": L.norm_params(cfg, d, device, lead),
         "attn": attn_mod.init_attn(cfg, gen, dt, device, lead)}
    if cfg.enc_dec and cross:
        p["lnx"] = L.norm_params(cfg, d, device, lead)
        p["xattn"] = attn_mod.init_attn(cfg, gen, dt, device, lead)
    p["ln2"] = L.norm_params(cfg, d, device, lead)
    if mlp_kind == "moe":
        p["moe"] = moe_mod.init_moe(cfg, gen, d, ff, dt, device, lead)
    else:
        p["mlp"] = mlp_mod.init_mlp(cfg, gen, d, ff, dt, device, lead)
    return p


def init_params(cfg: ModelConfig, seed: int | torch.Generator, *,
                device=None) -> dict:
    """Random parameters from a seed, in the reference's tree layout, drawn
    on ``device`` (the card unless the caller names another) from a
    generator of that device, so a seed gives the same weights on every
    device of one type.  Tied models also get ``embed_t``, a contiguous
    copy of ``embed.T`` (:func:`repro_torch.models.layers.head_weight`)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":                  # shapes only (schedule compile)
        gen = None
    elif isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch_dtype(cfg.param_dtype)
    kinds = cfg.block_kinds()
    reps, rem = cfg.stack_shape()
    params: dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, dev),
        "final_norm": L.norm_params(cfg, cfg.d_model, dev),
    }
    if cfg.tie_embeddings:
        params["embed_t"] = params["embed"].t().contiguous()
    else:
        params["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                      dev)
    params["blocks"] = [_init_block(cfg, gen, dev, (reps,), ak, mk)
                        if reps else {} for ak, mk in kinds]
    params["tail"] = [_init_block(cfg, gen, dev, (), *kinds[i])
                      for i in range(rem)]
    if any(ak == SHARED_ATTN for ak, _ in kinds):
        params["shared"] = _init_block(cfg, gen, dev, ())
    if cfg.frontend_dim:
        params["frontend"] = L.dense_init(gen, cfg.frontend_dim, cfg.d_model,
                                          dt, dev)
    if cfg.enc_dec:
        params["encoder"] = {
            "blocks": _init_block(cfg, gen, dev, (cfg.n_enc_layers,),
                                  cross=False),
            "final_norm": L.norm_params(cfg, cfg.d_model, dev)}
    return params


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------
def _apply_block(cfg, p: dict, shared_p: dict | None, x: torch.Tensor,
                 pos_ids: torch.Tensor, *, attn_kind: str, mlp_kind: str,
                 mode: str, cache: dict | None = None,
                 pos: int | None = None,
                 enc_out: torch.Tensor | None = None):
    """Returns (x, new_cache, aux), ``aux`` the MoE block's auxiliary loss
    or 0.0 (a Python float: a block without MoE launches nothing for it).
    In decode the cache's tensors are updated in place and returned; an
    enc-dec block's cross-attention K/V (``xk``, ``xv``: projected from
    ``enc_out`` in prefill) ride along untouched."""
    aux = 0.0
    if attn_kind == MAMBA:
        h = L.norm(cfg, p["ln1"], x)
        y, st = ssm_mod.mamba_forward(cfg, p["mamba"], h, cache=cache,
                                      return_cache=mode == "prefill")
        if mode == "decode":
            cache["conv"].copy_(st["conv"])
            cache["h"].copy_(st["h"])
            st = cache
        return x + y, st, aux

    pa = shared_p if attn_kind == SHARED_ATTN else p
    window = cfg.sliding_window if attn_kind == ATTN_LOCAL else 0
    h = L.norm(cfg, pa["ln1"], x)
    new_cache = cache
    if mode == "decode":
        y, attn_cache = attn_mod.attn_decode(cfg, pa["attn"], h, pos,
                                             cache["attn"], window=window)
        new_cache = {**cache, "attn": attn_cache}
    elif mode == "prefill":
        y, (k, v) = attn_mod.attn_forward(cfg, pa["attn"], h, pos_ids,
                                          window=window, return_kv=True)
        new_cache = {"k": k, "v": v}
    else:
        y = attn_mod.attn_forward(cfg, pa["attn"], h, pos_ids, window=window)
    x = x + y

    if cfg.enc_dec:
        hx = L.norm(cfg, pa["lnx"], x)
        if mode == "decode":
            yx, _ = attn_mod.attn_decode(
                cfg, pa["xattn"], hx, pos, None,
                cross_kv=(cache["xk"], cache["xv"]))
        else:
            yx, (xk, xv) = attn_mod.attn_forward(
                cfg, pa["xattn"], hx, pos_ids, x_kv=enc_out, causal=False,
                use_rope=False, return_kv=True)
            if mode == "prefill":
                new_cache = {**new_cache, "xk": xk, "xv": xv}
        x = x + yx

    h = L.norm(cfg, pa["ln2"], x)
    if mlp_kind == "moe":
        y, aux = moe_mod.moe_block(cfg, p["moe"], h)
    else:
        y = mlp_mod.mlp(cfg, pa["mlp"], h)
    return x + y, new_cache, aux


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------
def _select(tree, r: int):
    """Index ``r`` of every leaf's leading (stacked) axis (an int8
    :class:`QTensor` indexes its values and its scales)."""
    if isinstance(tree, dict):
        return {k: _select(v, r) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.q[r], tree.scale[r])
    return tree[r]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _period(cfg, kinds, blocks: list, shared_p: dict | None,
            x: torch.Tensor, pos_ids: torch.Tensor, mode: str, caches: list,
            pos, enc_out: torch.Tensor | None = None):
    """One pattern period: every block kind once.  Returns (x, aux, [new
    cache per kind]), ``aux`` summed over the period's blocks."""
    new = []
    aux = 0.0
    for i, (ak, mk) in enumerate(kinds):
        x, nc, a = _apply_block(cfg, blocks[i], shared_p, x, pos_ids,
                                attn_kind=ak, mlp_kind=mk, mode=mode,
                                pos=pos, cache=caches[i], enc_out=enc_out)
        aux = aux + a
        new.append(nc)
    if SP_CARRY["on"] and mode == "train" and x.shape[1] > 1:
        x = constrain(x, ("dp", "tp", None))
    return x, aux, new


def _check_remat(remat: str) -> None:
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")


#: the plain products a block runs outside the kernels (``torch.einsum`` and
#: ``torch.matmul`` lower to them): the MoE experts, the SSD's contractions
#: and everything on the ``"torch"`` backend
_PLAIN_DOTS = frozenset((torch.ops.aten.mm.default,
                         torch.ops.aten.bmm.default,
                         torch.ops.aten.addmm.default,
                         torch.ops.aten.baddbmm.default))


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The port's reading of ``checkpoint_dots``: keep what a forward's
    matmul produces (a kernel call in the ``forward`` role, or a plain
    product), recompute everything else (norms, activations, rope,
    softmax, routing, the flash kernel: the reference's ``pallas_call``
    is no dot either)."""
    if op is torch.ops.repro_torch.kernel_matmul.default:
        keep = args[8] == "forward"                 # the call's role
    else:
        keep = op in _PLAIN_DOTS
    return CheckpointPolicy.MUST_SAVE if keep else \
        CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _checkpointed(fn, *args, remat: str = "block"):
    """``fn(*args)`` under activation checkpointing: the inputs are kept,
    and under ``"dots"`` also the outputs of its matrix products (the
    forward's own tensors); the backward pass reruns ``fn`` (early stop
    off, so every other launch of the period repeats, and a kept product
    is handed back in its place) under the engine active now, recording
    nothing."""
    eng = engine.current()

    def contexts():
        if remat == "block":
            return contextlib.nullcontext(), eng.replaying()
        keep, recompute = create_selective_checkpoint_contexts(_dots_policy)
        return keep, _both(recompute, eng.replaying())

    with set_checkpoint_early_stop(False):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=contexts)


def stack_apply(cfg, params: dict, x: torch.Tensor, pos_ids: torch.Tensor, *,
                mode: str, caches: dict | None = None, pos: int | None = None,
                enc_out: torch.Tensor | None = None, remat: str = "none"):
    """Run every block.  caches: ``{'main': [per-position stacked], 'tail':
    [per-position]}`` in decode, where the cache tensors are updated in
    place and returned.  ``enc_out``: the encoder's output, which an
    enc-dec stack cross-attends in train and prefill.  ``remat="block"``
    checkpoints each period of the stacked part, ``remat="dots"`` keeps
    each period's matrix products and checkpoints the rest (the unstacked
    tail runs plainly under every policy, as in the reference).
    Returns (x, aux, new_caches); ``aux`` is the MoE auxiliary loss summed
    over the blocks (0 without MoE blocks).  The periods run are those
    ``params`` holds (``blocks`` stacked, ``tail``): a slice of them runs
    a stage of the stack (:func:`repro_torch.distributed.pipeline.
    lm_stages`)."""
    _check_remat(remat)
    kinds = cfg.block_kinds()
    reps = next((t.shape[0] for t in tree.leaves(params["blocks"])), 0)
    rem = len(params["tail"])
    shared_p = params.get("shared")
    collected: list[list] = [[] for _ in kinds]
    aux = 0.0
    for r in range(reps):
        blocks = [_select(params["blocks"][i], r) for i in range(len(kinds))]
        cs = [_select(caches["main"][i], r) if caches else None
              for i in range(len(kinds))]
        args = (cfg, kinds, blocks, shared_p, x, pos_ids, mode, cs, pos,
                enc_out)
        x, a, new = _period(*args) if remat == "none" else \
            _checkpointed(_period, *args, remat=remat)
        aux = aux + a
        for i, nc in enumerate(new):
            collected[i].append(nc)
    new_tail = []
    for i in range(rem):
        ak, mk = kinds[i]
        x, nc, a = _apply_block(cfg, params["tail"][i], shared_p, x, pos_ids,
                                attn_kind=ak, mlp_kind=mk, mode=mode,
                                pos=pos,
                                cache=caches["tail"][i] if caches else None,
                                enc_out=enc_out)
        aux = aux + a
        new_tail.append(nc)
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "prefill":
        main = [_stack(c) for c in collected] if reps else []
        return x, aux, {"main": main, "tail": new_tail}
    if mode == "decode":
        return x, aux, caches
    return x, aux, None


# ---------------------------------------------------------------------------
# frontends and the encoder (seamless-m4t, llava-next)
# ---------------------------------------------------------------------------
def frontend(cfg: ModelConfig, params: dict,
             embeds: torch.Tensor) -> torch.Tensor:
    """The stubbed frontend's embeddings (B, s, frontend_dim) projected to
    (B, s, d) in the compute dtype.  A plain product, as the reference's
    einsum runs outside its kernels; fp32 stays fp32 (TF32 off)."""
    cd = torch_dtype(cfg.compute_dtype)
    x, w = embeds.to(cd), params["frontend"].to(cd)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(x, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _enc_block(cfg, p: dict, x: torch.Tensor,
               pos_ids: torch.Tensor) -> torch.Tensor:
    h = L.norm(cfg, p["ln1"], x)
    x = x + attn_mod.attn_forward(cfg, p["attn"], h, pos_ids, causal=False)
    h = L.norm(cfg, p["ln2"], x)
    return x + mlp_mod.mlp(cfg, p["mlp"], h)


def encode(cfg: ModelConfig, params: dict, audio_embeds: torch.Tensor,
           remat: str = "none") -> torch.Tensor:
    """The encoder (seamless-m4t): the frontend's projection of the audio
    frames (B, sa, frontend_dim), then ``n_enc_layers`` non-causal, roped
    attention + dense MLP blocks and the encoder's final norm.
    ``remat="block"`` checkpoints each block; so does ``"dots"``, as in
    the reference, whose encoder takes it for ``"block"``."""
    _check_remat(remat)
    enc = params["encoder"]
    x = frontend(cfg, params, audio_embeds)
    pos_ids = torch.arange(x.shape[1], device=x.device)[None, :]
    for r in range(cfg.n_enc_layers):
        args = (cfg, _select(enc["blocks"], r), x, pos_ids)
        x = _enc_block(*args) if remat == "none" else \
            _checkpointed(_enc_block, *args)
    return L.norm(cfg, enc["final_norm"], x)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def embed_inputs(cfg: ModelConfig, params: dict, batch: dict, *,
                 remat: str = "none"):
    """The stack's input: the tokens' embeddings (B, S, d) in the compute
    dtype, a vision config's projected ``vision_embeds`` in front of them;
    an enc-dec config's encoder output from ``audio_embeds``.  Returns (x,
    enc_out or None)."""
    cd = torch_dtype(cfg.compute_dtype)
    x = L.embed(params, batch["tokens"], scale=cfg.name.startswith("gemma"),
                d=cfg.d_model, dtype=cd)
    enc_out = None
    if cfg.vision_tokens and "vision_embeds" in batch:
        x = torch.cat([frontend(cfg, params, batch["vision_embeds"]), x],
                      dim=1)
    if cfg.enc_dec:
        enc_out = encode(cfg, params, batch["audio_embeds"], remat=remat)
    return constrain(x, ("dp", None, None)), enc_out


def output_logits(cfg: ModelConfig, params: dict,
                  x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head: fp32 logits (B, S, V)."""
    return L.unembed(cfg, params, L.norm(cfg, params["final_norm"], x))


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            mode: str = "train", remat: str = "none"):
    """batch: ``{"tokens": (B, S) integer}``, plus ``"vision_embeds"`` (B,
    vision_tokens, frontend_dim) for a vision config, projected and put in
    front of the text (positions run over both), or ``"audio_embeds"`` (B,
    frames, frontend_dim) for an enc-dec config, which the decoder
    cross-attends through :func:`encode`.  Returns (logits (B, vt + S, V)
    fp32, aux, caches)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    check_supported(cfg)
    x, enc_out = embed_inputs(cfg, params, batch, remat=remat)
    pos_ids = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux, caches = stack_apply(cfg, params, x, pos_ids, mode=mode,
                                 enc_out=enc_out, remat=remat)
    return output_logits(cfg, params, x), aux, caches


def trainable(params: dict) -> dict:
    """The trained leaves: the tree without ``embed_t``, the serving copy
    of a tied ``embed.T`` (no optimizer or checkpoint leaf)."""
    return {k: v for k, v in params.items() if k != "embed_t"}


def with_head_copy(cfg: ModelConfig, params: dict) -> dict:
    """``params`` with ``embed_t`` derived again from ``embed`` (tied
    models), as serving reads it after an optimizer step."""
    if not cfg.tie_embeddings:
        return params
    return {**params, "embed_t": params["embed"].detach().t().contiguous()}


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            remat: str = "none"):
    """Next-token cross entropy + 0.01 x aux, as the reference computes it:
    CE = logsumexp - target logit in fp32 (a gather picks the same exact
    term as the reference's one-hot contraction), averaged over
    ``batch["loss_mask"][:, 1:]`` when given.  With ``"vision_embeds"`` in
    the batch of a vision config, the ``vt`` vision tokens come first: the
    logits at ``vt - 1 .. vt + S - 2`` predict every text token, and a
    given ``loss_mask`` is taken whole.  The head of a tied model comes
    from ``embed`` (:func:`trainable`).  Returns (loss, {"ce", "aux"}),
    ``aux`` the MoE blocks' load-balance loss (0 without them)."""
    logits, aux, _ = forward(cfg, trainable(params), batch, mode="train",
                             remat=remat)
    tokens = batch["tokens"]
    vt = cfg.vision_tokens if (cfg.vision_tokens and
                               "vision_embeds" in batch) else 0
    if vt:
        pred = logits[:, vt - 1:vt + tokens.shape[1] - 1]
        tgt = tokens
    else:
        pred = logits[:, :-1]
        tgt = tokens[:, 1:]
    predf = pred.to(torch.float32)
    tgt = tgt.to(torch.int64)
    lse = torch.logsumexp(predf, dim=-1)
    ll = predf.gather(-1, tgt.unsqueeze(-1)).squeeze(-1) - lse
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = (mask if vt else mask[:, 1:]).to(torch.float32)
        ce = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        ce = -torch.mean(ll)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def decode_step(cfg: ModelConfig, params: dict, caches: dict,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1) integer; pos: the absolute position.  Returns (logits
    (B, 1, V), caches), the caches updated in place."""
    cd = torch_dtype(cfg.compute_dtype)
    x = L.embed(params, tokens, scale=cfg.name.startswith("gemma"),
                d=cfg.d_model, dtype=cd)
    pos_ids = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                         device=x.device)
    x, _, caches = stack_apply(cfg, params, x, pos_ids, mode="decode",
                               caches=caches, pos=pos)
    x = L.norm(cfg, params["final_norm"], x)
    return L.unembed(cfg, params, x), caches
