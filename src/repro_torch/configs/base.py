"""Base configuration types — a copy of the JAX package's
``repro.configs.base`` (data only, no JAX), so the port's model code and
``--arch`` resolve the same configurations.

Every assigned architecture instantiates :class:`ModelConfig`; the four
assigned input shapes are :data:`SHAPES`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

# ---------------------------------------------------------------------------
# Layer-pattern vocabulary (heterogeneous stacks scan over a repeating block)
# ---------------------------------------------------------------------------
ATTN_GLOBAL = "attn_global"
ATTN_LOCAL = "attn_local"     # sliding-window attention
MAMBA = "mamba"               # Mamba2 SSD block
SHARED_ATTN = "shared_attn"   # zamba2 shared-weight attention block


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    shared_expert: bool = False     # llama4-style always-on expert
    moe_every: int = 1              # MoE layer every k-th block (llama4: 2)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256          # SSD chunk length
    conv_width: int = 4       # depthwise causal conv width

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture definition (exact assigned numbers)."""

    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                       # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention details ------------------------------------------------------
    head_dim: int = 0                  # 0 -> derived d_model // n_heads
    sliding_window: int = 4096
    # repeating layer pattern; empty -> [ATTN_GLOBAL] * n_layers homogeneous
    layer_pattern: tuple[str, ...] = ()
    logit_softcap: float = 0.0         # gemma2 final-logit softcap
    attn_softcap: float = 0.0          # gemma2 attention-logit softcap
    rope_theta: float = 10_000.0

    # norms / activations ----------------------------------------------------
    norm: str = "rmsnorm"              # rmsnorm | layernorm | nonparam_ln
    mlp: str = "swiglu"                # swiglu | geglu | gelu
    tie_embeddings: bool = False

    # mixtures / ssm ---------------------------------------------------------
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None

    # enc-dec (seamless-m4t) -------------------------------------------------
    enc_dec: bool = False
    n_enc_layers: int = 0

    # modality frontends (STUBS per assignment: precomputed embeddings) ------
    vision_tokens: int = 0             # llava-next: patch-embedding stand-ins
    audio_frames: int = 0              # seamless: frame-embedding stand-ins
    frontend_dim: int = 0              # embedding dim delivered by the stub

    # numerics ---------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.layer_pattern:
            return self.layer_pattern
        return (ATTN_GLOBAL,)

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the KV state does not grow linearly-unbounded with context
        for *all* layers (SSM/hybrid) or is window-bounded (pure SWA) or the
        arch has only a bounded number of global layers (gemma local:global).
        Pure full-attention archs return False and skip ``long_500k``."""
        pat = self.pattern
        if all(p in (MAMBA,) for p in pat):
            return True
        if any(p in (MAMBA, SHARED_ATTN) for p in pat):
            return True                       # hybrid
        if any(p == ATTN_LOCAL for p in pat):
            return True                       # SWA / local:global mixes
        return False

    def block_kinds(self) -> tuple[tuple[str, str], ...]:
        """One pattern period resolved to (attn_kind, mlp_kind) pairs.

        ``mlp_kind`` in {dense, moe, none}.  A pattern entry may force it
        with a suffix (``"attn_global:dense"`` — llama4 alternates dense and
        MoE FFNs); otherwise MoE-ness follows ``cfg.moe``.
        """
        out = []
        for kind in self.pattern:
            if ":" in kind:
                k, m = kind.split(":")
            else:
                k = kind
                m = "moe" if self.moe is not None else "dense"
            if k == MAMBA:
                m = "none"
            out.append((k, m))
        return tuple(out)

    def stack_shape(self) -> tuple[int, int]:
        """(reps, remainder) of the pattern over n_layers."""
        p = len(self.pattern)
        return self.n_layers // p, self.n_layers % p

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        return d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d

    def _dense_mlp_params(self) -> int:
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        return mult * self.d_model * self.d_ff

    def _mlp_params(self, mlp_kind: str) -> int:
        if mlp_kind == "none":
            return 0
        if mlp_kind == "moe":
            dense = self._dense_mlp_params()
            total = self.moe.n_experts * dense + self.d_model * self.moe.n_experts
            if self.moe.shared_expert:
                total += dense
            return total
        return self._dense_mlp_params()

    def _mamba_params(self) -> int:
        s = self.ssm
        d = self.d_model
        di = s.d_inner(d)
        nh = s.n_heads(d)
        # in_proj -> [z, x, B, C, dt]; depthwise conv over (x,B,C); out_proj
        return d * (2 * di + 2 * s.d_state + nh) + di * d \
            + s.conv_width * (di + 2 * s.d_state) + 2 * nh

    def _block_params(self, attn_kind: str, mlp_kind: str) -> int:
        if attn_kind == MAMBA:
            return self._mamba_params()
        if attn_kind == SHARED_ATTN:
            return 0                              # shared weights counted once
        return self._attn_params() + self._mlp_params(mlp_kind)

    def n_params(self) -> int:
        """Analytical parameter count (embedding + stacked blocks + head)."""
        d, V = self.d_model, self.vocab_size
        total = V * d + (0 if self.tie_embeddings else V * d)
        kinds = self.block_kinds()
        reps, rem = self.stack_shape()
        per = sum(self._block_params(a, m) for a, m in kinds)
        total += reps * per
        total += sum(self._block_params(a, m) for a, m in kinds[:rem])
        if any(a == SHARED_ATTN for a, _ in kinds):
            total += self._attn_params() + self._dense_mlp_params()
        if self.enc_dec:
            enc = self.n_enc_layers * (self._attn_params()
                                       + self._dense_mlp_params())
            xattn = self.n_layers * self._attn_params()
            total += enc + xattn
        if self.frontend_dim:
            total += self.frontend_dim * d
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only routed + shared experts)."""
        if self.moe is None:
            return self.n_params()
        dense = self._dense_mlp_params()
        kinds = self.block_kinds()
        reps, rem = self.stack_shape()
        n_moe = reps * sum(1 for _, m in kinds if m == "moe") \
            + sum(1 for _, m in kinds[:rem] if m == "moe")
        inactive = n_moe * (self.moe.n_experts - self.moe.top_k) * dense
        return self.n_params() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    microbatch: int = 0            # 0 -> no gradient accumulation
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    moment_dtype: str = "float32"  # bf16 for very large models (ZeRO-friendly)
    remat: str = "block"           # none | block | dots
    grad_compress: str = "none"    # none | int8 | topk
    seed: int = 0


def reduced(cfg: ModelConfig, **overrides: Any) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    pat = cfg.pattern
    small: dict[str, Any] = dict(
        n_layers=max(2, len(pat)),
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16 if cfg.n_heads else 0,
        sliding_window=16,
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(n_experts=4, top_k=cfg.moe.top_k,
                                 capacity_factor=cfg.moe.capacity_factor)
    if cfg.ssm is not None:
        small["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16)
    if cfg.enc_dec:
        small["n_enc_layers"] = 2
    if cfg.vision_tokens:
        small["vision_tokens"] = 8
        small["frontend_dim"] = 64
    if cfg.audio_frames:
        small["audio_frames"] = 16
        small["frontend_dim"] = 64
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
