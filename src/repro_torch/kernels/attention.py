"""Flash attention — blocked online-softmax attention, as a hand-written
CUDA kernel (``csrc/attention.cu``) with its plain PyTorch version.

``flash_attention(q, k, v)`` takes q (b, sq, hq, d) and k/v (b, skv, hkv,
d) in fp32 (GQA: hq % hkv == 0) and returns (b, sq, hq, d): causal with
queries aligned to the end of the keys, an optional sliding ``window`` and
a tanh logit ``softcap``.  For CPU tensors it runs :func:`flash_plain`
(:func:`repro_torch.kernels.ref.attention`); for CUDA tensors it launches
the kernel on the current stream, or raises.  The kernel reads q, k and v
through their strides (the head dim contiguous), so no transposed or padded
copies are made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

#: query rows per CTA and keys per tile of the kernel
BQ = 64
BKV = 64
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: int = 0, softcap: float = 0.0,
                scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale)


def live_tiles(iq: int, sq: int, skv: int, *, causal: bool,
               window: int) -> range:
    """The kv tiles query tile ``iq`` loops over: the kernel's loop bounds,
    computed as in ``csrc/attention.cu``.  They are the tiles the TPU
    kernel's grid-level skip keeps for the same rows."""
    q_lo = iq * BQ + skv - sq
    q_hi = min(q_lo + BQ - 1, skv - 1)
    n_kv = -(-skv // BKV)
    end = n_kv
    if causal:
        end = 0 if q_hi < 0 else min(n_kv, q_hi // BKV + 1)
    begin = 0
    if window > 0:
        num = q_lo - window - BKV + 2
        begin = 0 if num <= 0 else -(-num // BKV)
    return range(begin, end)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: operands on different devices")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("flash_attention: q, k and v must be float32")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             "head dim and 16-byte aligned rows")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: float | None = None) -> torch.Tensor:
    """Blocked attention on the flash kernel; see the module docstring."""
    if q.device.type == "cpu":
        return flash_plain(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)
    _check(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty((b, sq, hq, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.load("attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, skv, hq, hkv, d, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(causal), window, softcap, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
