"""Flash attention — blocked online-softmax attention, as a hand-written
CUDA kernel (``csrc/attention.cu``) with its plain PyTorch version.

``flash_attention(q, k, v)`` takes q (b, sq, hq, d) and k/v (b, skv, hkv,
d), all fp32 or all bf16 (GQA: hq % hkv == 0), and returns (b, sq, hq, d)
in their dtype (scores, softmax and P V in fp32 either way): causal with
queries aligned to the end of the keys, an optional sliding ``window`` and
a tanh logit ``softcap``.  For CPU tensors it runs :func:`flash_plain`
(:func:`repro_torch.kernels.ref.attention`); for CUDA tensors it launches
the kernel on the current stream, or raises.  The kernel reads q, k and v
through their strides (the head dim contiguous), so no transposed or padded
copies are made.

The tiling the kernel runs (:func:`flash_geometry`: the query-tile height
and whether a CTA takes two query tiles) is chosen here from the launch's
shape, so it can be tested on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.sa_conv_implicit import SM_COUNT

#: query rows of a CTA's tile: the kernel's two instantiations per head
#: dim (8 or 4 rows per thread); keys per kv tile, the same for every shape
BQ = (64, 128)
BKV = 64
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
#: element types the kernel is instantiated for, and their codes
#: (csrc/common.cuh Kind)
DTYPES = {torch.float32: 0, torch.bfloat16: 2}
#: padded row of a warp's half tile of probabilities (csrc/attention.cu PH)
PH = 36
#: modelled card time, in microseconds at d = 128, of one kv tile of a query
#: tile of each height, and of a query tile's own set-up (staging Q and
#: storing the output): fitted to the card times of the four tilings at
#: (1 or 4, 512, 16, 128), causal, on an H100 SXM
TILE_US = {64: 10.0, 128: 14.6}
QTILE_US = {64: 0.3, 128: 1.7}


@dataclasses.dataclass(frozen=True)
class FlashGeometry:
    """One launch's tiling (all counts, no pointers): query tiles of ``bq``
    rows, and CTA ``c`` takes unit ``c // heads`` of (batch, head)
    ``c % heads``: query tile ``q_tiles - 1 - unit``, then, ``paired``, its
    mirror ``unit``."""
    bq: int                     # query rows per tile
    paired: bool                # a CTA takes tiles n-1-u and u
    q_tiles: int                # query tiles per (batch, head)
    heads: int                  # batch * query heads
    smem_bytes: int             # dynamic shared memory
    makespan_us: float          # modelled card time, one CTA per SM

    @property
    def units(self) -> int:
        return (self.q_tiles + 1) // 2 if self.paired else self.q_tiles

    @property
    def ctas(self) -> int:
        return self.units * self.heads

    def cta_tiles(self, cta: int) -> tuple[int, tuple[int, ...]]:
        """(batch * hq + head, query tiles in the CTA's order) of one CTA,
        as the kernel derives them from its index."""
        unit, bh = divmod(cta, self.heads)
        first = self.q_tiles - 1 - unit
        return bh, (first,) + ((unit,) if self.paired and unit != first
                               else ())


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: int = 0, softcap: float = 0.0,
                scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale)


def live_tiles(iq: int, sq: int, skv: int, *, causal: bool, window: int,
               bq: int) -> range:
    """The kv tiles query tile ``iq`` of ``bq`` rows loops over: the
    kernel's loop bounds, computed as in ``csrc/attention.cu``.  They are
    the tiles the TPU kernel's grid-level skip keeps for the same rows."""
    q_lo = iq * bq + skv - sq
    q_hi = min(q_lo + bq - 1, skv - 1)
    n_kv = -(-skv // BKV)
    end = n_kv
    if causal:
        end = 0 if q_hi < 0 else min(n_kv, q_hi // BKV + 1)
    begin = 0
    if window > 0:
        num = q_lo - window - BKV + 2
        begin = 0 if num <= 0 else -(-num // BKV)
    return range(begin, end)


def smem_bytes(bq: int, d: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of a CTA (csrc/attention.cu ``smem_bytes``):
    the Q tile (fp32), two stages of K and V (``itemsize`` bytes an
    element), and the warps' slices of P."""
    return 4 * (bq * (d + 4) + bq * PH) + itemsize * 4 * BKV * (d + 4)


def _makespan(works: list[float]) -> float:
    """Card time of CTAs of ``works`` issued in order, one per SM at a
    time, each to the SM that frees first."""
    free = [0.0] * min(SM_COUNT, len(works))
    for t in works:
        heapq.heapreplace(free, free[0] + t)
    return max(free)


@functools.lru_cache(maxsize=None)
def flash_geometry(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
                   causal: bool, window: int,
                   itemsize: int = 4) -> FlashGeometry:
    """Pick the query-tile height and the pairing of query tiles for a
    launch from its shape alone: each candidate is costed as the card time
    of its CTAs (:data:`TILE_US` per live kv tile, :data:`QTILE_US` per
    query tile that has one) issued heaviest first onto the card's SMs,
    one 256-thread CTA per SM (``__launch_bounds__(256, 1)``); ties go to
    fewer CTAs.  The tiling changes only which CTA computes a row, never
    the row's summation order."""
    best = None
    for bq in BQ:
        n = -(-sq // bq)
        work = []
        for iq in range(n):
            live = len(live_tiles(iq, sq, skv, causal=causal, window=window,
                                  bq=bq))
            work.append(live * TILE_US[bq] + (QTILE_US[bq] if live else 0.0))
        for paired in (False, True):
            g = FlashGeometry(bq, paired, n, b * hq,
                              smem_bytes(bq, d, itemsize), 0.0)
            works = []
            for u in range(g.units):
                _, tiles = g.cta_tiles(u * g.heads)
                works += [sum(work[t] for t in tiles)] * g.heads
            g = dataclasses.replace(g, makespan_us=_makespan(works))
            key = (round(g.makespan_us, 3), g.ctas)
            if best is None or key < best[0]:
                best = (key, g)
    return best[1]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: operands on different devices")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in (k, v)):
        raise TypeError("flash_attention: q, k and v must be all float32 "
                        f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
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
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                s * t.element_size() % 16 for s in t.stride()[:3]):
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
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    g = flash_geometry(b, sq, skv, hq, hkv, d, bool(causal), int(window),
                       q.element_size())
    lib = _build.load("attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], b, sq, skv, hq, hkv, d, *q.stride()[:3],
        *k.stride()[:3],
        *v.stride()[:3], int(causal), window, softcap, scale, g.bq,
        int(g.paired), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
