"""Flash attention — blocked online-softmax attention, as a hand-written
CUDA kernel (``csrc/attention.cu``) with its plain PyTorch version.

``flash_attention(q, k, v)`` takes q (b, sq, hq, d) and k/v (b, skv, hkv,
d), all fp32 or all bf16 (GQA: hq % hkv == 0), and returns (b, sq, hq, d)
in their dtype (the softmax's statistics and sums in fp32 either way; fp32
on the CUDA cores' FMA loop, bf16 on the tensor cores, P split into two
bf16 terms for P V): causal with queries aligned to the end of the keys,
an optional sliding ``window`` and a tanh logit ``softcap``.  For CPU
tensors it runs :func:`flash_plain`
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

#: query rows of a CTA's tile: the kernels' two instantiations per head
#: dim (fp32: 8 or 4 rows per thread; bf16: two or one consumer
#: warpgroups of 64 rows); keys per kv tile, the same for every shape
BQ = (64, 128)
BKV = 64
#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
#: element types the kernels take, and their codes (csrc/common.cuh Kind)
DTYPES = {torch.float32: 0, torch.bfloat16: 2}
#: padded row of a warp's half tile of probabilities (csrc/attention.cu PH)
PH = 36
#: the bf16 kernel's ring of K and V stages (csrc/attention.cu TC_STAGES)
TC_STAGES = 3
#: modelled card time, in microseconds at d = 128, of one kv tile of a query
#: tile of each height, and of a query tile's own set-up (staging Q and
#: storing the output), by element size: fitted to the card times of the
#: four tilings at (1 or 4, 512, 16, 128), causal, on an H100 SXM (fp32:
#: the FMA kernel; bf16: the tensor-core kernel, tools/flash_cost_fit.py)
TILE_US = {4: {64: 10.0, 128: 14.6}, 2: {64: 2.425, 128: 2.812}}
QTILE_US = {4: {64: 0.3, 128: 1.7}, 2: {64: 1.758, 128: 4.218}}


def padded_dim(d: int) -> int:
    """The bf16 kernel's shared-memory row: d rounded up to 64 columns (one
    or two 128-byte swizzle atoms), the columns past d TMA's zeros."""
    return -(-d // 64) * 64


@dataclasses.dataclass(frozen=True)
class FlashGeometry:
    """One launch's tiling (all counts, no pointers): query tiles of ``bq``
    rows, and CTA ``c`` takes unit ``c // heads`` of (batch, head)
    ``c % heads``: query tile ``q_tiles - 1 - unit``, then, ``paired``, its
    mirror ``unit``.  ``tensor_cores``: the bf16 kernel (``threads``
    consumer threads, 128 a warpgroup of 64 rows, and a producer warp);
    else the fp32 FMA kernel (256 threads)."""
    bq: int                     # query rows per tile
    paired: bool                # a CTA takes tiles n-1-u and u
    q_tiles: int                # query tiles per (batch, head)
    heads: int                  # batch * query heads
    smem_bytes: int             # dynamic shared memory
    makespan_us: float          # modelled card time, one CTA per SM
    tensor_cores: bool = False

    @property
    def threads(self) -> int:
        """Threads that own outputs."""
        return 2 * self.bq if self.tensor_cores else 256

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

    def thread_outputs(self, t: int, d: int) -> tuple[list[int], list[int]]:
        """(rows, columns) of thread ``t``'s outputs within its query tile
        of ``bq`` x ``d``, as csrc/attention.cu stores them.  FMA kernel:
        warp w rows 2 RPT w + 2 r + half (RPT = bq / 16), lane (half, x)
        columns 4 (x + 16 c) .. + 3.  Tensor cores: wgmma's accumulator
        fragment; warpgroup t // 128 owns 64 rows, its warp v rows 16 v +
        lane // 4 and that + 8, columns 8 j + 2 (lane % 4) and that + 1 for
        every j below the padded row's DP / 8, stored where below d."""
        warp, lane = divmod(t, 32)
        if self.tensor_cores:
            r = 64 * (t // 128) + 16 * (warp % 4) + lane // 4
            return [r, r + 8], [c for j in range(padded_dim(d) // 8)
                                for c in (8 * j + 2 * (lane % 4) + e
                                          for e in (0, 1)) if c < d]
        rpt, nc4 = self.bq // 16, d // 4
        half, x = divmod(lane, 16)
        rows = [warp * 2 * rpt + 2 * r + half for r in range(rpt)]
        cols = [4 * (x + 16 * c) + e for c in range(-(-nc4 // 16))
                if x + 16 * c < nc4 for e in range(4)]
        return rows, cols


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
    """Dynamic shared memory of a CTA.  fp32 (csrc/attention.cu
    ``smem_bytes``): the Q tile, two stages of K and V, rows padded by 4,
    and the warps' slices of P.  bf16 (``TcTile::SMEM``): 1024 bytes to
    align to the swizzle's period, two Q tiles and ``TC_STAGES`` stages of
    K and V in rows of ``padded_dim(d)``, and 8-byte mbarriers: a full and
    an empty one a stage, one a Q tile."""
    if itemsize == 2:
        dp = padded_dim(d)
        return (1024 + 2 * 2 * bq * dp + TC_STAGES * 2 * 2 * BKV * dp
                + (2 * TC_STAGES + 2) * 8)
    return 4 * (bq * (d + 4) + bq * PH) + itemsize * 4 * BKV * (d + 4)


def _makespan(works: list[float]) -> float:
    """Card time of CTAs of ``works`` issued in order, one per SM at a
    time, each to the SM that frees first."""
    free = [0.0] * min(SM_COUNT, len(works))
    for t in works:
        heapq.heapreplace(free, free[0] + t)
    return max(free)


def tiling_makespan(bq: int, paired: bool, heads: int, sq: int, skv: int,
                    causal: bool, window: int, tile_us: float,
                    qtile_us: float) -> float:
    """Modelled card time of one tiling of a launch of ``heads`` (batch,
    head) pairs: each query tile costs ``tile_us`` per live kv tile and
    ``qtile_us`` if it has one, and the CTAs are issued in the kernel's
    order, heaviest first, one per SM (``__launch_bounds__(..., 1)``)."""
    n = -(-sq // bq)
    work = []
    for iq in range(n):
        live = len(live_tiles(iq, sq, skv, causal=causal, window=window,
                              bq=bq))
        work.append(live * tile_us + (qtile_us if live else 0.0))
    g = FlashGeometry(bq, paired, n, heads, 0, 0.0)
    works = []
    for u in range(g.units):
        _, tiles = g.cta_tiles(u * heads)
        works += [sum(work[t] for t in tiles)] * heads
    return _makespan(works)


@functools.lru_cache(maxsize=None)
def flash_geometry(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
                   causal: bool, window: int,
                   itemsize: int = 4) -> FlashGeometry:
    """Pick the query-tile height and the pairing of query tiles for a
    launch from its shape alone: each candidate is costed by
    :func:`tiling_makespan` with :data:`TILE_US` and :data:`QTILE_US` of
    its element size; ties go to fewer CTAs.  The tiling changes only which
    CTA computes a row, never the row's summation order."""
    best = None
    for bq in BQ:
        for paired in (False, True):
            g = FlashGeometry(
                bq, paired, -(-sq // bq), b * hq, smem_bytes(bq, d, itemsize),
                tiling_makespan(bq, paired, b * hq, sq, skv, causal, window,
                                TILE_US[itemsize][bq],
                                QTILE_US[itemsize][bq]),
                tensor_cores=itemsize == 2)
            key = (round(g.makespan_us, 3), g.ctas)
            if best is None or key < best[0]:
                best = (key, g)
    return best[1]


def widened_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  wide_out: torch.Tensor, *, causal: bool = True,
                  window: int = 0, softcap: float = 0.0,
                  scale: float | None = None) -> torch.Tensor:
    """The worst-case |got - wide_out| (fp64, shaped like the output) of a
    bf16 launch ``got`` on bf16 ``q``, ``k``, ``v`` against ``wide_out``,
    the fp32 launch on the same operands widened.  Derived, not fitted:

    Both kernels see the same exact operands, and every product of two
    bf16 values is exact in fp32, so they differ only in their roundings.
    Write W for the exact softmax weights of a row (computed here in fp64),
    A = W @ |V| per output column, n the row's visible keys, T its largest
    |logit| in log2 units, and u = 2^-20 (a generous cover of one fp32
    rounding, 2^-24, and of ex2.approx's few ulps).

    1. The scores.  The FMA kernel sums d products in order with fmaf, the
       tensor cores in 16-wide steps in their own order with truncating
       accumulation: |s_tc - s_fp32| <= d 2^-22 sum_i |q_i k_i| = sigma_j
       (the GEMM's bound, k 2^-22 (|x| @ |w|), with k = d).  Scaled to
       log2 units (the softcap's tanh shrinks differences, never grows
       them) and with the roundings of the scaling, the subtraction of the
       running max and ex2 in both kernels, every unnormalised weight moves
       by a factor within 2^+-Delta, Delta = scale log2(e) max_j sigma_j
       (1 + u) + u (T + 4).  Normalised weights then move by a factor
       within 2^+-2Delta, and since sum_j (w'_j - w_j) = 0 the output moves
       by at most (2^(2 Delta) - 1) A.
    2. P's split.  hi = bf16(p) is within 2^-8 p of p and lo = bf16(p - hi)
       within 2^-8 |p - hi|, so hi + lo is within 2^-16 p of p: at most
       2^-16 2^(2 Delta) A on the output.
    3. The sums over keys and the running rescales: the FMA kernel adds n
       terms and rescales once a tile, the tensor cores add 2 n (hi and lo)
       in 16-wide truncating steps, both sum l over the keys and divide
       once: together within (n + 64) u A.
    4. The bf16 output is the fp32 result rounded once: one bf16 ulp of
       ``wide_out`` (half an ulp of the unrounded result, which can sit one
       binade higher).

    bound = ulp_bf16(wide_out) + A ((2^(2 Delta) - 1) + 2^-16 2^(2 Delta)
    + (n + 64) u).  A row that sees no key has A = 0: both write 0."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    f64 = torch.float64
    scale = float(scale if scale is not None else d ** -0.5)
    scale2 = scale * 1.4426950408889634
    qd = q.to(f64)
    kd, vd = (ref.repeat_kv(t, g).to(f64) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd)
    sigma = d * 2.0 ** -22 * torch.einsum("bqhd,bkhd->bhqk", qd.abs(),
                                          kd.abs())
    logits = s * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    u = 2.0 ** -20
    t2 = (logits * 1.4426950408889634).abs().masked_fill(~mask, 0.0)
    sig = sigma.masked_fill(~mask, 0.0)
    delta = (scale2 * sig.amax(-1) * (1 + u) + u * (t2.amax(-1) + 4))
    w = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    w = torch.nan_to_num(w, nan=0.0)                 # rows that see no key
    a = torch.einsum("bhqk,bkhd->bhqd", w, vd.abs())
    n = mask.sum(-1).to(f64)                          # (sq,)
    grow = torch.exp2(2 * delta)[..., None]           # (b, h, sq, 1)
    rel = (grow - 1) + 2.0 ** -16 * grow + ((n + 64) * u)[:, None]
    wide = wide_out.to(f64)
    ulp = torch.ldexp(torch.ones_like(wide), torch.frexp(wide)[1] - 8)
    return ulp + (a * rel).permute(0, 2, 1, 3)


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
