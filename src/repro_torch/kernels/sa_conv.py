"""SA-CONV GEMM — the output-stationary tiled matmul of the compute-bound
regime, as a hand-written CUDA kernel (``csrc/sa_conv.cu``) with its plain
PyTorch version.

``sa_conv_matmul`` computes ``act((x @ w) * w_scale + bias)`` for ``x``
(m, k) fp32 or bf16 and ``w`` (k, n) fp32, bf16 or int8 (int8 with a (1, n)
or (n,) per-column ``w_scale``): ``w`` rounded to ``x``'s dtype, fp32
accumulation, the epilogue once per output in fp32, written as
``out_dtype`` (fp32 or bf16, by default ``x``'s).  For a CPU tensor it
runs :func:`sa_conv_matmul_plain`; for a CUDA tensor it launches the
kernel on the current stream, or raises.  The planner's TPU tiles do not
reach the kernel: it runs 128 x 128 output tiles, and
:func:`gemm_geometry` mirrors its grid, shared memory, copies and
producer in Python so that the CPU tests reach them.  Ragged m, n and k
are masked inside the kernel: no padded copies.

fp32 ``x`` runs the FMA loop on the CUDA cores: every output's k sum in one
thread, in increasing k, one fmaf a term.  bf16 ``x`` runs on the tensor
cores: ``wgmma`` products of 16 k, in increasing k, into one fp32
accumulator an output (w rounded to bf16 first), fed by one of two
producers that write the same swizzled tiles: TMA where x and w are bf16
with 16-byte-aligned bases and rows (:func:`tma_ok`), cp.async otherwise
(odd widths or bases, fp32 and int8 weights).  Neither kernel splits k or
reads m to choose its tiling, so a row's result is bitwise the same in any
launch.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.sa_conv_implicit import SM_COUNT
from repro_torch.kernels.sa_fc import W_KINDS, X_KINDS, check_operands

#: the FMA kernel's tiling (csrc/sa_conv.cu's constants), fp32 x: a CTA of
#: THREADS threads owns BM x BN outputs, a thread 8 x 8 of them, PER_SM
#: CTAs share an SM (128 registers a thread); k advances BK per stage of a
#: ring of STAGES; the x tile is stored k-major with rows of AP floats
BM, BN, THREADS, PER_SM = 128, 128, 256, 2
BK, STAGES = 16, 4
AP = BM + 4
#: the tensor-core kernel's tiling, bf16 x: a CTA of TC_THREADS threads (two
#: consumer warpgroups of 64 rows, TC_CONSUMERS threads, and a producer
#: warpgroup) owns TC_BM x TC_BN outputs, one CTA an SM; k advances TC_BK
#: (128 bytes of bf16) per stage of a ring of TC_STAGES; fp32 and int8
#: weights land in TC_RAW_STAGES raw stages first; the ring starts at a
#: TC_ALIGN-byte boundary (the 128-byte swizzle's period)
TC_BM, TC_BN, TC_BK, TC_STAGES, TC_RAW_STAGES = 128, 128, 64, 4, 3
TC_CONSUMERS, TC_THREADS, TC_ALIGN = 256, 384, 1024
#: bytes per element of each operand kind (``W_KINDS``' codes)
W_BYTES = {0: 4, 1: 1, 2: 2}


def copy_bytes(row_bytes: int, address: int = 0) -> int:
    """The widest cp.async piece (16, 8 or 4 bytes) that a row length and
    a base address allow; 0 where the rows are not a multiple of 4 bytes
    (element loads).  csrc/sa_conv.cu refuses a width that does not divide
    both."""
    a = row_bytes | address
    return 16 if a % 16 == 0 else 8 if a % 8 == 0 else 4 if a % 4 == 0 else 0


def tma_ok(k: int, n: int, w_kind: int, x_address: int = 0,
           w_address: int = 0) -> bool:
    """Whether a bf16-x launch takes the TMA producer (csrc/sa_conv.cu
    ``tma_ok``): bf16 weights, k > 0, and x's and w's bases and rows
    16-byte aligned (k % 8 == 0, n % 8 == 0).  Otherwise the cp.async
    producer fills the same tiles."""
    return (w_kind == 2 and k > 0 and n > 0 and k % 8 == 0 and n % 8 == 0
            and x_address % 16 == 0 and w_address % 16 == 0)


def smem_bytes(w_kind: int, x_kind: int = 0) -> int:
    """Dynamic shared memory of a CTA.  fp32 x: the ring of STAGES stages
    of an x tile (BK x AP floats) and a w tile (BK x BN weights).  bf16 x:
    TC_ALIGN bytes of slack, the ring of TC_STAGES stages of a bf16 x tile
    (TC_BM x TC_BK) and a bf16 w tile (TC_BK x TC_BN), TC_RAW_STAGES raw w
    tiles for fp32 and int8 weights, and a full and an empty mbarrier (8
    bytes each) per stage."""
    if x_kind == 0:
        return STAGES * (BK * AP * 4 + BK * BN * W_BYTES[w_kind])
    raw = 0 if w_kind == 2 else TC_RAW_STAGES * TC_BK * TC_BN * W_BYTES[w_kind]
    return (TC_ALIGN + TC_STAGES * 2 * (TC_BM * TC_BK + TC_BK * TC_BN) + raw
            + 2 * TC_STAGES * 8)


@dataclasses.dataclass(frozen=True)
class GemmGeometry:
    """One launch's grid, tile and copies (all counts, no pointers).  CTA
    ``c`` owns rows ``(c % row_tiles) * bm`` on and columns ``(c //
    row_tiles) * bn`` on: the row tile is the fastest grid index, so the
    row tiles that share a w panel run together.  ``tensor_cores``: the
    wgmma kernel (bf16 x) rather than the FMA loop (fp32 x)."""
    row_tiles: int
    col_tiles: int
    smem_bytes: int             # dynamic shared memory per CTA
    x_copy: int                 # bytes per x copy (fp32: 4, transposed,
    #                             k-major; bf16: rows as they lie)
    w_copy: int                 # bytes per w copy for rows from an aligned base
    tensor_cores: bool = False
    producer: str = "cp.async"  # "tma" or "cp.async", from aligned bases
    bm: int = BM
    bn: int = BN
    bk: int = BK                # k per ring stage
    stages: int = STAGES
    threads: int = THREADS      # threads that own outputs
    per_sm: int = PER_SM        # CTAs an SM holds

    @property
    def ctas(self) -> int:
        return self.row_tiles * self.col_tiles

    @property
    def waves(self) -> float:
        """CTAs over the card's CTA slots (per_sm on each SM)."""
        return self.ctas / (SM_COUNT * self.per_sm)

    def cta_origin(self, cta: int) -> tuple[int, int]:
        """(first row, first column) of CTA ``cta``'s tile."""
        return (cta % self.row_tiles) * self.bm, \
            (cta // self.row_tiles) * self.bn

    def thread_outputs(self, t: int) -> tuple[list[int], list[int]]:
        """(rows, columns) of thread ``t``'s outputs within its CTA's tile,
        as csrc/sa_conv.cu lays them out.  FMA loop: warps 2 along m by 4
        along n, each 64 x 32; a thread rows ty..ty+3 and ty+32..ty+35,
        columns tx..tx+3 and tx+16..tx+19.  Tensor cores: wgmma's
        accumulator fragment; consumer warpgroup t // 128 owns 64 rows,
        its warp v rows 16 v + lane // 4 and that + 8, columns 8 j + 2
        (lane % 4) and that + 1 for every j."""
        warp, lane = divmod(t, 32)
        if self.tensor_cores:
            r = 64 * (t // 128) + 16 * (warp % 4) + lane // 4
            return [r, r + 8], [8 * j + 2 * (lane % 4) + e
                                for j in range(self.bn // 8) for e in (0, 1)]
        ty = (warp // 4) * 64 + (lane // 4) * 4
        tx = (warp % 4) * 32 + (lane % 4) * 4
        rows = [ty + i for i in range(4)] + [ty + 32 + i for i in range(4)]
        cols = [tx + e for e in range(4)] + [tx + 16 + e for e in range(4)]
        return rows, cols

    def k_order(self, k: int) -> list[int]:
        """The k index of every term an output's sum adds, in order:
        stage by stage, ``bk`` each, increasing (the tensor cores take them
        16 at a time); -1 for the zero-filled terms past k.  It depends on
        k and the kernel alone: not on m, n, the CTA or the thread."""
        steps = -(-k // self.bk) * self.bk
        return [i if i < k else -1 for i in range(steps)]


@functools.lru_cache(maxsize=1024)
def gemm_geometry(m: int, n: int, k: int, w_kind: int,
                  x_kind: int = 0) -> GemmGeometry:
    """The launch of ``(m, k) @ (k, n)`` with weights of kind ``w_kind``
    and activations of kind ``x_kind`` (``W_KINDS``' codes), from aligned
    bases.  fp32 x: the FMA loop, one CTA per 128 x 128 output tile, row
    tiles fastest, x in 4-byte copies, w in the widest copies its rows
    allow.  bf16 x: the tensor cores, one CTA per TC_BM x TC_BN tile, row
    tiles fastest, one CTA an SM, the TMA producer where :func:`tma_ok`
    holds and otherwise cp.async copies of 16 bytes where the rows allow,
    else 4, else elements (narrower still for an unaligned base: w's from
    the wrapper, x's in C).  Nothing here reads m but the row tiles."""
    w_copy = copy_bytes(n * W_BYTES[w_kind])
    smem = smem_bytes(w_kind, x_kind)
    if x_kind == 0:
        return GemmGeometry(-(-m // BM), -(-n // BN), smem, 4, w_copy)
    # the cp.async producer copies 16-byte pieces, else 4-byte ones (8-byte
    # rows included), else elements
    x_copy, w_copy = (16 if v == 16 else 4 if v else 0
                      for v in (copy_bytes(k * W_BYTES[x_kind]), w_copy))
    return GemmGeometry(
        -(-m // TC_BM), -(-n // TC_BN), smem, x_copy, w_copy,
        tensor_cores=True,
        producer="tma" if tma_ok(k, n, w_kind) else "cp.async",
        bm=TC_BM, bn=TC_BN, bk=TC_BK, stages=TC_STAGES,
        threads=TC_CONSUMERS, per_sm=1)


def sa_conv_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor | None = None, *,
                         act: str = "none",
                         w_scale: torch.Tensor | None = None,
                         out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return ref.matmul_bias_act(x, w, bias, act=act, out_dtype=out_dtype,
                               w_scale=w_scale)


def sa_conv_matmul(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None, *, act: str = "none",
                   w_scale: torch.Tensor | None = None,
                   out_dtype=None) -> torch.Tensor:
    """(m, k) @ (k, n) on the SA-CONV GEMM kernel, fused scale + bias +
    act."""
    if x.device.type == "cpu":
        return sa_conv_matmul_plain(x, w, bias, act=act, w_scale=w_scale,
                                    out_dtype=out_dtype)
    out_dtype, w_scale, bias = check_operands("sa_conv_matmul", x, w, bias,
                                              w_scale, out_dtype)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    w_kind = W_KINDS[w.dtype]
    lib = _build.load("sa_conv")
    err = lib.sa_conv_launch(
        x.data_ptr(), w.data_ptr(), w_kind, X_KINDS[x.dtype],
        X_KINDS[out_dtype],
        w_scale.data_ptr() if w_scale is not None else None,
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        m, k, n, BN, copy_bytes(n * w.element_size(), w.data_ptr()),
        _build.act_code(act),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "sa_conv_matmul")
    sa_conv_matmul.launches += 1
    if x.dtype == torch.bfloat16:
        sa_conv_matmul.producers["tma" if tma_ok(
            k, n, w_kind, x.data_ptr(), w.data_ptr()) else "cp.async"] += 1
    return out


def kernel_producer(x: torch.Tensor, w: torch.Tensor) -> str:
    """The producer the built kernel gives a launch on ``x`` and ``w``
    (CUDA tensors): ``"tma"`` or ``"cp.async"`` for bf16 x, ``"fma"`` for
    fp32 x -- what :func:`tma_ok` must derive."""
    got = _build.load("sa_conv").sa_conv_producer(
        x.data_ptr(), w.data_ptr(), W_KINDS[w.dtype], X_KINDS[x.dtype],
        x.shape[1], w.shape[1])
    return {1: "tma", 0: "cp.async", -1: "fma"}[got]


def reset_producers() -> None:
    """Zero the bf16-x launches counted per producer."""
    sa_conv_matmul.producers = {"tma": 0, "cp.async": 0}


sa_conv_matmul.launches = 0
#: bf16-x launches per producer (the tensor-core kernel's), beside
#: ``launches``, which counts every launch
reset_producers()
