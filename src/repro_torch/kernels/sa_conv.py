"""SA-CONV GEMM — the output-stationary tiled matmul of the compute-bound
regime, as a hand-written CUDA kernel (``csrc/sa_conv.cu``) with its plain
PyTorch version.

``sa_conv_matmul`` computes ``act((x @ w) * w_scale + bias)`` for ``x``
(m, k) fp32 or bf16 and ``w`` (k, n) fp32, bf16 or int8 (int8 with a (1, n)
or (n,) per-column ``w_scale``): ``w`` rounded to ``x``'s dtype, fp32
accumulation, the epilogue once per output in fp32, written as
``out_dtype`` (fp32 or bf16, by default ``x``'s).  For a CPU tensor it
runs :func:`sa_conv_matmul_plain`; for a CUDA tensor it launches the
kernel on the current stream, or raises.  The
planner's TPU tiles do not reach the kernel: it runs 128 x 128 output
tiles, and :func:`gemm_geometry` mirrors its grid, shared memory and copy
widths in Python so that the CPU tests reach them.  Ragged m, n and k are masked inside the kernel: no padded copies.

Every output's k sum runs in one thread, in increasing k, whatever m, so
a row's result is bitwise the same in any launch.  With bf16 ``x``, x and
w are widened to fp32 in shared memory (w rounded to bf16 first) before
the same k loop, so the result is the fp32 launch's on the widened
operands, rounded once; it does not use the tensor cores yet.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.sa_conv_implicit import SM_COUNT
from repro_torch.kernels.sa_fc import W_KINDS, X_KINDS, check_operands

#: the kernel's tiling (csrc/sa_conv.cu's constants): a CTA of THREADS
#: threads owns BM x BN outputs, a thread 8 x 8 of them, PER_SM CTAs share
#: an SM (128 registers a thread); k advances BK per stage of a ring of
#: STAGES (STAGES_BF16 with bf16 x); the x tile is stored k-major with rows
#: of AP floats; bf16 x is staged as it lies, rows XRP bytes apart
BM, BN, THREADS, PER_SM = 128, 128, 256, 2
BK, STAGES, STAGES_BF16 = 16, 4, 5
AP = BM + 4
XRP = 48
#: bytes per element of each operand kind (``W_KINDS``' codes)
W_BYTES = {0: 4, 1: 1, 2: 2}


def copy_bytes(row_bytes: int, address: int = 0) -> int:
    """The widest cp.async piece (16, 8 or 4 bytes) that a row length and
    a base address allow; 0 where the rows are not a multiple of 4 bytes
    (element loads).  csrc/sa_conv.cu refuses a width that does not divide
    both."""
    a = row_bytes | address
    return 16 if a % 16 == 0 else 8 if a % 8 == 0 else 4 if a % 4 == 0 else 0


def smem_bytes(w_kind: int, x_kind: int = 0) -> int:
    """Dynamic shared memory of a CTA: the ring of STAGES stages of an x
    tile (BK x AP floats) and a w tile (BK x BN weights); with bf16 x, a
    ring of STAGES_BF16 stages of BM staged x rows and a w tile, then two
    x and two w tiles widened to fp32."""
    w_tile = BK * BN * W_BYTES[w_kind]
    if x_kind == 0:
        return STAGES * (BK * AP * 4 + w_tile)
    return STAGES_BF16 * (BM * XRP + w_tile) + 2 * BK * (AP + BN) * 4


@dataclasses.dataclass(frozen=True)
class GemmGeometry:
    """One launch's grid and copies (all counts, no pointers).  CTA ``c``
    owns rows ``(c % row_tiles) * BM`` on and columns ``(c // row_tiles) *
    BN`` on: the row tile is the fastest grid index, so the row tiles that
    share a w panel run together."""
    row_tiles: int
    col_tiles: int
    smem_bytes: int             # dynamic shared memory per CTA
    x_copy: int                 # bytes per x copy (fp32: 4, transposed,
    #                             k-major; bf16: rows as they lie)
    w_copy: int                 # bytes per w copy for rows from an aligned base

    @property
    def ctas(self) -> int:
        return self.row_tiles * self.col_tiles

    @property
    def waves(self) -> float:
        """CTAs over the card's CTA slots (PER_SM on each SM)."""
        return self.ctas / (SM_COUNT * PER_SM)

    def cta_origin(self, cta: int) -> tuple[int, int]:
        """(first row, first column) of CTA ``cta``'s tile."""
        return (cta % self.row_tiles) * BM, (cta // self.row_tiles) * BN

    @staticmethod
    def thread_outputs(t: int) -> tuple[list[int], list[int]]:
        """(rows, columns) of thread ``t``'s outputs within its CTA's tile,
        as csrc/sa_conv.cu lays them out: warps 2 along m by 4 along n,
        each 64 x 32; a thread rows ty..ty+3 and ty+32..ty+35, columns
        tx..tx+3 and tx+16..tx+19."""
        warp, lane = divmod(t, 32)
        ty = (warp // 4) * 64 + (lane // 4) * 4
        tx = (warp % 4) * 32 + (lane % 4) * 4
        rows = [ty + i for i in range(4)] + [ty + 32 + i for i in range(4)]
        cols = [tx + e for e in range(4)] + [tx + 16 + e for e in range(4)]
        return rows, cols

    @staticmethod
    def k_order(k: int) -> list[int]:
        """The k index of every term an output's thread adds, in order:
        stage by stage, BK each, increasing; -1 for the zero-filled terms
        past k.  It depends on k alone: not on m, n, the CTA or the
        thread."""
        steps = -(-k // BK) * BK
        return [i if i < k else -1 for i in range(steps)]


@functools.lru_cache(maxsize=1024)
def gemm_geometry(m: int, n: int, k: int, w_kind: int,
                  x_kind: int = 0) -> GemmGeometry:
    """The launch of ``(m, k) @ (k, n)`` with weights of kind ``w_kind``
    and activations of kind ``x_kind`` (``W_KINDS``' codes): one CTA per
    128 x 128 output tile, row tiles fastest; fp32 x in 4-byte copies,
    bf16 x and w in the widest copies their row lengths allow (narrower
    still for an unaligned base: w's from the wrapper, x's in C)."""
    x_copy = 4 if x_kind == 0 else copy_bytes(k * W_BYTES[x_kind])
    return GemmGeometry(-(-m // BM), -(-n // BN), smem_bytes(w_kind, x_kind),
                        x_copy, copy_bytes(n * W_BYTES[w_kind]))


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
    return out


sa_conv_matmul.launches = 0
