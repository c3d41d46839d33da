"""Pooling-&-activation unit — NHWC VALID maxpool then activation, as a
hand-written CUDA kernel (``csrc/pool_act.cu``) with its plain PyTorch
version (:func:`repro_torch.kernels.ref.maxpool_act`).

For a CPU tensor :func:`maxpool_act` runs the plain version; for a CUDA
tensor it launches the kernel on the current stream, or raises.  float32,
bfloat16, int8, uint8 and int32 maps are supported; integer maps take
``none`` or ``relu``.  A bf16 max is exact; its act runs in fp32 and is
rounded once.  :func:`pool_geometry` is the launch's geometry (the channel
vector a thread owns and the grid), in Python so that the CPU tests can
check it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.int8: 1, torch.uint8: 2, torch.int32: 3,
           torch.bfloat16: 4}
_FLOATS = (torch.float32, torch.bfloat16)

#: threads of a CTA (csrc/pool_act.cu's THREADS)
THREADS = 256
#: windows the kernel unrolls (VGG-16's and AlexNet's pools); any other
#: window runs the same order of maxes in runtime loops
UNROLLED = (2, 3)
#: vector widths in bytes, widest first (one element is the last resort)
VEC_BYTES = (16, 8, 4)
#: bytes of a per-image offset the kernel computes in 32 bits
MAX_IMAGE_BYTES = 2**31 - 1
#: images of one launch (the grid's y extent)
MAX_IMAGES = 65535


@dataclass(frozen=True)
class PoolGeometry:
    """How ``csrc/pool_act.cu`` covers an (n, h, w, c) map: a thread owns
    ``vec_bytes`` of channels of one output; the threads of an image are
    numbered with the channel vector fastest, then the output column, then
    the output row, in CTAs of :data:`THREADS`; the grid's y is the
    image."""
    n: int
    h: int
    w: int
    c: int
    itemsize: int
    window: int
    stride: int
    vec_bytes: int

    @property
    def oh(self) -> int:
        return (self.h - self.window) // self.stride + 1

    @property
    def ow(self) -> int:
        return (self.w - self.window) // self.stride + 1

    @property
    def vecs(self) -> int:
        """Channel vectors of a pixel."""
        return self.c * self.itemsize // self.vec_bytes

    @property
    def per_image(self) -> int:
        """Threads of one image."""
        return self.oh * self.ow * self.vecs

    @property
    def blocks(self) -> int:
        """CTAs of one image (the grid's x)."""
        return -(-self.per_image // THREADS)

    @property
    def grid(self) -> tuple[int, int]:
        return self.blocks, self.n

    def outputs(self):
        """``(vector, output row, output column)`` of every thread of one
        image, as the kernel decodes its index (numpy arrays)."""
        t = np.arange(self.per_image, dtype=np.int64)
        px = t // self.vecs
        return t % self.vecs, px // self.ow, px % self.ow


def vector_bytes(c: int, itemsize: int, base_align: int) -> int:
    """The widest vector that divides a pixel's bytes and the base
    address's alignment; one element where none does."""
    for v in VEC_BYTES:
        if v >= itemsize and (c * itemsize) % v == 0 and base_align % v == 0:
            return v
    return itemsize


def pool_geometry(n: int, h: int, w: int, c: int, itemsize: int, window: int,
                  stride: int, base_align: int) -> PoolGeometry:
    """The kernel's geometry for an (n, h, w, c) map of ``itemsize``-byte
    elements whose base address is aligned to ``base_align`` bytes: the
    widest vector that the pixel's bytes and the base allow, one output a
    thread."""
    return PoolGeometry(n, h, w, c, itemsize, window, stride,
                        vector_bytes(c, itemsize, base_align))


def _alignment(ptr: int) -> int:
    return ptr & -ptr if ptr else 1 << 30


def maxpool_act(x: torch.Tensor, *, window: int = 2, stride: int = 2,
                act: str = "relu") -> torch.Tensor:
    """(N, H, W, C) -> (N, OH, OW, C): max over each window, then act."""
    if x.device.type == "cpu":
        return ref.maxpool_act(x, window=window, stride=stride, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"maxpool_act: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"maxpool_act: expected NHWC, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"maxpool_act: dtype {x.dtype} not supported")
    if x.dtype not in _FLOATS and act not in ("none", "relu"):
        raise ValueError(f"maxpool_act: act {act!r} on an integer map")
    if not x.is_contiguous():
        raise ValueError("maxpool_act: x must be contiguous")
    n, h, w, c = x.shape
    if window < 1 or stride < 1 or h < window or w < window:
        raise ValueError(f"maxpool_act: window {window} stride {stride} on "
                         f"{(h, w)}")
    if n > MAX_IMAGES or h * w * c * x.element_size() > MAX_IMAGE_BYTES:
        raise ValueError(f"maxpool_act: {tuple(x.shape)} is more than the "
                         f"kernel takes ({MAX_IMAGES} images of < 2 GiB)")
    oh = (h - window) // stride + 1
    ow = (w - window) // stride + 1
    out = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    g = pool_geometry(n, h, w, c, x.element_size(), window, stride,
                      min(_alignment(x.data_ptr()),
                          _alignment(out.data_ptr())))
    lib = _build.load("pool_act")
    err = lib.pool_act_launch(
        x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], n, h, w, c, window,
        stride, _build.act_code(act), g.vec_bytes, g.blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "maxpool_act")
    maxpool_act.launches += 1
    return out


maxpool_act.launches = 0
