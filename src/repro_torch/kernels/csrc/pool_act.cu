// Pooling-&-activation unit on Hopper: out = act(maxpool(x)), NHWC VALID
// max pool with a square window and stride, for float32, int8, uint8 and
// int32 maps.
//
// Replaces: src/repro/kernels/pool_act.py::maxpool_act (Pallas body
// _pool_act_kernel), the pool that runs on its own whenever the planner
// declines to fuse it into the conv epilogue.
//
// What bounds it on this card: bytes.  It reads each input once (window^2
// reads per output, mostly from L1/L2 when windows overlap) and writes the
// pooled map once; there is no arithmetic to speak of.
//
// What the design does about it: one thread per output element with the
// channel index fastest, so a warp reads and writes consecutive addresses
// of each NHWC row.  No channel tiles and no padding: the reference padded
// channels to a 128-lane tile with the dtype's max identity; here every
// window starts from its own first element, so no identity is needed and
// any channel count works.  The window is scanned in (dp, dq) order with a
// strict '>' compare — the same scan as the conv kernel's fused pool, so
// conv -> this kernel equals the fused epilogue bitwise for monotone acts.
#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T act_of(T v, int act) {
  return v > T(0) ? v : T(0);       // integer maps: relu (the wrapper admits none/relu)
}
template <>
__device__ __forceinline__ float act_of<float>(float v, int act) {
  return apply_act(v, act);
}

template <typename T>
__global__ void pool_act_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w, int c,
                                int oh, int ow, int window, int stride, int act, size_t total) {
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(idx % c);
    size_t rest = idx / c;
    const int ox = static_cast<int>(rest % ow);
    rest /= ow;
    const int oy = static_cast<int>(rest % oh);
    const size_t img = rest / oh;
    const T* base = x + ((img * h + static_cast<size_t>(oy) * stride) * w +
                         static_cast<size_t>(ox) * stride) * c + ch;
    T m = base[0];
    for (int dp = 0; dp < window; ++dp)
      for (int dq = 0; dq < window; ++dq) {
        const T v = base[(static_cast<size_t>(dp) * w + dq) * c];
        m = v > m ? v : m;
      }
    out[idx] = act == ACT_NONE ? m : act_of<T>(m, act);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int n, int h, int w, int c, int window, int stride,
                   int act, cudaStream_t stream) {
  const int oh = (h - window) / stride + 1, ow = (w - window) / stride + 1;
  const size_t total = static_cast<size_t>(n) * oh * ow * c;
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > (1u << 20)) blocks = 1u << 20;          // grid-stride beyond this
  pool_act_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), h, w, c, oh, ow, window, stride, act,
      total);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 int8, 2 uint8, 3 int32.  Returns cudaGetLastError().
extern "C" int pool_act_launch(const void* x, void* out, int dtype, int n, int h, int w, int c,
                               int window, int stride, int act, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, out, n, h, w, c, window, stride, act, st);
    case 1: return launch<int8_t>(x, out, n, h, w, c, window, stride, act, st);
    case 2: return launch<uint8_t>(x, out, n, h, w, c, window, stride, act, st);
    case 3: return launch<int32_t>(x, out, n, h, w, c, window, stride, act, st);
    default: return cudaErrorInvalidValue;
  }
}
