// Pooling-&-activation unit on Hopper: out = act(maxpool(x)), NHWC VALID
// max pool with a square window and stride, for float32, bf16, int8, uint8
// and int32 maps.
//
// Replaces: src/repro/kernels/pool_act.py::maxpool_act (Pallas body
// _pool_act_kernel), the pool that runs on its own whenever the planner
// declines to fuse it into the conv epilogue.
//
// What bounds it on this card: bytes.  Each input byte is needed once and
// each pooled byte written once; a max per element is all the arithmetic.
//
// What the design does about it:
// - One lane owns one channel vector of VB bytes of one output: 16 (4 fp32
//   or int32, 16 int8 or uint8) where c * itemsize and the base address
//   allow it, else 8, 4 or one element.  VB is a template parameter of this
//   kernel, chosen by the wrapper from the shape and the pointer; int8 and
//   uint8 words are maxed four bytes at a time (__vmaxs4, __vmaxu4), bf16
//   words two halves at a time: each half widened to fp32 (exact), the
//   max taken by pool_max and the half it picked kept, so the max is
//   exact; the act runs in fp32 and rounds once to bf16 (bitwise the
//   reference's for none and relu).
//   Neighbouring lanes read neighbouring vectors of a pixel, so every load
//   and store is coalesced, and the card's thousands of resident lanes keep
//   enough bytes in flight.
// - A 2x2 or 3x3 window (VGG-16's and AlexNet's pools, any stride) is
//   unrolled: the lane issues all its read-only loads, row by row, before
//   the first max.  Any other window runs the same order in runtime loops.
// - The order of the maxes: the max over dq within each window row first,
//   then the row maxes folded in increasing dp.  The result must be the
//   bits of the one-element scan in (dp, dq) order with pool_max
//   (common.cuh), which the fused epilogue of sa_conv_implicit.cu runs, so
//   that conv -> this kernel equals the fused pool bitwise.  pool_max gives
//   NaN if any element is NaN (the last NaN in scan order, here too) and
//   otherwise the first maximum.  Row maxes folded in increasing dp give
//   the first maximum of the first row that holds the window's maximum,
//   which is the scan's first maximum.  Columns reduced first would not: a
//   2x2 window of -1, +0 over -0, x can flip the sign of the zero.
// - Index math in 32 bits per image, with one 64-bit image offset
//   (blockIdx.y) per thread.
// - Overlapping windows (3/2) read an input vector from up to four lanes;
//   L1 and L2 serve the repeats.  Tiles of several outputs a thread that
//   load each input row once were measured and lost at every AlexNet and
//   VGG-16 map (PERF.md §6), so a thread owns one output.
// - No shared memory: a streaming pass.
// The geometry (VB and the grid) comes from
// repro_torch/kernels/pool_act.py::pool_geometry; the launch refuses one it
// does not take.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// The element type's max and activation on one 32-bit word of a vector.
template <typename T>
struct WordOps;
template <>
struct WordOps<float> {
  static __device__ __forceinline__ uint32_t max(uint32_t m, uint32_t v) {
    return __float_as_uint(pool_max(__uint_as_float(m), __uint_as_float(v)));
  }
  static __device__ __forceinline__ uint32_t act(uint32_t v, int act) {
    return __float_as_uint(apply_act(__uint_as_float(v), act));
  }
};
template <>
struct WordOps<__nv_bfloat16> {   // two bf16 a word, the first in the low half
  static __device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
  static __device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
  // pool_max's rule on each half: v's half where it is greater or NaN
  static __device__ __forceinline__ bool takes(float m, float v) { return v > m || is_nan(v); }
  static __device__ __forceinline__ uint32_t max(uint32_t m, uint32_t v) {
    const uint32_t l = takes(lo(m), lo(v)) ? v : m;
    const uint32_t h = takes(hi(m), hi(v)) ? v : m;
    return (l & 0xffffu) | (h & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t act(uint32_t v, int act) {
    const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(apply_act(lo(v), act)));
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(apply_act(hi(v), act)));
    return l | (h << 16);
  }
};
template <>
struct WordOps<int32_t> {   // integer maps take none or relu (the wrapper checks)
  static __device__ __forceinline__ uint32_t max(uint32_t m, uint32_t v) {
    return static_cast<int32_t>(v) > static_cast<int32_t>(m) ? v : m;
  }
  static __device__ __forceinline__ uint32_t act(uint32_t v, int) {
    return static_cast<int32_t>(v) > 0 ? v : 0u;
  }
};
template <>
struct WordOps<int8_t> {
  static __device__ __forceinline__ uint32_t max(uint32_t m, uint32_t v) {
    return __vmaxs4(m, v);
  }
  static __device__ __forceinline__ uint32_t act(uint32_t v, int) { return __vmaxs4(v, 0u); }
};
template <>
struct WordOps<uint8_t> {
  static __device__ __forceinline__ uint32_t max(uint32_t m, uint32_t v) {
    return __vmaxu4(m, v);
  }
  static __device__ __forceinline__ uint32_t act(uint32_t v, int) { return v; }
};

// A channel vector of VB bytes as 32-bit words; a one- or two-byte vector
// sits in the low bytes of one word (bytewise and halfwise maxes leave the
// others out of it).
template <int VB>
struct Vec {
  static constexpr int kWords = VB >= 4 ? VB / 4 : 1;
  uint32_t w[kWords];
};

template <int VB>
__device__ __forceinline__ Vec<VB> load_vec(const char* p) {
  Vec<VB> r;
  if constexpr (VB == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = u.x, r.w[1] = u.y, r.w[2] = u.z, r.w[3] = u.w;
  } else if constexpr (VB == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = u.x, r.w[1] = u.y;
  } else if constexpr (VB == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (VB == 2) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    r.w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
  }
  return r;
}

template <int VB>
__device__ __forceinline__ void store_vec(char* p, const Vec<VB>& v) {
  if constexpr (VB == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else if constexpr (VB == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v.w[0], v.w[1]);
  } else if constexpr (VB == 4) {
    *reinterpret_cast<unsigned int*>(p) = v.w[0];
  } else if constexpr (VB == 2) {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(v.w[0]);
  } else {
    *reinterpret_cast<unsigned char*>(p) = static_cast<unsigned char>(v.w[0]);
  }
}

template <typename T, int VB>
__device__ __forceinline__ Vec<VB> vmax(const Vec<VB>& m, const Vec<VB>& v) {
  Vec<VB> r;
#pragma unroll
  for (int i = 0; i < Vec<VB>::kWords; ++i) r.w[i] = WordOps<T>::max(m.w[i], v.w[i]);
  return r;
}

template <typename T, int VB>
__device__ __forceinline__ Vec<VB> vact(Vec<VB> v, int act) {
  if (act != ACT_NONE) {
#pragma unroll
    for (int i = 0; i < Vec<VB>::kWords; ++i) v.w[i] = WordOps<T>::act(v.w[i], act);
  }
  return v;
}

struct PoolArgs {
  const char* x;
  char* out;
  long long img_in, img_out;  // bytes of one input and one output image
  int pix;                    // bytes of a pixel: c * itemsize
  int row;                    // bytes of an input row: w * pix
  int vecs;                   // channel vectors of a pixel: pix / VB
  int ow, win, str;
  int per_image;              // threads of one image: oh * ow * vecs
  int act;
};

// WIN == 0: any window, in runtime loops.
template <typename T, int VB, int WIN>
__global__ void __launch_bounds__(THREADS) pool_act_kernel(const PoolArgs a) {
  using V = Vec<VB>;
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= a.per_image) return;
  const int cv = t % a.vecs, px = t / a.vecs;
  const int ox = px % a.ow, oy = px / a.ow;
  const char* x =
      a.x + blockIdx.y * a.img_in + (oy * a.str * a.row + ox * a.str * a.pix + cv * VB);
  V acc;
  if constexpr (WIN == 0) {
    auto row_max = [&](const char* xr) {
      V rm = load_vec<VB>(xr);
      for (int dq = 1; dq < a.win; ++dq) rm = vmax<T, VB>(rm, load_vec<VB>(xr + dq * a.pix));
      return rm;
    };
    acc = row_max(x);
    for (int dp = 1; dp < a.win; ++dp) acc = vmax<T, VB>(acc, row_max(x + dp * a.row));
  } else {
    V v[WIN][WIN];
#pragma unroll
    for (int dp = 0; dp < WIN; ++dp)
#pragma unroll
      for (int dq = 0; dq < WIN; ++dq) v[dp][dq] = load_vec<VB>(x + dp * a.row + dq * a.pix);
#pragma unroll
    for (int dp = 0; dp < WIN; ++dp) {
      V rm = v[dp][0];
#pragma unroll
      for (int dq = 1; dq < WIN; ++dq) rm = vmax<T, VB>(rm, v[dp][dq]);
      acc = dp == 0 ? rm : vmax<T, VB>(acc, rm);
    }
  }
  store_vec<VB>(a.out + blockIdx.y * a.img_out + (px * a.pix + cv * VB), vact<T, VB>(acc, a.act));
}

template <typename T, int VB>
cudaError_t by_window(const PoolArgs& a, int blocks, int n, cudaStream_t st) {
  const dim3 grid(blocks, n);
  switch (a.win) {
    case 2: pool_act_kernel<T, VB, 2><<<grid, THREADS, 0, st>>>(a); break;
    case 3: pool_act_kernel<T, VB, 3><<<grid, THREADS, 0, st>>>(a); break;
    default: pool_act_kernel<T, VB, 0><<<grid, THREADS, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_vector(const PoolArgs& a, int vec_bytes, int blocks, int n, cudaStream_t st) {
  switch (vec_bytes) {
    case 16: return by_window<T, 16>(a, blocks, n, st);
    case 8: return by_window<T, 8>(a, blocks, n, st);
    case 4: return by_window<T, 4>(a, blocks, n, st);
    case 2:
      if constexpr (sizeof(T) == 2) return by_window<T, 2>(a, blocks, n, st);
      return cudaErrorInvalidValue;
    case 1:
      if constexpr (sizeof(T) == 1) return by_window<T, 1>(a, blocks, n, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 int8, 2 uint8, 3 int32, 4 bf16.  vec_bytes and blocks are
// pool_geometry's; a geometry the kernel does not take returns
// cudaErrorInvalidValue (the host's geometry disagrees) before any launch.
// Returns cudaGetLastError().
extern "C" int pool_act_launch(const void* x, void* out, int dtype, int n, int h, int w, int c,
                               int window, int stride, int act, int vec_bytes, int blocks,
                               void* stream) {
  static const int kItem[] = {4, 1, 1, 4, 2};
  if (dtype < 0 || dtype > 4 || n < 1 || n > 65535 || window < 1 || stride < 1 || h < window ||
      w < window || c < 1 || vec_bytes < 1)
    return cudaErrorInvalidValue;
  const int item = kItem[dtype];
  const long long pix = static_cast<long long>(c) * item;
  const int oh = (h - window) / stride + 1, ow = (w - window) / stride + 1;
  if (vec_bytes < item || pix % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(x) % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(out) % vec_bytes != 0)
    return cudaErrorInvalidValue;
  const long long img_in = pix * h * w;
  const long long per_image = static_cast<long long>(oh) * ow * (pix / vec_bytes);
  if (img_in >= (1ll << 31) || blocks != (per_image + THREADS - 1) / THREADS)
    return cudaErrorInvalidValue;
  PoolArgs a;
  a.x = static_cast<const char*>(x);
  a.out = static_cast<char*>(out);
  a.img_in = img_in, a.img_out = pix * oh * ow;
  a.pix = static_cast<int>(pix);
  a.row = static_cast<int>(pix * w);
  a.vecs = static_cast<int>(pix / vec_bytes);
  a.ow = ow, a.win = window, a.str = stride;
  a.per_image = static_cast<int>(per_image);
  a.act = act;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_vector<float>(a, vec_bytes, blocks, n, st);
    case 1: return by_vector<int8_t>(a, vec_bytes, blocks, n, st);
    case 2: return by_vector<uint8_t>(a, vec_bytes, blocks, n, st);
    case 3: return by_vector<int32_t>(a, vec_bytes, blocks, n, st);
    default: return by_vector<__nv_bfloat16>(a, vec_bytes, blocks, n, st);
  }
}

// The dynamic shared memory pool_act_launch passes for a map of type dtype
// read in vec_bytes vectors (as it takes them): 0, the kernel is a
// streaming pass; -1 where it has no instantiation.  What
// repro_torch/analysis/launch.py derives, asked of the built kernel.
extern "C" int pool_act_smem(int dtype, int vec_bytes) {
  static const int kItem[] = {4, 1, 1, 4, 2};
  if (dtype < 0 || dtype > 4) return -1;
  if (vec_bytes == 16 || vec_bytes == 8 || vec_bytes == 4) return 0;
  return vec_bytes == kItem[dtype] && vec_bytes < 4 ? 0 : -1;
}
