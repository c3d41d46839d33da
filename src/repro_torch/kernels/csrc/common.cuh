// Shared device helpers of the port's kernels: the activation epilogue,
// operand widening, the error string the ctypes wrappers report, and the
// pieces of Hopper's asynchronous pipeline that the tensor-core kernels
// (sa_conv.cu, attention.cu) share: mbarriers, wgmma descriptors and
// tensor maps for TMA.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Activation codes; repro_torch/kernels/_build.py holds the same table.
enum Act : int { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2, ACT_SILU = 3, ACT_GELU = 4 };

// NaN test on the bits: a compare such as x != x may be folded away under
// fast-math flags, a test of the bit pattern cannot.
__device__ __forceinline__ bool is_nan(float x) {
  return (__float_as_uint(x) & 0x7fffffffu) > 0x7f800000u;
}

// NaN goes through every activation, as in the reference (jax.nn.relu(NaN)
// is NaN): relu is max.NaN (NaN if x is NaN, else max(x, +0)), one
// instruction that no compiler flag folds away, where a compare and select
// changed SA-FC's register allocation and slowed it (PERF.md §6);
// leaky relu, silu and gelu propagate NaN by their arithmetic.
__device__ __forceinline__ float apply_act(float x, int act) {
  switch (act) {
    case ACT_RELU: {
      float r;
      asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(x));
      return r;
    }
    case ACT_LEAKY:                       // slope 0.1, as jax.nn.leaky_relu is called
      return x >= 0.f ? x : __fmul_rn(0.1f, x);
    case ACT_SILU:
      return x / (1.f + expf(-x));
    case ACT_GELU: {                      // the tanh form (jax.nn.gelu's default)
      const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.f + tanhf(inner));
    }
    default:
      return x;
  }
}

// The max rule of every pool window, standalone (pool_act.cu) and fused
// (sa_conv_implicit.cu): fold v, the later element in (dp, dq) order, into
// m.  NaN if either is NaN, as the reference's jnp.maximum gives; otherwise
// the first maximum (a strict '>'), so a tie of +0 and -0 keeps the earlier
// zero.  Both kernels apply it in an order that gives the same bits.
__device__ __forceinline__ float pool_max(float m, float v) {
  return v > m || is_nan(v) ? v : m;
}

// Epilogue of both GEMM-like kernels: (acc * scale) + bias, each rounded on
// its own (no fused multiply-add), the operation order of the plain version.
__device__ __forceinline__ float scale_bias(float acc, const float* scale, const float* bias,
                                            int col) {
  if (scale != nullptr) acc = __fmul_rn(acc, scale[col]);
  if (bias != nullptr) acc = __fadd_rn(acc, bias[col]);
  return acc;
}

// Operand type codes of the GEMM-like entry points (kernels/sa_fc.py
// W_KINDS holds the same) and their bytes per element.
enum Kind : int { KIND_F32 = 0, KIND_I8 = 1, KIND_BF16 = 2 };
constexpr int KIND_BYTES[] = {4, 1, 2};

// v rounded to bf16 (to nearest even) and widened back: an fp32 weight
// meeting bf16 activations, as the reference's w.astype(x.dtype) rounds it.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One output in the kernel's output type, rounded once to nearest even.
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// Hopper's asynchronous pipeline (sm_90a)
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed.  A wait
// that lasts 10 s traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned long long t0 = 0;
  for (unsigned i = 0;; ++i) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((i & 1023u) == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (i == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// A wgmma shared-memory descriptor, 128-byte swizzle: the start address,
// the leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ unsigned long long wgmma_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (static_cast<unsigned long long>(lbo >> 4) << 16) |
         (static_cast<unsigned long long>(sbo >> 4) << 32) | (1ull << 62);
}

// Keep the accumulators in their registers across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

namespace {

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (libcuda is not linked); null where the query finds none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
