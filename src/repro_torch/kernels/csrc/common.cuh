// Shared device helpers of the port's kernels: the activation epilogue,
// operand widening, the error string the ctypes wrappers report, cp.async,
// and the pieces of Hopper's asynchronous pipeline that the tensor-core
// kernels (sa_conv.cu, sa_conv_implicit.cu, attention.cu) share: mbarriers,
// TMA loads, wgmma and its descriptors, tensor maps, the shared-memory
// opt-in.
#pragma once

#include <atomic>
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

// One output in the kernel's output type, rounded once to nearest even.
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// cp.async of V bytes (16 through L2 only, 8 or 4 through L1), the bytes
// past src_bytes zero-filled.
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(V),
                 "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

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

// A 2-d TMA load of one box at coordinates (c0, c1) into shared memory,
// completing on the mbarrier at `bar`.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, unsigned bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// Generic-proxy writes (cp.async, st.shared) before the tensor cores read them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A (64 x 16, K-major) @ B (16 x 128, MN-major), fp32 accumulators.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], unsigned long long a,
                                                 unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}
// d += A (64 x 16, K-major) @ B (16 x 64, MN-major), fp32 accumulators.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], unsigned long long a,
                                                unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
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

// The tensor map of a row-major bf16 (rows, cols) matrix read in boxes of
// 64 columns (128 bytes) by box_rows rows, 128-byte swizzle, zeros out of
// bounds.
inline bool encode_bf16(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The shared-memory opt-in is a property of the device's context: set it
// once per device (bit d of `opted`), not on every launch.
template <typename K>
cudaError_t opt_in(K kern, int smem, std::atomic<unsigned long long>& opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if ((opted.load(std::memory_order_acquire) & bit) == 0 || bit == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
