// Shared device helpers of the port's kernels: the activation epilogue,
// operand widening, and the error string the ctypes wrappers report.
#pragma once

#include <cstddef>
#include <cstdint>
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

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
