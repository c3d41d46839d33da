// SA-FC on Hopper: out = act((x @ w) * scale + bias), x (b, k) fp32,
// w (k, n) fp32, bf16 or int8, fp32 accumulation.
//
// Replaces: src/repro/kernels/sa_fc.py::sa_fc_matmul (Pallas body
// _sa_fc_kernel), the batch-amortized weight stream of the paper's SA-FC
// array.
//
// What bounds it on this card: the weight stream.  At serving batches the
// k*n weight bytes dominate every other operand, so below b ~ 40 (fp32) the
// kernel can go no faster than k*n*itemsize / memory bandwidth; above it the
// fp32 FMA rate (no TF32: fp32 means fp32) takes over.
//
// What the design does about it:
//  * Each CTA owns BN = 16 output columns (n = 4096 gives 256 CTAs, enough
//    for all 132 SMs) and streams its (k, 16) slice of w exactly once per
//    batch tile of up to RB = 64 rows; a serving wave of 64 is one tile, so
//    every weight byte crosses memory once per wave.  Weights go straight
//    from global memory into registers (each is used by one thread only),
//    prefetched one chunk ahead so their latency hides behind the FMAs;
//    int8 and bf16 are widened in registers.
//  * The x chunk (RB rows x BK) is staged in shared memory, transposed so a
//    thread reads four rows with one 16-byte load.
//  * No split-K across CTAs and no atomics.  Thread (kl, c) sums
//    k = kl, kl + 16, kl + 32, ... in increasing order, and the 16 partial
//    sums of a column are added in the fixed order kl = 0..15.  That order
//    depends on neither b nor the batch tile, so a row's output is bitwise
//    the same in any batch: batched logits equal unbatched logits.
//  * Scale, bias and activation run once, at the end.
#include "common.cuh"

namespace {

constexpr int BN = 16;               // output columns per CTA
constexpr int KL = 16;               // k-lanes per column
constexpr int THREADS = BN * KL;     // 256
constexpr int BK = 64;               // k per staged chunk
constexpr int KPL = BK / KL;         // k per lane per chunk
constexpr int RC = 16;               // rows per reduction pass

template <typename WT, int RB>
__global__ void __launch_bounds__(THREADS)
sa_fc_kernel(const float* __restrict__ x, const WT* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ bias,
             float* __restrict__ out, int b, int k, int n, int act) {
  constexpr int XS = BK * RB;                          // floats per x buffer
  constexpr int XPT = (XS + THREADS - 1) / THREADS;    // x loads per thread
  constexpr int RCC = RB < RC ? RB : RC;
  constexpr int SMEM = (2 * XS > KL * RCC * BN) ? 2 * XS : KL * RCC * BN;
  __shared__ __align__(16) float sm[SMEM];

  const int t = threadIdx.x;
  const int c = t % BN;
  const int kl = t / BN;
  const int col = blockIdx.x * BN + c;
  const bool col_ok = col < n;
  const int nchunks = (k + BK - 1) / BK;

  for (int r0 = 0; r0 < b; r0 += RB) {
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;

    WT wnext[KPL];
    float xnext[XPT];
    auto load_w = [&](int ch) {
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int kk = ch * BK + kl + KL * i;
        wnext[i] = (col_ok && kk < k) ? w[static_cast<size_t>(kk) * n + col] : WT{};
      }
    };
    auto load_x = [&](int ch) {
#pragma unroll
      for (int i = 0; i < XPT; ++i) {
        const int e = t + THREADS * i;               // e = r * BK + kk, kk fastest
        const int r = e / BK, kk = e % BK;
        const int row = r0 + r, kx = ch * BK + kk;
        xnext[i] = (e < XS && row < b && kx < k) ? x[static_cast<size_t>(row) * k + kx] : 0.f;
      }
    };
    auto store_x = [&](int buf) {
      float* xs = sm + buf * XS;
#pragma unroll
      for (int i = 0; i < XPT; ++i) {
        const int e = t + THREADS * i;
        if (e < XS) xs[(e % BK) * RB + e / BK] = xnext[i];
      }
    };

    load_w(0);
    load_x(0);
    store_x(0);
    __syncthreads();
    for (int ch = 0; ch < nchunks; ++ch) {
      const int buf = ch & 1;
      WT wcur[KPL];
#pragma unroll
      for (int i = 0; i < KPL; ++i) wcur[i] = wnext[i];
      const bool more = ch + 1 < nchunks;
      if (more) {
        load_w(ch + 1);
        load_x(ch + 1);
      }
      const float* xs = sm + buf * XS;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const float wv = to_f32(wcur[i]);
        const float* xr = xs + (kl + KL * i) * RB;
        if constexpr (RB % 4 == 0) {
#pragma unroll
          for (int r = 0; r < RB; r += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + r);
            acc[r] = fmaf(xv.x, wv, acc[r]);
            acc[r + 1] = fmaf(xv.y, wv, acc[r + 1]);
            acc[r + 2] = fmaf(xv.z, wv, acc[r + 2]);
            acc[r + 3] = fmaf(xv.w, wv, acc[r + 3]);
          }
        } else {
#pragma unroll
          for (int r = 0; r < RB; ++r) acc[r] = fmaf(xr[r], wv, acc[r]);
        }
      }
      if (more) store_x(buf ^ 1);
      __syncthreads();
    }

    // Reduce the 16 k-lane partials of each output in the order kl = 0..15,
    // then the epilogue.  sm is free: the last chunk ended with a barrier.
#pragma unroll
    for (int rc = 0; rc < RB; rc += RCC) {
#pragma unroll
      for (int rr = 0; rr < RCC; ++rr) sm[(kl * RCC + rr) * BN + c] = acc[rc + rr];
      __syncthreads();
      if (t < RCC * BN) {
        const int rr = t / BN, cc = t % BN;
        float s = sm[rr * BN + cc];
#pragma unroll
        for (int j = 1; j < KL; ++j) s += sm[(j * RCC + rr) * BN + cc];
        const int row = r0 + rc + rr, ocol = blockIdx.x * BN + cc;
        if (row < b && ocol < n)
          out[static_cast<size_t>(row) * n + ocol] = apply_act(scale_bias(s, scale, bias, ocol), act);
      }
      __syncthreads();
    }
  }
}

template <typename WT>
cudaError_t launch_rb(int rb, const float* x, const WT* w, const float* scale, const float* bias,
                      float* out, int b, int k, int n, int act, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN);
  switch (rb) {
    case 1: sa_fc_kernel<WT, 1><<<grid, THREADS, 0, stream>>>(x, w, scale, bias, out, b, k, n, act); break;
    case 2: sa_fc_kernel<WT, 2><<<grid, THREADS, 0, stream>>>(x, w, scale, bias, out, b, k, n, act); break;
    case 4: sa_fc_kernel<WT, 4><<<grid, THREADS, 0, stream>>>(x, w, scale, bias, out, b, k, n, act); break;
    case 8: sa_fc_kernel<WT, 8><<<grid, THREADS, 0, stream>>>(x, w, scale, bias, out, b, k, n, act); break;
    case 16: sa_fc_kernel<WT, 16><<<grid, THREADS, 0, stream>>>(x, w, scale, bias, out, b, k, n, act); break;
    case 32: sa_fc_kernel<WT, 32><<<grid, THREADS, 0, stream>>>(x, w, scale, bias, out, b, k, n, act); break;
    case 64: sa_fc_kernel<WT, 64><<<grid, THREADS, 0, stream>>>(x, w, scale, bias, out, b, k, n, act); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// w_kind: 0 fp32, 1 int8, 2 bf16.  rb: the batch tile (a power of two <= 64).
// scale and bias may be null.  Returns cudaGetLastError() after the launch.
extern "C" int sa_fc_launch(const void* x, const void* w, int w_kind, const void* scale,
                            const void* bias, void* out, int b, int k, int n, int rb, int act,
                            void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* sf = static_cast<const float*>(scale);
  const auto* bf = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (w_kind) {
    case 0: return launch_rb(rb, xf, static_cast<const float*>(w), sf, bf, of, b, k, n, act, st);
    case 1: return launch_rb(rb, xf, static_cast<const int8_t*>(w), sf, bf, of, b, k, n, act, st);
    case 2: return launch_rb(rb, xf, static_cast<const __nv_bfloat16*>(w), sf, bf, of, b, k, n, act, st);
    default: return cudaErrorInvalidValue;
  }
}
