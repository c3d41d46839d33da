// SA-CONV GEMM on Hopper: out = act((x @ w) * scale + bias), x (m, k) fp32,
// w (k, n) fp32, bf16 or int8, fp32 accumulation, out (m, n) fp32.
//
// Replaces: src/repro/kernels/sa_conv.py::sa_conv_matmul (Pallas body
// _sa_conv_kernel), the output-stationary SA-CONV dataflow for matmuls the
// planner puts in the compute-bound regime (an LM's prefill projections).
//
// What bounds it on this card: the fp32 FMA rate.  At m = 2048 every weight
// is reused 2048 times, so the operations (2*m*n*k over 67 TFLOP/s on the
// CUDA cores; no TF32: fp32 means fp32) take about 10x longer than moving
// the operands once.  The kernel has to keep the FMA pipes fed from
// registers, not from memory.
//
// What the design does about it:
//  * A CTA of 256 threads owns a 128 x 128 output tile; each thread holds
//    an 8 x 8 register tile (two 4-row by two 4-column groups 64 apart), so
//    every k step does 64 FMAs for four 16-byte shared-memory loads.
//  * K advances in chunks of 8.  The next chunk of x and w is loaded into
//    registers while the current one is multiplied out of shared memory,
//    and stored into the other of two shared buffers: one barrier per
//    chunk.  x is stored transposed (k-major, rows padded by 4 floats) so
//    a thread reads four rows with one 16-byte load and the transposing
//    stores hit 32 different banks.
//  * int8 and bf16 weights are widened to fp32 as they are staged, so HBM
//    moves 1 or 2 bytes per weight.
//  * Ragged m, n and k are masked at the loads (zeros) and the stores: no
//    padded copies.  The epilogue applies scale, then bias, then the
//    activation once per output, in fp32, in the plain version's order.
//  * The k sum of each output runs in increasing k in one thread, so the
//    result does not depend on m or on the tile an output falls in.
#include "common.cuh"

namespace {

constexpr int BM = 128;              // rows per CTA
constexpr int BN = 128;              // columns per CTA
constexpr int BK = 8;                // k per staged chunk
constexpr int THREADS = 256;
constexpr int AP = BM + 4;           // padded row of the transposed x chunk
constexpr int LOADS = BM * BK / THREADS;   // x (and w) elements per thread per chunk

template <typename WT>
__global__ void __launch_bounds__(THREADS, 2)
sa_conv_kernel(const float* __restrict__ x, const WT* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               float* __restrict__ out, int m, int n, int k, int act) {
  __shared__ __align__(16) float as[2][BK][AP];
  __shared__ __align__(16) float bs[2][BK][BN];

  const int t = threadIdx.x;
  const int tx = t % 16;             // column group
  const int ty = t / 16;             // row group
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int nchunks = (k + BK - 1) / BK;

  float xa[LOADS], wb[LOADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = t + THREADS * i;
      const int r = e / BK, kk = e % BK;               // x: k fastest (coalesced rows)
      const int row = row0 + r, kx = k0 + kk;
      xa[i] = (row < m && kx < k) ? x[static_cast<size_t>(row) * k + kx] : 0.f;
      const int kw = k0 + e / BN, c = col0 + e % BN;   // w: columns fastest
      wb[i] = (kw < k && c < n) ? to_f32(w[static_cast<size_t>(kw) * n + c]) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = t + THREADS * i;
      as[buf][e % BK][e / BK] = xa[i];
      bs[buf][e / BN][e % BN] = wb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int ch = 0; ch < nchunks; ++ch) {
    const int buf = ch & 1;
    const bool more = ch + 1 < nchunks;
    if (more) load((ch + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);        // buf ^ 1 was last read before the previous barrier
    __syncthreads();
  }

  const bool vec = (n % 4) == 0;     // rows start 16-byte aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
    float* orow = out + static_cast<size_t>(row) * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = c + j < n ? apply_act(scale_bias(acc[i][h * 4 + j], scale, bias, c + j), act) : 0.f;
      if (vec && c + 3 < n) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < n) orow[c + j] = v[j];
      }
    }
  }
}

template <typename WT>
cudaError_t launch(const float* x, const WT* w, const float* scale, const float* bias, float* out,
                   int m, int n, int k, int act, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  sa_conv_kernel<WT><<<grid, THREADS, 0, stream>>>(x, w, scale, bias, out, m, n, k, act);
  return cudaGetLastError();
}

}  // namespace

// w_kind: 0 fp32, 1 int8, 2 bf16.  scale and bias may be null.  Returns
// cudaGetLastError() after the launch.
extern "C" int sa_conv_launch(const void* x, const void* w, int w_kind, const void* scale,
                              const void* bias, void* out, int m, int k, int n, int act,
                              void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* sf = static_cast<const float*>(scale);
  const auto* bf = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (w_kind) {
    case 0: return launch(xf, static_cast<const float*>(w), sf, bf, of, m, n, k, act, st);
    case 1: return launch(xf, static_cast<const int8_t*>(w), sf, bf, of, m, n, k, act, st);
    case 2: return launch(xf, static_cast<const __nv_bfloat16*>(w), sf, bf, of, m, n, k, act, st);
    default: return cudaErrorInvalidValue;
  }
}
