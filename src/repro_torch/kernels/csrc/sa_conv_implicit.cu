// SA-CONV on Hopper: a direct NHWC x HWIO VALID convolution with stride on
// a pre-padded input, out = act(conv(x, f) * scale + bias), and with a fused
// pool out = act(maxpool(conv(x, f) * scale + bias)).  x fp32, f fp32 or
// int8 (per-output-channel scale), fp32 accumulation.
//
// Replaces: src/repro/kernels/sa_conv_implicit.py::sa_conv_implicit
// (Pallas body _implicit_conv_kernel), with its fused pool epilogue.
//
// What bounds it on this card: fp32 FMAs.  AlexNet's convs do 60-500
// FLOP per byte of their compulsory traffic, far above the card's fp32
// ridge (~20 FLOP/B at 67 TFLOP/s and 3.35 TB/s), and TF32 is not allowed
// (fp32 means fp32), so the roof is the CUDA cores' FMA rate.
//
// What the design does about it:
//  * No im2col is materialised.  A CTA owns one image, a band of output
//    rows at full output width, and a tile of BCO = 8*G output channels.
//    It loops over input-channel chunks; for each it stages the band's
//    input rows (with their halo) and the filter chunk in dynamic shared
//    memory, then every thread accumulates 8 pixels x 8 channels in
//    registers: per (ci, p, q) tap one 4-byte read per pixel and two
//    16-byte broadcast reads of filter, for 64 FMAs.
//  * Input rows are stored per channel plane, split by stride phase
//    (column c lands at (c % s) * ceil(W/s) + c / s), so neighbouring
//    output pixels read neighbouring words even at stride 4: no bank
//    conflicts.
//  * Every output is summed by one thread in the fixed (ci, p, q) order.
//    The order does not depend on the band, the channel chunk, the batch
//    or the pool, so batched == unbatched and fused == unfused hold bitwise.
//  * The epilogue applies scale and bias (each rounded on its own), parks
//    the band's tile in shared memory, then takes the max over each pool
//    window in (dp, dq) order and applies act, writing only the pooled map
//    with the channel index fastest.  Unfused is the same code with a 1x1
//    window.  A band of pooled rows needs conv rows 2r .. 2r+2 for 3/2
//    windows, so neighbouring bands recompute their shared conv row; no
//    window is ever split across CTAs.
//  * int8 filters are widened once, when staged.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TPX = 8;               // output pixels per thread
constexpr int TCO = 8;               // output channels per thread

struct ConvArgs {
  const float* x;
  const void* f;
  const float* scale;                // (co,) or null
  const float* bias;                 // (co,) or null
  float* out;
  int h, w, ci, p, q, co, stride;    // padded input dims and filter
  int oh, ow;                        // conv output
  int pw, ps;                        // pool window and stride (1, 1: none)
  int poh, pow_;                     // emitted map
  int pr;                            // emitted rows per band
  int bci;                           // input channels per staged chunk
  int rin;                           // staged input rows per band
  int act;
};

template <int G, typename FT>
__global__ void __launch_bounds__(THREADS)
sa_conv_kernel(const ConvArgs a) {
  constexpr int BCO = TCO * G;       // output channels per CTA
  constexpr int PXG = THREADS / G;   // pixel groups
  constexpr int BCOP = BCO + 1;      // epilogue tile pitch (bank-conflict free)
  extern __shared__ __align__(16) float smem[];

  const int img = blockIdx.z;
  const int co0 = blockIdx.y * BCO;
  const int e0 = blockIdx.x * a.pr;                    // first emitted row
  const int e1 = min(e0 + a.pr, a.poh);
  const int cr0 = e0 * a.ps;                           // first conv row
  const int nrows = (e1 - 1) * a.ps + a.pw - e0 * a.ps;
  const int npix = nrows * a.ow;
  const int s = a.stride;
  const int ws = (a.w + s - 1) / s;                    // columns per stride phase
  const int wrow = s * ws;
  const int plane = a.rin * wrow;
  const int rows_in = (nrows - 1) * s + a.p;
  float* s_in = smem;
  float* s_f = smem + ((a.bci * plane + 3) & ~3);      // 16-byte aligned

  const int t = threadIdx.x;
  const int cg = t / PXG;
  const int pg = t % PXG;

  int base[TPX];
#pragma unroll
  for (int j = 0; j < TPX; ++j) {
    const int px = pg + PXG * j;
    base[j] = px < npix ? (px / a.ow) * s * wrow + px % a.ow : 0;
  }

  float acc[TPX][TCO];
#pragma unroll
  for (int j = 0; j < TPX; ++j)
#pragma unroll
    for (int e = 0; e < TCO; ++e) acc[j][e] = 0.f;

  const FT* f = static_cast<const FT*>(a.f);
  const float* xin = a.x + (static_cast<size_t>(img) * a.h + static_cast<size_t>(cr0) * s) * a.w * a.ci;
  const int taps = a.p * a.q;

  for (int c0 = 0; c0 < a.ci; c0 += a.bci) {
    const int nci = min(a.bci, a.ci - c0);
    // stage the band's input rows of this channel chunk, channel fastest in
    // global memory (coalesced when the chunk is the whole channel range)
    const int nin = rows_in * a.w * nci;
    for (int idx = t; idx < nin; idx += THREADS) {
      const int cl = idx % nci;
      const int rest = idx / nci;
      const int col = rest % a.w, row = rest / a.w;
      s_in[(cl * a.rin + row) * wrow + (col % s) * ws + col / s] =
          xin[(static_cast<size_t>(row) * a.w + col) * a.ci + c0 + cl];
    }
    // stage the filter chunk as [tap][cl][BCO], output channel fastest
    const int nf = taps * nci * BCO;
    for (int idx = t; idx < nf; idx += THREADS) {
      const int col = idx % BCO;
      const int rest = idx / BCO;
      const int cl = rest % nci, tap = rest / nci;
      const int cog = co0 + col;
      s_f[(tap * a.bci + cl) * BCO + col] =
          cog < a.co ? to_f32(f[(static_cast<size_t>(tap) * a.ci + c0 + cl) * a.co + cog]) : 0.f;
    }
    __syncthreads();

    for (int cl = 0; cl < nci; ++cl) {
      const float* in_c = s_in + cl * plane;
      for (int pp = 0; pp < a.p; ++pp) {
        for (int qq = 0; qq < a.q; ++qq) {
          const int off = pp * wrow + (qq % s) * ws + qq / s;
          const float* fp = s_f + ((pp * a.q + qq) * a.bci + cl) * BCO + cg * TCO;
          const float4 w0 = *reinterpret_cast<const float4*>(fp);
          const float4 w1 = *reinterpret_cast<const float4*>(fp + 4);
#pragma unroll
          for (int j = 0; j < TPX; ++j) {
            const float xv = in_c[base[j] + off];
            acc[j][0] = fmaf(xv, w0.x, acc[j][0]);
            acc[j][1] = fmaf(xv, w0.y, acc[j][1]);
            acc[j][2] = fmaf(xv, w0.z, acc[j][2]);
            acc[j][3] = fmaf(xv, w0.w, acc[j][3]);
            acc[j][4] = fmaf(xv, w1.x, acc[j][4]);
            acc[j][5] = fmaf(xv, w1.y, acc[j][5]);
            acc[j][6] = fmaf(xv, w1.z, acc[j][6]);
            acc[j][7] = fmaf(xv, w1.w, acc[j][7]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: scale + bias into the band tile, then pool (or 1x1) + act
  float* tile = smem;
#pragma unroll
  for (int j = 0; j < TPX; ++j) {
    const int fpx = pg + PXG * j;
    if (fpx < npix) {
#pragma unroll
      for (int e = 0; e < TCO; ++e) {
        const int col = cg * TCO + e;
        const int cog = co0 + col;
        tile[fpx * BCOP + col] = cog < a.co ? scale_bias(acc[j][e], a.scale, a.bias, cog) : 0.f;
      }
    }
  }
  __syncthreads();

  const int nout = (e1 - e0) * a.pow_ * BCO;
  for (int idx = t; idx < nout; idx += THREADS) {
    const int col = idx % BCO;
    const int rest = idx / BCO;
    const int ex = rest % a.pow_, er = rest / a.pow_;
    const int cog = co0 + col;
    if (cog >= a.co) continue;
    const float* tp = tile + (er * a.ps * a.ow + ex * a.ps) * BCOP + col;
    float m = tp[0];
    for (int dp = 0; dp < a.pw; ++dp)
      for (int dq = 0; dq < a.pw; ++dq) {
        const float v = tp[(dp * a.ow + dq) * BCOP];
        m = v > m ? v : m;
      }
    a.out[((static_cast<size_t>(img) * a.poh + e0 + er) * a.pow_ + ex) * a.co + cog] =
        apply_act(m, a.act);
  }
}

template <int G, typename FT>
cudaError_t launch(const ConvArgs& a, int n, int nbands, int smem_bytes, cudaStream_t stream) {
  constexpr int BCO = TCO * G;
  auto* kern = sa_conv_kernel<G, FT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(nbands, (a.co + BCO - 1) / BCO, n);
  kern<<<grid, THREADS, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// f_kind: 0 fp32, 1 int8.  groups: 4 (32 channels x 512 pixels per CTA) or
// 8 (64 x 256).  pw = ps = 1 for no pool.  The band geometry (pr, nbands,
// bci, rin, smem_bytes) comes from repro_torch/kernels/sa_conv_implicit.py.
// Returns the first CUDA error of the attribute call or the launch.
extern "C" int sa_conv_implicit_launch(const void* x, const void* f, int f_kind,
                                       const void* scale, const void* bias, void* out, int n,
                                       int h, int w, int ci, int p, int q, int co, int stride,
                                       int pw, int ps, int pr, int nbands, int bci, int rin,
                                       int groups, int act, int smem_bytes, void* stream) {
  ConvArgs a;
  a.x = static_cast<const float*>(x);
  a.f = f;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.h = h; a.w = w; a.ci = ci; a.p = p; a.q = q; a.co = co; a.stride = stride;
  a.oh = (h - p) / stride + 1;
  a.ow = (w - q) / stride + 1;
  a.pw = pw; a.ps = ps;
  a.poh = (a.oh - pw) / ps + 1;
  a.pow_ = (a.ow - pw) / ps + 1;
  a.pr = pr; a.bci = bci; a.rin = rin; a.act = act;
  auto st = static_cast<cudaStream_t>(stream);
  if (groups == 4 && f_kind == 0) return launch<4, float>(a, n, nbands, smem_bytes, st);
  if (groups == 4 && f_kind == 1) return launch<4, int8_t>(a, n, nbands, smem_bytes, st);
  if (groups == 8 && f_kind == 0) return launch<8, float>(a, n, nbands, smem_bytes, st);
  if (groups == 8 && f_kind == 1) return launch<8, int8_t>(a, n, nbands, smem_bytes, st);
  return cudaErrorInvalidValue;
}
