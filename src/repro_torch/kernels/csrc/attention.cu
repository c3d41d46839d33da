// Flash attention on Hopper: out = softmax(mask(cap(q k^T * scale))) v per
// (batch, query head), q (b, sq, hq, d), k/v (b, skv, hkv, d), fp32, read
// through their strides; out (b, sq, hq, d) fp32, contiguous.
//
// Replaces: src/repro/kernels/attention.py::flash_attention (Pallas body
// _flash_kernel): blocked online-softmax attention, causal with queries
// aligned to the end of the keys (offset skv - sq), optional sliding window
// and tanh logit softcap, GQA (query head h reads kv head h / (hq / hkv)),
// fully masked kv tiles skipped, fp32 running max / sum / accumulator, and
// a guarded final divide.
//
// What bounds it on this card: at a 512-token prefill with d = 128 the
// operations (4 * sq * skv * d per head, half of it masked away by the
// causal skip) on the fp32 CUDA cores; the bytes are q, k, v and out once.
// The (sq, skv) score matrix never touches device memory.
//
// What the design does about it:
//  * One CTA of 256 threads per (batch * query head, tile of 64 query
//    rows).  The TPU kernel's sequential kv grid axis becomes a loop inside
//    the CTA, and its grid-level skip of dead tiles becomes the loop's
//    bounds: causal ends the loop at the tile of the last query row, the
//    window starts it at the first tile any row can see.  CTAs with the
//    most live tiles (the last query tiles) are issued first.
//  * The query tile stays in shared memory for the whole loop; each 64-row
//    K and V tile is staged with 16-byte loads, rows padded by 4 floats so
//    the 16-byte reads of 8 neighbouring rows fall in different banks.  At
//    d = 128 that is 116 KB: dynamic shared memory above the 48 KB default,
//    opted in per instantiation.
//  * Thread (ty, tx) holds query rows 4ty..4ty+3: scores for key columns
//    tx + 16j and output columns tx + 16c.  The 16 threads of a row share
//    its running max and sum through warp shuffles, so the statistics stay
//    in registers, in fp32.  Masked scores take -1e30 and their
//    probabilities are set to 0 explicitly, as the TPU kernel does.
//  * Probabilities go through shared memory once per tile for the P V
//    product; the final divide treats l == 0 (a row that saw no key) as 1.
#include "common.cuh"

namespace {

constexpr int BQ = 64;               // query rows per CTA
constexpr int BKV = 64;              // keys per tile
constexpr int THREADS = 256;
constexpr int PP = BKV + 4;          // padded row of the probability tile
constexpr float NEG_INF = -1e30f;

struct Strides {                     // in elements; the head dim is contiguous
  long long b, s, h;
};

template <int D>
constexpr int smem_bytes() {
  return ((BQ + 2 * BKV) * (D + 4) + BQ * PP) * static_cast<int>(sizeof(float));
}

// rows [s0, s0 + nrows) of one head into a (nrows, D + 4) tile; rows at or
// beyond len are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base, Strides st, int bi,
                                          int head, int s0, int nrows, int len) {
  constexpr int V4 = D / 4;
  for (int e = threadIdx.x; e < nrows * V4; e += THREADS) {
    const int r = e / V4, c4 = e % V4;
    const int s = s0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < len)
      v = *reinterpret_cast<const float4*>(base + bi * st.b + s * st.s + head * st.h + c4 * 4);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c4 * 4) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, Strides qs_, Strides ks_,
             Strides vs_, int sq, int skv, int hq, int hkv, int causal, int window,
             float softcap, float scale) {
  constexpr int DP = D + 4;
  constexpr int DC = D / 16;         // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * DP;
  float* vs = ks + BKV * DP;
  float* ps = vs + BKV * DP;

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int bh = blockIdx.y;
  const int bi = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int offset = skv - sq;                     // queries sit at the end
  const int q_lo = iq * BQ + offset;               // position of row 0
  const int q_hi = min(q_lo + BQ - 1, skv - 1);    // of the last real row

  // live kv tiles: the TPU kernel's skip test, as loop bounds
  const int n_kv = (skv + BKV - 1) / BKV;
  int kt_end = n_kv;
  if (causal) kt_end = q_hi < 0 ? 0 : min(n_kv, q_hi / BKV + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int num = q_lo - window - BKV + 2;       // first kt with k_hi > q_lo - window
    kt_begin = num <= 0 ? 0 : (num + BKV - 1) / BKV;
  }

  load_tile<D>(qs, q, qs_, bi, h, iq * BQ, BQ, sq);

  float m_run[4], l_run[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * BKV;
    __syncthreads();                               // the previous tile is consumed
    load_tile<D>(ks, k, ks_, bi, hk, k_lo, BKV, skv);
    load_tile<D>(vs, v, vs_, bi, hk, k_lo, BKV, skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * DP + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * DP + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + ty * 4 + i;
      bool ok[4];
      float mcur = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_lo + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        ok[j] = kpos < skv && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? x : NEG_INF;
        mcur = fmaxf(mcur, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)        // the 16 threads of this row
        mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, off));
      const float mnew = fmaxf(m_run[i], mcur);
      const float alpha = expf(m_run[i] - mnew);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mnew) : 0.f;
        ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l_run[i] = alpha * l_run[i] + rsum;
      m_run[i] = mnew;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                               // the probability tile is complete

#pragma unroll 2
    for (int jj = 0; jj < BKV; jj += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * PP + jj);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float* vc = vs + jj * DP + tx + 16 * c;
        const float v0 = vc[0], v1 = vc[DP], v2 = vc[2 * DP], v3 = vc[3 * DP];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][c];
          a = fmaf(pv[i].x, v0, a);
          a = fmaf(pv[i].y, v1, a);
          a = fmaf(pv[i].z, v2, a);
          a = fmaf(pv[i].w, v3, a);
          acc[i][c] = a;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = iq * BQ + ty * 4 + i;
    if (row >= sq) continue;
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    float* o = out + ((static_cast<size_t>(bi) * sq + row) * hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = acc[i][c] / l;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, Strides qs,
                   Strides ks, Strides vs, int b, int sq, int skv, int hq, int hkv, int causal,
                   int window, float softcap, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, b * hq);
  flash_kernel<D><<<grid, THREADS, bytes, stream>>>(q, k, v, out, qs, ks, vs, sq, skv, hq, hkv,
                                                    causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// Head dims: multiples of 16 up to 128.  Strides are in elements, for
// (batch, seq, head); the head dim must be contiguous and every row
// 16-byte aligned (the wrapper checks).  Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int sq, int skv, int hq, int hkv, int d,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh, int causal,
                                      int window, float softcap, float scale, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  auto st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DIM) \
  case DIM: return launch<DIM>(qf, kf, vf, of, qs, ks, vs, b, sq, skv, hq, hkv, causal, window, softcap, scale, st)
  switch (d) {
    FLASH_CASE(16);
    FLASH_CASE(32);
    FLASH_CASE(48);
    FLASH_CASE(64);
    FLASH_CASE(80);
    FLASH_CASE(96);
    FLASH_CASE(112);
    FLASH_CASE(128);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}
