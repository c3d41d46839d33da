// Flash attention on Hopper: out = softmax(mask(cap(q k^T * scale))) v per
// (batch, query head), q (b, sq, hq, d), k/v (b, skv, hkv, d), all fp32 or
// all bf16, read through their strides; out (b, sq, hq, d) in their type,
// contiguous.  Scores, softmax and P V run in fp32 for either type, as in
// the TPU kernel (which widens q, k and v to fp32): bf16 operands are
// widened where they are read, and the output is rounded once.
//
// Replaces: src/repro/kernels/attention.py::flash_attention (Pallas body
// _flash_kernel): blocked online-softmax attention, causal with queries
// aligned to the end of the keys (offset skv - sq), optional sliding window
// and tanh logit softcap, GQA (query head h reads kv head h / (hq / hkv)),
// fully masked kv tiles skipped, fp32 running max / sum / accumulator, and
// a guarded final divide.
//
// What bounds it on this card: at a 512-token prefill with d = 128 the
// operations (4 * d per unmasked (query, key) pair) on the fp32 CUDA cores:
// fp32 means fp32, no TF32 and no tensor cores.  The bytes are q, k, v and
// out once; the (sq, skv) score matrix never touches device memory.  What
// keeps the kernel from the FMA roof is issue slots spent on anything but
// FMAs (shared-memory loads, the softmax, barriers with nothing in flight)
// and SMs left idle by CTAs of unequal work.
//
// What the design does about it:
//  * A CTA is 256 threads, 8 warps, and holds a tile of BQ = 16 * RPT query
//    rows of one (batch, query head): 128 rows (RPT = 8) or 64 (RPT = 4).
//    kernels/attention.py::flash_geometry picks the tile height and whether
//    a CTA takes two query tiles (tile n-1-u, then tile u: under a causal
//    mask every pair has the same number of live kv tiles) from the shape
//    alone, costed as the makespan of its CTAs on 132 SMs.  The TPU kernel's
//    sequential kv grid axis becomes a loop inside the CTA, and its
//    grid-level skip of dead tiles becomes the loop's bounds.
//  * Q stays in shared memory for the CTA's loop over kv tiles; a paired
//    CTA stages the second tile's Q as soon as the first tile's last scores
//    are in registers (one extra barrier per CTA).  K and V tiles of BKV =
//    64 keys stream through a two-stage cp.async ring of 16-byte copies:
//    tile t + 1 lands while tile t computes, one barrier per tile.  Rows
//    are padded by 4 floats, so the 16-byte reads of 8 neighbouring rows
//    fall in 8 different bank groups.  At d = 128 and 128 rows that is 216
//    KB: one CTA per SM.
//  * Warp w owns 2 * RPT query rows, interleaved between its half-warps:
//    lane (half, x) holds rows 2i + half.  For the scores it holds keys
//    x + 16j (j < 4) of those rows: per 4 columns of d, RPT float4 loads of
//    Q (one address per half-warp, broadcast) and 4 of K for 16 * RPT FMAs.
//    For P V it holds output columns 4x..4x+3 and 64+4x..: V is read as
//    float4, 16 lanes over one contiguous row.
//  * P never leaves the warp that made it: each warp writes its rows'
//    probabilities to its own slice of shared memory, 32 keys at a time,
//    and reads them back after a __syncwarp, as float4 of 4 keys.  No
//    barrier of the CTA guards P.
//  * The softmax runs in base 2: scores are scaled by scale * log2(e), so
//    each probability is one MUFU ex2.  The 16 lanes of a row share its
//    running max through warp shuffles (a butterfly, so every lane holds
//    the same bits; the 2 * RPT rows' shuffles interleaved), and a row
//    whose max stood skips rescaling its accumulators.  Each lane keeps the
//    running sum of its own keys, and the lanes' sums meet in one butterfly
//    when the query tile ends.  All in fp32.  Masked scores take -1e30 and
//    their probabilities are set to 0 explicitly, as the TPU kernel does;
//    the final divide treats l == 0 (a row that saw no key) as 1.
//  * One summation order per output row, whatever the tile height, the
//    pairing or the batch: each score sums d in order (one fmaf each); a
//    lane's sum of probabilities adds its 4 keys of a tile in order, tile
//    by tile, and the row's sum is the butterfly over lanes; the output
//    sums keys in order.  A kv tile in which none of a row's keys is
//    visible leaves that row's statistics and sums bit-for-bit unchanged
//    (alpha = 1, p = 0), so a warp skips a tile that none of its rows sees,
//    and a taller query tile that visits more kv tiles gives the same bits:
//    rows of a b = 4 launch equal a b = 1 launch.
//  * __launch_bounds__(256, 1): up to 255 registers for the 8 x 4 score
//    tile and 8 x 8 accumulators, no spills.
//  * bf16 (the type is a template parameter, so the fp32 instantiations are
//    the code they were before bf16): K and V stream through the same ring
//    in 2 bytes, 8-byte cp.async copies (as many as fp32's 16-byte ones) into
//    rows padded by 4 elements, where 8-byte reads of 16 neighbouring rows
//    fall in distinct banks; each 4-value read is widened to fp32 in
//    registers.  Q is widened once as it is staged (synchronous loads: it is
//    staged once per query tile).  The loops and their order are fp32's,
//    so a bf16 launch equals the fp32 launch on the widened operands,
//    rounded once.  Not on the tensor cores yet: the bf16 bound is their
//    rate (989 TFLOP/s), far above these FMAs (kernels/attention.py).
#include "common.cuh"

namespace {

constexpr int BKV = 64;              // keys per tile
constexpr int THREADS = 256;
constexpr int PH = 32 + 4;           // padded row of a warp's half tile of P
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {                     // in elements; the head dim is contiguous
  long long b, s, h;
};

// the Q tile (fp32), two stages of K and V (in T), the warps' P slices
template <int D, int RPT, typename T>
constexpr int smem_bytes() {
  return (16 * RPT * (D + 4) + 16 * RPT * PH) * static_cast<int>(sizeof(float)) +
         4 * BKV * (D + 4) * static_cast<int>(sizeof(T));
}

// four consecutive elements of a row: 16 bytes of fp32, 8 of bf16
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }
// four consecutive bf16 values widened to fp32 (one 8-byte load)
__device__ __forceinline__ float4 widen4(uint2 q) {
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// 2^x in one MUFU op (a result below 2^-126 flushes to 0: far below what
// a probability next to the row's max of 1 can add)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [s0, s0 + ROWS) of one head (base: its row 0) into a (ROWS, D + 4)
// tile, as cp.async copies of 4 elements; rows at or beyond len are
// zero-filled.  Where a row's 4-element columns divide the CTA, each thread
// copies one column of every STEP-th row, its addresses moved by a
// constant stride.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* base, long long row_stride,
                                           int s0, int len) {
  constexpr int NC4 = D / 4;
  if constexpr (THREADS % NC4 == 0) {
    constexpr int STEP = THREADS / NC4;            // rows per pass of the CTA
    const int r0 = threadIdx.x / NC4, c = threadIdx.x % NC4;
    const T* src = base + (s0 + r0) * row_stride + c * 4;
    T* d = dst + r0 * (D + 4) + c * 4;
#pragma unroll
    for (int it = 0; it < (ROWS + STEP - 1) / STEP; ++it) {
      if (ROWS % STEP == 0 || r0 + it * STEP < ROWS) {
        const bool ok = s0 + r0 + it * STEP < len;
        cp_async4(d + it * STEP * (D + 4), ok ? src + it * STEP * row_stride : base, ok);
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * NC4; e += THREADS) {
      const int r = e / NC4, c = e % NC4;
      const bool ok = s0 + r < len;
      cp_async4(dst + r * (D + 4) + c * 4, base + (ok ? (s0 + r) * row_stride : 0) + c * 4, ok);
    }
  }
}

// The query tile into the fp32 Q tile: fp32 rows by cp.async; bf16 rows
// loaded (8 bytes a thread), widened and stored, zeros past len.
template <int D, int ROWS>
__device__ __forceinline__ void stage_q(float* dst, const float* base, long long row_stride,
                                        int s0, int len) {
  stage_rows<D, ROWS>(dst, base, row_stride, s0, len);
}
template <int D, int ROWS>
__device__ __forceinline__ void stage_q(float* dst, const __nv_bfloat16* base,
                                        long long row_stride, int s0, int len) {
  constexpr int NC4 = D / 4;
  for (int e = threadIdx.x; e < ROWS * NC4; e += THREADS) {
    const int r = e / NC4, c = e % NC4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + r < len) v = widen4(*reinterpret_cast<const uint2*>(base + (s0 + r) * row_stride + c * 4));
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c * 4) = v;
  }
}

// kv tiles [begin, end) that query tile iq (rows [iq * BQ, iq * BQ + BQ))
// visits: the TPU kernel's skip test, as loop bounds
template <int BQ>
__device__ __forceinline__ void kv_range(int iq, int sq, int skv, int causal, int window,
                                         int& begin, int& end) {
  const int q_lo = iq * BQ + skv - sq;             // position of row 0
  const int q_hi = min(q_lo + BQ - 1, skv - 1);    // of the last real row
  const int n_kv = (skv + BKV - 1) / BKV;
  end = n_kv;
  if (causal) end = q_hi < 0 ? 0 : min(n_kv, q_hi / BKV + 1);
  begin = 0;
  if (window > 0) {
    const int num = q_lo - window - BKV + 2;       // first kt with k_hi > q_lo - window
    begin = num <= 0 ? 0 : (num + BKV - 1) / BKV;
  }
}

template <int D, int RPT, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, Strides qs_, Strides ks_,
             Strides vs_, int sq, int skv, int hq, int hkv, int causal, int window,
             float softcap, float scale, int paired) {
  constexpr int BQ = 16 * RPT;       // query rows per tile
  constexpr int DP = D + 4;
  constexpr int NC4 = D / 4;         // float4 columns of a row
  constexpr int DC4 = (NC4 + 15) / 16;   // float4 output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  T* kvs = reinterpret_cast<T*>(qs + BQ * DP);       // [stage][K, V][BKV][DP]
  float* ps = reinterpret_cast<float*>(kvs + 4 * BKV * DP);  // [warp][2 * RPT][PH]

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int half = lane / 16, x = lane % 16;
  const int nq = (sq + BQ - 1) / BQ;               // query tiles
  const int units = paired ? (nq + 1) / 2 : nq;    // CTAs per (batch, head)
  const int bhs = gridDim.x / units;
  const int unit = blockIdx.x / bhs, bh = blockIdx.x % bhs;
  const int bi = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int offset = skv - sq;                     // queries sit at the end
  const float scale2 = __fmul_rn(scale, LOG2E);

  const T* qbase = q + bi * qs_.b + h * qs_.h;
  const T* kbase = k + bi * ks_.b + hk * ks_.h;
  const T* vbase = v + bi * vs_.b + hk * vs_.h;
  auto stage_kv = [&](int stage, int kt) {
    T* dst = kvs + stage * 2 * BKV * DP;
    stage_rows<D, BKV>(dst, kbase, ks_.s, kt * BKV, skv);
    stage_rows<D, BKV>(dst + BKV * DP, vbase, vs_.s, kt * BKV, skv);
  };

  // the CTA's query tiles: the heaviest first, then (paired) its mirror
  const int tile0 = nq - 1 - unit, tile1 = unit;
  const int ntiles = paired && tile1 != tile0 ? 2 : 1;
  int kb0, ke0, kb1, ke1;
  kv_range<BQ>(tile0, sq, skv, causal, window, kb0, ke0);
  kv_range<BQ>(tile1, sq, skv, causal, window, kb1, ke1);

  float* pw = ps + w * 2 * RPT * PH;               // this warp's P slice
  int stage = 0;
  bool in_flight = false;                          // K/V of the next tile staged into `stage`
  bool q_in_flight = false;                        // Q of the next query tile staged
  for (int i = 0; i < ntiles; ++i) {
    const int iq = i == 0 ? tile0 : tile1;
    const int kt_begin = i == 0 ? kb0 : kb1, kt_end = i == 0 ? ke0 : ke1;
    // the first kv tile of the next query tile, -1 if there is none
    const int kt_next = i + 1 < ntiles && kb1 < ke1 ? kb1 : -1;
    const int r0 = iq * BQ + w * 2 * RPT;          // the warp's first row
    const int r_last = min(r0 + 2 * RPT, sq) - 1;  // its last real row
    if (kt_begin < kt_end) {
      if (!q_in_flight) {
        if (i > 0) __syncthreads();                // every warp is done with the last Q
        stage_q<D, BQ>(qs, qbase, qs_.s, iq * BQ, sq);
      }
      if (!in_flight) stage_kv(stage, kt_begin);
      cp_async_commit();
    }

    float m_run[RPT], l_run[RPT];
    float4 acc[RPT][DC4];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      m_run[r] = NEG_INF;
      l_run[r] = 0.f;
#pragma unroll
      for (int c = 0; c < DC4; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    for (int kt = kt_begin; kt < kt_end; ++kt) {
      cp_async_wait_all();
      __syncthreads();                             // tile kt is staged; tile kt - 1 is consumed
      const int nkt = kt + 1 < kt_end ? kt + 1 : kt_next;
      in_flight = nkt >= 0;
      if (in_flight) {
        stage_kv(stage ^ 1, nkt);
        cp_async_commit();
      }
      const T* ks = kvs + stage * 2 * BKV * DP;
      const T* vs = ks + BKV * DP;
      stage ^= 1;

      // skip a tile that none of the warp's real rows sees: it would leave
      // their statistics and sums unchanged
      const int k_lo = kt * BKV, k_hi = min(k_lo + BKV, skv) - 1;
      const bool live = r_last >= r0 && !(causal && k_lo > r_last + offset) &&
                        !(window > 0 && k_hi <= r0 + offset - window);

      // scores: lane (half, x) has rows 2r + half, keys x + 16j
      float s[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
      if (live) {
        const float* qrow = qs + (w * 2 * RPT + half) * DP;
        const T* krow = ks + x * DP;
#pragma unroll 8
        for (int dd = 0; dd < D; dd += 4) {
          float4 kv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) kv[j] = lds4(krow + 16 * j * DP + dd);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float4 qv = lds4(qrow + 2 * r * DP + dd);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[r][j] = fmaf(qv.x, kv[j].x, s[r][j]);
              s[r][j] = fmaf(qv.y, kv[j].y, s[r][j]);
              s[r][j] = fmaf(qv.z, kv[j].z, s[r][j]);
              s[r][j] = fmaf(qv.w, kv[j].w, s[r][j]);
            }
          }
        }
      }
      // the last scores of this query tile are in registers: the next
      // tile's Q lands while this one finishes
      if (kt + 1 == kt_end && kt_next >= 0) {
        __syncthreads();                           // every warp is done with Q
        stage_q<D, BQ>(qs, qbase, qs_.s, tile1 * BQ, sq);
        cp_async_commit();
        q_in_flight = true;
      }
      if (!live) continue;

      // online softmax in base 2, each operation rounded on its own.  Row r
      // sees the tile's keys x + 16j with lo < x + 16j <= hi.
      float mx[RPT];
      unsigned seen = 0;                           // bit 4r + j: key j of row r is visible
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int qpos = r0 + 2 * r + half + offset;
        const int hi = min(causal ? qpos - k_lo : BKV - 1, k_hi - k_lo);
        const int lo = window > 0 ? qpos - window - k_lo : -1;
        mx[r] = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // in log2 units: exp2 of a difference is exp of the scores'
          float t;
          if (softcap > 0.f)
            t = __fmul_rn(__fmul_rn(softcap, tanhf(__fdiv_rn(__fmul_rn(s[r][j], scale), softcap))),
                          LOG2E);
          else
            t = __fmul_rn(s[r][j], scale2);
          const bool ok = x + 16 * j <= hi && x + 16 * j > lo;
          seen |= static_cast<unsigned>(ok) << (4 * r + j);
          s[r][j] = ok ? t : NEG_INF;
          mx[r] = fmaxf(mx[r], s[r][j]);
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)        // the 16 lanes of each row
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float mnew = fmaxf(m_run[r], mx[r]);
        const float alpha = ex2(__fsub_rn(m_run[r], mnew));
        float lsum = 0.f;                          // this lane's keys; lanes are summed at the end
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = ex2(__fsub_rn(s[r][j], mnew));
          s[r][j] = (seen >> (4 * r + j)) & 1u ? p : 0.f;
          lsum = __fadd_rn(lsum, s[r][j]);
        }
        l_run[r] = __fmaf_rn(alpha, l_run[r], lsum);
        m_run[r] = mnew;
        if (alpha == 1.f) continue;                // the max stood: acc * 1 is acc
#pragma unroll
        for (int c = 0; c < DC4; ++c) {
          acc[r][c].x = __fmul_rn(acc[r][c].x, alpha);
          acc[r][c].y = __fmul_rn(acc[r][c].y, alpha);
          acc[r][c].z = __fmul_rn(acc[r][c].z, alpha);
          acc[r][c].w = __fmul_rn(acc[r][c].w, alpha);
        }
      }

      // P V, 32 keys at a time through the warp's P slice, keys in order
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (hf) __syncwarp();                      // the first half is read
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          pw[(2 * r + half) * PH + x] = s[r][2 * hf];
          pw[(2 * r + half) * PH + x + 16] = s[r][2 * hf + 1];
        }
        __syncwarp();
#pragma unroll 2
        for (int k4 = 0; k4 < 32; k4 += 4) {
          float4 p[RPT];
#pragma unroll
          for (int r = 0; r < RPT; ++r) p[r] = lds4(pw + (2 * r + half) * PH + k4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const T* vrow = vs + (32 * hf + k4 + e) * DP;
#pragma unroll
            for (int c = 0; c < DC4; ++c) {
              if (NC4 % 16 && x + 16 * c >= NC4) continue;
              const float4 vv = lds4(vrow + 4 * (x + 16 * c));
#pragma unroll
              for (int r = 0; r < RPT; ++r) {
                const float pe = e == 0 ? p[r].x : e == 1 ? p[r].y : e == 2 ? p[r].z : p[r].w;
                acc[r][c].x = fmaf(pe, vv.x, acc[r][c].x);
                acc[r][c].y = fmaf(pe, vv.y, acc[r][c].y);
                acc[r][c].z = fmaf(pe, vv.z, acc[r][c].z);
                acc[r][c].w = fmaf(pe, vv.w, acc[r][c].w);
              }
            }
          }
        }
      }
    }

#pragma unroll
    for (int off = 8; off > 0; off >>= 1)          // each lane's sums of its keys
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        l_run[r] = __fadd_rn(l_run[r], __shfl_xor_sync(0xffffffffu, l_run[r], off));
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = r0 + 2 * r + half;
      if (row >= sq) continue;
      const float l = l_run[r] == 0.f ? 1.f : l_run[r];
      T* o = out + ((static_cast<size_t>(bi) * sq + row) * hq + h) * D;
#pragma unroll
      for (int c = 0; c < DC4; ++c) {
        if (NC4 % 16 && x + 16 * c >= NC4) continue;
        store4(o + 4 * (x + 16 * c),
               make_float4(__fdiv_rn(acc[r][c].x, l), __fdiv_rn(acc[r][c].y, l),
                           __fdiv_rn(acc[r][c].z, l), __fdiv_rn(acc[r][c].w, l)));
      }
    }
  }
}

template <int D, int RPT, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
                   Strides vs, int b, int sq, int skv, int hq, int hkv, int causal, int window,
                   float softcap, float scale, int paired, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D, RPT, T>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<D, RPT, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long nq = (sq + 16 * RPT - 1) / (16 * RPT);
  const long long ctas = (paired ? (nq + 1) / 2 : nq) * b * hq;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_kernel<D, RPT, T><<<static_cast<unsigned>(ctas), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), qs, ks, vs, sq, skv, hq, hkv, causal, window, softcap, scale, paired);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_rows(int bq, const void* q, const void* k, const void* v, void* out,
                        Strides qs, Strides ks, Strides vs, int b, int sq, int skv, int hq,
                        int hkv, int causal, int window, float softcap, float scale, int paired,
                        cudaStream_t stream) {
  switch (bq) {
    case 64:
      return launch<D, 4, T>(q, k, v, out, qs, ks, vs, b, sq, skv, hq, hkv, causal, window,
                             softcap, scale, paired, stream);
    case 128:
      return launch<D, 8, T>(q, k, v, out, qs, ks, vs, b, sq, skv, hq, hkv, causal, window,
                             softcap, scale, paired, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_kind(int kind, int bq, const void* q, const void* k, const void* v, void* out,
                        Strides qs, Strides ks, Strides vs, int b, int sq, int skv, int hq,
                        int hkv, int causal, int window, float softcap, float scale, int paired,
                        cudaStream_t stream) {
  switch (kind) {
    case KIND_F32:
      return launch_rows<D, float>(bq, q, k, v, out, qs, ks, vs, b, sq, skv, hq, hkv, causal,
                                   window, softcap, scale, paired, stream);
    case KIND_BF16:
      return launch_rows<D, __nv_bfloat16>(bq, q, k, v, out, qs, ks, vs, b, sq, skv, hq, hkv,
                                           causal, window, softcap, scale, paired, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: the type of q, k, v and out (0 fp32, 2 bf16).  Head dims:
// multiples of 16 up to 128; bq: query rows per tile, 64 or 128; paired: a
// CTA takes query tiles n-1-u and u.  Strides are in elements, for (batch,
// seq, head); the head dim must be contiguous and every row 16-byte
// aligned (the wrapper checks).  Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int kind, int b, int sq, int skv, int hq, int hkv, int d,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh, int causal,
                                      int window, float softcap, float scale, int bq,
                                      int paired, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  auto st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DIM)                                                                          \
  case DIM:                                                                                      \
    return launch_kind<DIM>(kind, bq, q, k, v, out, qs, ks, vs, b, sq, skv, hq, hkv, causal,    \
                            window, softcap, scale, paired, st)
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
