// Flash attention on Hopper: out = softmax(mask(cap(q k^T * scale))) v per
// (batch, query head), q (b, sq, hq, d), k/v (b, skv, hkv, d), all fp32 or
// all bf16, read through their strides; out (b, sq, hq, d) in their type,
// contiguous.  Two kernels compute it: fp32 runs the FMA loop below on the
// CUDA cores (flash_kernel: fp32 means fp32, no TF32); bf16 runs on the
// tensor cores (flash_wgmma_kernel, further down).  Either way the
// softmax's statistics and sums are fp32 and the output is rounded once.
//
// Replaces: src/repro/kernels/attention.py::flash_attention (Pallas body
// _flash_kernel): blocked online-softmax attention, causal with queries
// aligned to the end of the keys (offset skv - sq), optional sliding window
// and tanh logit softcap, GQA (query head h reads kv head h / (hq / hkv)),
// fully masked kv tiles skipped, fp32 running max / sum / accumulator, and
// a guarded final divide.
//
// fp32.  What bounds it on this card: at a 512-token prefill with d = 128
// the operations (4 * d per unmasked (query, key) pair) on the fp32 CUDA
// cores.  The bytes are q, k, v and out once; the (sq, skv) score matrix
// never touches device memory.  What keeps the kernel from the FMA roof is
// issue slots spent on anything but FMAs (shared-memory loads, the softmax,
// barriers with nothing in flight) and SMs left idle by CTAs of unequal
// work.
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
//
// bf16.  What bounds it: the tensor cores' bf16 rate (989 TFLOP/s) for
// the long prefills and train shapes, the bytes for the short ones.  The
// FMA loop on widened operands this replaces ran at ~32 TFLOP/s, 3 % of
// that bound (PERF.md).  The numerics stay as near the TPU kernel's (which
// widens q, k and v to fp32) as the tensor cores allow:
//  * Q K^T on wgmma m64n64k16, bf16 operands from shared memory: every
//    product is exact in fp32, every score sums d in 16-wide steps, in
//    increasing order, into one fp32 accumulator.
//  * The softmax in registers, in the accumulator's layout (lane (g, tq) of
//    warp v holds rows 16 v + g and that + 8, keys 8 j + 2 tq and that + 1):
//    base 2, one MUFU ex2 a probability, masked scores -1e30 and their p 0,
//    the row's max over the four lanes of a quad by two shuffles; each lane
//    sums its own keys, and the quad's sums meet when the query tile ends.
//  * P V on wgmma m64nDPk16 with A from registers: each fp32 p is split
//    into two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), both summed
//    into the same fp32 accumulators (hi then lo, 16 keys a step, in
//    order), so P carries an error of at most 2^-16 p where one rounding
//    would carry 2^-8 p; the second product doubles only that half of the
//    MMA work.  The S accumulators become the A fragments in place (their
//    layouts agree), so P never goes to shared memory.  V is the B operand,
//    (keys x d) row-major, read with wgmma's transpose bit.
//  * A CTA: NWG consumer warpgroups of 64 query rows each (BQ = 64 or 128,
//    so live_tiles, the pairing and the launch pass's order check keep
//    their meaning) and a producer warp whose first thread keeps TMA loads
//    of K and V tiles (BKV = 64 keys) in flight through a ring of TC_STAGES
//    stages, each guarded by a full and an empty mbarrier; both query
//    tiles' Q are loaded up front into buffers of their own.  TMA reads q,
//    k and v through 4-D tensor maps over their (b, s, h, d) strides; its
//    out-of-bounds zeros fill the sequence's tail and the head dim's
//    padding.  Two warpgroups of a CTA overlap one's softmax with the
//    other's products.
//  * Head dims: a shared-memory row is DP = d rounded up to 64 columns (one
//    or two 128-byte swizzle atoms), padded with TMA's zeros, as the TPU
//    kernel pads d to 128: d = 80 runs Q K^T and P V at 128 columns (the
//    padded columns add +0 to each score and are never stored), about 1.5x
//    its MMA work; 64 and 128 waste none.  Four instantiations (DP in {64,
//    128} by NWG in {1, 2}).
//  * One summation order per output row, whatever the tile height, the
//    pairing or the batch: a row's scores, sums and products depend on its
//    own row of Q and its kv tiles only (a wgmma row depends on its own row
//    of A; Q tiles start at multiples of 64, so a row's place in its
//    warpgroup is the same at either height), and a kv tile in which a row
//    sees no key leaves its statistics unchanged (alpha = 1, hi = lo = 0):
//    a warpgroup skips a tile that none of its rows sees, and rows of a b =
//    4 launch equal a b = 1 launch, bitwise.
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

// the Q tile, two stages of K and V, the warps' P slices (fp32)
template <int D, int RPT>
constexpr int smem_bytes() {
  return (16 * RPT * (D + 4) + 16 * RPT * PH + 4 * BKV * (D + 4)) * static_cast<int>(sizeof(float));
}

// four consecutive elements of a row (16 bytes)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

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
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const float* base, long long row_stride,
                                           int s0, int len) {
  constexpr int NC4 = D / 4;
  if constexpr (THREADS % NC4 == 0) {
    constexpr int STEP = THREADS / NC4;            // rows per pass of the CTA
    const int r0 = threadIdx.x / NC4, c = threadIdx.x % NC4;
    const float* src = base + (s0 + r0) * row_stride + c * 4;
    float* d = dst + r0 * (D + 4) + c * 4;
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

template <int D, int RPT>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, Strides qs_, Strides ks_,
             Strides vs_, int sq, int skv, int hq, int hkv, int causal, int window,
             float softcap, float scale, int paired) {
  constexpr int BQ = 16 * RPT;       // query rows per tile
  constexpr int DP = D + 4;
  constexpr int NC4 = D / 4;         // float4 columns of a row
  constexpr int DC4 = (NC4 + 15) / 16;   // float4 output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kvs = qs + BQ * DP;                        // [stage][K, V][BKV][DP]
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

  const float* qbase = q + bi * qs_.b + h * qs_.h;
  const float* kbase = k + bi * ks_.b + hk * ks_.h;
  const float* vbase = v + bi * vs_.b + hk * vs_.h;
  auto stage_kv = [&](int stage, int kt) {
    float* dst = kvs + stage * 2 * BKV * DP;
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
        stage_rows<D, BQ>(qs, qbase, qs_.s, iq * BQ, sq);
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
      const float* ks = kvs + stage * 2 * BKV * DP;
      const float* vs = ks + BKV * DP;
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
        const float* krow = ks + x * DP;
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
        stage_rows<D, BQ>(qs, qbase, qs_.s, tile1 * BQ, sq);
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
            const float* vrow = vs + (32 * hf + k4 + e) * DP;
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
      float* o = out + ((static_cast<size_t>(bi) * sq + row) * hq + h) * D;
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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
// K and V tiles of BKV keys stream through a ring of TC_STAGES stages; a row
// of q, k or v lies in 64-column boxes of 128 bytes, 128-byte swizzled, DP / 64
// of them, DP the head dim rounded up to 64 (the columns past d are TMA's
// out-of-bounds zeros).  Two query tiles' Q (a CTA takes at most two) have a
// buffer each, so no Q is ever overwritten.
constexpr int TC_STAGES = 3;
constexpr int TC_BOX = BKV * 128;    // one 64-column box of a K or V tile

template <int DP, int NWG>
struct TcTile {
  static constexpr int BQ = 64 * NWG;                 // query rows: a warpgroup's 64 each
  static constexpr int BOXES = DP / 64;
  static constexpr int Q_BYTES = BOXES * BQ * 128;   // one query tile
  static constexpr int KV_BYTES = BOXES * TC_BOX;     // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int THREADS = 128 * NWG + 32;      // the consumers and a producer warp
  // 1024 bytes to align the buffers to the swizzle's period, two Q tiles,
  // the ring, and the mbarriers: full and empty a stage, one a Q tile
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + TC_STAGES * STAGE_BYTES + (2 * TC_STAGES + 2) * 8;
};

__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// S (64 x 64) = A (64 x 16, K-major) @ B (16 x 64, K-major) + S if scale_d:
// the scores of 16 more columns of the head dim.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], unsigned long long a,
                                            unsigned long long b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
// O (64 x 64 or 64 x 128) += A (64 x 16, from registers) @ B (16 x N,
// MN-major): 16 keys of P V.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4],
                                         unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const unsigned (&a)[4],
                                         unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// A pair of bf16 values as one 32-bit register, the first in the low half.
__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const unsigned*>(&h);
}

// grid and tiles as the FMA kernel's; a CTA of TcTile::THREADS threads.
// Warpgroup wg < NWG owns query rows 64 wg .. 64 wg + 63 of each tile; the
// last warp's first thread issues every TMA load.  qmap, kmap and vmap read
// q, k and v as 4-D (d, heads, seq, batch) tensors through their strides,
// in boxes of 64 columns by 1 head by BQ rows (Q) or BKV keys (K, V) by 1
// batch; rows past sq or skv and columns past d arrive as zeros.
template <int DP, int NWG>
__global__ void __launch_bounds__(TcTile<DP, NWG>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                   int d, int sq, int skv, int hq, int hkv, int causal, int window,
                   float softcap, float scale, int paired) {
  using L = TcTile<DP, NWG>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  unsigned char* qbuf =
      tc_smem + ((1024 - (smem_addr(tc_smem) & 1023u)) & 1023u);   // [tile][box][BQ][128 B]
  unsigned char* ring = qbuf + 2 * L::Q_BYTES;                // [stage][K, V][box][BKV][128 B]
  const unsigned full0 = smem_addr(ring + TC_STAGES * L::STAGE_BYTES);
  const unsigned empty0 = full0 + 8 * TC_STAGES;
  const unsigned qfull0 = empty0 + 8 * TC_STAGES;

  const int nq = (sq + BQ - 1) / BQ;
  const int units = paired ? (nq + 1) / 2 : nq;
  const int bhs = gridDim.x / units;
  const int unit = blockIdx.x / bhs, bh = blockIdx.x % bhs;
  const int bi = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int tile0 = nq - 1 - unit, tile1 = unit;
  const int ntiles = paired && tile1 != tile0 ? 2 : 1;
  int kb[2], ke[2];
  kv_range<BQ>(tile0, sq, skv, causal, window, kb[0], ke[0]);
  kv_range<BQ>(tile1, sq, skv, causal, window, kb[1], ke[1]);

  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * NWG);
    }
    mbar_init(qfull0, 1);
    mbar_init(qfull0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (t >= 128 * NWG) {
    // ---- producer: both query tiles' Q, then the kv tiles in loop order ----
    if (t != 128 * NWG) return;
    for (int i = 0; i < ntiles; ++i) {
      const unsigned bar = qfull0 + 8 * i, dst = smem_addr(qbuf + i * L::Q_BYTES);
      mbar_expect_tx(bar, L::Q_BYTES);
      for (int x = 0; x < L::BOXES; ++x)
        tma_load_4d(dst + x * BQ * 128, &qmap, bar, 64 * x, h, (i == 0 ? tile0 : tile1) * BQ, bi);
    }
    int seq = 0;
    for (int i = 0; i < ntiles; ++i)
      for (int kt = kb[i]; kt < ke[i]; ++kt, ++seq) {
        const int slot = seq % TC_STAGES;
        if (seq >= TC_STAGES) mbar_wait(empty0 + 8 * slot, ((seq / TC_STAGES) - 1) & 1);
        const unsigned bar = full0 + 8 * slot;
        const unsigned kd = smem_addr(ring + slot * L::STAGE_BYTES), vd = kd + L::KV_BYTES;
        mbar_expect_tx(bar, L::STAGE_BYTES);
        for (int x = 0; x < L::BOXES; ++x) {
          tma_load_4d(kd + x * TC_BOX, &kmap, bar, 64 * x, hk, kt * BKV, bi);
          tma_load_4d(vd + x * TC_BOX, &vmap, bar, 64 * x, hk, kt * BKV, bi);
        }
      }
    return;
  }

  // ---- consumers: warp v of warpgroup wg; lane (g, tq) holds rows
  // 16 v + g and that + 8 (index hh), columns or keys 8 j + 2 tq + e at
  // [4 j + 2 hh + e] of its accumulators ----
  const int wg = t / 128, v = (t % 128) / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int offset = skv - sq;                     // queries sit at the end
  const float scale2 = __fmul_rn(scale, LOG2E);
  int seq = 0;
  for (int i = 0; i < ntiles; ++i) {
    const int iq = i == 0 ? tile0 : tile1;
    const int r0 = iq * BQ + wg * 64;              // the warpgroup's first row
    const int r_last = min(r0 + 63, sq - 1);       // its last real row
    const int row0 = r0 + 16 * v + g;              // this thread's rows: row0, row0 + 8
    const unsigned qa = smem_addr(qbuf + i * L::Q_BYTES) + wg * 64 * 128;
    mbar_wait(qfull0 + 8 * i, 0);

    float o[DP / 2], m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < DP / 2; ++c) o[c] = 0.f;

    for (int kt = kb[i]; kt < ke[i]; ++kt, ++seq) {
      const int slot = seq % TC_STAGES;
      mbar_wait(full0 + 8 * slot, (seq / TC_STAGES) & 1);
      // a tile that none of the warpgroup's real rows sees would leave
      // their statistics and sums unchanged: skip it
      const int k_lo = kt * BKV, k_hi = min(k_lo + BKV, skv) - 1;
      const bool live = r_last >= r0 && !(causal && k_lo > r_last + offset) &&
                        !(window > 0 && k_hi <= r0 + offset - window);
      if (live) {
        const unsigned ka = smem_addr(ring + slot * L::STAGE_BYTES), va = ka + L::KV_BYTES;
        // scores: d in 16-wide steps, in order (the padded columns add +0)
        float s[32];
#pragma unroll
        for (int c = 0; c < 32; ++c) s[c] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss_n64(s, wgmma_desc(qa + (kk / 4) * BQ * 128 + 32 * (kk % 4), 16, 1024),
                       wgmma_desc(ka + (kk / 4) * TC_BOX + 32 * (kk % 4), 16, 1024), kk > 0);
        wgmma_commit();
        fence_operands(s);
        wgmma_wait_all();
        fence_operands(s);

        // online softmax in base 2, each operation rounded on its own; the
        // four lanes of a row (tq) share its max through two shuffles
        unsigned seen = 0;                         // bit 4 j + 2 hh + e: that key is visible
        float mx[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int qpos = row0 + 8 * hh + offset;
          const int hi = min(causal ? qpos - k_lo : BKV - 1, k_hi - k_lo);
          const int lo = window > 0 ? qpos - window - k_lo : -1;
          mx[hh] = NEG_INF;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = 8 * j + 2 * tq + e, c = 4 * j + 2 * hh + e;
              float tv;
              if (softcap > 0.f)
                tv = __fmul_rn(__fmul_rn(softcap, tanhf(__fdiv_rn(__fmul_rn(s[c], scale), softcap))),
                               LOG2E);
              else
                tv = __fmul_rn(s[c], scale2);
              const bool ok = key <= hi && key > lo;
              seen |= static_cast<unsigned>(ok) << c;
              s[c] = ok ? tv : NEG_INF;
              mx[hh] = fmaxf(mx[hh], s[c]);
            }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], off));
        float alpha[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float mnew = fmaxf(m_run[hh], mx[hh]);
          alpha[hh] = ex2(__fsub_rn(m_run[hh], mnew));
          float lsum = 0.f;                        // this lane's keys; the quad is summed at the end
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 4 * j + 2 * hh + e;
              s[c] = (seen >> c) & 1u ? ex2(__fsub_rn(s[c], mnew)) : 0.f;
              lsum = __fadd_rn(lsum, s[c]);
            }
          l_run[hh] = __fmaf_rn(alpha[hh], l_run[hh], lsum);
          m_run[hh] = mnew;
        }
#pragma unroll
        for (int c = 0; c < DP / 2; ++c) o[c] = __fmul_rn(o[c], alpha[(c >> 1) & 1]);

        // P as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), in the A
        // fragments of the four 16-key steps: register r of step kk holds
        // keys 16 kk + 8 (r / 2) + 2 tq + {0, 1} of row hh = r % 2
        unsigned ph[4][4], pl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int c = 4 * (2 * kk + r / 2) + 2 * (r % 2);
            const __nv_bfloat162 hi2 = __floats2bfloat162_rn(s[c], s[c + 1]);
            const float2 hf = __bfloat1622float2(hi2);
            ph[kk][r] = bf16x2_bits(hi2);
            pl[kk][r] = bf16x2_bits(__floats2bfloat162_rn(__fsub_rn(s[c], hf.x), __fsub_rn(s[c + 1], hf.y)));
          }

        // P V: 16 keys a step, in order, hi then lo into the same sums
        fence_operands(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const unsigned long long vb = wgmma_desc(va + kk * 16 * 128, TC_BOX, 1024);
          wgmma_rs(o, ph[kk], vb);
          wgmma_rs(o, pl[kk], vb);
        }
        wgmma_commit();
        fence_operands(o);
        wgmma_wait_all();
        fence_operands(o);
      }
      mbar_arrive(empty0 + 8 * slot);              // this thread is done with the stage
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1)          // each lane's sums of its keys
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l_run[hh] = __fadd_rn(l_run[hh], __shfl_xor_sync(0xffffffffu, l_run[hh], off));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= sq) continue;
      const float l = l_run[hh] == 0.f ? 1.f : l_run[hh];
      __nv_bfloat16* orow = out + ((static_cast<size_t>(bi) * sq + row) * hq + h) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        if (c < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2 * hh], l), __fdiv_rn(o[4 * j + 2 * hh + 1], l));
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  Strides qs, ks, vs;
  int b, sq, skv, hq, hkv, d, causal, window;
  float softcap, scale;
  int paired;
  cudaStream_t stream;
};

template <int D, int RPT>
cudaError_t launch(const Args& a) {
  constexpr int bytes = smem_bytes<D, RPT>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<D, RPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long nq = (a.sq + 16 * RPT - 1) / (16 * RPT);
  const long long ctas = (a.paired ? (nq + 1) / 2 : nq) * a.b * a.hq;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_kernel<D, RPT><<<static_cast<unsigned>(ctas), THREADS, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<float*>(a.out), a.qs, a.ks, a.vs, a.sq, a.skv, a.hq, a.hkv, a.causal, a.window,
      a.softcap, a.scale, a.paired);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rows(int bq, const Args& a) {
  switch (bq) {
    case 64: return launch<D, 4>(a);
    case 128: return launch<D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_fp32(int bq, const Args& a) {
  switch (a.d) {
    case 16: return launch_rows<16>(bq, a);
    case 32: return launch_rows<32>(bq, a);
    case 48: return launch_rows<48>(bq, a);
    case 64: return launch_rows<64>(bq, a);
    case 80: return launch_rows<80>(bq, a);
    case 96: return launch_rows<96>(bq, a);
    case 112: return launch_rows<112>(bq, a);
    case 128: return launch_rows<128>(bq, a);
    default: return cudaErrorInvalidValue;
  }
}

// The tensor map of a bf16 (batch, seq, heads, d) tensor with these
// strides (elements; d contiguous), read in boxes of 64 columns, 1 head and
// `rows` rows, 128-byte swizzle, zeros out of bounds.  A dimension of size 1
// is never stepped over: it takes the stride of a packed layout, so that
// whatever stride PyTorch reports for it never reaches the tensor map.
bool encode_heads(CUtensorMap* map, const void* base, int d, int heads, int seq, int batch,
                  const Strides& st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq > 0 ? seq : 1),
                              static_cast<cuuint64_t>(batch)};
  const long long el[3] = {st.h, st.s, st.b};
  cuuint64_t strides[3];
  cuuint64_t packed = static_cast<cuuint64_t>(d) * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? packed : static_cast<cuuint64_t>(el[i]) * 2;
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int NWG>
cudaError_t launch_tc(const Args& a) {
  using L = TcTile<DP, NWG>;
  auto kern = flash_wgmma_kernel<DP, NWG>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap{}, kmap{}, vmap{};
  if (!encode_heads(&qmap, a.q, a.d, a.hq, a.sq, a.b, a.qs, L::BQ) ||
      !encode_heads(&kmap, a.k, a.d, a.hkv, a.skv, a.b, a.ks, BKV) ||
      !encode_heads(&vmap, a.v, a.d, a.hkv, a.skv, a.b, a.vs, BKV))
    return cudaErrorInvalidValue;
  const long long nq = (a.sq + L::BQ - 1) / L::BQ;
  const long long ctas = (a.paired ? (nq + 1) / 2 : nq) * a.b * a.hq;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<static_cast<unsigned>(ctas), L::THREADS, L::SMEM, a.stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(a.out), a.d, a.sq, a.skv, a.hq, a.hkv,
      a.causal, a.window, a.softcap, a.scale, a.paired);
  return cudaGetLastError();
}

cudaError_t launch_bf16(int bq, const Args& a) {
  const bool wide = a.d > 64;                      // DP = 128, else 64
  switch (bq) {
    case 64: return wide ? launch_tc<128, 1>(a) : launch_tc<64, 1>(a);
    case 128: return wide ? launch_tc<128, 2>(a) : launch_tc<64, 2>(a);
    default: return cudaErrorInvalidValue;
  }
}

bool head_dim_ok(int d) { return d >= 16 && d <= 128 && d % 16 == 0; }

}  // namespace

// kind: the type of q, k, v and out (0 fp32: the FMA kernel; 2 bf16: the
// tensor cores).  Head dims: multiples of 16 up to 128; bq: query rows per
// tile, 64 or 128; paired: a CTA takes query tiles n-1-u and u.  Strides are
// in elements, for (batch, seq, head); the head dim must be contiguous and
// every row and base 16-byte aligned (the wrapper checks).  Returns
// cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int kind, int b, int sq, int skv, int hq, int hkv, int d,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh, int causal,
                                      int window, float softcap, float scale, int bq,
                                      int paired, void* stream) {
  if (!head_dim_ok(d) || hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, out, {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
               b, sq, skv, hq, hkv, d, causal, window, softcap, scale, paired,
               static_cast<cudaStream_t>(stream)};
  if (kind == KIND_F32) return launch_fp32(bq, a);
  if (kind == KIND_BF16) return launch_bf16(bq, a);
  return cudaErrorInvalidValue;
}

namespace {

template <int D>
int smem_fp32(int bq) {
  switch (bq) {
    case 64: return smem_bytes<D, 4>();
    case 128: return smem_bytes<D, 8>();
    default: return -1;
  }
}

}  // namespace

// The dynamic shared memory flash_attention_launch passes for head dim d,
// query tiles of bq rows and element type kind (as it takes them), or -1
// where it has no instantiation: what repro_torch/analysis/launch.py
// derives, asked of the built kernel.
extern "C" int flash_smem(int d, int bq, int kind) {
  if (!head_dim_ok(d)) return -1;
  if (kind == KIND_BF16) {
    const bool wide = d > 64;
    if (bq == 64) return wide ? TcTile<128, 1>::SMEM : TcTile<64, 1>::SMEM;
    if (bq == 128) return wide ? TcTile<128, 2>::SMEM : TcTile<64, 2>::SMEM;
    return -1;
  }
  if (kind != KIND_F32) return -1;
  switch (d) {
    case 16: return smem_fp32<16>(bq);
    case 32: return smem_fp32<32>(bq);
    case 48: return smem_fp32<48>(bq);
    case 64: return smem_fp32<64>(bq);
    case 80: return smem_fp32<80>(bq);
    case 96: return smem_fp32<96>(bq);
    case 112: return smem_fp32<112>(bq);
    case 128: return smem_fp32<128>(bq);
    default: return -1;
  }
}
