// SA-CONV GEMM on Hopper: out = act((x @ w) * scale + bias), x (m, k) fp32
// or bf16, w (k, n) fp32, bf16 or int8, fp32 accumulation, out (m, n) fp32
// or bf16.
//
// The function is the TPU kernel's, whatever the types: w is rounded to
// x's type (an fp32 w with bf16 x to nearest even; int8 and bf16 weights
// are exact), every product is summed in fp32 (a product of two bf16
// values is exact in fp32); the epilogue runs in fp32, once per output,
// and the result is rounded once to the output type.  Two kernels compute
// it: fp32 x runs the FMA loop below on the CUDA cores (sa_conv_gemm_kernel:
// fp32 means fp32, no TF32); bf16 x runs on the tensor cores
// (sa_conv_wgmma_kernel, further down), as the TPU kernel runs its bf16
// product on the matrix unit (jnp.dot with preferred_element_type fp32).
//
// Replaces: src/repro/kernels/sa_conv.py::sa_conv_matmul (Pallas body
// _sa_conv_kernel), the output-stationary SA-CONV dataflow for matmuls the
// planner puts in the compute-bound regime (an LM's prefill projections).
//
// fp32 x.  What bounds it on this card: the fp32 FMA rate.  At m = 2048
// every weight is reused 2048 times, so the operations (2*m*n*k over 67
// TFLOP/s on the CUDA cores) take about 10x longer than moving the
// operands once.  An SM issues one warp instruction per scheduler per
// cycle and retires one warp FFMA per scheduler per cycle, so every other
// instruction on the k loop (shared-memory loads, copies, addresses,
// barriers) takes the place of an FMA.
//
// What held the first design back, at 30.3-33.1 TFLOP/s on OLMo-1B's
// prefill shapes (1.51-1.72x torch.mm), and what this one does:
//  1. Spills: 404 bytes per instantiation on the k loop, under the 128
//     registers of two CTAs per SM, from 64 sums, 16 fragment values and 8
//     registers of staged loads.  The tile stays 128 x 128 outputs per CTA
//     of 256 threads, 8 x 8 a thread, two CTAs per SM, but no register
//     holds a load in flight any more (item 2), so ptxas fits the sums, two
//     k steps of fragments and the addresses in 128 registers, no spill.
//     The fragments of step k + 1 are loaded while step k's 64 FMAs run.
//     Measured against one CTA per SM with 8 x 16 a thread (up to 255
//     registers): two CTAs overlap one CTA's barrier and copies with the
//     other's FMAs, and ran 1-10 % faster at every path shape.
//  2. Loads staged through registers, 4 bytes at a time.  Now a ring of
//     STAGES stages in dynamic shared memory is filled by cp.async: w's
//     rows (n contiguous) in 16-byte pieces straight into a k-major tile (8
//     or 4 bytes, or element loads, where a row's bytes or its base allow no
//     more), x in 4-byte copies transposed into a k-major tile padded to
//     BM + 4 floats (a warp's copies cover two rows of 16 k; its fragment
//     loads are conflict-free).  Interior tiles and stages copy without
//     masks: 8 x copies and 2 w copies a thread per stage, ~85 instructions
//     for 1024 FMAs.  int8 and bf16 weights cross memory in 1 or 2 bytes and
//     are widened as fragments are loaded.
//  3. A short chunk: 8 k between barriers, one chunk in flight.  Now 16 k
//     per stage and STAGES - 1 = 3 stages in flight (32 k spilled at 128
//     registers; 3 stages ran slower).
//  4. A grid with n fastest.  Now m is fastest: the row tiles that share a
//     w panel run together (n fastest ran 6-10 % slower here).  At m = 2048
//     that is 256 CTAs (0.97 of the 264 slots) for q/k/v/o and down, 1024
//     for gate/up and 6288 for the lm_head.
//
// bf16 x.  What bounds it: the tensor cores' bf16 rate (989 TFLOP/s), ~295
// operations per byte of device memory, which every prefill and train
// GEMM of the LM paths exceeds.  The widened FMA loop this replaces ran at
// 4.5 % of that bound (PERF.md).  One CTA per 128 x 128 output tile, row
// tiles fastest, one CTA per SM (128 KB of ring and more); three warpgroups:
//  - two consumer warpgroups, 64 rows each, issue wgmma.mma_async
//    m64n128k16 (bf16 in, fp32 accumulators in registers), four per ring
//    stage of BK = 64 k, one stage's group left in flight while the next
//    is issued.  x (m, k) row-major is the K-major A operand, w (k, n)
//    row-major the MN-major B operand (wgmma's transpose flag), both in
//    128-byte-swizzled shared memory, read by descriptors.
//  - one producer warpgroup (setmaxnreg gives its registers to the
//    consumers) fills a ring of TC_STAGES stages, each guarded by a full
//    and an empty mbarrier.  Two producers write the same swizzled layout:
//      TMA (cp.async.bulk.tensor.2d, one thread; tensor maps built by the
//      launcher through cudaGetDriverEntryPoint) where x and w are bf16
//      with 16-byte-aligned bases and rows (k % 8 == 0, n % 8 == 0);
//      cp.async otherwise (16- or 4-byte pieces or element loads,
//      zero-filled), for odd widths and bases and for fp32 and int8
//      weights, which land in a raw staging ring and are rounded to bf16
//      into the swizzled tile (fp32 to nearest even, int8 exactly).
//    Ragged m, n and k are zero-filled by either producer and masked at the
//    stores.
//
// One summation order per output.  fp32 x: every output's k sum runs in
// one thread, in increasing k, one fmaf per term, from +0, with no split
// over k.  bf16 x: every output's k sum runs in 16-wide wgmma steps, in
// increasing k, into one fp32 register that starts at +0, with no split
// over k; inside a step the tensor core's own (deterministic) order
// applies.  Tile, BK and producer depend on (n, k, types, alignment),
// never on m, and m and the grid change which thread computes an output,
// never its terms or their order, so row r of any launch equals row r of
// a launch over fewer rows, bitwise.  The zero-filled k padding adds +0
// after every real term.  The epilogue applies scale, then bias, then the
// activation once per output, in fp32, in the plain version's order.
#include "common.cuh"

namespace {

// The tiling (kernels/sa_conv.py holds the same constants; the launch
// refuses another BN).  8 warps, 2 along m by 4 along n, each 64 x 32; a
// thread owns rows ty..ty+3 and ty+32..ty+35 by columns tx..tx+3 and
// tx+16..tx+19 of its CTA's tile.
constexpr int BM = 128;              // rows per CTA
constexpr int BN = 128;              // columns per CTA
constexpr int THREADS = 256;
constexpr int PER_SM = 2;            // CTAs per SM: 128 registers a thread
constexpr int BK = 16;               // k per ring stage
constexpr int STAGES = 4;            // ring depth: STAGES - 1 stages in flight
constexpr int AP = BM + 4;           // padded k row of the transposed x tile (floats)
constexpr int XPT = BM * BK / THREADS;  // x copies per thread per stage

// One stage of the ring: x k-major fp32 as copied, then w as copied.
template <typename WT, typename XT>
struct Ring {
  static constexpr int DEPTH = STAGES;
  static constexpr int X_BYTES = BK * AP * 4;
  static constexpr int W_BYTES = BK * BN * static_cast<int>(sizeof(WT));
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int SMEM = DEPTH * STAGE_BYTES;
  static_assert(STAGE_BYTES % 16 == 0, "stages start 16-byte aligned");
};

// The thread's 8 staged weights of one k row (columns tx..tx+3 and
// tx+16..tx+19), widened to fp32.
__device__ __forceinline__ void load_b(const float* p, float* v) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float4 q = *reinterpret_cast<const float4*>(p + 16 * j);
    v[4 * j] = q.x; v[4 * j + 1] = q.y; v[4 * j + 2] = q.z; v[4 * j + 3] = q.w;
  }
}
__device__ __forceinline__ void load_b(const int8_t* p, float* v) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const char4 q = *reinterpret_cast<const char4*>(p + 16 * j);
    v[4 * j] = q.x; v[4 * j + 1] = q.y; v[4 * j + 2] = q.z; v[4 * j + 3] = q.w;
  }
}
__device__ __forceinline__ void load_b(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint2 q = *reinterpret_cast<const uint2*>(p + 16 * j);
    v[4 * j] = __uint_as_float(q.x << 16); v[4 * j + 1] = __uint_as_float(q.x & 0xffff0000u);
    v[4 * j + 2] = __uint_as_float(q.y << 16); v[4 * j + 3] = __uint_as_float(q.y & 0xffff0000u);
  }
}

// R rows x ROW_BYTES bytes of a row-major matrix (rows `stride` elements
// apart) into shared memory, rows PITCH bytes apart: the stage's k-major w
// tile (R = BK, PITCH = ROW_BYTES).  V bytes per cp.async, consecutive
// threads on consecutive pieces of a row.  MASKED: rows >= `rows` and
// elements >= `cols` are zero-filled (a V-byte piece is wholly in or out: V
// divides a row's bytes); unmasked for a tile inside both.
template <int V, int R, int ROW_BYTES, int PITCH, bool MASKED = true, typename T>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const T* src, int stride, int rows,
                                          int cols, const T* any, int t) {
  constexpr int PER_ROW = ROW_BYTES / V;                  // pieces per row
  constexpr int EL = V / static_cast<int>(sizeof(T));
  static_assert(THREADS % PER_ROW == 0, "a thread keeps its column");
  constexpr int RSTEP = THREADS / PER_ROW;                // rows between a thread's pieces
  constexpr int ITER = (R + RSTEP - 1) / RSTEP;
  const int cv = t % PER_ROW;
  int r = t / PER_ROW;
  if (R % RSTEP != 0 && r >= R) return;                   // (only when ITER == 1)
  const bool col_ok = cv * EL < cols;
  const T* s = src + (r * stride + cv * EL);
  unsigned char* d = dst + r * PITCH + cv * V;
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const bool ok = !MASKED || (col_ok && r < rows);
    cp_async<V>(d, ok ? s : any, ok ? V : 0);
    r += RSTEP;
    s += RSTEP * stride;
    d += RSTEP * PITCH;
  }
}

template <int V, int ROW_BYTES, bool MASKED = true, typename T>
__device__ __forceinline__ void copy_w(unsigned char* dst, const T* src, int stride, int rows,
                                       int cols, const T* any, int t) {
  copy_rows<V, BK, ROW_BYTES, ROW_BYTES, MASKED>(dst, src, stride, rows, cols, any, t);
}

// Four adjacent outputs in one store: a float4, or four bf16 in 8 bytes.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// The epilogue of a thread's 8 x 8 sums (rows row0..row0+3 and row0+32..
// row0+35, columns col0..col0+3 and col0+16..col0+19): scale, bias, then
// the activation, rounded once to the output type.
template <typename OT>
__device__ __forceinline__ void store_tile(const float (&acc)[8][8], const float* scale,
                                           const float* bias, OT* out, int m, int n, int row0,
                                           int col0, int act) {
  const bool vec = (n % 4) == 0;     // rows start 16-byte (fp32) or 8-byte (bf16) aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? i : 28 + i);
    if (row >= m) continue;
    OT* orow = out + static_cast<size_t>(row) * n;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = col0 + 16 * j;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = c + e < n ? apply_act(scale_bias(acc[i][4 * j + e], scale, bias, c + e), act) : 0.f;
      if (vec && c + 3 < n) {
        store4(orow + c, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < n) store_out(orow + c + e, v[e]);
      }
    }
  }
}

// grid: one CTA per (row tile, column tile), row tile fastest.  wvec:
// bytes per copy of a w row piece (16, 8 or 4; 0: element loads); x moves
// in 4-byte copies.
template <typename WT, typename XT, typename OT>
__global__ void __launch_bounds__(THREADS, PER_SM)
sa_conv_gemm_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    OT* __restrict__ out, int m, int n, int k, int row_tiles, int wvec, int act) {
  using C = Ring<WT, XT>;
  constexpr int DEPTH = C::DEPTH;
  constexpr int ROW_BYTES = BN * static_cast<int>(sizeof(WT));
  extern __shared__ __align__(16) unsigned char smem[];

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int ty = (warp / 4) * 64 + (lane / 4) * 4;
  const int tx = (warp % 4) * 32 + (lane % 4) * 4;
  const int row0 = (blockIdx.x % row_tiles) * BM;
  const int col0 = (blockIdx.x / row_tiles) * BN;
  const int nst = (k + BK - 1) / BK;

  // x: the thread copies element (xr + (THREADS / BK) i, xk) of each stage
  const int xk = t % BK, xr = t / BK;
  const int xrows = m - row0;
  const XT* xsrc = x + (static_cast<size_t>(row0 + xr) * k + xk);
  const size_t xstep = static_cast<size_t>(THREADS / BK) * k;  // between a thread's x rows
  // Interior tiles and stages take their copies unmasked.
  const bool full_m = row0 + BM <= m, full_n = col0 + BN <= n;

  // stage s of x and w into ring slot `slot`
  auto load = [&](int s, int slot) {
    unsigned char* base = smem + slot * C::STAGE_BYTES;
    const int k0 = s * BK;
    const bool full_k = k0 + BK <= k;
    {                                // x transposed to k-major at copy time
      float* xs = reinterpret_cast<float*>(base) + xk * AP + xr;
      const XT* xp = xsrc + k0;
      if (full_m && full_k) {
#pragma unroll
        for (int i = 0; i < XPT; ++i) cp_async<4>(xs + (THREADS / BK) * i, xp + i * xstep, 4);
      } else {
        const bool k_ok = k0 + xk < k;
#pragma unroll
        for (int i = 0; i < XPT; ++i) {
          const bool ok = k_ok && xr + (THREADS / BK) * i < xrows;
          cp_async<4>(xs + (THREADS / BK) * i, ok ? xp + i * xstep : x, ok ? 4 : 0);
        }
      }
    }
    unsigned char* ws = base + C::X_BYTES;
    const WT* wt = w + (static_cast<size_t>(k0) * n + col0);
    if (wvec == 16 && full_n && full_k)
      copy_w<16, ROW_BYTES, false>(ws, wt, n, k - k0, n - col0, w, t);
    else if (wvec == 16)
      copy_w<16, ROW_BYTES>(ws, wt, n, k - k0, n - col0, w, t);
    else if (wvec == 8)
      copy_w<8, ROW_BYTES>(ws, wt, n, k - k0, n - col0, w, t);
    else if (wvec == 4)
      copy_w<4, ROW_BYTES>(ws, wt, n, k - k0, n - col0, w, t);
    else {
      WT* wd = reinterpret_cast<WT*>(ws);
      for (int e = t; e < BK * BN; e += THREADS) {
        const int kk = k0 + e / BN, col = col0 + e % BN;
        wd[e] = (kk < k && col < n) ? w[static_cast<size_t>(kk) * n + col] : WT{};
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float a[2][8], b[2][8];
  // the fragments of k step kk of a stage: x rows ty.. and ty+32.., w
  // columns
  auto frag = [&](const float* xs, const auto* ws, int kk, float* av, float* bv) {
    const float4 a0 = *reinterpret_cast<const float4*>(xs + kk * AP);
    const float4 a1 = *reinterpret_cast<const float4*>(xs + kk * AP + 32);
    av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
    av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
    load_b(ws + kk * BN, bv);
  };
  // the 16 k steps of one stage, the x tile at xs (k-major fp32)
  auto compute = [&](const float* xs, const auto* ws) {
    frag(xs, ws, 0, a[0], b[0]);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const int cur = kk & 1;
      if (kk + 1 < BK) frag(xs, ws, kk + 1, a[cur ^ 1], b[cur ^ 1]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[cur][i], b[cur][j], acc[i][j]);
    }
  };

#pragma unroll
  for (int s = 0; s < DEPTH - 1; ++s) {
    if (s < nst) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<DEPTH - 2>();
    __syncthreads();               // stage s landed; slot (s - 1) % DEPTH is free
    const int nx = s + DEPTH - 1;
    if (nx < nst) load(nx, nx % DEPTH);
    cp_async_commit();

    const unsigned char* base = smem + (s % DEPTH) * C::STAGE_BYTES;
    compute(reinterpret_cast<const float*>(base) + ty,
            reinterpret_cast<const WT*>(base + C::X_BYTES) + tx);
  }

  store_tile(acc, scale, bias, out, m, n, row0 + ty, col0 + tx, act);
}

// ---------------------------------------------------------------------------
// bf16 x on the tensor cores
// ---------------------------------------------------------------------------
// The tiling (kernels/sa_conv.py holds the same constants).  Warpgroups 0
// and 1 consume (rows 64 wg .. 64 wg + 63 of the tile each), warpgroup 2
// produces.  A stage holds x's 128 x 64 tile (one 128-byte row of 64 k per
// x row) and w's 64 x 128 tile (two boxes of 64 columns, one 128-byte row
// per k), both 128-byte swizzled.
constexpr int TC_BM = 128;           // rows per CTA
constexpr int TC_BN = 128;           // columns per CTA
constexpr int TC_BK = 64;            // k per ring stage: 128 bytes of bf16
constexpr int TC_STAGES = 4;         // ring depth
constexpr int TC_RAW_STAGES = 3;     // raw fp32 / int8 w stages (cp.async producer)
constexpr int TC_CONSUMERS = 256;    // threads of the two consumer warpgroups
constexpr int TC_THREADS = 384;      // and the producer warpgroup
constexpr int TC_ALIGN = 1024;       // the 128-byte swizzle's period
constexpr int TC_A_BYTES = TC_BM * TC_BK * 2;
constexpr int TC_B_BYTES = TC_BK * TC_BN * 2;
constexpr int TC_BOX = TC_BK * 128;  // one 64-column box of the w tile
constexpr int TC_REGS = 168;         // registers a thread at launch: 65536 / 384, rounded to 8

// The ring, the raw staging ring (fp32 and int8 weights only), then a
// full and an empty mbarrier per stage; TC_ALIGN bytes of slack to align
// the ring to the swizzle's period.
template <typename WT>
struct TcRing {
  static constexpr bool CONVERT = sizeof(WT) != 2;
  static constexpr int STAGE_BYTES = TC_A_BYTES + TC_B_BYTES;
  static constexpr int RAW_BYTES = TC_BK * TC_BN * static_cast<int>(sizeof(WT));
  static constexpr int RAW = CONVERT ? TC_RAW_STAGES * RAW_BYTES : 0;
  static constexpr int SMEM = TC_ALIGN + TC_STAGES * STAGE_BYTES + RAW + 2 * TC_STAGES * 8;
};

// Byte offset o of a 1024-byte-aligned block of 128-byte rows, as the
// 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B, wgmma's layout 1)
// places it: the 16-byte chunk of a row XOR the row's index mod 8.
__device__ __forceinline__ unsigned sw128(unsigned o) { return o ^ (((o >> 7) & 7u) << 4); }

__device__ __forceinline__ void producer_sync() {   // the producer warpgroup's 128 threads
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// R rows of ROW_BYTES bytes of a row-major matrix (rows `stride` elements
// apart) into a stage by the producer warpgroup's 128 threads (pt): V
// bytes per cp.async (0: element loads), consecutive threads on
// consecutive pieces of a row, each thread on one piece of every RSTEP-th
// row; rows >= `rows` and elements >= `cols` are zero-filled (a V-byte
// piece is wholly in or out: V divides a row's bytes and the tile's first
// column).  SWZ: into 128-byte boxes of R rows, swizzled as TMA writes
// them; else row-major (the raw staging ring).
template <int V, int R, int ROW_BYTES, bool SWZ, typename T>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const T* src, size_t stride,
                                           int rows, int cols, const T* any, int pt) {
  constexpr int SZ = static_cast<int>(sizeof(T));
  constexpr int VB = V == 0 ? SZ : V;                    // bytes per piece
  constexpr int EL = VB / SZ;
  constexpr int PER_ROW = ROW_BYTES / VB;
  static_assert(128 % PER_ROW == 0, "a thread keeps its piece of the row");
  constexpr int RSTEP = 128 / PER_ROW;                   // rows between a thread's pieces
  static_assert(R % RSTEP == 0, "every thread takes as many pieces");
  const int c = pt % PER_ROW, r0 = pt / PER_ROW;
  const int b = c * VB;
  const bool col_ok = c * EL < cols;
  // the 128-byte box of the piece, its byte within a row of the box
  const unsigned box = SWZ ? (b / 128) * (R * 128) : 0, in_row = SWZ ? b % 128 : b;
  const T* s = src + (static_cast<size_t>(r0) * stride + c * EL);
#pragma unroll 4
  for (int i = 0; i < R / RSTEP; ++i) {
    const int r = r0 + i * RSTEP;
    const unsigned off = SWZ ? box + r * 128 + (in_row ^ ((r & 7) << 4))
                             : static_cast<unsigned>(r * ROW_BYTES) + in_row;
    const bool ok = col_ok && r < rows;
    if constexpr (V == 0)
      *reinterpret_cast<T*>(dst + off) = ok ? *s : T{};
    else
      cp_async<V>(dst + off, ok ? s : any, ok ? V : 0);
    s += RSTEP * stride;
  }
}

// Eight weights of the raw staging ring as eight bf16 (an fp32 weight
// rounded to nearest even, int8 exactly), packed for one 16-byte store.
__device__ __forceinline__ unsigned bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ uint4 to_bf16x8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(b.x, b.y), bf16x2(b.z, b.w));
}
__device__ __forceinline__ uint4 to_bf16x8(const int8_t* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = static_cast<float>(static_cast<int8_t>(((j < 4 ? q.x : q.y) >> (8 * (j % 4))) & 0xffu));
  return make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]), bf16x2(v[6], v[7]));
}

// Two adjacent outputs in one store: a float2, or two bf16 in 4 bytes.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// grid: one CTA per (row tile, column tile), row tile fastest, as the FMA
// kernel's.  TMA: the producer loads through xmap and wmap (bf16 x and w,
// boxes of 64 x 128 and 64 x 64, 128-byte swizzle, out-of-bounds zeros);
// else through cp.async, 16- or 4-byte pieces or element loads (wvec /
// xvec 16, 8 or 4, 0).  out is fp32, or bf16 where out_bf16: a branch of
// the epilogue, not an instantiation, to keep the build short.
template <typename WT, bool TMA>
__global__ void __launch_bounds__(TC_THREADS, 1)
sa_conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                     const __nv_bfloat16* __restrict__ x, const WT* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     void* __restrict__ out, int out_bf16, int m, int n, int k, int row_tiles,
                     int wvec, int xvec, int act) {
  using C = TcRing<WT>;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  unsigned char* ring = tc_smem + ((TC_ALIGN - (smem_addr(tc_smem) & (TC_ALIGN - 1))) & (TC_ALIGN - 1));
  unsigned char* raw = ring + TC_STAGES * C::STAGE_BYTES;
  const unsigned full0 = smem_addr(raw + C::RAW);        // full[s] = full0 + 8 s
  const unsigned empty0 = full0 + 8 * TC_STAGES;
  auto a_tile = [&](int slot) { return ring + slot * C::STAGE_BYTES; };
  auto b_tile = [&](int slot) { return ring + slot * C::STAGE_BYTES + TC_A_BYTES; };

  const int t = threadIdx.x;
  const int row0 = (blockIdx.x % row_tiles) * TC_BM;
  const int col0 = (blockIdx.x / row_tiles) * TC_BN;
  const int nst = (k + TC_BK - 1) / TC_BK;
  // registers a thread after setmaxnreg: one TMA thread needs few, the
  // cp.async producer's address and mask arithmetic more
  constexpr int PRODUCER_REGS = TMA ? 40 : 120;
  constexpr int CONSUMER_REGS = (TC_REGS * TC_THREADS - PRODUCER_REGS * 128) / TC_CONSUMERS;
  static_assert(CONSUMER_REGS % 8 == 0 &&
                    PRODUCER_REGS * 128 + CONSUMER_REGS * TC_CONSUMERS == TC_REGS * TC_THREADS,
                "setmaxnreg redistributes the CTA's registers, no more");

  if (t == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full0 + 8 * s, TMA ? 1 : 128);
      mbar_init(empty0 + 8 * s, TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (t >= TC_CONSUMERS) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = t - TC_CONSUMERS;
    if constexpr (TMA) {
      if (pt != 0) return;
      for (int s = 0; s < nst; ++s) {
        const int slot = s % TC_STAGES;
        if (s >= TC_STAGES) mbar_wait(empty0 + 8 * slot, ((s / TC_STAGES) - 1) & 1);
        const unsigned bar = full0 + 8 * slot;
        mbar_expect_tx(bar, C::STAGE_BYTES);
        const unsigned a = smem_addr(a_tile(slot)), b = smem_addr(b_tile(slot));
        tma_load(a, &xmap, bar, s * TC_BK, row0);
        tma_load(b, &wmap, bar, col0, s * TC_BK);
        tma_load(b + TC_BOX, &wmap, bar, col0 + 64, s * TC_BK);
      }
    } else {
      // Stage s is issued while stages s - LAG .. s - 1 land.  Each
      // iteration first completes stage s - LAG (fp32 and int8 weights are
      // rounded from the raw ring into it) and marks it full, then waits
      // for stage s's slot, which the consumers free once they have
      // issued stage s - TC_STAGES + 1: LAG <= TC_STAGES - 1, and the raw
      // ring holds LAG + 1 stages.
      constexpr int LAG = C::CONVERT ? TC_RAW_STAGES - 1 : TC_STAGES - 1;
      constexpr int WROW = TC_BN * static_cast<int>(sizeof(WT));
      for (int s = 0; s < nst + LAG; ++s) {
        if (s >= LAG) {
          cp_async_wait<LAG - 1>();                      // this thread's copies of stage d landed
          const int d = s - LAG, slot = d % TC_STAGES;
          if constexpr (C::CONVERT) {
            // every thread's copies of stage d landed, and every thread
            // is done with the raw slot stage s takes over
            producer_sync();
            const WT* rw = reinterpret_cast<const WT*>(raw + (d % TC_RAW_STAGES) * C::RAW_BYTES);
            unsigned char* bd = b_tile(slot);
            for (int c = pt; c < TC_BK * TC_BN / 8; c += 128) {
              const int r = c / (TC_BN / 8), cc = c % (TC_BN / 8);
              *reinterpret_cast<uint4*>(bd + (cc / 8) * TC_BOX + sw128(r * 128 + (cc % 8) * 16)) =
                  to_bf16x8(rw + r * TC_BN + cc * 8);
            }
          }
          fence_proxy_async();
          mbar_arrive(full0 + 8 * slot);
        }
        if (s < nst) {
          const int slot = s % TC_STAGES, k0 = s * TC_BK;
          if (s >= TC_STAGES) mbar_wait(empty0 + 8 * slot, ((s / TC_STAGES) - 1) & 1);
          const __nv_bfloat16* xs = x + (static_cast<size_t>(row0) * k + k0);
          unsigned char* ad = a_tile(slot);
          if (xvec == 16)
            stage_rows<16, TC_BM, 128, true>(ad, xs, k, m - row0, k - k0, x, pt);
          else if (xvec != 0)
            stage_rows<4, TC_BM, 128, true>(ad, xs, k, m - row0, k - k0, x, pt);
          else
            stage_rows<0, TC_BM, 128, true>(ad, xs, k, m - row0, k - k0, x, pt);
          const WT* ws = w + (static_cast<size_t>(k0) * n + col0);
          constexpr bool SWZ = !C::CONVERT;
          unsigned char* wd = C::CONVERT ? raw + (s % TC_RAW_STAGES) * C::RAW_BYTES : b_tile(slot);
          if (wvec == 16)
            stage_rows<16, TC_BK, WROW, SWZ>(wd, ws, n, k - k0, n - col0, w, pt);
          else if (wvec != 0)
            stage_rows<4, TC_BK, WROW, SWZ>(wd, ws, n, k - k0, n - col0, w, pt);
          else
            stage_rows<0, TC_BK, WROW, SWZ>(wd, ws, n, k - k0, n - col0, w, pt);
        }
        cp_async_commit();
      }
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = t / 128;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int s = 0; s < nst; ++s) {
      const int slot = s % TC_STAGES;
      mbar_wait(full0 + 8 * slot, (s / TC_STAGES) & 1);
      const unsigned a = smem_addr(a_tile(slot)) + wg * 64 * 128;
      const unsigned b = smem_addr(b_tile(slot));
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk)           // 16 k: 32 bytes along A's rows,
        wgmma_m64n128k16(acc, wgmma_desc(a + 32 * kk, 16, 1024),   // 16 rows of B's boxes
                         wgmma_desc(b + 2048 * kk, TC_BOX, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_operands(acc);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_operands(acc);
      if (s > 0) mbar_arrive(empty0 + 8 * ((s - 1) % TC_STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);

    // the accumulator fragment: warp v of the warpgroup holds rows 16 v +
    // lane / 4 and that + 8, columns 8 j + 2 (lane % 4) and that + 1
    const int v = (t % 128) / 32, lane = t % 32;
    const int r0 = row0 + wg * 64 + 16 * v + lane / 4;
    const bool pair = (n % 2) == 0;
    auto store = [&](auto* o) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= m) continue;
        auto* orow = o + static_cast<size_t>(row) * n;
#pragma unroll
        for (int j = 0; j < TC_BN / 8; ++j) {
          const int c = col0 + 8 * j + 2 * (lane % 4);
          if (c >= n) continue;
          const float e0 = apply_act(scale_bias(acc[4 * j + 2 * h], scale, bias, c), act);
          if (c + 1 < n) {
            const float e1 =
                apply_act(scale_bias(acc[4 * j + 2 * h + 1], scale, bias, c + 1), act);
            if (pair) {
              store2(orow + c, e0, e1);
            } else {
              store_out(orow + c, e0);
              store_out(orow + c + 1, e1);
            }
          } else {
            store_out(orow + c, e0);
          }
        }
      }
    };
    if (out_bf16)
      store(static_cast<__nv_bfloat16*>(out));
    else
      store(static_cast<float*>(out));
  }
}

struct Args {
  const void *x, *w;
  const float *scale, *bias;
  void* out;
  int m, n, k, wvec, xvec, act;
  cudaStream_t stream;
};

template <typename WT, typename XT, typename OT>
cudaError_t launch(const Args& a) {
  using C = Ring<WT, XT>;
  auto kern = sa_conv_gemm_kernel<WT, XT, OT>;
  static std::atomic<unsigned long long> opted{0};
  cudaError_t err = opt_in(kern, C::SMEM, opted);
  if (err != cudaSuccess) return err;
  const int row_tiles = (a.m + BM - 1) / BM;
  const long long ctas = static_cast<long long>(row_tiles) * ((a.n + BN - 1) / BN);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(ctas), THREADS, C::SMEM, a.stream>>>(
      static_cast<const XT*>(a.x), static_cast<const WT*>(a.w), a.scale, a.bias,
      static_cast<OT*>(a.out), a.m, a.n, a.k, row_tiles, a.wvec, a.act);
  return cudaGetLastError();
}

// The TMA producer's condition (kernels/sa_conv.py tma_ok mirrors it):
// bf16 w, k > 0, x's and w's bases and rows 16-byte aligned.
bool tma_ok(const void* x, const void* w, int w_kind, int k, int n) {
  return w_kind == KIND_BF16 && k > 0 && n > 0 && k % 8 == 0 && n % 8 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

template <typename WT, bool TMA>
cudaError_t launch_tc(const Args& a, bool out_bf16) {
  using C = TcRing<WT>;
  auto kern = sa_conv_wgmma_kernel<WT, TMA>;
  static std::atomic<unsigned long long> opted{0};
  cudaError_t err = opt_in(kern, C::SMEM, opted);
  if (err != cudaSuccess) return err;
  // setmaxnreg moves registers within the CTA's allocation: launched with
  // fewer than TC_REGS a thread, the consumers' increase would wait forever.
  static const int regs = [&] {
    cudaFuncAttributes fa{};
    return cudaFuncGetAttributes(&fa, kern) == cudaSuccess ? fa.numRegs : -1;
  }();
  if (regs != TC_REGS) return cudaErrorInvalidConfiguration;
  CUtensorMap xmap{}, wmap{};
  if constexpr (TMA) {
    if (!encode_bf16(&xmap, a.x, a.m, a.k, TC_BM) || !encode_bf16(&wmap, a.w, a.k, a.n, TC_BK))
      return cudaErrorInvalidValue;
  }
  const int row_tiles = (a.m + TC_BM - 1) / TC_BM;
  const long long ctas = static_cast<long long>(row_tiles) * ((a.n + TC_BN - 1) / TC_BN);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(ctas), TC_THREADS, C::SMEM, a.stream>>>(
      xmap, wmap, static_cast<const __nv_bfloat16*>(a.x), static_cast<const WT*>(a.w), a.scale,
      a.bias, a.out, out_bf16 ? 1 : 0, a.m, a.n, a.k, row_tiles, a.wvec, a.xvec, a.act);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_bf16(const Args& a, bool out_bf16) {
  if constexpr (sizeof(WT) == 2) {
    if (tma_ok(a.x, a.w, KIND_BF16, a.k, a.n)) return launch_tc<WT, true>(a, out_bf16);
  }
  return launch_tc<WT, false>(a, out_bf16);
}

// The instantiations of one weight type: x and out each fp32 or bf16.
template <typename WT>
cudaError_t launch_types(int x_kind, int out_kind, const Args& a) {
  using BF = __nv_bfloat16;
  if (x_kind == KIND_F32 && out_kind == KIND_F32) return launch<WT, float, float>(a);
  if (x_kind == KIND_F32 && out_kind == KIND_BF16) return launch<WT, float, BF>(a);
  if (x_kind == KIND_BF16 && (out_kind == KIND_F32 || out_kind == KIND_BF16))
    return launch_bf16<WT>(a, out_kind == KIND_BF16);
  return cudaErrorInvalidValue;
}

// The widest copy (16, 8 or 4 bytes) that an address and its rows' length
// allow; 0 if rows are not a multiple of 4 bytes (element loads).
int copy_bytes(const void* p, long long row_bytes) {
  const long long a = static_cast<long long>(reinterpret_cast<uintptr_t>(p)) | row_bytes;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 0;
}

}  // namespace

// w_kind: 0 fp32, 1 int8, 2 bf16; x_kind and out_kind: 0 fp32, 2 bf16.
// bn: the caller's columns per CTA, refused unless it is BN.  wvec: bytes
// per w copy (16, 8 or 4; 0: element loads), refused unless it divides
// both w's address and its rows' bytes.  bf16 x's copies and producer are
// worked out here.  scale and bias (fp32) may be null.  Returns
// cudaGetLastError() after the launch.
extern "C" int sa_conv_launch(const void* x, const void* w, int w_kind, int x_kind, int out_kind,
                              const void* scale, const void* bias, void* out, int m, int k, int n,
                              int bn, int wvec, int act, void* stream) {
  if (w_kind < 0 || w_kind > 2 || (x_kind != KIND_F32 && x_kind != KIND_BF16) || bn != BN ||
      m < 0 || n < 0 || k < 0)
    return cudaErrorInvalidValue;
  const long long align = static_cast<long long>(reinterpret_cast<uintptr_t>(w)) |
                          (static_cast<long long>(n) * KIND_BYTES[w_kind]);
  if (!(wvec == 0 || wvec == 4 || wvec == 8 || wvec == 16) || (wvec != 0 && align % wvec != 0) ||
      reinterpret_cast<uintptr_t>(x) % KIND_BYTES[x_kind] != 0)
    return cudaErrorInvalidValue;
  const int xvec = x_kind == KIND_BF16 ? copy_bytes(x, static_cast<long long>(k) * 2) : 0;
  const Args a{x, w, static_cast<const float*>(scale), static_cast<const float*>(bias), out,
               m, n, k, wvec, xvec, act, static_cast<cudaStream_t>(stream)};
  switch (w_kind) {
    case 0: return launch_types<float>(x_kind, out_kind, a);
    case 1: return launch_types<int8_t>(x_kind, out_kind, a);
    case 2: return launch_types<__nv_bfloat16>(x_kind, out_kind, a);
    default: return cudaErrorInvalidValue;
  }
}

namespace {

template <typename WT>
int smem_types(int x_kind) {
  if (x_kind == KIND_F32) return Ring<WT, float>::SMEM;
  if (x_kind == KIND_BF16) return TcRing<WT>::SMEM;
  return -1;
}

}  // namespace

// The dynamic shared memory sa_conv_launch passes for these types (w_kind
// and x_kind as it takes them), or -1 where it has no instantiation: what
// repro_torch/analysis/launch.py derives, asked of the built kernel.
extern "C" int sa_conv_smem(int w_kind, int x_kind) {
  switch (w_kind) {
    case 0: return smem_types<float>(x_kind);
    case 1: return smem_types<int8_t>(x_kind);
    case 2: return smem_types<__nv_bfloat16>(x_kind);
    default: return -1;
  }
}

// The producer sa_conv_launch gives these operands: 1 TMA, 0 cp.async
// (bf16 x on the tensor cores), -1 for fp32 x (the FMA loop) or kinds it
// refuses: what kernels/sa_conv.py tma_ok derives, asked of the built
// kernel.
extern "C" int sa_conv_producer(const void* x, const void* w, int w_kind, int x_kind, int k,
                                int n) {
  if (w_kind < 0 || w_kind > 2 || x_kind != KIND_BF16) return -1;
  return tma_ok(x, w, w_kind, k, n) ? 1 : 0;
}
