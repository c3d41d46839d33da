// SA-CONV GEMM on Hopper: out = act((x @ w) * scale + bias), x (m, k) fp32
// or bf16, w (k, n) fp32, bf16 or int8, fp32 accumulation, out (m, n) fp32
// or bf16.
//
// The function is the TPU kernel's, whatever the types: w is rounded to
// x's type (an fp32 w with bf16 x to nearest even; int8 and bf16 weights
// are exact), both are widened to fp32 and every product is summed in
// fp32 (a product of two bf16 values is exact in fp32); the epilogue runs
// in fp32 and the result is rounded once to the output type.  The
// activation and output types are template parameters beside the weight
// type, so the fp32 instantiations are the code they were before bf16.
//
// Replaces: src/repro/kernels/sa_conv.py::sa_conv_matmul (Pallas body
// _sa_conv_kernel), the output-stationary SA-CONV dataflow for matmuls the
// planner puts in the compute-bound regime (an LM's prefill projections).
//
// What bounds it on this card: the fp32 FMA rate.  At m = 2048 every weight
// is reused 2048 times, so the operations (2*m*n*k over 67 TFLOP/s on the
// CUDA cores; no TF32: fp32 means fp32) take about 10x longer than moving
// the operands once.  An SM issues one warp instruction per scheduler per
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
// bf16 x.  A 4-byte copy of bf16 x would carry two k of one row, so x
// cannot be transposed at copy time.  Instead its rows are copied as they
// lie (16-byte cp.async pieces, a row of BK = 16 k in 32 bytes, staged 48
// bytes apart so a quarter-warp's 16-byte reads of 8 rows hit distinct
// banks) into a ring of STAGES_BF16 stages, and one stage ahead of the FMAs
// each thread widens 8 k of one row into a double-buffered k-major fp32
// tile, the one fp32 x uses.  The weights of the stage are widened beside
// it (8 a thread: bf16 and int8 exactly, fp32 rounded to bf16 first) into
// a double-buffered fp32 w tile, so the k loop, its fragments and its
// order are those of fp32 x and w: widening w as fragments were read cost
// 8 more instructions per 64 FMAs and ran 28 % slower (PERF.md, PR 19).
// One barrier per stage still covers it all: stage s + 1 is widened while
// stage s computes, and a fifth stage keeps three in flight.  No register
// holds a load in flight.  bf16 is not run on the tensor cores yet: its
// bound is their rate (989 TFLOP/s), so this kernel sits far from it
// (kernels/sa_conv.py; PERF.md).
//
// One summation order per output: every output's k sum runs in one thread,
// in increasing k, one fmaf per term, from +0, with no split over k.  m and
// the grid change which thread computes an output, never its terms or
// their order, so row r of any launch equals row r of a launch over fewer
// rows, bitwise.  Ragged m, n and k are zero-filled by the copies (k's
// padding adds +0 * +0 after every real term) and masked at the stores.
// The epilogue applies scale, then bias, then the activation once per
// output, in fp32, in the plain version's order.
#include <atomic>

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
constexpr int STAGES_BF16 = 5;       // the ring's depth with bf16 x
constexpr int AP = BM + 4;           // padded k row of the transposed x tile (floats)
constexpr int XRP = 48;              // staged row of bf16 x (bytes; BK values in 32)
constexpr int XPT = BM * BK / THREADS;  // x copies per thread per stage

// One stage of the ring: x as copied (k-major fp32, or row-major bf16),
// then w as copied; with bf16 x, two widened k-major fp32 x tiles and two
// widened fp32 w tiles follow the ring.
template <typename WT, typename XT>
struct Ring {
  static constexpr bool BF = sizeof(XT) == 2;
  static constexpr int DEPTH = BF ? STAGES_BF16 : STAGES;
  static constexpr int X_BYTES = BF ? BM * XRP : BK * AP * 4;
  static constexpr int W_BYTES = BK * BN * static_cast<int>(sizeof(WT));
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int XF_BYTES = BF ? 2 * BK * AP * 4 : 0;
  static constexpr int WF_BYTES = BF ? 2 * BK * BN * 4 : 0;
  static constexpr int SMEM = DEPTH * STAGE_BYTES + XF_BYTES + WF_BYTES;
  static_assert(STAGE_BYTES % 16 == 0, "stages start 16-byte aligned");
};

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
// tile (R = BK, PITCH = ROW_BYTES), or bf16 x's rows (R = BM).  V bytes per
// cp.async, consecutive threads on consecutive pieces of a row.  MASKED:
// rows >= `rows` and elements >= `cols` are zero-filled (a V-byte piece is
// wholly in or out: V divides a row's bytes); unmasked for a tile inside
// both.
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

// Thread t's 8 k (half t / BM of the stage) of x row t % BM, from the
// staged bf16 rows into the k-major fp32 tile: a warp's stores fill 32
// consecutive floats of each k row.
__device__ __forceinline__ void widen_x(const unsigned char* raw, float* xf, int t) {
  const int r = t % BM, h = t / BM;
  const uint4 q = *reinterpret_cast<const uint4*>(raw + r * XRP + h * 16);
  float* d = xf + (h * 8) * AP + r;
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d[(2 * j) * AP] = __uint_as_float(u[j] << 16);
    d[(2 * j + 1) * AP] = __uint_as_float(u[j] & 0xffff0000u);
  }
}

// Thread t's 8 consecutive weights of the stage's k-major w tile (k row
// t / 16, columns 8 (t % 16) on), widened to fp32 as bf16 x meets them: an
// fp32 weight rounded to bf16 first, bf16 and int8 exact.
__device__ __forceinline__ void widen8(const float* p, float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float4 q = reinterpret_cast<const float4*>(p)[j];
    v[4 * j] = round_bf16(q.x); v[4 * j + 1] = round_bf16(q.y);
    v[4 * j + 2] = round_bf16(q.z); v[4 * j + 3] = round_bf16(q.w);
  }
}
__device__ __forceinline__ void widen8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(u[j] << 16);
    v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen8(const int8_t* p, float (&v)[8]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const unsigned u[2] = {q.x, q.y};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = static_cast<float>(static_cast<int8_t>((u[j / 4] >> (8 * (j % 4))) & 0xffu));
}
template <typename WT>
__device__ __forceinline__ void widen_w(const WT* raw, float* wf, int t) {
  float v[8];
  widen8(raw + 8 * t, v);
  float4* d = reinterpret_cast<float4*>(wf + 8 * t);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
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

// grid: one CTA per (row tile, column tile), row tile fastest.  wvec /
// xvec: bytes per copy of a w / bf16 x row piece (16, 8 or 4; 0: element
// loads); fp32 x always moves in 4-byte copies.
template <typename WT, typename XT, typename OT>
__global__ void __launch_bounds__(THREADS, PER_SM)
sa_conv_gemm_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    OT* __restrict__ out, int m, int n, int k, int row_tiles, int wvec, int xvec,
                    int act) {
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

  // fp32 x: the thread copies element (xr + (THREADS / BK) i, xk) of each stage
  const int xk = t % BK, xr = t / BK;
  const int xrows = m - row0;
  const XT* xsrc = x + (static_cast<size_t>(row0 + xr) * k + xk);
  const size_t xstep = static_cast<size_t>(THREADS / BK) * k;  // between a thread's x rows
  // Interior tiles and stages take their copies unmasked.
  const bool full_m = row0 + BM <= m, full_n = col0 + BN <= n;
  // bf16 x: the two widened k-major x tiles and two widened w tiles
  float* xf = reinterpret_cast<float*>(smem + DEPTH * C::STAGE_BYTES);
  float* wf = xf + 2 * BK * AP;

  // stage s of x and w into ring slot `slot`
  auto load = [&](int s, int slot) {
    unsigned char* base = smem + slot * C::STAGE_BYTES;
    const int k0 = s * BK;
    const bool full_k = k0 + BK <= k;
    if constexpr (C::BF) {           // x's rows as they lie
      constexpr int XROW = BK * 2;
      const XT* xt = x + (static_cast<size_t>(row0) * k + k0);
      if (xvec == 16 && full_m && full_k)
        copy_rows<16, BM, XROW, XRP, false>(base, xt, k, xrows, k - k0, x, t);
      else if (xvec == 16)
        copy_rows<16, BM, XROW, XRP>(base, xt, k, xrows, k - k0, x, t);
      else if (xvec == 8)
        copy_rows<8, BM, XROW, XRP>(base, xt, k, xrows, k - k0, x, t);
      else if (xvec == 4)
        copy_rows<4, BM, XROW, XRP>(base, xt, k, xrows, k - k0, x, t);
      else {                         // rows of an odd length or base
        XT* xd = reinterpret_cast<XT*>(base);
        for (int e = t; e < BM * BK; e += THREADS) {
          const int r = e / BK, kk = e % BK;
          xd[r * (XRP / 2) + kk] =
              (r < xrows && k0 + kk < k) ? xt[static_cast<size_t>(r) * k + kk] : XT{};
        }
      }
    } else {                         // x transposed to k-major at copy time
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
  // columns (w as staged, or widened to fp32 with bf16 x)
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
  if constexpr (C::BF) {
    // stage s + 1 is widened while stage s computes, so stage 0 goes first
    auto widen = [&](int s) {        // stage s into widened tiles s & 1
      const unsigned char* base = smem + (s % DEPTH) * C::STAGE_BYTES;
      widen_x(base, xf + (s & 1) * BK * AP, t);
      widen_w(reinterpret_cast<const WT*>(base + C::X_BYTES), wf + (s & 1) * BK * BN, t);
    };
    cp_async_wait<DEPTH - 2>();
    __syncthreads();
    if (nst > 0) widen(0);
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<DEPTH - 3>();
      __syncthreads();               // stage s + 1 landed and stage s widened; slot s - 1 is free
      const int nx = s + DEPTH - 1;
      if (nx < nst) load(nx, nx % DEPTH);
      cp_async_commit();
      if (s + 1 < nst) widen(s + 1);
      compute(xf + (s & 1) * BK * AP + ty, wf + (s & 1) * BK * BN + tx);
    }
  } else {
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
  }

  store_tile(acc, scale, bias, out, m, n, row0 + ty, col0 + tx, act);
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
  // The shared-memory opt-in is a property of the device's context: set it
  // once per device (bit d of `opted`), not on every launch.
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if ((opted.load(std::memory_order_acquire) & bit) == 0 || bit == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit, std::memory_order_release);
  }
  const int row_tiles = (a.m + BM - 1) / BM;
  const long long ctas = static_cast<long long>(row_tiles) * ((a.n + BN - 1) / BN);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(ctas), THREADS, C::SMEM, a.stream>>>(
      static_cast<const XT*>(a.x), static_cast<const WT*>(a.w), a.scale, a.bias,
      static_cast<OT*>(a.out), a.m, a.n, a.k, row_tiles, a.wvec, a.xvec, a.act);
  return cudaGetLastError();
}

// The instantiations of one weight type: x and out each fp32 or bf16.
template <typename WT>
cudaError_t launch_types(int x_kind, int out_kind, const Args& a) {
  using BF = __nv_bfloat16;
  if (x_kind == KIND_F32 && out_kind == KIND_F32) return launch<WT, float, float>(a);
  if (x_kind == KIND_F32 && out_kind == KIND_BF16) return launch<WT, float, BF>(a);
  if (x_kind == KIND_BF16 && out_kind == KIND_F32) return launch<WT, BF, float>(a);
  if (x_kind == KIND_BF16 && out_kind == KIND_BF16) return launch<WT, BF, BF>(a);
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
// both w's address and its rows' bytes.  bf16 x's copies are worked out
// here.  scale and bias (fp32) may be null.  Returns cudaGetLastError()
// after the launch.
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
  const int xvec = x_kind == KIND_BF16 ? copy_bytes(x, static_cast<long long>(k) * 2) : 4;
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
  if (x_kind == KIND_BF16) return Ring<WT, __nv_bfloat16>::SMEM;
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
