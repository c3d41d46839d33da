// SA-FC on Hopper: out = act((x @ w) * scale + bias), x (b, k) fp32 or
// bf16, w (k, n) fp32, bf16 or int8, fp32 accumulation, out fp32 or bf16.
//
// The function is the TPU kernel's, whatever the types: w is rounded to
// x's type (an fp32 w with bf16 x to nearest even; int8 and bf16 weights
// are exact), both are widened to fp32 and every product is summed in
// fp32 (a product of two bf16 values is exact in fp32); the epilogue runs
// in fp32 and the result is rounded once to the output type.  The
// activation and output types are template parameters beside the weight
// type, so the fp32 instantiations are the code they were before bf16.
//
// Replaces: src/repro/kernels/sa_fc.py::sa_fc_matmul (Pallas body
// _sa_fc_kernel), the batch-amortized weight stream of the paper's SA-FC
// array.
//
// What bounds it on this card.  Every weight is used b times, so up to
// b ~ 40 (fp32 weights) the k*n*itemsize weight bytes over 3.35 TB/s bound
// it: an OLMo-1B decode step at b = 4 streams 5 GB of weights per second of
// bound.  Above that the fp32 FMA rate (67 TFLOP/s on the CUDA cores; no
// TF32: fp32 means fp32) takes over: AlexNet's fc1 at b = 64 is 4.8 GFLOP,
// 72 us of FMAs against 45 us of weight bytes.
//
// What the design does about it:
//  * A fixed split over k, independent of b and of the tile.  k is cut
//    into chunks of BK = 32 and the chunks into S segments of equal length
//    (the last may be shorter); S comes from kernels/sa_fc.py::fc_split(k,
//    n), so the grid has >= 264 CTAs (two per SM) at the path's shapes
//    even at the widest column tile (64 columns, b <= 32).
//    Within a segment, k-lane l (of KL = 4) sums k = 8l..8l+7 of every
//    chunk, in increasing k, with one fmaf per term; the four lane sums are
//    added ((l0 + l1) + l2) + l3 into the segment's partial P_s; the
//    partials are added (((P_0 + P_1) + P_2) + ...) in segment order;
//    then scale, bias and activation.  That order depends on (k, n) alone,
//    so a row's output is bitwise the same in any batch, at any row tile.
//  * Two ways to run the same order.  "Whole": a CTA walks all S segments
//    and keeps the running sum in shared memory (used when the column and
//    row tiles alone give >= 264 CTAs, e.g. the m = 512 prefill and the
//    lm_head).  "Split": one CTA per segment writes P_s to a workspace the
//    wrapper allocates; the last CTA to arrive on a tile (an int arrival
//    counter per tile, reset to 0 by that CTA for the next launch on the
//    stream) reads P_0..P_{S-1} in order and runs the epilogue.  No atomic
//    ever adds a float.
//  * A 16-byte weight stream: cp.async copies 16-byte pieces of w and x
//    (8 or 4 bytes where a row's bytes or the pointer allow no more; plain
//    element loads for rows whose bytes are not a multiple of 4), a warp
//    on whole rows of the tile, into a ring of STAGES shared-memory
//    stages: up to 5 chunks in flight per CTA at b <= 8 (3 above) and 2-4
//    CTAs per SM keep 70-120 KB of fp32 weights and x per SM in flight.
//    int8 and bf16 weights cross memory in 1 or 2 bytes and are widened in
//    registers after the copy.
//  * Register tiles: a thread owns RT rows x 4 adjacent columns for one
//    k-lane (8 x 4 at b >= 64), so one 16-byte x load feeds 16 FMAs and one
//    16-byte weight load RT x 4.  x is staged row-major with rows padded to
//    BK + 4 floats: a warp's x loads hit distinct bank quads or broadcast,
//    its weight loads are contiguous.  Rows of a thread are RG apart.
//    bf16 x crosses memory and is staged in 2 bytes (rows padded to BK + 8
//    elements, 80 bytes, so 16-byte copies land aligned) and is widened
//    where the k-lane loop reads it: 4 k of a row in one 8-byte load, so
//    the loop, its order and its FMAs are those of fp32 x.
//  * b > 64 runs a grid dimension of 64-row tiles: weights are streamed
//    once per tile, and each tile sums in the same order.
//  * Ragged b, k and n are masked by zero-filled copies and by the stores.
//    k's zero-filled terms come after every real term of a lane and add
//    +0 to a sum that is never -0 (it starts at +0), so they change no bit.
//    The epilogue runs once per output.
#include <atomic>

#include "common.cuh"

namespace {

constexpr int KL = 4;                // k-lanes per output
constexpr int KG = 8;                // consecutive k of a lane in a chunk
constexpr int BK = KL * KG;          // k per chunk (32)
constexpr int XST = BK + 4;          // padded x row in shared memory (floats)
constexpr int XST_BF16 = BK + 8;     // the same for bf16 x (elements, 80 bytes)

template <typename XT>
constexpr int x_stride() { return sizeof(XT) == 4 ? XST : XST_BF16; }

// The tile of each instantiation (weight type, activation type, row tile).
// kernels/sa_fc.py::_COLS holds the same column widths (the launch refuses
// a mismatch).
template <typename WT, typename XT, int RB>
struct Cfg {
  static constexpr int RT = RB < 8 ? RB : 8;               // rows per thread
  static constexpr int RG = RB / RT;                       // row groups
  static constexpr int CG = RB <= 32 ? 16 : 8;             // column groups
  static constexpr int BN = 4 * CG;                        // columns per CTA
  static constexpr int THREADS = KL * RG * CG;
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);  // <= 128 registers
  static constexpr int STAGES = RB <= 8 ? 6 : 4;
  static constexpr int XS = x_stride<XT>();                // staged x row (elements)
  static constexpr int X_BYTES = RB * XS * static_cast<int>(sizeof(XT));
  static constexpr int STAGE_BYTES = X_BYTES + BK * BN * static_cast<int>(sizeof(WT));
  // the ring, the lanes' sums, the running total
  static constexpr int SMEM = STAGES * STAGE_BYTES + (KL + 1) * RB * BN * 4;
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

// Four adjacent staged weights, widened to fp32.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&v)[4]) {
  const char4 q = *reinterpret_cast<const char4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16); v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16); v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// Four consecutive staged x values of one row, widened to fp32.
__device__ __forceinline__ float4 load_x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_x4(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}

// A tile of R rows x ROW_BYTES bytes of a row-major matrix (rows of
// `stride` elements) into shared memory (rows `dst_stride` bytes apart),
// V bytes per cp.async, consecutive threads on consecutive pieces (a warp
// covers whole rows); rows >= `rows` and elements >= `cols` of a row are
// zero-filled (a V-byte piece is wholly in or out: V divides a row's
// bytes).  A thread keeps one column and steps down the rows; loops longer
// than two stay rolled, which keeps the instantiations under 128 registers.
template <int V, int R, int ROW_BYTES, int THREADS, typename T>
__device__ __forceinline__ void copy_tile(unsigned char* dst, int dst_stride, const T* src,
                                          int stride, int rows, int cols, const T* any, int t) {
  constexpr int PER_ROW = ROW_BYTES / V;                  // pieces per row
  constexpr int EL = V / static_cast<int>(sizeof(T));
  static_assert(THREADS % PER_ROW == 0, "a thread keeps its column");
  constexpr int RSTEP = THREADS / PER_ROW;                // rows between a thread's pieces
  constexpr int ITER = (R + RSTEP - 1) / RSTEP;
  constexpr int UNROLL = ITER <= 2 ? ITER : 1;
  const int cv = t % PER_ROW;
  int r = t / PER_ROW;
  if (R % RSTEP != 0 && r >= R) return;                   // (only when ITER == 1)
  const bool col_ok = cv * EL < cols;
  const T* s = src + (r * stride + cv * EL);
  unsigned char* d = dst + r * dst_stride + cv * V;
#pragma unroll UNROLL
  for (int i = 0; i < ITER; ++i) {
    const bool ok = col_ok && r < rows;
    cp_async<V>(d, ok ? s : any, ok ? V : 0);
    r += RSTEP;
    s += RSTEP * stride;
    d += RSTEP * dst_stride;
  }
}

// grid (column tiles, row tiles, S if split else 1).  part: (S, b, n)
// fp32 partials (split only); arrivals: one int per (row tile, column
// tile), 0 on entry and left 0.  wvec / xvec: bytes per copy of a w / x
// row piece (16, 8 or 4; 0: element loads).
template <typename WT, typename XT, typename OT, int RB>
__global__ void __launch_bounds__(Cfg<WT, XT, RB>::THREADS, Cfg<WT, XT, RB>::MIN_BLOCKS)
sa_fc_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ bias,
             OT* __restrict__ out, float* __restrict__ part, int* __restrict__ arrivals,
             int b, int k, int n, int seg_chunks, int nseg, int split, int wvec, int xvec,
             int act) {
  using C = Cfg<WT, XT, RB>;
  constexpr int XS = C::XS, XROW = BK * static_cast<int>(sizeof(XT));
  constexpr int RT = C::RT, RG = C::RG, CG = C::CG, BN = C::BN;
  constexpr int THREADS = C::THREADS, STAGES = C::STAGES, TILE = RB * BN, E = TILE / THREADS;
  static_assert(E * THREADS == TILE, "whole outputs per thread in the final sum");
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + STAGES * C::STAGE_BYTES);
  float* tot = red + KL * TILE;
  __shared__ int last;

  const int t = threadIdx.x;
  const int c = t % CG;
  const int g = (t / CG) % RG;
  const int l = t / (CG * RG);
  const int col0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * RB;

  const int nch_all = (k + BK - 1) / BK;
  int c_begin = 0, c_end = nch_all;
  if (split) {
    c_begin = blockIdx.z * seg_chunks;
    c_end = min(c_begin + seg_chunks, nch_all);
  }
  const int nch = c_end - c_begin;

  // one chunk of x (RB rows x BK) and w (BK rows x BN) into a ring slot
  constexpr int ROW_BYTES = BN * static_cast<int>(sizeof(WT));
  auto load = [&](int j, int slot) {
    unsigned char* xs = smem + slot * C::STAGE_BYTES;
    unsigned char* ws = xs + C::X_BYTES;
    const int k0 = j * BK;
    const XT* xt = x + static_cast<size_t>(r0) * k + k0;
    const WT* wt = w + static_cast<size_t>(k0) * n + col0;
    constexpr int XP = XS * static_cast<int>(sizeof(XT));   // staged row pitch (bytes)
    if (xvec == 16)
      copy_tile<16, RB, XROW, THREADS>(xs, XP, xt, k, b - r0, k - k0, x, t);
    else if (xvec == 8)
      copy_tile<8, RB, XROW, THREADS>(xs, XP, xt, k, b - r0, k - k0, x, t);
    else if constexpr (sizeof(XT) == 4)
      copy_tile<4, RB, XROW, THREADS>(xs, XP, xt, k, b - r0, k - k0, x, t);
    else if (xvec == 4)
      copy_tile<4, RB, XROW, THREADS>(xs, XP, xt, k, b - r0, k - k0, x, t);
    else {                           // bf16 rows of an odd length or base
      XT* xd = reinterpret_cast<XT*>(xs);
      for (int e = t; e < RB * BK; e += THREADS) {
        const int row = e / BK, kk = e % BK;
        xd[row * XS + kk] = (r0 + row < b && k0 + kk < k)
                                ? xt[static_cast<size_t>(row) * k + kk] : XT{};
      }
    }
    if (wvec == 16)
      copy_tile<16, BK, ROW_BYTES, THREADS>(ws, ROW_BYTES, wt, n, k - k0, n - col0, w, t);
    else if (wvec == 8)
      copy_tile<8, BK, ROW_BYTES, THREADS>(ws, ROW_BYTES, wt, n, k - k0, n - col0, w, t);
    else if (wvec == 4)
      copy_tile<4, BK, ROW_BYTES, THREADS>(ws, ROW_BYTES, wt, n, k - k0, n - col0, w, t);
    else {
      WT* wd = reinterpret_cast<WT*>(ws);
      for (int e = t; e < BK * BN; e += THREADS) {
        const int kk = k0 + e / BN, col = col0 + e % BN;
        wd[e] = (kk < k && col < n) ? w[static_cast<size_t>(kk) * n + col] : WT{};
      }
    }
  };

  float acc[RT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[i][cc] = 0.f;

  // The end of segment `seg`: lanes summed in order into P_seg, which goes
  // to the workspace (split) or onto the running total; after the last
  // segment (whole) the epilogue writes the output.
  auto finish_segment = [&](int seg, bool final) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float* a = acc[i];
      *reinterpret_cast<float4*>(red + (l * RB + g + RG * i) * BN + 4 * c) =
          make_float4(a[0], a[1], a[2], a[3]);
      a[0] = a[1] = a[2] = a[3] = 0.f;
    }
    __syncthreads();
    for (int e = t; e < TILE; e += THREADS) {
      float p = red[e] + red[TILE + e];
#pragma unroll
      for (int j = 2; j < KL; ++j) p += red[j * TILE + e];
      const int row = r0 + e / BN, col = col0 + e % BN;
      if (split) {
        if (row < b && col < n) part[(static_cast<unsigned>(seg) * b + row) * n + col] = p;
      } else {
        const float v = seg == 0 ? p : tot[e] + p;
        if (!final)
          tot[e] = v;
        else if (row < b && col < n)
          store_out(out + static_cast<size_t>(row) * n + col,
                    apply_act(scale_bias(v, scale, bias, col), act));
      }
    }
  };

  int seg = c_begin / seg_chunks, seg_left = seg_chunks;   // c_begin starts a segment
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) load(c_begin + s, s);
    cp_async_commit();
  }
  for (int i = 0; i < nch; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = i + STAGES - 1;
    if (nx < nch) load(c_begin + nx, nx % STAGES);
    cp_async_commit();

    const unsigned char* base = smem + (i % STAGES) * C::STAGE_BYTES;
    const XT* xs = reinterpret_cast<const XT*>(base);
    const WT* ws = reinterpret_cast<const WT*>(base + C::X_BYTES);
#pragma unroll
    for (int q = 0; q < KG; q += 4) {
      const int kk = l * KG + q;
      float wv[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        load4(ws + (kk + j) * BN + 4 * c, wv[j]);
        if constexpr (sizeof(XT) == 2 && sizeof(WT) == 4) {   // w to x's type first
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) wv[j][cc] = round_bf16(wv[j][cc]);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 xv = load_x4(xs + (g + RG * r) * XS + kk);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(xa[j], wv[j][cc], acc[r][cc]);
      }
    }
    if (--seg_left == 0 || i + 1 == nch) {
      finish_segment(seg++, i + 1 == nch);
      seg_left = seg_chunks;
    }
  }
  if (nch == 0) finish_segment(0, true);                  // k == 0: the epilogue of zeros
  if (!split) return;

  // The last CTA to arrive on this tile adds P_0..P_{S-1} in order.
  __threadfence();
  __syncthreads();
  if (t == 0) {
    int* cnt = arrivals + blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(cnt, 1) == nseg - 1;
    if (last) *cnt = 0;                                   // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // E outputs per thread, their loads in flight
  // together.  Split launches are small: (S, b, n) has < 2^31 elements.
  const unsigned stride = static_cast<unsigned>(b) * n;
  unsigned at[E];
  float v[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = t + THREADS * i, row = r0 + e / BN, col = col0 + e % BN;
    at[i] = row < b && col < n ? static_cast<unsigned>(row) * n + col : 0u;
    v[i] = __ldcg(part + at[i]);
  }
#pragma unroll 4
  for (int s = 1; s < nseg; ++s)
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] += __ldcg(part + (s * stride + at[i]));
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = t + THREADS * i, row = r0 + e / BN, col = col0 + e % BN;
    if (row < b && col < n) store_out(out + at[i], apply_act(scale_bias(v[i], scale, bias, col), act));
  }
}

struct Args {
  const void *x, *w;
  const float *scale, *bias;
  void* out;
  float* part;
  int* arrivals;
  int b, k, n, bn, seg_chunks, nseg, split, wvec, xvec, act;
  cudaStream_t stream;
};

template <typename WT, typename XT, typename OT, int RB>
cudaError_t launch(const Args& a) {
  using C = Cfg<WT, XT, RB>;
  if (a.bn != C::BN) return cudaErrorInvalidValue;
  constexpr int smem = C::SMEM;
  auto kern = sa_fc_kernel<WT, XT, OT, RB>;
  // The shared-memory opt-in is a property of the device's context: set it
  // once per device (bit d of `opted`), not on every launch.
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if ((opted.load(std::memory_order_acquire) & bit) == 0 || bit == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((a.n + C::BN - 1) / C::BN, (a.b + RB - 1) / RB, a.split ? a.nseg : 1);
  kern<<<grid, C::THREADS, smem, a.stream>>>(
      static_cast<const XT*>(a.x), static_cast<const WT*>(a.w), a.scale, a.bias,
      static_cast<OT*>(a.out), a.part, a.arrivals, a.b, a.k, a.n, a.seg_chunks, a.nseg, a.split,
      a.wvec, a.xvec, a.act);
  return cudaGetLastError();
}

template <typename WT, typename XT, typename OT>
cudaError_t launch_rb(int rb, const Args& a) {
  switch (rb) {
    case 1: return launch<WT, XT, OT, 1>(a);
    case 2: return launch<WT, XT, OT, 2>(a);
    case 4: return launch<WT, XT, OT, 4>(a);
    case 8: return launch<WT, XT, OT, 8>(a);
    case 16: return launch<WT, XT, OT, 16>(a);
    case 32: return launch<WT, XT, OT, 32>(a);
    case 64: return launch<WT, XT, OT, 64>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The instantiations of one weight type: x and out each fp32 or bf16.
template <typename WT>
cudaError_t launch_types(int x_kind, int out_kind, int rb, const Args& a) {
  using BF = __nv_bfloat16;
  if (x_kind == KIND_F32 && out_kind == KIND_F32) return launch_rb<WT, float, float>(rb, a);
  if (x_kind == KIND_F32 && out_kind == KIND_BF16) return launch_rb<WT, float, BF>(rb, a);
  if (x_kind == KIND_BF16 && out_kind == KIND_F32) return launch_rb<WT, BF, float>(rb, a);
  if (x_kind == KIND_BF16 && out_kind == KIND_BF16) return launch_rb<WT, BF, BF>(rb, a);
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
// rb / bn: the row tile (a power of two <= 64) and its column width.  seg_chunks: chunks of 32 k per segment (S
// = ceil(ceil(k / 32) / seg_chunks) segments).  part non-null: one CTA per
// segment, partials in part (S * b * n floats) and arrivals (one zeroed int
// per tile); null: one CTA per tile.  scale and bias may be null.  Returns
// cudaGetLastError() after the launch.
extern "C" int sa_fc_launch(const void* x, const void* w, int w_kind, int x_kind, int out_kind,
                            const void* scale, const void* bias, void* out, void* part,
                            void* arrivals, int b, int k, int n, int rb, int bn, int seg_chunks,
                            int act, void* stream) {
  if (seg_chunks < 1 || w_kind < 0 || w_kind > 2 || (part != nullptr && arrivals == nullptr) ||
      (x_kind != KIND_F32 && x_kind != KIND_BF16))
    return cudaErrorInvalidValue;
  const int split = part != nullptr;
  const int chunks = (k + BK - 1) / BK;
  const int nseg = chunks > seg_chunks ? (chunks + seg_chunks - 1) / seg_chunks : 1;
  const int wvec = copy_bytes(w, static_cast<long long>(n) * KIND_BYTES[w_kind]);
  const int xvec = copy_bytes(x, static_cast<long long>(k) * KIND_BYTES[x_kind]);
  if (xvec == 0 && x_kind == KIND_F32) return cudaErrorInvalidValue;
  const Args a{x, w, static_cast<const float*>(scale), static_cast<const float*>(bias), out,
               static_cast<float*>(part), static_cast<int*>(arrivals), b, k, n, bn, seg_chunks,
               nseg, split, wvec, xvec, act, static_cast<cudaStream_t>(stream)};
  switch (w_kind) {
    case 0: return launch_types<float>(x_kind, out_kind, rb, a);
    case 1: return launch_types<int8_t>(x_kind, out_kind, rb, a);
    case 2: return launch_types<__nv_bfloat16>(x_kind, out_kind, rb, a);
    default: return cudaErrorInvalidValue;
  }
}

namespace {

template <typename WT, typename XT>
int smem_rb(int rb) {
  switch (rb) {
    case 1: return Cfg<WT, XT, 1>::SMEM;
    case 2: return Cfg<WT, XT, 2>::SMEM;
    case 4: return Cfg<WT, XT, 4>::SMEM;
    case 8: return Cfg<WT, XT, 8>::SMEM;
    case 16: return Cfg<WT, XT, 16>::SMEM;
    case 32: return Cfg<WT, XT, 32>::SMEM;
    case 64: return Cfg<WT, XT, 64>::SMEM;
    default: return -1;
  }
}

template <typename WT>
int smem_types(int x_kind, int rb) {
  if (x_kind == KIND_F32) return smem_rb<WT, float>(rb);
  if (x_kind == KIND_BF16) return smem_rb<WT, __nv_bfloat16>(rb);
  return -1;
}

}  // namespace

// The dynamic shared memory sa_fc_launch passes at row tile rb for these
// types (w_kind and x_kind as it takes them), or -1 where it has no
// instantiation: what repro_torch/analysis/launch.py derives, asked of the
// built kernel.
extern "C" int sa_fc_smem(int w_kind, int x_kind, int rb) {
  switch (w_kind) {
    case 0: return smem_types<float>(x_kind, rb);
    case 1: return smem_types<int8_t>(x_kind, rb);
    case 2: return smem_types<__nv_bfloat16>(x_kind, rb);
    default: return -1;
  }
}
