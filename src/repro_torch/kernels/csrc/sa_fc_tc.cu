// SA-FC's bf16-activation path on Hopper's tensor cores: out = act((x @ w)
// * scale + bias) for bf16 x (b, k) and w (k, n) fp32, int8 or bf16, fp32
// accumulation, out fp32 or bf16: every SA-FC launch with bf16 x, at every
// b (LM decode steps, prefill waves, the bf16 CNN head).  fp32 x runs the
// FMA kernel (sa_fc.cu).
//
// Replaces: src/repro/kernels/sa_fc.py:155 sa_fc_matmul (Pallas body
// _sa_fc_kernel) with bf16 activations, the batch-amortized weight stream
// of the paper's SA-FC array.
//
// The function is the TPU kernel's: w is rounded to x's type (an fp32 w
// to nearest even, int8 and bf16 exactly), the products of two bf16 values
// are exact and are summed in fp32 by mma.sync.m16n8k16; scale, bias and
// the activation run once in fp32 and the output is rounded once.
//
// What bounds it on this card.  The k*n weight bytes over 3.35 TB/s at
// every b below the planner's flip batch: a weight feeds b rows, 2 b FLOP
// per weight, so up to b ~ 300 (bf16 w) the tensor cores' 989 TFLOP/s
// are not the limit, and mma.sync's rate (a fraction of wgmma's) is not
// either at the batches SA-FC serves (an OLMo-1B decode step streams 2.35
// GB of bf16 weights: 0.70 ms; AlexNet's head at b = 64 reads 235 MB of
// fp32 weights: 0.070 ms, 7.5 GFLOP).  The CUDA cores' 67 TFLOP/s were
// the FMA loop's limit above b ~ 40.  Below ~10 MB a launch is latency:
// DRAM's first bytes, the chunks one warp sums in a row, the k segments'
// sum.
//
// One summation order per output, a function of (k, n) alone, so a row's
// output is bitwise the same in any batch and through either mode below.
// k is cut into chunks of BK = 32 and the chunks into S segments of
// seg_chunks (kernels/sa_fc.py::fc_split(k, n), the last may be shorter).
// Within a segment the k16 steps run in increasing k, each one mma of its
// 16 products from +0, added to the segment's fp32 sum (from +0) rounded
// to nearest; the segments' partials are added (((P_0 + P_1) + P_2) + ...)
// in order; then scale, bias, activation.
// The weight tile is the A operand (16 columns of n x 16 k, from the
// staged w by ldmatrix.trans for bf16, by loads rounded to bf16 for fp32
// and int8) and x the B operand (8 rows of the batch a slice).  A row of
// x is a column of B, and each output of the product is a function of its
// own row and column alone, so the instructions that make an output are
// the same whatever b is, whatever slice or row tile the row rides in.
// Zero-filled terms (k past its end) add exact zeros.
//
// Two ways to run that order: a unit is (column tile, k segment, row
// tile), one warp a unit, streaming its chunks through its own ring of
// stages in shared memory (the chunk's w, then its 32 k of the tile's x
// rows), across unit boundaries; the only barrier on the stream is the
// warp's own.
//  * Narrow (row tile 8, i.e. b <= 8, and k and n <= 4096: attention
//    projections at decode; sa_fc_narrow_kernel).  Units of 16 columns
//    (one m16 tile, one n8 slice); 512-thread CTAs, one an SM, at most
//    132, own contiguous runs of column groups and every segment of them;
//    a CTA's units, segment-major, go round-robin to its 16 warps, and
//    after one barrier the CTA adds each output's segments in order from
//    shared memory (at most 64 KiB of partials: S <= 128 chunks, and S
//    falls as n grows).  Stages arrive by cp.async.
//  * Wide (the rest: MLPs, heads, every launch of more than 8 rows;
//    sa_fc_wide_kernel).  Row tiles (kernels/sa_fc.py::tc_rows) of 8
//    where k is split into 8 or more segments (n is then at most ~2100:
//    the weights stay in L2 while the row tiles read them, and each
//    tile's tail below stays short), else the smallest of 8, 16, 32, 64
//    that holds b, 64 above; each sums in the same order.  Units of TC
//    columns (kernels/sa_fc.py::tc_cols: 64 for bf16 and int8 w, 32 for
//    fp32, at row tiles 8 and 16; 64 at 32, 32 at 64), RB / 8 slices of
//    the row tile; CTAs of 8 warps (4 at row tiles 32 and 64), one an SM,
//    at most 132; unit u runs on warp (u / ctas) % warps of CTA u % ctas,
//    so the units spread over the SMs first.  Stages arrive by TMA (w in
//    boxes of rows of up to 128 bytes, x in a box of 32 k x min(b, RB)
//    rows, both swizzled, on one mbarrier) where both operands' rows and
//    bases are 16-byte aligned, by cp.async into the same layout
//    otherwise.  S > 1: the warp writes P_s to the workspace (S, b, n)
//    and arrives on its (row tile, column tile)'s counter; the warp
//    arriving last adds the S partials in order (128 loads a lane in
//    flight) and resets the counter for the next launch.  No atomic ever
//    adds a float.
// Shared memory is laid out as TMA's 32/64/128-byte swizzle of the row
// width (chunk index ^ the row bits above 128 bytes), so ldmatrix reads 8
// rows of a column block conflict-free; cp.async writes the same layout.
// Edges: ragged b (rows past b read zeros and are not stored), k (copies
// zero-fill rows past k) and n (copies zero-fill columns past n, stores
// are masked), k = 0 (the epilogue of zeros); 8- and 4-byte copies, or
// element loads, where a row's bytes or its base allow no 16-byte pieces.
#include "common.cuh"

namespace {

constexpr int BK = 32;                       // k per chunk (two k16 steps)
constexpr int SM_COUNT = 132;                // an H100's SMs: the grids' caps
constexpr int NARROW_MAX = 4096;             // the narrow kernel's largest k and n
constexpr int ROWS = 8;                      // rows of an n8 slice; the narrow row tile
constexpr int X_ROW = BK * 2;                // a staged x row: 32 k in bf16 (64 bytes)

using BF = __nv_bfloat16;

// The narrow kernel for b <= 8 rows (one row tile of 8) and k and n up to
// NARROW_MAX, the wide one for every other launch.
__host__ __device__ constexpr bool is_narrow(int b, int k, int n) {
  return b <= ROWS && k <= NARROW_MAX && n <= NARROW_MAX;
}

// Byte offset of (row r, byte b) in a block of rows of ROWB (<= 128)
// bytes, as TMA's swizzle of that width stores it from a 1024-byte
// aligned base: the 16-byte chunk index XOR the address bits above 128.
template <int ROWB>
__device__ __forceinline__ int swz(int r, int b) {
  constexpr int MASK = ROWB / 16 - 1;
  return r * ROWB + ((((b >> 4) ^ ((r * ROWB) >> 7)) & MASK) << 4) + (b & 15);
}

// Byte offset of weight (k row r, column c) in a unit's staged chunk:
// boxes of BOXB-byte rows (32 rows each), column-block after column-block.
template <int WB, int BOXB>
__device__ __forceinline__ int w_off(int r, int c) {
  const int b = c * WB;
  return (b / BOXB) * (BK * BOXB) + swz<BOXB>(r, b % BOXB);
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&b)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr)
               : "memory");
}

// acc += A (16 x 16) B (16 x 8), bf16 operands: the tensor cores sum the
// step's 16 exact products from +0, and the step's sum goes onto the fp32
// accumulator with one add rounded to nearest.  (Feeding acc through the
// product's accumulator instead would truncate the running sum at every
// step, an error that grows with k and leans one way.)
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  float d[4];
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

// Two values rounded to bf16 (to nearest even), the first in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float staged(const unsigned char* p, float) {
  return *reinterpret_cast<const float*>(p);
}
__device__ __forceinline__ float staged(const unsigned char* p, int8_t) {
  return static_cast<float>(*reinterpret_cast<const int8_t*>(p));
}

// The A fragment of the m16 tile at unit column m0 and the k16 step at
// chunk row k0: register q holds (columns m0 + g + 8 (q & 1), k rows k0 +
// 2 t + 8 (q >> 1) and the next), g = lane / 4, t = lane % 4.  bf16: one
// ldmatrix.trans of four 8 x 8 blocks (k rows x 8 columns); fp32 and int8:
// two loads a register, rounded to bf16 as the reference rounds w to x's
// type (int8 exactly).
template <typename WT, int BOXB>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const unsigned char* ws, int m0, int k0,
                                       int lid) {
  constexpr int WB = static_cast<int>(sizeof(WT));
  if constexpr (WB == 2) {
    const int r = k0 + ((lid >> 4) << 3) + (lid & 7);
    const int c = m0 + (((lid >> 3) & 1) << 3);
    ldmatrix_x4_trans(a, smem_addr(ws + w_off<WB, BOXB>(r, c)));
  } else {
    const int g = lid >> 2, t = lid & 3;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = m0 + g + ((q & 1) << 3), r = k0 + 2 * t + ((q >> 1) << 3);
      a[q] = pack_bf16(staged(ws + w_off<WB, BOXB>(r, c), WT{}),
                       staged(ws + w_off<WB, BOXB>(r + 1, c), WT{}));
    }
  }
}

// The B fragment of n8 slice `sl` and the k16 step at chunk k0: x rows
// 8 sl + g, k0 + 2 t (+ 8) and the next, one ldmatrix of two 8 x 8 blocks.
__device__ __forceinline__ void load_b(unsigned (&b)[2], const unsigned char* xs, int sl, int k0,
                                       int lid) {
  const int r = sl * ROWS + (lid & 7);
  const int byte = k0 * 2 + (((lid >> 3) & 1) << 4);
  ldmatrix_x2(b, smem_addr(xs + swz<X_ROW>(r, byte)));
}

// A unit's chunk of w (BK rows of k from k0, COLS columns from col0) into
// a stage, V bytes a copy (0: element loads), zero-filled past k and n (a
// V-byte piece is wholly in or out: V divides a row's bytes).
template <typename WT, int COLS, int BOXB, int V>
__device__ __forceinline__ void copy_w(unsigned char* st, const WT* w, int k, int n, int k0,
                                       int col0, int lid) {
  constexpr int WB = static_cast<int>(sizeof(WT));
  constexpr int E = V == 0 ? 1 : V / WB;                   // elements a piece
  constexpr int PER_ROW = COLS / E;
#pragma unroll 4
  for (int i = lid; i < BK * PER_ROW; i += 32) {
    const int r = i / PER_ROW, c = i % PER_ROW * E;
    const int kk = k0 + r, col = col0 + c;
    const bool ok = kk < k && col < n;
    unsigned char* dst = st + w_off<WB, BOXB>(r, c);
    if constexpr (V >= 4) {
      cp_async<V>(dst, ok ? w + (static_cast<size_t>(kk) * n + col) : w, ok ? V : 0);
    } else {                                 // rows of an odd length or base
      *reinterpret_cast<WT*>(dst) = ok ? w[static_cast<size_t>(kk) * n + col] : WT{};
    }
  }
}
template <typename WT, int COLS, int BOXB>
__device__ __forceinline__ void copy_w_any(int v, unsigned char* st, const WT* w, int k, int n,
                                           int k0, int col0, int lid) {
  if (v == 16) copy_w<WT, COLS, BOXB, 16>(st, w, k, n, k0, col0, lid);
  else if (v == 8) copy_w<WT, COLS, BOXB, 8>(st, w, k, n, k0, col0, lid);
  else if (v == 4) copy_w<WT, COLS, BOXB, 4>(st, w, k, n, k0, col0, lid);
  else copy_w<WT, COLS, BOXB, 0>(st, w, k, n, k0, col0, lid);
}

// The chunk's 32 k of x rows r0 .. r0 + RB - 1 into a stage's x block, V
// bytes a copy (0: element loads), zero-filled past b and k.
template <int RB, int V>
__device__ __forceinline__ void copy_x(unsigned char* xs, const BF* x, int b, int k, int r0,
                                       int k0, int lid) {
  constexpr int E = V == 0 ? 1 : V / 2;
  constexpr int PER_ROW = BK / E;
#pragma unroll 4
  for (int i = lid; i < RB * PER_ROW; i += 32) {
    const int r = i / PER_ROW, kc = i % PER_ROW * E;
    const int row = r0 + r, kk = k0 + kc;
    const bool ok = row < b && kk < k;
    unsigned char* dst = xs + swz<X_ROW>(r, kc * 2);
    if constexpr (V >= 4) {
      cp_async<V>(dst, ok ? x + (static_cast<size_t>(row) * k + kk) : x, ok ? V : 0);
    } else {
      *reinterpret_cast<BF*>(dst) = ok ? x[static_cast<size_t>(row) * k + kk] : BF{};
    }
  }
}
template <int RB>
__device__ __forceinline__ void copy_x_any(int v, unsigned char* xs, const BF* x, int b, int k,
                                           int r0, int k0, int lid) {
  if (v == 16) copy_x<RB, 16>(xs, x, b, k, r0, k0, lid);
  else if (v == 8) copy_x<RB, 8>(xs, x, b, k, r0, k0, lid);
  else if (v == 4) copy_x<RB, 4>(xs, x, b, k, r0, k0, lid);
  else copy_x<RB, 0>(xs, x, b, k, r0, k0, lid);
}

// One output, through the epilogue, in the output's type.
__device__ __forceinline__ void emit(void* out, int out_bf16, size_t i, float v, const float* scale,
                                     const float* bias, int col, int act) {
  v = apply_act(scale_bias(v, scale, bias, col), act);
  if (out_bf16)
    store_out(static_cast<BF*>(out) + i, v);
  else
    store_out(static_cast<float*>(out) + i, v);
}

// ---------------------------------------------------------------------------
// narrow: 16-column warp units at row tile 8, CTAs that own their groups'
// segments
// ---------------------------------------------------------------------------
namespace narrow {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int GCOLS = 16;                    // columns of a unit: one m16 tile
constexpr int PART_SMEM_MAX = 65536;         // the most partials k <= NARROW_MAX gives

template <typename WT>
struct Cfg {
  static constexpr int ROWB = GCOLS * static_cast<int>(sizeof(WT));   // a chunk row of w
  static constexpr int W_BYTES = BK * ROWB;
  static constexpr int STAGE = W_BYTES + ROWS * X_ROW;               // w, then 8 x rows
  static constexpr int DEPTH = sizeof(WT) == 4 ? 4 : 6;              // stages of a ring
};

// Bytes of the partials of a CTA's units (S > 1).
long long part_bytes(int nseg, int span) {
  return nseg > 1 ? static_cast<long long>(span) * nseg * ROWS * GCOLS * 4 : 0;
}

// Dynamic shared memory of a launch: the rings, then the partials.
template <typename WT>
int smem_bytes(int nseg, int span) {
  return WARPS * Cfg<WT>::DEPTH * Cfg<WT>::STAGE + static_cast<int>(part_bytes(nseg, span));
}

// grid (ctas): CTA c owns groups [c groups / ctas, (c + 1) groups / ctas)
// of 16 columns and all nseg segments of each.  wvec / xvec: bytes per
// copy of a w / x row piece (16, 8, 4, or 0: element loads).
template <typename WT>
__global__ void __launch_bounds__(THREADS, 1)
sa_fc_narrow_kernel(const BF* __restrict__ x, const WT* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    void* __restrict__ out, int out_bf16, int b, int k, int n, int seg_chunks,
                    int nseg, int groups, int wvec, int xvec, int act) {
  using C = Cfg<WT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int cta = blockIdx.x;
  const int g0 = static_cast<int>(static_cast<long long>(cta) * groups / gridDim.x);
  const int gc = static_cast<int>(static_cast<long long>(cta + 1) * groups / gridDim.x) - g0;
  const int units = gc * nseg;                             // segment-major: u = s gc + group
  const int nch = (k + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int g = lid >> 2, t = lid & 3;
  unsigned char* ring = smem + warp * (C::DEPTH * C::STAGE);
  float* part = reinterpret_cast<float*>(smem + WARPS * C::DEPTH * C::STAGE);

  // The load cursor walks this warp's chunks (its units u = warp, warp +
  // WARPS, ..., each unit's chunks in order) ahead of the products; every
  // call commits one cp.async group, empty past the end, so that the wait
  // below counts stages.
  int lu = warp - WARPS, lch = 0, lend = 0, lcol0 = 0;
  auto issue = [&](int slot) {
    while (lch >= lend && lu < units) {
      lu += WARPS;
      if (lu < units) {
        const int s = lu / gc;
        lch = s * seg_chunks;
        lend = min(lch + seg_chunks, nch);
        lcol0 = (g0 + lu - s * gc) * GCOLS;
      }
    }
    if (lu < units) {
      unsigned char* st = ring + slot * C::STAGE;
      const int k0 = lch * BK;
      copy_w_any<WT, GCOLS, C::ROWB>(wvec, st, w, k, n, k0, lcol0, lid);
      copy_x_any<ROWS>(xvec, st + C::W_BYTES, x, b, k, 0, k0, lid);
      ++lch;
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int s = 0; s < C::DEPTH - 1; ++s) issue(s);

  int slot = 0;                                            // the stage computed next
#pragma unroll 1
  for (int u = warp; u < units; u += WARPS) {
    const int s = u / gc;
    const int c0 = s * seg_chunks, c1 = min(c0 + seg_chunks, nch);
    const int col0 = (g0 + u - s * gc) * GCOLS;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int ch = c0; ch < c1; ++ch) {
      cp_async_wait<C::DEPTH - 2>();
      __syncwarp();
      issue(slot == 0 ? C::DEPTH - 1 : slot - 1);
      const unsigned char* st = ring + slot * C::STAGE;
      slot = slot == C::DEPTH - 1 ? 0 : slot + 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned a[4], bq[2];
        load_b(bq, st + C::W_BYTES, 0, 16 * h, lid);
        load_a<WT, C::ROWB>(a, st, 0, 16 * h, lid);
        mma_bf16(acc, a, bq);
      }
    }
    // the unit's partial P_s: rows 2t, 2t + 1, columns g, g + 8
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 2 * t + (e & 1), cc = g + ((e >> 1) << 3);
      if (nseg == 1) {
        if (r < b && col0 + cc < n)
          emit(out, out_bf16, static_cast<size_t>(r) * n + col0 + cc, acc[e], scale, bias,
               col0 + cc, act);
      } else {
        part[(u * ROWS + r) * GCOLS + cc] = acc[e];
      }
    }
  }
  if (nseg == 1) return;

  // Each output of the CTA's groups: P_0 + P_1 + ... in segment order.
  __syncthreads();
  const int outs = gc * ROWS * GCOLS;
  for (int e = threadIdx.x; e < outs; e += THREADS) {
    const int gl = e / (ROWS * GCOLS), r = e / GCOLS % ROWS, cc = e % GCOLS;
    float v = part[(gl * ROWS + r) * GCOLS + cc];
    for (int s = 1; s < nseg; ++s) v += part[((s * gc + gl) * ROWS + r) * GCOLS + cc];
    const int col = (g0 + gl) * GCOLS + cc;
    if (r < b && col < n)
      emit(out, out_bf16, static_cast<size_t>(r) * n + col, v, scale, bias, col, act);
  }
}

}  // namespace narrow

// ---------------------------------------------------------------------------
// wide: TC-column warp units of RB rows, TMA or cp.async
// ---------------------------------------------------------------------------
namespace wide {

constexpr int DEPTH = 4;                     // stages of a warp's ring

template <typename WT, int RB>
struct Cfg {
  static constexpr int WB = static_cast<int>(sizeof(WT));
  // warps a CTA, one CTA an SM: 8 at row tiles 8 and 16, whose 4 KB
  // chunks of w stream faster from 8 warps an SM than 8 KB ones from 4
  // (PERF.md, section 6), 4 above, where a stage's x rows take the room
  static constexpr int WARPS = RB <= 16 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  // columns of a unit: 4 KB of w a chunk (2 KB of int8) at row tiles 8
  // and 16, then 64 and 32 columns: at most 64 accumulators a thread
  static constexpr int TC = RB <= 16 ? (WB == 4 ? 32 : 64) : 2048 / RB;
  static constexpr int TILES = TC / 16;                    // m16 tiles
  static constexpr int SLICES = RB / ROWS;                 // n8 slices
  static constexpr int ROWB = TC * WB;                     // a chunk row of w
  static constexpr int BOXB = ROWB < 128 ? ROWB : 128;     // a TMA box row
  static constexpr int BOX_COLS = BOXB / WB;
  static constexpr int BOXES = ROWB / BOXB;
  static constexpr int W_BYTES = BK * ROWB;
  static constexpr int X_BYTES = RB * X_ROW;
  static constexpr int STAGE = (W_BYTES + X_BYTES + 1023) / 1024 * 1024;
  static constexpr int SP = TC + 4;                        // a scratch row (floats)
  static constexpr int PER = RB * TC / 32;                 // outputs of a unit a lane
  // 1024 bytes to align the rings to the swizzle's period, the rings, each
  // warp's scratch of its unit's outputs (RB rows of SP floats), each
  // warp's DEPTH mbarriers
  static constexpr int SMEM =
      1024 + WARPS * DEPTH * STAGE + WARPS * RB * SP * 4 + WARPS * DEPTH * 8;
  static_assert(W_BYTES % 1024 == 0, "the x box starts on the swizzle's period");
};

// grid (ctas): unit u = (s tiles + tile) row_tiles + row tile, of
// row_tiles * tiles * nseg, runs on warp (u / ctas) % C::WARPS of CTA u %
// ctas.  part, arrivals (S > 1): the (nseg, b, n) fp32 partials and one
// int per (row tile, column tile), 0 on entry and left 0.  TMA: the stages
// arrive by TMA (wmap: w in boxes of BOX_COLS columns x 32 k rows; xmap: x
// in boxes of 32 k x min(b, RB) rows, xbytes; both swizzled) on one
// mbarrier a stage (x rows past b are left as they are: they feed only
// outputs that are not stored); else by cp.async, wvec / xvec bytes per
// copy of a w / x row piece (16, 8, 4, or 0: element loads).
template <typename WT, int RB, bool TMA>
__global__ void __launch_bounds__(Cfg<WT, RB>::THREADS, 1)
sa_fc_wide_kernel(const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap xmap, const BF* __restrict__ x,
                  const WT* __restrict__ w, const float* __restrict__ scale,
                  const float* __restrict__ bias, void* __restrict__ out, int out_bf16,
                  float* __restrict__ part, int* __restrict__ arrivals, int b, int k, int n,
                  int seg_chunks, int nseg, int tiles, int row_tiles, int xbytes, int wvec,
                  int xvec, int act) {
  using C = Cfg<WT, RB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int g = lid >> 2, t = lid & 3;
  const int units = row_tiles * tiles * nseg;
  constexpr int WARPS = C::WARPS;
  const int stride = gridDim.x * WARPS;
  const int first = warp * gridDim.x + blockIdx.x;
  const int nch = (k + BK - 1) / BK;
  unsigned char* ring = smem + warp * (DEPTH * C::STAGE);
  float* scr = reinterpret_cast<float*>(smem + WARPS * DEPTH * C::STAGE) + warp * RB * C::SP;
  const unsigned bars =
      smem_addr(smem + WARPS * DEPTH * C::STAGE + WARPS * RB * C::SP * 4) + warp * DEPTH * 8;
  if constexpr (TMA) {
    if (lid == 0) {
      for (int s = 0; s < DEPTH; ++s) mbar_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }

  // The load cursor walks this warp's chunks (its units in order, each
  // unit's chunks in order) ahead of the products; with cp.async every
  // call commits one group, empty past the end, so that the wait below
  // counts stages.
  int lu = first - stride, lch = 0, lend = 0, lcol0 = 0, lr0 = 0;
  auto issue = [&](int slot) {
    while (lch >= lend && lu < units) {
      lu += stride;
      if (lu < units) {
        const int v = lu / row_tiles, s = v / tiles;
        lch = s * seg_chunks;
        lend = min(lch + seg_chunks, nch);
        lcol0 = (v - s * tiles) * C::TC;
        lr0 = (lu - v * row_tiles) * RB;
      }
    }
    if (lu < units) {
      unsigned char* st = ring + slot * C::STAGE;
      const int k0 = lch * BK;
      ++lch;
      if constexpr (TMA) {
        if (lid == 0) {
          const unsigned bar = bars + 8 * slot;
          fence_proxy_async();                           // the warp's reads of the slot first
          mbar_expect_tx(bar, C::W_BYTES + xbytes);
#pragma unroll
          for (int j = 0; j < C::BOXES; ++j)
            tma_load(smem_addr(st + j * BK * C::BOXB), &wmap, bar, lcol0 + j * C::BOX_COLS, k0);
          tma_load(smem_addr(st + C::W_BYTES), &xmap, bar, k0, lr0);
        }
        return;
      }
      copy_w_any<WT, C::TC, C::BOXB>(wvec, st, w, k, n, k0, lcol0, lid);
      copy_x_any<RB>(xvec, st + C::W_BYTES, x, b, k, lr0, k0, lid);
    }
    if constexpr (!TMA) cp_async_commit();
  };
#pragma unroll 1
  for (int s = 0; s < DEPTH - 1; ++s) issue(s);

  int slot = 0, phase = 0;                                 // the stage computed next
#pragma unroll 1
  for (int u = first; u < units; u += stride) {
    const int v = u / row_tiles, s = v / tiles, tile = v - s * tiles, rt = u - v * row_tiles;
    const int c0 = s * seg_chunks, c1 = min(c0 + seg_chunks, nch);
    const int col0 = tile * C::TC, r0 = rt * RB;
    float acc[C::TILES][C::SLICES][4];
#pragma unroll
    for (int j = 0; j < C::TILES; ++j)
#pragma unroll
      for (int sl = 0; sl < C::SLICES; ++sl)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][sl][e] = 0.f;
#pragma unroll 1
    for (int ch = c0; ch < c1; ++ch) {
      if constexpr (TMA)
        mbar_wait(bars + 8 * slot, phase);
      else
        cp_async_wait<DEPTH - 2>();
      __syncwarp();
      issue(slot == 0 ? DEPTH - 1 : slot - 1);
      const unsigned char* st = ring + slot * C::STAGE;
      if (++slot == DEPTH) slot = 0, phase ^= 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned bq[C::SLICES][2];
#pragma unroll
        for (int sl = 0; sl < C::SLICES; ++sl) load_b(bq[sl], st + C::W_BYTES, sl, 16 * h, lid);
#pragma unroll
        for (int j = 0; j < C::TILES; ++j) {
          unsigned a[4];
          load_a<WT, C::BOXB>(a, st, 16 * j, 16 * h, lid);
#pragma unroll
          for (int sl = 0; sl < C::SLICES; ++sl) mma_bf16(acc[j][sl], a, bq[sl]);
        }
      }
    }
    // The unit's partial into the warp's scratch (acc[j][sl][e] is row 8
    // sl + 2 t + (e & 1), column 16 j + g + 8 (e >> 1) of the unit), then
    // lane l takes outputs o = l + 32 i (row o / TC, column o % TC):
    // coalesced stores, and one copy of the epilogue's code.
    __syncwarp();                                          // the last unit's reads done
#pragma unroll
    for (int j = 0; j < C::TILES; ++j)
#pragma unroll
      for (int sl = 0; sl < C::SLICES; ++sl)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          scr[(sl * ROWS + 2 * t + (e & 1)) * C::SP + 16 * j + g + ((e >> 1) << 3)] =
              acc[j][sl][e];
    __syncwarp();
    if (nseg > 1) {
      // P_s to the workspace; the last warp on this tile adds P_0..P_{S-1}
#pragma unroll 8
      for (int i = 0; i < C::PER; ++i) {
        const int o = lid + 32 * i, row = r0 + o / C::TC, col = col0 + o % C::TC;
        if (row < b && col < n)
          part[(static_cast<size_t>(s) * b + row) * n + col] =
              scr[o / C::TC * C::SP + o % C::TC];
      }
      __threadfence();
      __syncwarp();
      int last = 0;
      if (lid == 0) {
        int* cnt = arrivals + rt * tiles + tile;
        last = atomicAdd(cnt, 1) == nseg - 1;
        if (last) *cnt = 0;                              // ready for the next launch
      }
      if (!__shfl_sync(0xffffffffu, last, 0)) continue;
      __threadfence();
      // QU segments' partials of the lane's outputs loaded together (128
      // loads in flight), then added in segment order.  Split launches
      // are small: (S, b, n) has < 2^31 elements.
      constexpr int QU = 128 / C::PER;
      const unsigned stride = static_cast<unsigned>(b) * n;
#pragma unroll 1
      for (int q0 = 0; q0 < nseg; q0 += QU) {
        float p[QU][C::PER];
#pragma unroll
        for (int j = 0; j < QU; ++j)
#pragma unroll
          for (int i = 0; i < C::PER; ++i) {
            const int o = lid + 32 * i, row = r0 + o / C::TC, col = col0 + o % C::TC;
            p[j][i] = q0 + j < nseg && row < b && col < n
                          ? __ldcg(part + ((q0 + j) * stride +
                                           static_cast<unsigned>(row) * n + col))
                          : 0.f;
          }
#pragma unroll
        for (int j = 0; j < QU; ++j)
#pragma unroll
          for (int i = 0; i < C::PER; ++i) {
            const int o = lid + 32 * i;
            float& v = scr[o / C::TC * C::SP + o % C::TC];
            if (q0 + j < nseg) v = q0 + j == 0 ? p[j][i] : v + p[j][i];
          }
      }
    }
#pragma unroll 4
    for (int i = 0; i < C::PER; ++i) {
      const int o = lid + 32 * i, row = r0 + o / C::TC, col = col0 + o % C::TC;
      if (row < b && col < n)
        emit(out, out_bf16, static_cast<size_t>(row) * n + col,
             scr[o / C::TC * C::SP + o % C::TC], scale, bias, col, act);
    }
  }
}

}  // namespace wide

// A row-major (rows, cols) matrix of `type` read in boxes of box_cols x
// box_rows, swizzled by the box row's bytes (32, 64 or 128), zeros out of
// bounds.
bool encode(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, int rows,
            int cols, int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int box_bytes = box_cols * elem;
  const CUtensorMapSwizzle sw = box_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename WT>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(WT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : sizeof(WT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_UINT8;   // int8 bits, copied as they are
}

struct Args {
  const BF* x;
  const void* w;
  const float *scale, *bias;
  void* out;
  int out_bf16;
  float* part;
  int* arrivals;
  int b, k, n, seg_chunks, nseg, ctas, wvec, xvec, act;
  cudaStream_t stream;
};

template <typename WT>
cudaError_t launch_narrow(const Args& a) {
  using namespace narrow;
  auto kern = sa_fc_narrow_kernel<WT>;
  static std::atomic<unsigned long long> opted{0};
  cudaError_t err = opt_in(kern, smem_bytes<WT>(1, 1) + PART_SMEM_MAX, opted);
  if (err != cudaSuccess) return err;
  const int groups = (a.n + GCOLS - 1) / GCOLS;
  const int span = (groups + a.ctas - 1) / a.ctas;
  if (a.ctas > groups || a.ctas > SM_COUNT || part_bytes(a.nseg, span) > PART_SMEM_MAX)
    return cudaErrorInvalidValue;
  kern<<<a.ctas, THREADS, smem_bytes<WT>(a.nseg, span), a.stream>>>(
      a.x, static_cast<const WT*>(a.w), a.scale, a.bias, a.out, a.out_bf16, a.b, a.k, a.n,
      a.seg_chunks, a.nseg, groups, a.wvec, a.xvec, a.act);
  return cudaGetLastError();
}

template <typename WT, int RB, bool TMA>
cudaError_t launch_wide(const Args& a) {
  using C = wide::Cfg<WT, RB>;
  auto kern = wide::sa_fc_wide_kernel<WT, RB, TMA>;
  static std::atomic<unsigned long long> opted{0};
  cudaError_t err = opt_in(kern, C::SMEM, opted);
  if (err != cudaSuccess) return err;
  const int tiles = (a.n + C::TC - 1) / C::TC;
  const int row_tiles = (a.b + RB - 1) / RB;
  const int xrows = a.b < RB ? a.b : RB;
  const long long units = static_cast<long long>(row_tiles) * tiles * a.nseg;
  if (a.ctas > SM_COUNT || a.ctas > units ||
      (a.nseg > 1 && (a.part == nullptr || a.arrivals == nullptr)))
    return cudaErrorInvalidValue;
  CUtensorMap wmap{}, xmap{};
  if constexpr (TMA) {
    if (!encode(&wmap, tma_type<WT>(), C::WB, a.w, a.k, a.n, C::BOX_COLS, BK) ||
        !encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, a.b, a.k, BK, xrows))
      return cudaErrorInvalidValue;
  }
  kern<<<a.ctas, C::THREADS, C::SMEM, a.stream>>>(
      wmap, xmap, a.x, static_cast<const WT*>(a.w), a.scale, a.bias, a.out, a.out_bf16, a.part,
      a.arrivals, a.b, a.k, a.n, a.seg_chunks, a.nseg, tiles, row_tiles, xrows * X_ROW, a.wvec,
      a.xvec, a.act);
  return cudaGetLastError();
}

// The kernel for (k, n) at row tile RB: narrow (is_narrow, b <= 8), or
// wide (any row tiles) on TMA
// where both operands' rows and bases are 16-byte aligned (what a tensor
// map takes) and k > 0, on cp.async otherwise.
template <typename WT, int RB>
cudaError_t launch_kernel(const Args& a) {
  if constexpr (RB == ROWS) {
    if (is_narrow(a.b, a.k, a.n)) return launch_narrow<WT>(a);
  }
  return a.wvec == 16 && a.xvec == 16 && a.k > 0 ? launch_wide<WT, RB, true>(a)
                                                 : launch_wide<WT, RB, false>(a);
}

template <typename WT>
cudaError_t launch_rb(int rb, const Args& a) {
  switch (rb) {
    case 8: return launch_kernel<WT, 8>(a);
    case 16: return launch_kernel<WT, 16>(a);
    case 32: return launch_kernel<WT, 32>(a);
    case 64: return launch_kernel<WT, 64>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The widest copy (16, 8 or 4 bytes) that an address and its rows' length
// allow; 0 (element loads) otherwise.
int copy_bytes(const void* p, long long row_bytes) {
  const long long a = static_cast<long long>(reinterpret_cast<uintptr_t>(p)) | row_bytes;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 0;
}

template <typename WT, int RB>
int smem_wide() {
  return wide::Cfg<WT, RB>::SMEM;
}

template <typename WT>
int smem_rb(int b, int k, int n, int rb, int nseg, int span) {
  if (rb == ROWS && is_narrow(b, k, n)) return narrow::smem_bytes<WT>(nseg, span);
  switch (rb) {
    case 8: return smem_wide<WT, 8>();
    case 16: return smem_wide<WT, 16>();
    case 32: return smem_wide<WT, 32>();
    case 64: return smem_wide<WT, 64>();
    default: return -1;
  }
}

}  // namespace

// x (b, k) bf16; w (k, n) of w_kind (0 fp32, 1 int8, 2 bf16); out_kind 0
// fp32, 2 bf16.  rb: the row tile (8, 16, 32 or 64; ceil(b / rb) row
// tiles); seg_chunks: chunks of 32 k per segment (S =
// ceil(ceil(k / 32) / seg_chunks)); ctas: the grid (kernels/sa_fc.py::
// tc_launch).  Narrow: part and arrivals unused.  Wide (S > 1): part S * b
// * n floats and arrivals ceil(b / rb) * ceil(n / tc) zeroed ints.  scale
// and bias may be null.  Returns cudaGetLastError() after the launch.
extern "C" int sa_fc_tc_launch(const void* x, const void* w, int w_kind, int out_kind,
                               const void* scale, const void* bias, void* out, void* part,
                               void* arrivals, int b, int k, int n, int rb, int seg_chunks,
                               int ctas, int act, void* stream) {
  if (seg_chunks < 1 || b < 1 || n < 1 || k < 0 || ctas < 1 ||
      (out_kind != KIND_F32 && out_kind != KIND_BF16) || w_kind < 0 || w_kind > 2)
    return cudaErrorInvalidValue;
  const int chunks = (k + BK - 1) / BK;
  const int nseg = chunks > seg_chunks ? (chunks + seg_chunks - 1) / seg_chunks : 1;
  const Args a{static_cast<const BF*>(x), w, static_cast<const float*>(scale),
               static_cast<const float*>(bias), out, out_kind == KIND_BF16,
               static_cast<float*>(part), static_cast<int*>(arrivals), b, k, n, seg_chunks, nseg,
               ctas, copy_bytes(w, static_cast<long long>(n) * KIND_BYTES[w_kind]),
               copy_bytes(x, static_cast<long long>(k) * 2), act,
               static_cast<cudaStream_t>(stream)};
  switch (w_kind) {
    case 0: return launch_rb<float>(rb, a);
    case 1: return launch_rb<int8_t>(rb, a);
    default: return launch_rb<BF>(rb, a);
  }
}

// The dynamic shared memory sa_fc_tc_launch passes for w_kind and b rows
// at row tile rb for (k, n), S segments and at most span column groups a
// narrow CTA (the wide kernel's depends on the types and rb alone), or -1
// where it has no instantiation: what repro_torch/analysis/launch.py
// derives, asked of the built kernel.
extern "C" int sa_fc_tc_smem(int w_kind, int b, int k, int n, int rb, int nseg, int span) {
  switch (w_kind) {
    case 0: return smem_rb<float>(b, k, n, rb, nseg, span);
    case 1: return smem_rb<int8_t>(b, k, n, rb, nseg, span);
    case 2: return smem_rb<BF>(b, k, n, rb, nseg, span);
    default: return -1;
  }
}
