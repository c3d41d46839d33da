// SA-FC's decode path on Hopper: out = act((x @ w) * scale + bias) for bf16
// x of b <= 8 rows and bf16 w (k, n), fp32 accumulation, out fp32 or bf16:
// every LM decode step the port serves.  It adds every output's terms in
// exactly the order of the FMA kernel (sa_fc.cu), so the two give the
// same bits and kernels/sa_fc.py picks between them by dtype and row tile
// alone.
//
// Replaces: src/repro/kernels/sa_fc.py::sa_fc_matmul (Pallas body
// _sa_fc_kernel) on its decode shapes, the batch-amortized weight stream
// of the paper's SA-FC array.
//
// What bounds it on this card.  The k*n*2 weight bytes over 3.35 TB/s: a
// weight feeds b <= 8 rows, at most 8 FMAs per 2 bytes, i.e. 27 TFLOP/s at
// the memory's rate, 40 % of the CUDA cores' fp32 rate (a product of two
// bf16 values is exact in fp32, so the tensor cores buy nothing here).  An
// OLMo-1B decode step streams 2.35 GB of bf16 weights: 0.70 ms of bound.
// Below ~10 MB a launch is latency: DRAM's first bytes, the chunks one
// warp sums in a row, combining the k segments.
//
// The fixed order (sa_fc.cu's, bit for bit).  k is cut into chunks of BK
// = 32 and the chunks into S segments of seg_chunks (kernels/sa_fc.py::
// fc_split(k, n), the last may be shorter).  Within a segment, k-lane l
// (of KL = 4) sums k = 8l..8l+7 of every chunk, in increasing k, one fmaf
// per term from +0; the lanes are added ((l0 + l1) + l2) + l3 into the
// segment's partial P_s; the partials are added (((P_0 + P_1) + P_2) + ...)
// in segment order; then scale, bias and activation once, in fp32.
// Zero-filled terms (k past its end) add +0 to a sum that is never -0.
//
// Two ways to run that order, picked by (k, n) alone (kernels/sa_fc.py::
// decode_launch): a unit is (column tile, k segment) in both.
//  * Narrow (k and n <= 4096: attention projections; sa_fc_narrow_
//    kernel).  A unit is 16 columns, one warp: thread (l, p) = (lane / 8,
//    lane % 8) owns k-lane l of columns 2p and 2p+1 for all RB rows, and
//    the four lanes are added with shuffles.  CTAs (512 threads, one an
//    SM, min(groups, 132) of them) own contiguous runs of column groups
//    and every segment of them; a CTA's units, segment-major, go
//    round-robin to its 16 warps, and after one barrier the CTA adds each
//    output's segments in order from shared memory (at most 64 KiB of
//    partials: S <= 128 chunks, and S falls as n grows): no workspace, no
//    counter, no atomic.  The fine units keep every SM busy on small
//    matrices, whose time is latency; on long rows their 32-byte row
//    pieces stream slowly.
//  * Wide (the rest: MLPs, heads, Mamba's projections; sa_fc_wide_kernel).
//    A unit is 128 columns, run by a team of 4 warps, warp l summing
//    k-lane l: thread p owns columns 4p..4p+3, so each warp's stage is its
//    lane's 8 rows of 256 bytes.  Stages arrive by TMA (a 2-d box of w, one
//    of x, on one mbarrier) where both operands' rows and bases are 16-byte
//    aligned, by cp.async otherwise.  At a unit's end warps 1-3 leave
//    their sums in shared memory, a 128-thread barrier, warp 0 adds the
//    lanes in order, a second barrier frees the buffer.  S > 1: warp 0
//    writes P_s to the workspace (S, b, n) and arrives on the tile's
//    counter; the team arriving last loads the S partials a batch at a
//    time, adds them in order and resets the counter for the next launch.
//    Teams of 256-thread CTAs, two an SM, take units round-robin.  (16-
//    column warps streamed OLMo-1B's head at half its byte bound however
//    many warps an SM held, and no faster without their FMAs: cp.async's
//    32-byte row pieces capped the stream; 64-column teams reached 0.100
//    ms on cp.async or TMA, 128-column ones 0.095: PERF.md, section 6.)
// In both each warp streams its own chunks through a private ring of
// stages in shared memory, across unit boundaries, with the chunk's x rows
// in the same stage (a warp's units cover their own k ranges: x fetched a
// chunk ahead from global memory waited out L2's latency every chunk), and
// the only barrier on the stream is the warp's own.  The assignment
// depends on (k, n) alone.  Edges: ragged b (rows past b read zeros and are
// not stored), k (copies zero-fill rows past k) and n (copies zero-fill
// columns past n, the stores are masked), k = 0 (the epilogue of zeros);
// 8- and 4-byte copies, or element loads, where a row's bytes or its base
// allow no 16-byte pieces.
#include "common.cuh"

namespace {

constexpr int KL = 4;                        // k-lanes per output
constexpr int KG = 8;                        // consecutive k of a lane in a chunk
constexpr int BK = KL * KG;                  // k per chunk (32)
constexpr int SM_COUNT = 132;                // an H100's SMs: the grids' caps
constexpr int NARROW_MAX = 4096;             // the narrow kernel's largest k and n

// The narrow kernel for k and n up to NARROW_MAX, the wide one beyond.
__host__ __device__ constexpr bool is_narrow(int k, int n) {
  return k <= NARROW_MAX && n <= NARROW_MAX;
}

using BF = __nv_bfloat16;

// bf16 word halves widened to fp32: the lower-addressed element is the low half.
__device__ __forceinline__ float lo_f32(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f32(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

// ---------------------------------------------------------------------------
// narrow: 16-column warp units, CTAs that own their groups' segments
// ---------------------------------------------------------------------------
namespace narrow {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int GCOLS = 16;                    // columns of a unit (2 per thread)
constexpr int ROW_BYTES = GCOLS * 2;         // a chunk row of a unit in bf16
constexpr int LANE_BLOCK = KG * ROW_BYTES + 32;   // a k-lane's 8 rows, padded
constexpr int X_OFF = KL * LANE_BLOCK;       // a stage's x rows (64 B each) from here
constexpr int DEPTH = 6;                     // stages of a warp's ring
constexpr int PART_SMEM_MAX = 65536;         // the most partials k <= NARROW_MAX gives


// One chunk of a unit at row tile rb: the weights, then rb rows of x.
__host__ __device__ constexpr int stage_bytes(int rb) { return X_OFF + rb * BK * 2; }

// Bytes of the partials of a CTA's units (S > 1).
long long part_bytes(int rb, int nseg, int span) {
  return nseg > 1 ? static_cast<long long>(span) * nseg * rb * GCOLS * 4 : 0;
}

// Dynamic shared memory of a launch: the rings, then the partials.
int smem_bytes(int rb, int nseg, int span) {
  return WARPS * DEPTH * stage_bytes(rb) + static_cast<int>(part_bytes(rb, nseg, span));
}

// A chunk of a unit (32 rows of k from k0, 16 columns from col0) into a
// ring stage, V bytes per copy, zero-filled past k and n (a V-byte piece
// is wholly in or out: V divides a row's bytes).
template <int V>
__device__ __forceinline__ void copy_w(unsigned char* st, const BF* w, int k, int n, int k0,
                                       int col0, int lid) {
  constexpr int PER_ROW = ROW_BYTES / V;
  constexpr int EL = V / 2;
#pragma unroll
  for (int j = 0; j < BK * PER_ROW / 32; ++j) {
    const int i = lid + 32 * j, r = i / PER_ROW, cv = i % PER_ROW;
    const int kk = k0 + r, col = col0 + cv * EL;
    const bool ok = kk < k && col < n;
    unsigned char* dst = st + (r / KG) * LANE_BLOCK + (r % KG) * ROW_BYTES + cv * V;
    if constexpr (V >= 4) {
      cp_async<V>(dst, ok ? w + (static_cast<size_t>(kk) * n + col) : w, ok ? V : 0);
    } else {                                 // rows of an odd length or base
      *reinterpret_cast<BF*>(dst) = ok ? w[static_cast<size_t>(kk) * n + col] : BF{};
    }
  }
}

// The chunk's 32 k of the RB rows of x into the stage's x rows, V bytes
// per copy, zero-filled past b and k.
template <int V, int RB>
__device__ __forceinline__ void copy_x(unsigned char* st, const BF* x, int b, int k, int k0,
                                       int lid) {
  constexpr int PER_ROW = BK * 2 / V;
  constexpr int EL = V / 2;
#pragma unroll
  for (int j = 0; j < (RB * PER_ROW + 31) / 32; ++j) {
    const int i = lid + 32 * j, r = i / PER_ROW, cv = i % PER_ROW;
    if (RB * PER_ROW % 32 != 0 && r >= RB) break;
    const int kk = k0 + cv * EL;
    const bool ok = r < b && kk < k;
    unsigned char* dst = st + X_OFF + r * (BK * 2) + cv * V;
    if constexpr (V >= 4) {
      cp_async<V>(dst, ok ? x + (static_cast<size_t>(r) * k + kk) : x, ok ? V : 0);
    } else {
      *reinterpret_cast<BF*>(dst) = ok ? x[static_cast<size_t>(r) * k + kk] : BF{};
    }
  }
}

// grid (ctas): CTA c owns groups [c groups / ctas, (c + 1) groups / ctas)
// of 16 columns and all nseg segments of each.  wvec / xvec: bytes per
// copy of a w / x row piece (16, 8, 4, or 2: element loads).
template <typename OT, int RB>
__global__ void __launch_bounds__(THREADS, 1)
sa_fc_narrow_kernel(const BF* __restrict__ x, const BF* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    OT* __restrict__ out, int b, int k, int n, int seg_chunks, int nseg,
                    int groups, int wvec, int xvec, int act) {
  constexpr int STAGE = stage_bytes(RB);
  extern __shared__ __align__(16) unsigned char smem[];
  const int cta = blockIdx.x;
  const int g0 = static_cast<int>(static_cast<long long>(cta) * groups / gridDim.x);
  const int gc = static_cast<int>(static_cast<long long>(cta + 1) * groups / gridDim.x) - g0;
  const int units = gc * nseg;                             // segment-major: u = s gc + group
  const int nch = (k + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int l = lid / KG, p = lid % KG;
  unsigned char* ring = smem + warp * (DEPTH * STAGE);
  float* part = reinterpret_cast<float*>(smem + WARPS * DEPTH * STAGE);

  // The load cursor walks this warp's chunks (its units u = warp, warp +
  // WARPS, ..., each unit's chunks in order) ahead of the FMAs; every call
  // commits one cp.async group, empty past the end, so that the wait below
  // counts stages.
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
      unsigned char* st = ring + slot * STAGE;
      const int k0 = lch * BK;
      if (wvec == 16) copy_w<16>(st, w, k, n, k0, lcol0, lid);
      else if (wvec == 8) copy_w<8>(st, w, k, n, k0, lcol0, lid);
      else if (wvec == 4) copy_w<4>(st, w, k, n, k0, lcol0, lid);
      else copy_w<2>(st, w, k, n, k0, lcol0, lid);
      if (xvec == 16) copy_x<16, RB>(st, x, b, k, k0, lid);
      else if (xvec == 8) copy_x<8, RB>(st, x, b, k, k0, lid);
      else if (xvec == 4) copy_x<4, RB>(st, x, b, k, k0, lid);
      else copy_x<2, RB>(st, x, b, k, k0, lid);
      ++lch;
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int s = 0; s < DEPTH - 1; ++s) issue(s);

  int slot = 0;                                            // the stage computed next
#pragma unroll 1
  for (int u = warp; u < units; u += WARPS) {
    const int s = u / gc;
    const int c0 = s * seg_chunks, c1 = min(c0 + seg_chunks, nch);
    const int col0 = (g0 + u - s * gc) * GCOLS;
    float acc[RB][2];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 1
    for (int ch = c0; ch < c1; ++ch) {
      cp_async_wait<DEPTH - 2>();
      __syncwarp();
      issue(slot == 0 ? DEPTH - 1 : slot - 1);
      const unsigned char* st = ring + slot * STAGE;
      slot = slot == DEPTH - 1 ? 0 : slot + 1;
      unsigned xw[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const uint4 q = *reinterpret_cast<const uint4*>(st + X_OFF + r * (BK * 2) + l * 16);
        xw[r][0] = q.x; xw[r][1] = q.y; xw[r][2] = q.z; xw[r][3] = q.w;
      }
      const unsigned* ws = reinterpret_cast<const unsigned*>(st + l * LANE_BLOCK) + p;
#pragma unroll
      for (int q = 0; q < KG; ++q) {
        const unsigned v = ws[q * (ROW_BYTES / 4)];
        const float w0 = lo_f32(v), w1 = hi_f32(v);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float xf = q % 2 == 0 ? lo_f32(xw[r][q / 2]) : hi_f32(xw[r][q / 2]);
          acc[r][0] = fmaf(xf, w0, acc[r][0]);
          acc[r][1] = fmaf(xf, w1, acc[r][1]);
        }
      }
    }
    // the unit's partial P_s: lanes ((l0 + l1) + l2) + l3, in the threads of lane 0
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float a0 = acc[r][cc];
        const float a1 = __shfl_down_sync(0xffffffffu, a0, KG);
        const float a2 = __shfl_down_sync(0xffffffffu, a0, 2 * KG);
        const float a3 = __shfl_down_sync(0xffffffffu, a0, 3 * KG);
        acc[r][cc] = ((a0 + a1) + a2) + a3;
      }
    if (l == 0) {
      if (nseg == 1) {
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = col0 + 2 * p + cc;
            if (r < b && col < n)
              store_out(out + (static_cast<size_t>(r) * n + col),
                        apply_act(scale_bias(acc[r][cc], scale, bias, col), act));
          }
      } else {
#pragma unroll
        for (int r = 0; r < RB; ++r)
          *reinterpret_cast<float2*>(part + (u * RB + r) * GCOLS + 2 * p) =
              make_float2(acc[r][0], acc[r][1]);
      }
    }
  }
  if (nseg == 1) return;

  // Each output of the CTA's groups: P_0 + P_1 + ... in segment order.
  __syncthreads();
  const int outs = gc * RB * GCOLS;
  for (int e = threadIdx.x; e < outs; e += THREADS) {
    const int gl = e / (RB * GCOLS), r = e / GCOLS % RB, cc = e % GCOLS;
    float v = part[(gl * RB + r) * GCOLS + cc];
    for (int s = 1; s < nseg; ++s) v += part[((s * gc + gl) * RB + r) * GCOLS + cc];
    const int col = (g0 + gl) * GCOLS + cc;
    if (r < b && col < n)
      store_out(out + (static_cast<size_t>(r) * n + col),
                apply_act(scale_bias(v, scale, bias, col), act));
  }
}


}  // namespace narrow

// ---------------------------------------------------------------------------
// wide: 128-column units of four-warp teams, TMA or cp.async
// ---------------------------------------------------------------------------
namespace wide {

constexpr int TILE = 128;                    // columns of a unit
constexpr int C = TILE / 32;                 // columns a thread owns: two words of bf16
static_assert(C == 4, "a thread reads its 4 columns of a row as one 8-byte word pair");
constexpr int TEAMS = 2;                     // teams of KL warps a CTA
constexpr int THREADS = 32 * KL * TEAMS;
constexpr int PER_SM = 2;                    // CTAs an SM holds
constexpr int DEPTH = 4;                     // stages of a warp's ring
constexpr int W_BYTES = KG * TILE * 2;       // a lane's 8 rows of a chunk (2 KB)
constexpr int X_BYTES = 128;                 // its 8 k of up to 8 x rows, padded
constexpr int STAGE = W_BYTES + X_BYTES;     // 128-byte aligned pieces for TMA
constexpr int WARPS = KL * TEAMS;


// Dynamic shared memory: 128 bytes to align the rings, the warps' rings,
// the lane sums of warps 1-3 of each team, then each warp's DEPTH
// mbarriers.
__host__ __device__ constexpr int smem_bytes(int rb) {
  return 128 + WARPS * DEPTH * STAGE + TEAMS * (KL - 1) * rb * TILE * 4 + WARPS * DEPTH * 8;
}

// Lane l's 8 rows of chunk k0 of the tile from col0 into a ring stage, V
// bytes per copy, zero-filled past k and n (a V-byte piece is wholly in or
// out: V divides a row's bytes).  32 threads copy 4 rows of 128 bytes at a
// time.
template <int V>
__device__ __forceinline__ void copy_w(unsigned char* st, const BF* w, int k, int n, int k0,
                                       int col0, int lid) {
  constexpr int PER_ROW = TILE * 2 / V;
  constexpr int EL = V / 2;
#pragma unroll
  for (int j = 0; j < KG * PER_ROW / 32; ++j) {
    const int i = lid + 32 * j, q = i / PER_ROW, cv = i % PER_ROW;
    const int kk = k0 + q, col = col0 + cv * EL;
    const bool ok = kk < k && col < n;
    unsigned char* dst = st + q * (TILE * 2) + cv * V;
    if constexpr (V >= 4) {
      cp_async<V>(dst, ok ? w + (static_cast<size_t>(kk) * n + col) : w, ok ? V : 0);
    } else {                                 // rows of an odd length or base
      *reinterpret_cast<BF*>(dst) = ok ? w[static_cast<size_t>(kk) * n + col] : BF{};
    }
  }
}

// The lane's 8 k from k0 of the RB rows of x into the stage, V bytes per
// copy, zero-filled past b and k.
template <int V, int RB>
__device__ __forceinline__ void copy_x(unsigned char* st, const BF* x, int b, int k, int k0,
                                       int lid) {
  constexpr int PER_ROW = KG * 2 / V;
  constexpr int EL = V / 2;
  static_assert(RB * PER_ROW <= 32 * 2, "two pieces a thread at most");
#pragma unroll
  for (int j = 0; j < (RB * PER_ROW + 31) / 32; ++j) {
    const int i = lid + 32 * j, r = i / PER_ROW, cv = i % PER_ROW;
    if (r >= RB) break;
    const int kk = k0 + cv * EL;
    const bool ok = r < b && kk < k;
    unsigned char* dst = st + W_BYTES + r * (KG * 2) + cv * V;
    static_assert(RB * KG * 2 <= X_BYTES, "x rows fit the stage");
    if constexpr (V >= 4) {
      cp_async<V>(dst, ok ? x + (static_cast<size_t>(r) * k + kk) : x, ok ? V : 0);
    } else {
      *reinterpret_cast<BF*>(dst) = ok ? x[static_cast<size_t>(r) * k + kk] : BF{};
    }
  }
}

// The team's 128 threads (named barrier 1 + team).
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "n"(32 * KL) : "memory");
}

// grid (ctas): team t of CTA c is team c TEAMS + t of ctas TEAMS, and runs
// units u = that, + ctas TEAMS, ... of tiles * nseg, u = s tiles + tile.
// part, arrivals (S > 1): the (nseg, b, n) fp32 partials and one int per
// tile, 0 on entry and left 0.  TMA: the stages arrive by TMA (wmap: w in
// boxes of 64 columns x 8 rows; xmap: x in boxes of 8 k x RB rows) on one
// mbarrier a stage; else by cp.async, wvec / xvec bytes per copy of a w /
// x row piece (16, 8, 4, or 2: element loads).
template <typename OT, int RB, bool TMA>
__global__ void __launch_bounds__(THREADS, PER_SM)
sa_fc_wide_kernel(const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap xmap, const BF* __restrict__ x,
                    const BF* __restrict__ w, const float* __restrict__ scale,
                    const float* __restrict__ bias, OT* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ arrivals, int b, int k, int n,
                    int seg_chunks, int nseg, int tiles, int wvec, int xvec, int act) {
  constexpr int SUMS = (KL - 1) * RB * TILE;               // floats of a team's lane sums
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - smem_addr(smem_raw) % 128) % 128);
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int team = warp / KL, l = warp % KL;
  const int units = tiles * nseg;
  const int nteams = gridDim.x * TEAMS;
  const int first = blockIdx.x * TEAMS + team;
  const int nch = (k + BK - 1) / BK;
  unsigned char* ring = smem + warp * (DEPTH * STAGE);
  float* sums = reinterpret_cast<float*>(smem + WARPS * DEPTH * STAGE) + team * SUMS;
  const unsigned bars = smem_addr(smem + WARPS * DEPTH * STAGE + TEAMS * SUMS * 4) +
                        warp * DEPTH * 8;                  // this warp's mbarriers
  if constexpr (TMA) {
    if (lid == 0) {
      for (int s = 0; s < DEPTH; ++s) mbar_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }

  // The load cursor walks this warp's chunks (its team's units in order,
  // each unit's chunks in order) ahead of the FMAs; every call commits one
  // cp.async group, empty past the end, so that the wait below counts
  // stages.
  int lu = first - nteams, lch = 0, lend = 0, lcol0 = 0;
  auto issue = [&](int slot) {
    while (lch >= lend && lu < units) {
      lu += nteams;
      if (lu < units) {
        const int s = lu / tiles;
        lch = s * seg_chunks;
        lend = min(lch + seg_chunks, nch);
        lcol0 = (lu - s * tiles) * TILE;
      }
    }
    if (lu < units) {
      unsigned char* st = ring + slot * STAGE;
      const int k0 = lch * BK + KG * l;
      ++lch;
      if constexpr (TMA) {
        if (lid == 0) {
          const unsigned bar = bars + 8 * slot;
          fence_proxy_async();                           // the warp's reads of the slot first
          mbar_expect_tx(bar, W_BYTES + RB * KG * 2);
          tma_load(smem_addr(st), &wmap, bar, lcol0, k0);
          tma_load(smem_addr(st + W_BYTES), &xmap, bar, k0, 0);
        }
        return;
      }
      if (wvec == 16) copy_w<16>(st, w, k, n, k0, lcol0, lid);
      else if (wvec == 8) copy_w<8>(st, w, k, n, k0, lcol0, lid);
      else if (wvec == 4) copy_w<4>(st, w, k, n, k0, lcol0, lid);
      else copy_w<2>(st, w, k, n, k0, lcol0, lid);
      if (xvec == 16) copy_x<16, RB>(st, x, b, k, k0, lid);
      else if (xvec == 8) copy_x<8, RB>(st, x, b, k, k0, lid);
      else if (xvec == 4) copy_x<4, RB>(st, x, b, k, k0, lid);
      else copy_x<2, RB>(st, x, b, k, k0, lid);
    }
    if constexpr (!TMA) cp_async_commit();
  };
#pragma unroll 1
  for (int s = 0; s < DEPTH - 1; ++s) issue(s);

  int slot = 0, phase = 0;                                 // the stage computed next
#pragma unroll 1
  for (int u = first; u < units; u += nteams) {
    const int s = u / tiles, tile = u - s * tiles;
    const int c0 = s * seg_chunks, c1 = min(c0 + seg_chunks, nch);
    const int col0 = tile * TILE;
    float acc[RB][C];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int cc = 0; cc < C; ++cc) acc[r][cc] = 0.f;
#pragma unroll 1
    for (int ch = c0; ch < c1; ++ch) {
      if constexpr (TMA)
        mbar_wait(bars + 8 * slot, phase);
      else
        cp_async_wait<DEPTH - 2>();
      __syncwarp();
      issue(slot == 0 ? DEPTH - 1 : slot - 1);
      const unsigned char* st = ring + slot * STAGE;
      if (++slot == DEPTH) slot = 0, phase ^= 1;
      unsigned xw[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const uint4 q = *reinterpret_cast<const uint4*>(st + W_BYTES + r * (KG * 2));
        xw[r][0] = q.x; xw[r][1] = q.y; xw[r][2] = q.z; xw[r][3] = q.w;
      }
      const uint2* ws = reinterpret_cast<const uint2*>(st) + lid;
#pragma unroll
      for (int q = 0; q < KG; ++q) {
        const uint2 t = ws[q * (TILE / C)];
        const unsigned v[2] = {t.x, t.y};
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float xf = q % 2 == 0 ? lo_f32(xw[r][q / 2]) : hi_f32(xw[r][q / 2]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc[r][2 * j] = fmaf(xf, lo_f32(v[j]), acc[r][2 * j]);
            acc[r][2 * j + 1] = fmaf(xf, hi_f32(v[j]), acc[r][2 * j + 1]);
          }
        }
      }
    }
    // the unit's partial P_s: lanes ((l0 + l1) + l2) + l3, in warp 0
    float* buf = sums;
    if (l > 0) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int cc = 0; cc < C; cc += 2)
          *reinterpret_cast<float2*>(buf + ((l - 1) * RB + r) * TILE + C * lid + cc) =
              make_float2(acc[r][cc], acc[r][cc + 1]);
    }
    team_sync(team);
    if (l == 0) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int cc = 0; cc < C; cc += 2) {
          float2 a[KL - 1];
#pragma unroll
          for (int j = 0; j < KL - 1; ++j)
            a[j] = *reinterpret_cast<const float2*>(buf + (j * RB + r) * TILE + C * lid + cc);
          acc[r][cc] = ((acc[r][cc] + a[0].x) + a[1].x) + a[2].x;
          acc[r][cc + 1] = ((acc[r][cc + 1] + a[0].y) + a[1].y) + a[2].y;
        }
    }
    team_sync(team);                                       // the buffer read: free again
    if (l > 0) continue;
    const int col = col0 + C * lid;
    if (nseg > 1) {
      // P_s to the workspace; the last team on this tile adds P_0..P_{S-1}
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int cc = 0; cc < C; ++cc)
          if (r < b && col + cc < n)
            part[(static_cast<size_t>(s) * b + r) * n + col + cc] = acc[r][cc];
      __threadfence();
      __syncwarp();
      int last = 0;
      if (lid == 0) {
        last = atomicAdd(arrivals + tile, 1) == nseg - 1;
        if (last) arrivals[tile] = 0;                    // ready for the next launch
      }
      if (!__shfl_sync(0xffffffffu, last, 0)) continue;
      __threadfence();
      // the partials loaded U segments at a time, all in flight together,
      // then added in segment order
      constexpr int U = 64 / (RB * C) < 8 ? 64 / (RB * C) : 8;
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int cc = 0; cc < C; ++cc) acc[r][cc] = 0.f;
#pragma unroll 1
      for (int j0 = 0; j0 < nseg; j0 += U) {
        float t[U][RB][C];
#pragma unroll
        for (int i = 0; i < U; ++i)
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int cc = 0; cc < C; ++cc)
              t[i][r][cc] = j0 + i < nseg && r < b && col + cc < n
                                ? __ldcg(part + ((static_cast<size_t>(j0 + i) * b + r) * n +
                                                 col + cc))
                                : 0.f;
#pragma unroll
        for (int i = 0; i < U; ++i)
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int cc = 0; cc < C; ++cc)
              if (j0 + i < nseg) acc[r][cc] = j0 + i == 0 ? t[i][r][cc] : acc[r][cc] + t[i][r][cc];
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int cc = 0; cc < C; ++cc)
        if (r < b && col + cc < n)
          store_out(out + (static_cast<size_t>(r) * n + col + cc),
                    apply_act(scale_bias(acc[r][cc], scale, bias, col + cc), act));
  }
}


}  // namespace wide

// A row-major bf16 (rows, cols) matrix read in boxes of box_cols x
// box_rows, no swizzle, zeros out of bounds.
bool encode(CUtensorMap* map, const void* base, int rows, int cols, int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const BF *x, *w;
  const float *scale, *bias;
  void* out;
  float* part;
  int* arrivals;
  int b, k, n, seg_chunks, nseg, ctas, wvec, xvec, act;
  cudaStream_t stream;
};

template <typename OT, int RB>
cudaError_t launch_narrow(const Args& a) {
  using namespace narrow;
  auto kern = sa_fc_narrow_kernel<OT, RB>;
  static std::atomic<unsigned long long> opted{0};
  cudaError_t err = opt_in(kern, WARPS * DEPTH * stage_bytes(RB) + PART_SMEM_MAX, opted);
  if (err != cudaSuccess) return err;
  const int groups = (a.n + GCOLS - 1) / GCOLS;
  const int span = (groups + a.ctas - 1) / a.ctas;
  if (a.ctas > groups || a.ctas > SM_COUNT || part_bytes(RB, a.nseg, span) > PART_SMEM_MAX)
    return cudaErrorInvalidValue;
  kern<<<a.ctas, THREADS, smem_bytes(RB, a.nseg, span), a.stream>>>(
      a.x, a.w, a.scale, a.bias, static_cast<OT*>(a.out), a.b, a.k, a.n, a.seg_chunks, a.nseg,
      groups, a.wvec, a.xvec, a.act);
  return cudaGetLastError();
}

template <typename OT, int RB, bool TMA>
cudaError_t launch_wide(const Args& a) {
  using namespace wide;
  auto kern = sa_fc_wide_kernel<OT, RB, TMA>;
  static std::atomic<unsigned long long> opted{0};
  constexpr int smem = smem_bytes(RB);
  cudaError_t err = opt_in(kern, smem, opted);
  if (err != cudaSuccess) return err;
  const int tiles = (a.n + TILE - 1) / TILE;
  const long long units = static_cast<long long>(tiles) * a.nseg;
  if (a.ctas > SM_COUNT * PER_SM || a.ctas > (units + TEAMS - 1) / TEAMS ||
      (a.nseg > 1 && (a.part == nullptr || a.arrivals == nullptr)))
    return cudaErrorInvalidValue;
  CUtensorMap wmap{}, xmap{};
  if constexpr (TMA) {
    if (!encode(&wmap, a.w, a.k, a.n, TILE, KG) || !encode(&xmap, a.x, a.b, a.k, KG, RB))
      return cudaErrorInvalidValue;
  }
  kern<<<a.ctas, THREADS, smem, a.stream>>>(wmap, xmap, a.x, a.w, a.scale, a.bias,
                                            static_cast<OT*>(a.out), a.part, a.arrivals, a.b,
                                            a.k, a.n, a.seg_chunks, a.nseg, tiles, a.wvec,
                                            a.xvec, a.act);
  return cudaGetLastError();
}

// The kernel for (k, n): narrow (is_narrow), or wide on TMA where both
// operands' rows and bases are 16-byte aligned (what a tensor map takes),
// on cp.async otherwise.
template <typename OT, int RB>
cudaError_t launch_kernel(const Args& a) {
  if (is_narrow(a.k, a.n)) return launch_narrow<OT, RB>(a);
  return a.wvec == 16 && a.xvec == 16 ? launch_wide<OT, RB, true>(a)
                                      : launch_wide<OT, RB, false>(a);
}

template <typename OT>
cudaError_t launch_rb(int rb, const Args& a) {
  switch (rb) {
    case 1: return launch_kernel<OT, 1>(a);
    case 2: return launch_kernel<OT, 2>(a);
    case 4: return launch_kernel<OT, 4>(a);
    case 8: return launch_kernel<OT, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The widest copy (16, 8 or 4 bytes) that an address and its rows' length
// allow; 2 (element loads) otherwise.
int copy_bytes(const void* p, long long row_bytes) {
  const long long a = static_cast<long long>(reinterpret_cast<uintptr_t>(p)) | row_bytes;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
}

}  // namespace

// x (b, k) and w (k, n) bf16; out_kind 0 fp32, 2 bf16.  rb: the row tile
// (1, 2, 4 or 8, >= b); seg_chunks: chunks of 32 k per segment (S =
// ceil(ceil(k / 32) / seg_chunks)); ctas: the grid (kernels/sa_fc.py::
// decode_launch).  Narrow (k and n <= 4096): part and arrivals unused.
// Wide (S > 1): part S * b * n floats and arrivals ceil(n / 128) zeroed
// ints.  scale and bias may be
// null.  Returns cudaGetLastError() after the launch.
extern "C" int sa_fc_decode_launch(const void* x, const void* w, int out_kind, const void* scale,
                                   const void* bias, void* out, void* part, void* arrivals, int b,
                                   int k, int n, int rb, int seg_chunks, int ctas, int act,
                                   void* stream) {
  if (seg_chunks < 1 || b < 1 || b > rb || n < 1 || ctas < 1 ||
      (out_kind != KIND_F32 && out_kind != KIND_BF16))
    return cudaErrorInvalidValue;
  const int chunks = (k + BK - 1) / BK;
  const int nseg = chunks > seg_chunks ? (chunks + seg_chunks - 1) / seg_chunks : 1;
  const Args a{static_cast<const BF*>(x), static_cast<const BF*>(w),
               static_cast<const float*>(scale), static_cast<const float*>(bias), out,
               static_cast<float*>(part), static_cast<int*>(arrivals), b, k, n, seg_chunks, nseg,
               ctas, copy_bytes(w, static_cast<long long>(n) * 2),
               copy_bytes(x, static_cast<long long>(k) * 2), act,
               static_cast<cudaStream_t>(stream)};
  return out_kind == KIND_F32 ? launch_rb<float>(rb, a) : launch_rb<BF>(rb, a);
}

// The dynamic shared memory sa_fc_decode_launch passes at row tile rb for
// (k, n), S segments and at most span column groups a narrow CTA (the wide
// kernel's depends on rb alone), or -1 where it has no instantiation: what
// repro_torch/analysis/launch.py derives, asked of the built kernel.
extern "C" int sa_fc_decode_smem(int k, int n, int rb, int nseg, int span) {
  if (rb != 1 && rb != 2 && rb != 4 && rb != 8) return -1;
  return is_narrow(k, n) ? narrow::smem_bytes(rb, nseg, span) : wide::smem_bytes(rb);
}
