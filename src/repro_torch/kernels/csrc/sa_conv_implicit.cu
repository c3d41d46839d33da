// SA-CONV on Hopper: a direct NHWC x HWIO VALID convolution with stride on
// a pre-padded input, out = act(conv(x, f) * scale + bias), and with a fused
// pool out = act(maxpool(conv(x, f) * scale + bias)).  x fp32 or bf16, f
// fp32 or int8 (per-output-channel scale), fp32 accumulation, no TF32; the
// output fp32, or bf16 or fp32 for bf16 x.  Two kernels compute it: fp32 x
// runs the FMA loop (sa_conv_kernel) on the CUDA cores; bf16 x runs an
// implicit GEMM on the tensor cores (sa_conv_wgmma_kernel, further down),
// as the TPU kernel runs its bf16 product on the matrix unit.
//
// Replaces: src/repro/kernels/sa_conv_implicit.py::sa_conv_implicit
// (Pallas body _implicit_conv_kernel), with its fused pool epilogue.
//
// fp32 x.  What bounds it on this card: fp32 FMAs.  AlexNet's convs do 60-500
// FLOP per byte of their compulsory traffic, far above the card's fp32
// ridge (~20 FLOP/B at 67 TFLOP/s and 3.35 TB/s), and TF32 is not allowed
// (fp32 means fp32), so the roof is the CUDA cores' FMA rate.  What keeps
// a direct conv from that roof is FMA slots spent on no pixel (tiles that
// do not fit the map, a last wave of CTAs that leaves SMs idle) and issue
// slots spent on anything but FMAs (shared-memory loads, address and loop
// arithmetic, barriers with nothing in flight).
//
// What the design does about it:
//  * Tiles fitted to the map, chosen by kernels/sa_conv_implicit.py::
//    conv_geometry from the layer's shape alone (never from the batch; the
//    batch only changes the CTA count).  A CTA is 256 threads and one of
//    three tiles: 512 pixels x 32 output channels (8 x 8 per thread; conv1),
//    512 x 64 (8 x 16; conv3, conv4) or 768 x 32 (6 x 16; conv2, conv5).
//    Without a pool the pixel tiles run over the
//    flattened (image, row, column) output, across row and image ends, so
//    every pixel slot but those of the last tile holds a pixel.  With a
//    pool a CTA takes k whole bands of emitted rows, from one image or
//    several, so no pool window is split; the band height and k are chosen
//    so the grid fills the card (AlexNet conv2: one whole 27x27 image per
//    768-pixel CTA; conv5: 8 bands of 3 pooled rows).  A CTA's bands, or
//    the images its flat tile touches, are its segments: it stages each
//    segment's input rows (with their halo) one after the other.
//  * A two-stage cp.async ring over chunks of ng groups of 4 input
//    channels (as many as shared memory holds: 2 at AlexNet's conv2, 4 at
//    conv3-conv5): while the CTA computes chunk g from one stage, chunk g + 1
//    streams into the other.  A staged pixel holds a group's 4 channels in
//    16 bytes (one plane per group), so the input copy is one 16-byte
//    cp.async per pixel and group where ci % 4 == 0 (4-byte copies,
//    zero-filled past ci, otherwise); a warp copies a whole input row at a
//    time from a per-CTA table of row addresses, so the copy loop does no
//    division.  conv1 (ci = 3) stages its whole 3-channel window in one
//    chunk.  fp32 filters stream in 16-byte pieces of 4 output channels;
//    int8 filters cross memory as 4-byte pieces and each thread widens the
//    pieces it copied once they land.
//  * A compile-time tap loop for AlexNet's and VGG-16's filters, (p, q,
//    stride) = (11, 11, 4), (5, 5, 1), (3, 3, 1): the q loop is unrolled
//    with constant offsets (p too for 3x3; a rolled p loop keeps 5x5 and
//    11x11 bodies in the instruction cache).  Any other shape runs the
//    generic instantiation with runtime loops and the same order.  Per tap a
//    thread reads one float4 (4 channels) per pixel and 4 float4 of filter
//    per channel and 4 output channels (a broadcast: every warp holds one
//    channel group) for 4 x 8 x 16 FMAs in the 8 x 16 tile, with 32-bit
//    shared addresses that it moves row by row, so every load is
//    [register + constant].  16 channels per thread halve the pixel loads
//    per FMA against 8 and ran 8-15 % faster at conv2-conv5.
//  * Staged rows are split by stride phase at stride 4 (column c lands at
//    (c % 4) * ceil(W / 4) + c / 4), so neighbouring output pixels read
//    neighbouring 16-byte words: a quarter-warp's float4 loads cover 128
//    contiguous bytes, no bank conflicts.  The taps of a filter row then
//    run phase by phase (q = 0, 4, 8, 1, 5, 9, ...), each phase's offsets
//    constant.
//  * Every output is summed by one thread in one order fixed by the
//    layer's (ci, p, q): channel groups of 4 in order, within a group the
//    taps in (p, q) order (by stride phase at stride 4), within a tap the
//    group's channels in order, one fmaf each.  The order does not depend
//    on the batch, the tile, the chunk, the segment or the pool, so
//    batched == unbatched and fused == unfused hold bitwise.  Zero-filled
//    channels past ci add +0 * 0 to a sum that starts at +0 and so change
//    no bit.
//  * The epilogue applies scale and bias (each rounded on its own), parks
//    the tile in shared memory, then takes the max over each pool window in
//    (dp, dq) order and applies act, writing the emitted map with the
//    channel index fastest.  Unfused is the same code with a 1x1 window.
//  * Registers: even the 8 x 8 tile with its filter values and pixel
//    addresses needs more than the 128 registers that two 256-thread CTAs
//    per SM allow (ptxas spilled 28-712 bytes per instantiation there), so
//    __launch_bounds__(256, 1): one CTA per SM, up to 255 registers, no
//    spills; the geometry's cost model counts one CTA per SM.  The 16-channel
//    tiles are not built for the 11x11 filter, whose unrolled row spills.
//
// bf16 x.  Replaces the bf16 instantiations of the FMA loop, which widened
// each pixel to fp32 in registers and ran at 2.9 % of the tensor cores'
// bound at AlexNet's convs (PERF.md).  What bounds it: the tensor cores'
// bf16 rate (989 TFLOP/s): AlexNet's and VGG-16's convs reuse every input
// value p q co times and every weight once a pixel, far above the card's
// ~295 operations a byte.  What keeps an implicit GEMM from it is feeding
// the tensor cores: gathering the pixels' receptive fields (no patch
// matrix exists in memory) and the filter, tile slots that hold no pixel,
// and k padding.  What the design does:
//  * An implicit GEMM: M the CTA's output pixels, N the output channels, K
//    = p q ci in (dp, dq, c) order (ci padded as below): for one filter row
//    dp, the q ci values of a pixel's taps lie contiguous in NHWC, so
//    consecutive k are consecutive addresses except at a new dp.  K is
//    padded with zeros to a multiple of 64, a whole ring stage (A and the
//    filter both zero there: the steps past K add exact zeros to sums that
//    are never -0).
//  * The filter: one pass a launch rounds it (fp32 to nearest even, int8
//    exactly, as the reference rounds w_tile.astype(patch.dtype)) into a
//    (K, co rounded up to 8) bf16 scratch the wrapper allocates; TMA loads
//    its 64 k x 64-column boxes, 128-byte swizzled, zeros past K and co.
//    The scratch halves the bytes every CTA re-reads from L2 against fp32,
//    and the producer spends no instruction on the filter.
//  * Two tiles (conv_geometry's tc tiles): 256 pixels x 128 channels, or
//    512 x 64 where a pool band needs more pixels (conv1's bands of 4
//    pooled rows: 9 x 55 = 495; VGG-16 conv1_2's pooled row: 2 x 224) or
//    co is 64.  Flat tiles without a pool, whole pool-window bands with one,
//    as the FMA loop's geometry, so no window is split and no column strip
//    is needed at AlexNet's and VGG-16's widths.
//  * 384 threads: two consumer warpgroups, each 64 MB rows (MB = 2 or 4 m64
//    blocks), issue wgmma.mma_async m64nBNk16 (bf16 in, fp32 sums in
//    registers, 128 a thread), four k steps a ring stage of 64 k, one
//    stage's group left in flight while the next is issued.  A producer
//    warpgroup (setmaxnreg gives its registers to the consumers) fills a
//    ring of 4 (256-pixel tile) or 3 (512) stages guarded by full and empty
//    mbarriers: one thread issues the filter's TMA; all 128 gather A, the
//    pixels' 128-byte k rows of the stage, by cp.async into the 128-byte
//    swizzle that wgmma reads, from a table of each pixel's first input
//    element built once a CTA; a thread that copies at most 32 rows a
//    stage keeps its rows' entries in registers (reading the table for
//    every copy cost 15-22 % at AlexNet's conv2-conv5: the producer's
//    issue, not the tensor cores, sets the pace; PERF.md).  The copies L2
//    serves (cp.async.cg): caching them in L1 or ordering k by channel
//    block, so that successive stages reuse lines, gained nothing.  A
//    piece is 16 bytes (8 channels of one tap)
//    where ci % 8 == 0 (AlexNet conv2-conv5, VGG-16 past conv1_1), 8 bytes
//    (4 channels) where ci == 4.  Any other ci (conv1's 3, whose rows are
//    only 2-byte aligned) is first copied, with its channels padded by
//    zeros to 4 (ci < 4) or to a multiple of 8, into a scratch the wrapper
//    allocates (so is an x whose base does not align with its pieces), and
//    the filter's rows gain the same zero channels: K = p q cp, conv1's
//    484 in place of 363, and no lane of A is read from a neighbouring
//    pixel (a NaN or an infinity times a zero weight would be NaN).  A
//    first design gathered conv1 two elements a lane and took twice the
//    FMA loop's time (PERF.md).  k past K is zero in A and in the filter.
//  * The epilogue applies scale and bias in registers in the FMA loop's
//    order, parks the fp32 tile in the ring, and runs the FMA loop's pool
//    epilogue on it (max over each window in (dp, dq) order, act, one
//    rounding to the output type).
//  * One summation order per output: its K terms in 16-wide wgmma steps,
//    in increasing k, into one fp32 register that starts at +0, never split
//    over k; inside a step the tensor cores' own deterministic order.  The
//    order depends on (ci, p, q) only: the tile, the pool, the batch and
//    the producer change which thread holds an output, not its terms, so
//    batched == unbatched, fused == unfused and strips stitch, bitwise, and
//    a bf16 output is the fp32 output rounded once.  Against the FMA loop
//    the sums differ by order only: kernels/sa_conv_implicit.py::
//    widened_bound.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 4;             // input channels per staged group (16 bytes a pixel)
// kernels/sa_conv_implicit.py holds the same table limits
constexpr int MAX_SEGMENTS = 32;
constexpr int MAX_ROWS = 256;
enum { SG_IMG, SG_R0, SG_PX0, SG_SLOT0, SG_PR0, SG_NPR, SG_C0, SG_FIELDS };

struct ConvArgs {
  const void* x;                     // fp32 (the FMA loop) or bf16 (the tensor cores)
  const void* f;
  const float* scale;                // (co,) or null
  const float* bias;                 // (co,) or null
  void* out;                         // fp32, or bf16 where out_bf16
  int n, h, w, ci, p, q, co, stride; // padded input dims and filter
  int oh, ow;                        // conv output
  int pw, ps;                        // pool window and stride (1, 1: none)
  int poh, pow_;                     // emitted map
  int bands;                         // bands per image; 0: flat pixel tiles
  int rows;                          // emitted rows of a full band
  int per_cta;                       // bands per CTA; flat: pixels per CTA
  int rin;                           // staged input rows per stage
  int wst;                           // staged columns per input row
  int ng;                            // groups of GROUP channels per chunk
  int chunks;                        // channel chunks
  int act;
  int f_int8;
  int out_bf16;                      // bf16 x only
  int xvec;                          // bytes per input copy: 16 or 4 (the FMA loop)
  int fvec;                          // bytes per filter copy: 16 or 4, 0: element loads
  int kdim;                          // p q ci (the tensor cores)
};

// Words of one stage: the chunk's ng planes of staged input rows (16-byte
// pixels), its fp32 filter rows [group][tap][channel][BCO] and their int8
// raw bytes.
__host__ __device__ inline int stage_words(int rin, int wst, int taps, int cpg, int bco, int ng) {
  return ng * (rin * wst * 4 + taps * cpg * bco + taps * cpg * bco / 4);
}

// Dynamic shared memory of a launch (bytes): the staging ring (two stages
// where ci takes more than one chunk) or the epilogue tile of cap pixels x
// bco + 1 floats, whichever is larger.
inline int dynamic_smem(int rin, int wst, int taps, int cpg, int bco, int cap, int chunks,
                        int ng) {
  const int stages = chunks > 1 ? 2 : 1;
  const int ring = stages * stage_words(rin, wst, taps, cpg, bco, ng);
  const int tile = cap * (bco + 1);
  return 4 * (ring > tile ? ring : tile);
}

template <int N>
__device__ __forceinline__ void shift(unsigned (&base)[N], int by) {
#pragma unroll
  for (int j = 0; j < N; ++j) base[j] += by;
}

// A 16-byte shared-memory load at a 32-bit shared address.
__device__ __forceinline__ float4 lds128(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// One tap of one staged channel group.  base[]: shared byte addresses of
// the thread's pixels in the stage; xoff: the tap's byte offset (a
// constant in the specialised instantiations); fr: shared byte address of
// the group's filter rows for this thread's TCO output channels.
template <int TPX, int TCO, int BCO, int CPG>
__device__ __forceinline__ void conv_tap(float (&acc)[TPX][TCO], const unsigned (&base)[TPX],
                                         unsigned xoff, unsigned fr) {
  float wv[CPG][TCO];
#pragma unroll
  for (int c = 0; c < CPG; ++c)
#pragma unroll
    for (int e = 0; e < TCO; e += 4) {
      const float4 w = lds128(fr + (c * BCO + e) * 4);
      wv[c][e] = w.x; wv[c][e + 1] = w.y; wv[c][e + 2] = w.z; wv[c][e + 3] = w.w;
    }
#pragma unroll
  for (int j = 0; j < TPX; ++j) {
    const float4 xv = lds128(base[j] + xoff);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int c = 0; c < CPG; ++c)
#pragma unroll
      for (int e = 0; e < TCO; ++e) acc[j][e] = fmaf(xs[c], wv[c][e], acc[j][e]);
  }
}

// Every tap of a staged chunk in (p, q) order; at stride 4 the q of one
// stride phase run together (phase 0: q = 0, 4, 8; phase 1: 1, 5, 9; ...),
// so that each tap's offset is a constant.  base[] is moved row by row and
// phase by phase (rowb, phb: bytes per staged row and per stride phase) and
// left as it was found.
template <int P_, int Q_, int S_, int TPX, int TCO, int BCO, int CPG>
__device__ __forceinline__ void conv_chunk(float (&acc)[TPX][TCO], unsigned (&base)[TPX],
                                           unsigned fr, int P, int Q, int rowb, int phb) {
  constexpr int PU = (P_ > 0 && P_ <= 3) ? P_ : 1;
  constexpr int FTAP = CPG * BCO * 4;                 // filter bytes per tap
#pragma unroll PU
  for (int pp = 0; pp < P; ++pp) {
    const unsigned frow = fr + pp * Q * FTAP;
    if constexpr (S_ > 1) {
#pragma unroll
      for (int k = 0; k < S_; ++k) {
#pragma unroll
        for (int qq = k; qq < Q_; qq += S_)
          conv_tap<TPX, TCO, BCO, CPG>(acc, base, (qq / S_) * 16, frow + qq * FTAP);
        shift(base, phb);
      }
      shift(base, rowb - S_ * phb);
    } else if constexpr (Q_ > 0) {
#pragma unroll
      for (int qq = 0; qq < Q_; ++qq) conv_tap<TPX, TCO, BCO, CPG>(acc, base, qq * 16, frow + qq * FTAP);
      shift(base, rowb);
    } else {
      for (int qq = 0; qq < Q; ++qq) conv_tap<TPX, TCO, BCO, CPG>(acc, base, qq * 16, frow + qq * FTAP);
      shift(base, rowb);
    }
  }
  shift(base, -P * rowb);
}

// fp32 x.  P_, Q_, S_: the filter and stride, or 0 for runtime values (the
// generic instantiation).  TPX pixels x TCO channels per thread, G channel
// groups of TCO per CTA, CPG channels per staged group (4, or 3 when ci ==
// 3).
template <int P_, int Q_, int S_, int TPX, int TCO, int G, int CPG>
__global__ void __launch_bounds__(THREADS, 1)
sa_conv_kernel(const ConvArgs a) {
  constexpr int BCO = TCO * G;       // output channels per CTA
  constexpr int PXG = THREADS / G;   // pixel groups
  constexpr int CAP = PXG * TPX;     // pixel slots
  constexpr int BCOP = BCO + 1;      // epilogue tile pitch (bank-conflict free)
  constexpr bool SPLIT = S_ > 1;     // staged rows split by stride phase
  const int NG = a.ng;
  const int P = P_ ? P_ : a.p;
  const int Q = Q_ ? Q_ : a.q;
  const int S = S_ ? S_ : a.stride;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_row[MAX_ROWS];                     // staged slot -> input row
  __shared__ int s_seg[MAX_SEGMENTS][SG_FIELDS];
  __shared__ int s_count[3];

  const int t = threadIdx.x;
  const int co0 = blockIdx.y * BCO;
  const int ohw = a.oh * a.ow;
  const long long p0 = static_cast<long long>(blockIdx.x) * a.per_cta;

  // the CTA's segments: (image, first conv row, conv rows, first pixel in
  // the CTA, first staged slot, first emitted row, emitted rows, offset of
  // the first pixel in the segment's rows)
  if (t == 0) {
    int nseg = 0, px = 0, slot = 0;
    if (a.bands == 0) {
      const long long total = static_cast<long long>(a.n) * ohw;
      const long long p1 = min(p0 + a.per_cta, total);
      const int i0 = static_cast<int>(p0 / ohw), i1 = static_cast<int>((p1 - 1) / ohw);
      for (int img = i0; img <= i1; ++img) {
        const long long base = static_cast<long long>(img) * ohw;
        const int lo = static_cast<int>(max(p0, base) - base);
        const int hi = static_cast<int>(min(p1, base + ohw) - base);
        const int r0 = lo / a.ow, r1 = (hi - 1) / a.ow;
        int* sg = s_seg[nseg++];
        sg[SG_IMG] = img; sg[SG_R0] = r0; sg[SG_PX0] = px; sg[SG_SLOT0] = slot;
        sg[SG_PR0] = r0; sg[SG_NPR] = r1 - r0 + 1; sg[SG_C0] = lo - r0 * a.ow;
        px += hi - lo;
        slot += (r1 - r0) * S + P;
      }
    } else {
      const int u0 = blockIdx.x * a.per_cta;
      const int u1 = min(u0 + a.per_cta, a.n * a.bands);
      for (int u = u0; u < u1; ++u) {
        const int img = u / a.bands, band = u - img * a.bands;
        const int pr0 = band * a.rows, npr = min(a.rows, a.poh - pr0);
        const int nr = (npr - 1) * a.ps + a.pw;
        int* sg = s_seg[nseg++];
        sg[SG_IMG] = img; sg[SG_R0] = pr0 * a.ps; sg[SG_PX0] = px; sg[SG_SLOT0] = slot;
        sg[SG_PR0] = pr0; sg[SG_NPR] = npr; sg[SG_C0] = 0;
        px += nr * a.ow;
        slot += (nr - 1) * S + P;
      }
    }
    s_count[0] = nseg; s_count[1] = px; s_count[2] = slot;
  }
  __syncthreads();
  const int nseg = s_count[0], npix = s_count[1], nslots = s_count[2];
  for (int sl = t; sl < nslots; sl += THREADS) {
    int s = 0;
    while (s + 1 < nseg && s_seg[s + 1][SG_SLOT0] <= sl) ++s;
    s_row[sl] = s_seg[s][SG_IMG] * a.h + s_seg[s][SG_R0] * S + (sl - s_seg[s][SG_SLOT0]);
  }

  const int cg = t / PXG;
  const int pg = t % PXG;
  const int rowp = a.wst * 4;                          // words per staged row
  const int ws = SPLIT ? a.wst / S_ : 0;               // columns per stride phase
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned base[TPX];                                  // shared byte addresses of the pixels
#pragma unroll
  for (int j = 0; j < TPX; ++j) {
    const int i = pg + PXG * j;
    base[j] = sbase;
    if (i < npix) {
      int s = 0;
      while (s + 1 < nseg && s_seg[s + 1][SG_PX0] <= i) ++s;
      const int l = i - s_seg[s][SG_PX0] + s_seg[s][SG_C0];
      const int oyl = l / a.ow, ox = l - oyl * a.ow;
      base[j] += 4 * ((s_seg[s][SG_SLOT0] + oyl * S) * rowp + ox * (SPLIT ? 4 : 4 * S));
    }
  }

  const int taps = P * Q;
  const int planew = a.rin * rowp;                     // words per group's input plane
  const int xw = NG * planew;
  const int fwg = taps * CPG * BCO;                    // filter words per group
  const int stage = stage_words(a.rin, a.wst, taps, CPG, BCO, NG);
  const int warp = t >> 5, lane = t & 31;
  const float* const xg = static_cast<const float*>(a.x);

  // stage channel chunk g (NG groups of 4 channels) into stage buffer st
  auto load_chunk = [&](int g, int st) {
    float* sx = smem + st * stage;
    float* sf = sx + xw;
    unsigned char* sraw = reinterpret_cast<unsigned char*>(sf + NG * fwg);
    const int c0 = g * GROUP * NG;
    for (int sl = warp; sl < nslots; sl += THREADS / 32) {
      const float* src = xg + static_cast<size_t>(s_row[sl]) * a.w * a.ci + c0;
      float* dst = sx + sl * rowp;
      for (int c = lane; c < a.w; c += 32) {
        const int dc = SPLIT ? (c % S_) * ws + c / S_ : c;
        const float* sp = src + static_cast<size_t>(c) * a.ci;
        for (int gi = 0; gi < NG; ++gi) {
          const int nci = min(CPG, a.ci - c0 - GROUP * gi);
          float* dp = dst + gi * planew + dc * 4;
          if (a.xvec == 16) {
            cp_async<16>(dp, nci > 0 ? sp + GROUP * gi : xg, nci > 0 ? 16 : 0);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              cp_async<4>(dp + k, k < nci ? sp + GROUP * gi + k : xg, k < nci ? 4 : 0);
          }
        }
      }
    }
    constexpr int PPR = BCO / 4;                       // 4-channel pieces per filter row
    for (int gi = 0; gi < NG; ++gi) {
      const int cg0 = c0 + GROUP * gi;
      const int nci = min(CPG, a.ci - cg0);
      if (a.fvec == 0 || a.fvec == 4 && !a.f_int8) {   // element copies
        for (int e = t; e < fwg; e += THREADS) {
          const int col = e % BCO, row = e / BCO;
          const int cl = row % CPG, tap = row / CPG;
          const int cog = co0 + col;
          const bool ok = cl < nci && cog < a.co;
          const size_t fi = (static_cast<size_t>(tap) * a.ci + cg0 + cl) * a.co + cog;
          float* d = sf + gi * fwg + e;
          if (a.f_int8)
            *d = ok ? static_cast<float>(static_cast<const int8_t*>(a.f)[fi]) : 0.f;
          else
            cp_async<4>(d, ok ? static_cast<const float*>(a.f) + fi : a.x, ok ? 4 : 0);
        }
      } else {                                         // pieces of 4 output channels
        for (int e = t; e < fwg / 4; e += THREADS) {
          const int piece = e % PPR, row = e / PPR;
          const int cl = row % CPG, tap = row / CPG;
          const int cog = co0 + 4 * piece;
          const bool ok = cl < nci && cog < a.co;
          const size_t fi = (static_cast<size_t>(tap) * a.ci + cg0 + cl) * a.co + cog;
          if (a.f_int8)
            cp_async<4>(sraw + gi * fwg + 4 * e, ok ? static_cast<const int8_t*>(a.f) + fi : a.f,
                        ok ? 4 : 0);
          else
            cp_async<16>(sf + gi * fwg + 4 * e, ok ? static_cast<const float*>(a.f) + fi : a.x,
                         ok ? 16 : 0);
        }
      }
    }
  };

  float acc[TPX][TCO];
#pragma unroll
  for (int j = 0; j < TPX; ++j)
#pragma unroll
    for (int e = 0; e < TCO; ++e) acc[j][e] = 0.f;

  __syncthreads();                                     // the row table
  load_chunk(0, 0);
  cp_async_commit();
  for (int g = 0; g < a.chunks; ++g) {
    const int st = g & 1;
    if (g + 1 < a.chunks) {
      load_chunk(g + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const float* sf = smem + st * stage + xw;
    if (a.f_int8 && a.fvec == 4) {                     // widen the pieces this thread copied
      const char4* raw = reinterpret_cast<const char4*>(sf + NG * fwg);
      float4* wide = reinterpret_cast<float4*>(const_cast<float*>(sf));
      for (int gi = 0; gi < NG; ++gi)
        for (int e = t; e < fwg / 4; e += THREADS) {
          const char4 v = raw[gi * fwg / 4 + e];
          wide[gi * fwg / 4 + e] = make_float4(v.x, v.y, v.z, v.w);
        }
    }
    __syncthreads();
    const int ngr = min(NG, (a.ci - g * GROUP * NG + GROUP - 1) / GROUP);   // groups holding channels
#pragma unroll 1
    for (int gi = 0; gi < ngr; ++gi) {
      const int off = st * stage + gi * planew;        // this stage's group plane
      shift(base, 4 * off);
      conv_chunk<P_, Q_, S_, TPX, TCO, BCO, CPG>(acc, base,
                                            sbase + 4 * (st * stage + xw + gi * fwg + cg * TCO), P,
                                            Q, 4 * rowp, 16 * ws);
      shift(base, -4 * off);
    }
    __syncthreads();
  }

  // epilogue: scale + bias into the tile, then pool (or 1x1) + act
  float* tile = smem;
#pragma unroll
  for (int j = 0; j < TPX; ++j) {
    const int i = pg + PXG * j;
    if (i < npix) {
#pragma unroll
      for (int e = 0; e < TCO; ++e) {
        const int col = cg * TCO + e;
        const int cog = co0 + col;
        tile[i * BCOP + col] = cog < a.co ? scale_bias(acc[j][e], a.scale, a.bias, cog) : 0.f;
      }
    }
  }
  __syncthreads();

  if (a.bands == 0) {
    for (int idx = t; idx < npix * BCO; idx += THREADS) {
      const int col = idx % BCO, i = idx / BCO;
      const int cog = co0 + col;
      if (cog < a.co)
        static_cast<float*>(a.out)[static_cast<size_t>(p0 + i) * a.co + cog] =
            apply_act(tile[i * BCOP + col], a.act);
    }
    return;
  }
  int nout = 0;
  for (int s = 0; s < nseg; ++s) nout += s_seg[s][SG_NPR] * a.pow_;
  for (int idx = t; idx < nout * BCO; idx += THREADS) {
    const int col = idx % BCO;
    int rest = idx / BCO, s = 0;
    while (rest >= s_seg[s][SG_NPR] * a.pow_) rest -= s_seg[s++][SG_NPR] * a.pow_;
    const int cog = co0 + col;
    if (cog >= a.co) continue;
    const int er = rest / a.pow_, ex = rest - er * a.pow_;
    const float* tp = tile + (s_seg[s][SG_PX0] + er * a.ps * a.ow + ex * a.ps) * BCOP + col;
    float m = tp[0];
    for (int dp = 0; dp < a.pw; ++dp)
      for (int dq = 0; dq < a.pw; ++dq) {
        m = pool_max(m, tp[(dp * a.ow + dq) * BCOP]);
      }
    const size_t orow = static_cast<size_t>(s_seg[s][SG_IMG]) * a.poh + s_seg[s][SG_PR0] + er;
    static_cast<float*>(a.out)[(orow * a.pow_ + ex) * a.co + cog] = apply_act(m, a.act);
  }
}

template <int P, int Q, int S, int TPX, int TCO, int G, int CPG>
cudaError_t launch(const ConvArgs& a, int smem_bytes, cudaStream_t stream) {
  constexpr int BCO = TCO * G;
  constexpr int CAP = THREADS / G * TPX;
  const int need = dynamic_smem(a.rin, a.wst, a.p * a.q, CPG, BCO, CAP, a.chunks, a.ng);
  if (need != smem_bytes) return cudaErrorInvalidValue;   // the host's geometry disagrees
  auto* kern = sa_conv_kernel<P, Q, S, TPX, TCO, G, CPG>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return err;
  const long long units = static_cast<long long>(a.n) * (a.bands ? a.bands : a.oh * a.ow);
  const long long tiles = (units + a.per_cta - 1) / a.per_cta;
  const dim3 grid(static_cast<unsigned>(tiles), (a.co + BCO - 1) / BCO);
  kern<<<grid, THREADS, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// The tiles of kernels/sa_conv_implicit.py::TILES.  The 8 x 16 tile is not
// built for the 11x11 filter: its unrolled filter row needs more than 255
// registers.
template <int TPX, int TCO, int G>
cudaError_t dispatch(const ConvArgs& a, int smem_bytes, cudaStream_t st) {
  if (a.p == 11 && a.q == 11 && a.stride == 4) {
    if constexpr (TPX * TCO > 64) {
      return cudaErrorInvalidValue;
    } else {
      return a.ci == 3 ? launch<11, 11, 4, TPX, TCO, G, 3>(a, smem_bytes, st)
                       : launch<11, 11, 4, TPX, TCO, G, 4>(a, smem_bytes, st);
    }
  }
  if (a.p == 5 && a.q == 5 && a.stride == 1)
    return launch<5, 5, 1, TPX, TCO, G, 4>(a, smem_bytes, st);
  if (a.p == 3 && a.q == 3 && a.stride == 1)
    return launch<3, 3, 1, TPX, TCO, G, 4>(a, smem_bytes, st);
  return launch<0, 0, 0, TPX, TCO, G, 4>(a, smem_bytes, st);
}

cudaError_t by_tile(const ConvArgs& a, int tile, int smem_bytes, cudaStream_t st) {
  if (tile == 0) return dispatch<8, 8, 4>(a, smem_bytes, st);
  if (tile == 1) return dispatch<8, 16, 4>(a, smem_bytes, st);
  if (tile == 2) return dispatch<6, 16, 2>(a, smem_bytes, st);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 x on the tensor cores
// ---------------------------------------------------------------------------
// One output in the launch's output type: bf16 rounded once where
// a.out_bf16, else fp32.
__device__ __forceinline__ void put(const ConvArgs& a, size_t i, float v) {
  if (a.out_bf16)
    store_out(static_cast<__nv_bfloat16*>(a.out) + i, v);
  else
    static_cast<float*>(a.out)[i] = v;
}

// The CTA's segments as the FMA loop builds them (its code, for a table in
// dynamic shared memory), by one thread: (image, first conv row, first pixel in
// the CTA, first staged slot, first emitted row, emitted rows, offset of
// the first pixel in the segment's rows) of each band of the CTA (bands >
// 0) or each image its flat tile of per_cta pixels touches; count: the
// segments, pixels and staged rows.  S and P: the stride and the filter's
// rows.
__device__ __forceinline__ void build_segments(const ConvArgs& a, int (*seg)[SG_FIELDS], int* count,
                                               int S, int P) {
  const int ohw = a.oh * a.ow;
  const long long p0 = static_cast<long long>(blockIdx.x) * a.per_cta;
  int nseg = 0, px = 0, slot = 0;
  if (a.bands == 0) {
    const long long total = static_cast<long long>(a.n) * ohw;
    const long long p1 = min(p0 + a.per_cta, total);
    const int i0 = static_cast<int>(p0 / ohw), i1 = static_cast<int>((p1 - 1) / ohw);
    for (int img = i0; img <= i1; ++img) {
      const long long base = static_cast<long long>(img) * ohw;
      const int lo = static_cast<int>(max(p0, base) - base);
      const int hi = static_cast<int>(min(p1, base + ohw) - base);
      const int r0 = lo / a.ow, r1 = (hi - 1) / a.ow;
      int* sg = seg[nseg++];
      sg[SG_IMG] = img; sg[SG_R0] = r0; sg[SG_PX0] = px; sg[SG_SLOT0] = slot;
      sg[SG_PR0] = r0; sg[SG_NPR] = r1 - r0 + 1; sg[SG_C0] = lo - r0 * a.ow;
      px += hi - lo;
      slot += (r1 - r0) * S + P;
    }
  } else {
    const int u0 = blockIdx.x * a.per_cta;
    const int u1 = min(u0 + a.per_cta, a.n * a.bands);
    for (int u = u0; u < u1; ++u) {
      const int img = u / a.bands, band = u - img * a.bands;
      const int pr0 = band * a.rows, npr = min(a.rows, a.poh - pr0);
      const int nr = (npr - 1) * a.ps + a.pw;
      int* sg = seg[nseg++];
      sg[SG_IMG] = img; sg[SG_R0] = pr0 * a.ps; sg[SG_PX0] = px; sg[SG_SLOT0] = slot;
      sg[SG_PR0] = pr0; sg[SG_NPR] = npr; sg[SG_C0] = 0;
      px += nr * a.ow;
      slot += (nr - 1) * S + P;
    }
  }
  count[0] = nseg; count[1] = px; count[2] = slot;
}

// The FMA loop's epilogue, second half, run by NT threads (t < NT):
// act(max over each pool window) of the parked tile (pixel i's BCO
// channels at tile[i * PITCH]), written with the channel index fastest;
// unfused is a 1x1 window.  Flat tiles write pixel p0 + i of the flattened
// output.
template <int BCO, int PITCH, int NT>
__device__ __forceinline__ void emit_tile(const ConvArgs& a, const int (*seg)[SG_FIELDS], int nseg,
                                          int npix, const float* tile, int co0, long long p0, int t) {
  if (a.bands == 0) {
    for (int idx = t; idx < npix * BCO; idx += NT) {
      const int col = idx % BCO, i = idx / BCO;
      const int cog = co0 + col;
      if (cog < a.co)
        put(a, static_cast<size_t>(p0 + i) * a.co + cog, apply_act(tile[i * PITCH + col], a.act));
    }
    return;
  }
  int nout = 0;
  for (int s = 0; s < nseg; ++s) nout += seg[s][SG_NPR] * a.pow_;
  for (int idx = t; idx < nout * BCO; idx += NT) {
    const int col = idx % BCO;
    int rest = idx / BCO, s = 0;
    while (rest >= seg[s][SG_NPR] * a.pow_) rest -= seg[s++][SG_NPR] * a.pow_;
    const int cog = co0 + col;
    if (cog >= a.co) continue;
    const int er = rest / a.pow_, ex = rest - er * a.pow_;
    const float* tp = tile + (seg[s][SG_PX0] + er * a.ps * a.ow + ex * a.ps) * PITCH + col;
    float m = tp[0];
    for (int dp = 0; dp < a.pw; ++dp)
      for (int dq = 0; dq < a.pw; ++dq) {
        m = pool_max(m, tp[(dp * a.ow + dq) * PITCH]);
      }
    const size_t orow = static_cast<size_t>(seg[s][SG_IMG]) * a.poh + seg[s][SG_PR0] + er;
    put(a, (orow * a.pow_ + ex) * a.co + cog, apply_act(m, a.act));
  }
}

// Warpgroups 0 and 1 consume (64 MB pixel rows of the tile each), warpgroup
// 2 produces.  A stage holds the pixels' A tile (one 128-byte row of 64 k a
// pixel) and the filter's B tile (BN / 64 boxes of 64 k rows of 64
// channels), both 128-byte swizzled.
constexpr int TC_BK = 64;            // k per ring stage: 128 bytes of bf16
constexpr int TC_CONSUMERS = 256;    // threads of the two consumer warpgroups
constexpr int TC_THREADS = 384;      // and the producer warpgroup
constexpr int TC_ALIGN = 1024;       // the 128-byte swizzle's period
constexpr int TC_BOX = TC_BK * 128;  // one 64-column box of the B tile
constexpr int TC_REGS = 168;         // registers a thread at launch: 65536 / 384, rounded to 8
// registers a thread after setmaxnreg: the producer's gather keeps a few
// rows' loads in flight; the consumers hold 128 sums each
constexpr int TC_PRODUCER_REGS = 88;
constexpr int TC_ROW_REGS = 32;      // most rows a producer thread keeps in registers
constexpr int TC_CONSUMER_REGS = (TC_REGS * TC_THREADS - TC_PRODUCER_REGS * 128) / TC_CONSUMERS;
static_assert(TC_CONSUMER_REGS % 8 == 0 &&
                  TC_PRODUCER_REGS * 128 + TC_CONSUMER_REGS * TC_CONSUMERS == TC_REGS * TC_THREADS,
              "setmaxnreg redistributes the CTA's registers, no more");

// The tiles of kernels/sa_conv_implicit.py::TC_TILES: MB m64 blocks a
// consumer warpgroup, BM = 128 MB pixel slots by BN channels, MB BN = 256.
// Dynamic shared memory: the alignment slack, the ring, the pixel table
// (each slot's first input element), the segment table and its counts, a
// full and an empty mbarrier a stage.  The epilogue parks the fp32 tile
// (PITCH floats a pixel) in the ring.
template <int MB>
struct TcTile {
  static constexpr int BN = 256 / MB;
  static constexpr int BM = 128 * MB;
  static constexpr int STAGES = MB == 2 ? 4 : 3;
  static constexpr int A_BYTES = BM * TC_BK * 2;
  static constexpr int B_BYTES = TC_BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int TABLES = BM * 8 + MAX_SEGMENTS * SG_FIELDS * 4 + 16;
  static constexpr int SMEM = TC_ALIGN + RING + TABLES + 2 * STAGES * 8;
  static constexpr int PITCH = BN + 4;
  static_assert(BM * PITCH * 4 <= RING, "the parked tile fits the ring");
};

// The filter (taps, ci, co) as the bf16 B matrix (taps cp, co8): row tap
// cp + c holds channel c of the tap (zeros for c >= ci), fp32 rounded to
// nearest even, int8 exactly, zeros in columns co..co8.
template <typename WT>
__global__ void round_filter_kernel(const WT* __restrict__ f, __nv_bfloat16* __restrict__ fb, int taps,
                                    int ci, int cp, int co, int co8) {
  const long long total = static_cast<long long>(taps) * cp * co8;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / co8;
    const int c = static_cast<int>(i - r * co8);
    const long long tap = r / cp;
    const int ch = static_cast<int>(r - tap * cp);
    fb[i] = __float2bfloat16_rn(c < co && ch < ci ? to_f32(f[(tap * ci + ch) * co + c]) : 0.f);
  }
}

// x (pixels, ci) as (pixels, cp) bf16, zeros in channels ci..cp: the
// gather's 8- or 16-byte pieces then hold channels of one tap, at aligned
// addresses, whatever ci and x's base.
__global__ void pad_channels_kernel(const unsigned short* __restrict__ x, unsigned short* __restrict__ xp,
                                    long long pixels, int ci, int cp) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < pixels * cp;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long px = i / cp;
    const int c = static_cast<int>(i - px * cp);
    xp[i] = c < ci ? x[px * ci + c] : 0;
  }
}

__device__ __forceinline__ void consumer_sync() {   // the two consumer warpgroups' 256 threads
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_tile(float (&d)[N / 2], unsigned long long a, unsigned long long b) {
  if constexpr (N == 128)
    wgmma_m64n128k16(d, a, b);
  else
    wgmma_m64n64k16(d, a, b);
}

// grid: one CTA per (pixel tile, channel tile), pixel tiles fastest, as the
// FMA loop's.  fmap: the rounded filter, (K, co8) bf16, boxes of 64 x 64.
// a.x holds a.ci channels a pixel (padded where the launch padded them);
// the producer gathers V-byte pieces, V / 2 channels of one tap: V = 16
// where ci % 8 == 0, V = 8 where ci == 4.
template <int MB, int V>
__global__ void __launch_bounds__(TC_THREADS, 1)
sa_conv_wgmma_kernel(const __grid_constant__ CUtensorMap fmap, const ConvArgs a) {
  using T = TcTile<MB>;
  constexpr int BN = T::BN, BM = T::BM, STAGES = T::STAGES;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* ring = tc_smem + ((TC_ALIGN - (smem_addr(tc_smem) & (TC_ALIGN - 1))) & (TC_ALIGN - 1));
  long long* pix = reinterpret_cast<long long*>(ring + T::RING);
  int (*seg)[SG_FIELDS] = reinterpret_cast<int (*)[SG_FIELDS]>(pix + BM);
  int* count = reinterpret_cast<int*>(seg + MAX_SEGMENTS);
  const unsigned full0 = smem_addr(count + 4);           // full[s] = full0 + 8 s
  const unsigned empty0 = full0 + 8 * STAGES;
  auto a_tile = [&](int slot) { return ring + slot * T::STAGE_BYTES; };
  auto b_tile = [&](int slot) { return ring + slot * T::STAGE_BYTES + T::A_BYTES; };

  const int t = threadIdx.x;
  const int co0 = blockIdx.y * BN;
  const long long p0 = static_cast<long long>(blockIdx.x) * a.per_cta;
  const int nst = (a.kdim + TC_BK - 1) / TC_BK;

  if (t == 0) {
    if (a.bands) {
      build_segments(a, seg, count, a.stride, a.p);
    } else {
      count[0] = 0;
      count[1] = static_cast<int>(min(static_cast<long long>(a.per_cta),
                                      static_cast<long long>(a.n) * a.oh * a.ow - p0));
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 129);                     // 128 gathers + the filter's expect_tx
      mbar_init(empty0 + 8 * s, TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nseg = count[0], npix = count[1];
  // each slot's first input element: pixel (img, oy, ox) reads from row oy
  // stride, column ox stride
  for (int i = t; i < npix; i += TC_THREADS) {
    long long img;
    int oy, ox;
    if (a.bands == 0) {
      const long long P = p0 + i, ohw = static_cast<long long>(a.oh) * a.ow;
      img = P / ohw;
      const int rem = static_cast<int>(P - img * ohw);
      oy = rem / a.ow;
      ox = rem - oy * a.ow;
    } else {
      int s = 0;
      while (s + 1 < nseg && seg[s + 1][SG_PX0] <= i) ++s;
      const int l = i - seg[s][SG_PX0], oyl = l / a.ow;
      img = seg[s][SG_IMG];
      oy = seg[s][SG_R0] + oyl;
      ox = l - oyl * a.ow;
    }
    pix[i] = ((img * a.h + static_cast<long long>(oy) * a.stride) * a.w +
              static_cast<long long>(ox) * a.stride) * a.ci;
  }
  __syncthreads();

  if (t >= TC_CONSUMERS) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TC_PRODUCER_REGS));
    const int pt = t - TC_CONSUMERS;
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
    // the input offset of k within a pixel's receptive field: (dp w + dq)
    // ci + c for k = (dp q + dq) ci + c
    auto k_off = [&](int k) {
      const int tap = k / a.ci, c = k - tap * a.ci;
      const int dp = tap / a.q, dq = tap - dp * a.q;
      return (static_cast<long long>(dp) * a.w + dq) * a.ci + c;
    };
    // A stage's gathers are issued while stages s - LAG .. s - 1 land; the
    // consumers free a slot once they have issued the stage after it, so
    // LAG <= STAGES - 1.
    constexpr int LAG = STAGES - 1;
    constexpr int PPR = 128 / V;                         // pieces of a pixel's 128-byte row
    constexpr int RSTEP = 128 / PPR;                     // rows between a thread's pieces
    constexpr int NR = BM / RSTEP;                       // rows a thread copies a stage
    // up to TC_ROW_REGS rows a thread keep their first input element in
    // registers (-1: no pixel), so a copy costs no shared-memory load;
    // more (the 512-pixel tile's 8-byte pieces) read the pixel table
    constexpr bool REG_ROWS = NR <= TC_ROW_REGS;
    int roff[REG_ROWS ? NR : 1];
    if constexpr (REG_ROWS) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = pt / PPR + RSTEP * i;
        roff[i] = r < npix ? static_cast<int>(pix[r]) : -1;
      }
    }
    for (int s = 0; s < nst + LAG; ++s) {
      if (s >= LAG) {
        cp_async_wait<LAG - 1>();                       // this thread's copies of stage s - LAG
        fence_proxy_async();
        mbar_arrive(full0 + 8 * ((s - LAG) % STAGES));
      }
      if (s < nst) {
        const int slot = s % STAGES;
        if (s >= STAGES) mbar_wait(empty0 + 8 * slot, ((s / STAGES) - 1) & 1);
        const unsigned bar = full0 + 8 * slot;
        if (pt == 0) {
          mbar_expect_tx(bar, T::B_BYTES);
#pragma unroll
          for (int bx = 0; bx < BN / 64; ++bx)
            tma_load(smem_addr(b_tile(slot)) + bx * TC_BOX, &fmap, bar, co0 + 64 * bx, s * TC_BK);
        }
        // thread pt: piece c (V / 2 channels of one tap) of rows pt / PPR +
        // RSTEP i; pieces past K and rows past the CTA's pixels are zeros
        const int c = pt % PPR, r0 = pt / PPR;
        const int k0 = s * TC_BK + (V / 2) * c;
        const bool kok = k0 < a.kdim;
        const long long off = kok ? k_off(k0) : 0;
        unsigned char* d = a_tile(slot) + r0 * 128 + ((((V * c) >> 4) ^ (r0 & 7)) << 4) + (V * c & 15);
        if constexpr (REG_ROWS) {
          const __nv_bfloat16* xk = x + off;
#pragma unroll
          for (int i = 0; i < NR; ++i) {
            const bool ok = kok && roff[i] >= 0;
            cp_async<V>(d + i * RSTEP * 128, ok ? xk + roff[i] : x, ok ? V : 0);
          }
        } else {
#pragma unroll 4
          for (int i = 0; i < NR; ++i) {
            const int r = r0 + RSTEP * i;
            const bool ok = kok && r < npix;
            cp_async<V>(d + i * RSTEP * 128, ok ? x + pix[r] + off : x, ok ? V : 0);
          }
        }
      }
      cp_async_commit();
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TC_CONSUMER_REGS));
    const int wg = t / 128;
    float acc[MB][BN / 2];
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[b][i] = 0.f;
    for (int s = 0; s < nst; ++s) {
      const int slot = s % STAGES;
      mbar_wait(full0 + 8 * slot, (s / STAGES) & 1);
      const unsigned ab = smem_addr(a_tile(slot)) + wg * MB * 64 * 128;
      const unsigned bb = smem_addr(b_tile(slot));
#pragma unroll
      for (int b = 0; b < MB; ++b) fence_operands(acc[b]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk)             // 16 k: 32 bytes along A's rows,
#pragma unroll                                            // 16 rows of B's boxes
        for (int b = 0; b < MB; ++b)
          wgmma_tile<BN>(acc[b], wgmma_desc(ab + b * 64 * 128 + 32 * kk, 16, 1024),
                         wgmma_desc(bb + 2048 * kk, TC_BOX, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int b = 0; b < MB; ++b) fence_operands(acc[b]);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int b = 0; b < MB; ++b) fence_operands(acc[b]);
      if (s > 0) mbar_arrive(empty0 + 8 * ((s - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int b = 0; b < MB; ++b) fence_operands(acc[b]);

    // park scale(acc) + bias: warp v of a warpgroup holds rows 16 v + lane
    // / 4 and that + 8 of each m64 block, columns 8 j + 2 (lane % 4) and
    // that + 1; every stage has been read once both warpgroups get here
    consumer_sync();
    float* tile = reinterpret_cast<float*>(ring);
    const int v = (t % 128) / 32, lane = t % 32;
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (wg * MB + b) * 64 + 16 * v + lane / 4 + 8 * h;
        if (row >= npix) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * (lane % 4) + e;
            const int cog = co0 + col;
            tile[row * T::PITCH + col] =
                cog < a.co ? scale_bias(acc[b][4 * j + 2 * h + e], a.scale, a.bias, cog) : 0.f;
          }
      }
    consumer_sync();
    emit_tile<BN, T::PITCH, TC_CONSUMERS>(a, seg, nseg, npix, tile, co0, p0, t);
  }
}

template <int MB, int V>
cudaError_t launch_tc(const ConvArgs& a, const CUtensorMap& fmap, cudaStream_t stream) {
  using T = TcTile<MB>;
  auto kern = sa_conv_wgmma_kernel<MB, V>;
  static std::atomic<unsigned long long> opted{0};
  cudaError_t err = opt_in(kern, T::SMEM, opted);
  if (err != cudaSuccess) return err;
  // setmaxnreg moves registers within the CTA's allocation: launched with
  // fewer than TC_REGS a thread, the consumers' increase would wait forever
  static const int regs = [&] {
    cudaFuncAttributes fa{};
    return cudaFuncGetAttributes(&fa, kern) == cudaSuccess ? fa.numRegs : -1;
  }();
  if (regs != TC_REGS) return cudaErrorInvalidConfiguration;
  const long long units = static_cast<long long>(a.n) * (a.bands ? a.bands : a.oh * a.ow);
  const long long tiles = (units + a.per_cta - 1) / a.per_cta;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), (a.co + T::BN - 1) / T::BN);
  kern<<<grid, TC_THREADS, T::SMEM, stream>>>(fmap, a);
  return cudaGetLastError();
}

// The channels a pixel of bf16 x is gathered with: ci where ci % 8 == 0
// or ci == 4 (pieces of 16 or 8 bytes), else ci padded to 4 (ci < 4) or to
// a multiple of 8; kernels/sa_conv_implicit.py::tc_channels holds the same.
int tc_channels(int ci) { return ci % 8 == 0 || ci == 4 ? ci : ci < 4 ? 4 : (ci + 7) / 8 * 8; }

// bf16 x: round the filter into fb; where xp is given (the channels padded
// to tc_channels(ci), or x not aligned to its pieces) copy x into it; then
// the tensor-core kernel of tile (0: 256 x 128, 1: 512 x 64).
cudaError_t launch_bf16(ConvArgs a, void* fb, void* xp, int tile, int smem_bytes, cudaStream_t st) {
  const int cp = tc_channels(a.ci), vb = cp % 8 == 0 ? 16 : 8;
  const bool aligned = reinterpret_cast<uintptr_t>(a.x) % vb == 0;
  if (fb == nullptr || tile < 0 || tile > 1 || a.kdim < 1 ||
      (xp == nullptr && (cp != a.ci || !aligned)) ||
      static_cast<long long>(a.n) * a.h * a.w * cp > 0x7fffffffLL ||   // 32-bit pixel offsets
      smem_bytes != (tile == 0 ? TcTile<2>::SMEM : TcTile<4>::SMEM) ||
      (a.bands == 0 && a.per_cta != (tile == 0 ? TcTile<2>::BM : TcTile<4>::BM)) ||
      (a.bands != 0 && (a.per_cta < 1 || a.per_cta > MAX_SEGMENTS)))
    return cudaErrorInvalidValue;
  const int taps = a.p * a.q;
  const int co8 = (a.co + 7) / 8 * 8;
  auto grid_of = [](long long n) { return static_cast<int>((n + 255) / 256 < 1056 ? (n + 255) / 256 : 1056); };
  const long long frows = static_cast<long long>(taps) * cp;
  auto* fbh = static_cast<__nv_bfloat16*>(fb);
  if (a.f_int8)
    round_filter_kernel<int8_t><<<grid_of(frows * co8), 256, 0, st>>>(
        static_cast<const int8_t*>(a.f), fbh, taps, a.ci, cp, a.co, co8);
  else
    round_filter_kernel<float><<<grid_of(frows * co8), 256, 0, st>>>(
        static_cast<const float*>(a.f), fbh, taps, a.ci, cp, a.co, co8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (xp != nullptr) {
    const long long pixels = static_cast<long long>(a.n) * a.h * a.w;
    pad_channels_kernel<<<grid_of(pixels * cp), 256, 0, st>>>(
        static_cast<const unsigned short*>(a.x), static_cast<unsigned short*>(xp), pixels, a.ci, cp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a.x = xp;
    a.ci = cp;
  }
  a.kdim = taps * cp;
  if (reinterpret_cast<uintptr_t>(a.x) % vb != 0) return cudaErrorInvalidValue;
  CUtensorMap fmap{};
  if (!encode_bf16(&fmap, fb, a.kdim, co8, TC_BK)) return cudaErrorInvalidValue;
  if (tile == 0)
    return vb == 16 ? launch_tc<2, 16>(a, fmap, st) : launch_tc<2, 8>(a, fmap, st);
  return vb == 16 ? launch_tc<4, 16>(a, fmap, st) : launch_tc<4, 8>(a, fmap, st);
}

}  // namespace

// x_kind and out_kind: 0 fp32, 2 bf16 (fp32 x writes fp32).  f_kind: 0
// fp32, 1 int8.  pw = ps = 1 for no pool.  bands 0: flat pixel tiles of
// per_cta pixels; else bands per image, emitted rows per band (rows) and
// bands per CTA (per_cta).  fp32 x: tile 0 (8 pixels x 8 channels per
// thread, 512 x 32 per CTA), 1 (8 x 16, 512 x 64) or 2 (6 x 16, 768 x 32);
// rin: staged input rows of a stage; ng: groups of 4 channels per staged
// chunk; fb unused.  bf16 x: tile 0 (256 pixels x 128 channels) or 1 (512
// x 64) on the tensor cores; rin and ng unused; fb a (p q cp, co rounded up
// to 8) bf16 scratch the filter is rounded into, cp = tc_channels(ci); xp
// null, or an (n, h, w, cp) bf16 scratch x is copied into first (needed
// where cp != ci or x is not aligned to the gather's pieces).  The geometry comes from
// repro_torch/kernels/sa_conv_implicit.py::conv_geometry; smem_bytes must
// equal what it implies.  Returns the first CUDA error of the launches.
extern "C" int sa_conv_implicit_launch(const void* x, int x_kind, int out_kind, const void* f,
                                       int f_kind, const void* scale, const void* bias, void* out, int n,
                                       int h, int w, int ci, int p, int q, int co, int stride,
                                       int pw, int ps, int tile, int bands, int rows, int per_cta,
                                       int rin, int ng, int act, int smem_bytes, void* fb,
                                       void* xp, void* stream) {
  ConvArgs a;
  if (!(x_kind == KIND_F32 && out_kind == KIND_F32) &&
      !(x_kind == KIND_BF16 && (out_kind == KIND_F32 || out_kind == KIND_BF16)))
    return cudaErrorInvalidValue;
  if (f_kind != 0 && f_kind != 1) return cudaErrorInvalidValue;
  a.x = x;
  a.f = f;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.out_bf16 = out_kind == KIND_BF16;
  a.n = n; a.h = h; a.w = w; a.ci = ci; a.p = p; a.q = q; a.co = co; a.stride = stride;
  a.oh = (h - p) / stride + 1;
  a.ow = (w - q) / stride + 1;
  a.pw = pw; a.ps = ps;
  a.poh = (a.oh - pw) / ps + 1;
  a.pow_ = (a.ow - pw) / ps + 1;
  a.bands = bands; a.rows = rows; a.per_cta = per_cta; a.rin = rin; a.act = act;
  a.f_int8 = f_kind == 1;
  a.kdim = p * q * ci;
  auto st = static_cast<cudaStream_t>(stream);
  if (x_kind == KIND_BF16) return launch_bf16(a, fb, xp, tile, smem_bytes, st);
  const bool split = p == 11 && q == 11 && stride == 4;   // the specialised strided shape
  a.wst = split ? stride * ((w + stride - 1) / stride) : w;
  const bool cpg3 = split && ci == 3;
  a.ng = ng;
  a.chunks = (ci + GROUP * ng - 1) / (GROUP * ng);
  if (ng < 1 || cpg3 && ng != 1) return cudaErrorInvalidValue;
  const auto addr = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr); };
  a.xvec = ci % 4 == 0 && addr(x) % 16 == 0 ? 16 : 4;
  if (a.f_int8)
    a.fvec = co % 4 == 0 && addr(f) % 4 == 0 ? 4 : 0;
  else
    a.fvec = co % 4 == 0 && addr(f) % 16 == 0 ? 16 : 4;
  return by_tile(a, tile, smem_bytes, st);
}

// The dynamic shared memory sa_conv_implicit_launch passes for these
// arguments (tile, x_kind, ci, p, q, stride, rin and ng as it takes them; w
// the launch's padded input width), or -1 where it has no instantiation:
// what repro_torch/analysis/launch.py derives, asked of the built kernel.
extern "C" int sa_conv_implicit_smem(int tile, int x_kind, int w, int ci, int p, int q,
                                     int stride, int rin, int ng) {
  if (x_kind == KIND_BF16) return tile == 0 ? TcTile<2>::SMEM : tile == 1 ? TcTile<4>::SMEM : -1;
  static const int kTile[3][3] = {{8, 8, 4}, {8, 16, 4}, {6, 16, 2}};   // TPX, TCO, G
  if (tile < 0 || tile > 2 || x_kind != KIND_F32 || ng < 1 || stride < 1) return -1;
  const int tpx = kTile[tile][0], tco = kTile[tile][1], g = kTile[tile][2];
  const bool split = p == 11 && q == 11 && stride == 4;
  if (split && tpx * tco > 64) return -1;
  const int wst = split ? stride * ((w + stride - 1) / stride) : w;
  const int cpg = split && ci == 3 ? 3 : GROUP;
  return dynamic_smem(rin, wst, p * q, cpg, tco * g, THREADS / g * tpx,
                      (ci + GROUP * ng - 1) / (GROUP * ng), ng);
}
