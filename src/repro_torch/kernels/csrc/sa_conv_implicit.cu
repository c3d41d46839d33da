// SA-CONV on Hopper: a direct NHWC x HWIO VALID convolution with stride on
// a pre-padded input, out = act(conv(x, f) * scale + bias), and with a fused
// pool out = act(maxpool(conv(x, f) * scale + bias)).  x fp32 or bf16, f
// fp32 or int8 (per-output-channel scale), fp32 accumulation, no TF32; the
// output fp32, or bf16 for bf16 x.
//
// Replaces: src/repro/kernels/sa_conv_implicit.py::sa_conv_implicit
// (Pallas body _implicit_conv_kernel), with its fused pool epilogue.
//
// What bounds it on this card: fp32 FMAs.  AlexNet's convs do 60-500
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
//  * bf16 x (a template parameter beside the tile; the fp32 instantiations
//    keep their code): a staged pixel's 4 channels lie as they came, in the
//    first 8 bytes of its 16-byte slot, so the geometry, the addresses and
//    the tap offsets are fp32's; one 8-byte shared load per pixel and tap,
//    widened to fp32 by shifts.  An fp32 filter is first rounded to bf16, as
//    the reference rounds w_tile.astype(patch.dtype): each thread rounds the
//    pieces it copied once they land (int8 is exact in bf16).  The sums,
//    scale, bias, pool and act run in fp32 and the output is rounded once,
//    so a bf16 launch equals the fp32 launch on the widened operands,
//    rounded once, bitwise.  Pixels of ci % 4 != 0 (or an unaligned base)
//    take 2-byte loads, which cp.async has not: plain loads and stores into
//    the stage that no thread reads until the next barrier.  bf16 x runs
//    the 8 x 8 and 6 x 16 tiles only: in the 8 x 16 tile the widened
//    pixels spilled the unrolled 3x3 and 5x5 bodies (24-180 bytes).
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
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 4;             // input channels per staged group (16 bytes a pixel)
// kernels/sa_conv_implicit.py holds the same table limits
constexpr int MAX_SEGMENTS = 32;
constexpr int MAX_ROWS = 256;
enum { SG_IMG, SG_R0, SG_PX0, SG_SLOT0, SG_PR0, SG_NPR, SG_C0, SG_FIELDS };

struct ConvArgs {
  const void* x;                     // fp32 or bf16 (the kernel's XT)
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
  int xvec;                          // bytes per input copy: 16 or 4 (fp32), 8 or 2 (bf16)
  int fvec;                          // bytes per filter copy: 16 or 4, 0: element loads
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

// An 8-byte shared-memory load at a 32-bit shared address.
__device__ __forceinline__ uint2 lds64(unsigned addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// A staged pixel's 4 channels as fp32: 16 bytes of fp32, or the first 8
// bytes of its slot as bf16, widened exactly (a bf16 is the high half of
// its fp32).
template <typename XT>
__device__ __forceinline__ float4 load_px(unsigned addr) {
  if constexpr (sizeof(XT) == 4) {
    return lds128(addr);
  } else {
    const uint2 u = lds64(addr);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
}

// One tap of one staged channel group.  base[]: shared byte addresses of
// the thread's pixels in the stage; xoff: the tap's byte offset (a
// constant in the specialised instantiations); fr: shared byte address of
// the group's filter rows for this thread's TCO output channels.
template <typename XT, int TPX, int TCO, int BCO, int CPG>
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
    const float4 xv = load_px<XT>(base[j] + xoff);
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
template <typename XT, int P_, int Q_, int S_, int TPX, int TCO, int BCO, int CPG>
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
          conv_tap<XT, TPX, TCO, BCO, CPG>(acc, base, (qq / S_) * 16, frow + qq * FTAP);
        shift(base, phb);
      }
      shift(base, rowb - S_ * phb);
    } else if constexpr (Q_ > 0) {
#pragma unroll
      for (int qq = 0; qq < Q_; ++qq) conv_tap<XT, TPX, TCO, BCO, CPG>(acc, base, qq * 16, frow + qq * FTAP);
      shift(base, rowb);
    } else {
      for (int qq = 0; qq < Q; ++qq) conv_tap<XT, TPX, TCO, BCO, CPG>(acc, base, qq * 16, frow + qq * FTAP);
      shift(base, rowb);
    }
  }
  shift(base, -P * rowb);
}

// One output in the launch's output type: fp32 for fp32 x; for bf16 x,
// bf16 (rounded once) or fp32 as a.out_bf16 says.
template <typename XT>
__device__ __forceinline__ void put(const ConvArgs& a, size_t i, float v) {
  if constexpr (sizeof(XT) == 2) {
    if (a.out_bf16) {
      store_out(static_cast<__nv_bfloat16*>(a.out) + i, v);
      return;
    }
  }
  static_cast<float*>(a.out)[i] = v;
}

// XT: the activation type, float or __nv_bfloat16.  P_, Q_, S_: the filter
// and stride, or 0 for runtime values (the generic instantiation).  TPX
// pixels x TCO channels per thread, G channel groups of TCO per CTA, CPG
// channels per staged group (4, or 3 when ci == 3).
template <typename XT, int P_, int Q_, int S_, int TPX, int TCO, int G, int CPG>
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
  const XT* const xg = static_cast<const XT*>(a.x);

  // stage channel chunk g (NG groups of 4 channels) into stage buffer st
  auto load_chunk = [&](int g, int st) {
    float* sx = smem + st * stage;
    float* sf = sx + xw;
    unsigned char* sraw = reinterpret_cast<unsigned char*>(sf + NG * fwg);
    const int c0 = g * GROUP * NG;
    for (int sl = warp; sl < nslots; sl += THREADS / 32) {
      const XT* src = xg + static_cast<size_t>(s_row[sl]) * a.w * a.ci + c0;
      float* dst = sx + sl * rowp;
      for (int c = lane; c < a.w; c += 32) {
        const int dc = SPLIT ? (c % S_) * ws + c / S_ : c;
        const XT* sp = src + static_cast<size_t>(c) * a.ci;
        for (int gi = 0; gi < NG; ++gi) {
          const int nci = min(CPG, a.ci - c0 - GROUP * gi);
          float* dp = dst + gi * planew + dc * 4;
          if constexpr (sizeof(XT) == 4) {
            if (a.xvec == 16) {
              cp_async<16>(dp, nci > 0 ? sp + GROUP * gi : xg, nci > 0 ? 16 : 0);
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                cp_async<4>(dp + k, k < nci ? sp + GROUP * gi + k : xg, k < nci ? 4 : 0);
            }
          } else if (a.xvec == 8) {          // the slot's first 8 bytes
            cp_async<8>(dp, nci > 0 ? sp + GROUP * gi : xg, nci > 0 ? 8 : 0);
          } else {                           // element loads, zeros past ci
            unsigned short* dh = reinterpret_cast<unsigned short*>(dp);
            const unsigned short* sh = reinterpret_cast<const unsigned short*>(sp + GROUP * gi);
#pragma unroll
            for (int k = 0; k < 4; ++k) dh[k] = k < nci ? sh[k] : 0;
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
    if constexpr (sizeof(XT) == 2) {
      if (!a.f_int8) {                                 // round the fp32 pieces this thread copied
        float* fw = const_cast<float*>(sf);
        const int step = a.fvec == 16 ? 4 : 1;         // floats per copy
        for (int gi = 0; gi < NG; ++gi)
          for (int e = t; e < fwg / step; e += THREADS)
            for (int k = 0; k < step; ++k) {
              float* v = fw + gi * fwg + e * step + k;
              *v = round_bf16(*v);
            }
      }
    }
    __syncthreads();
    const int ngr = min(NG, (a.ci - g * GROUP * NG + GROUP - 1) / GROUP);   // groups holding channels
#pragma unroll 1
    for (int gi = 0; gi < ngr; ++gi) {
      const int off = st * stage + gi * planew;        // this stage's group plane
      shift(base, 4 * off);
      conv_chunk<XT, P_, Q_, S_, TPX, TCO, BCO, CPG>(acc, base,
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
        put<XT>(a, static_cast<size_t>(p0 + i) * a.co + cog, apply_act(tile[i * BCOP + col], a.act));
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
    put<XT>(a, (orow * a.pow_ + ex) * a.co + cog, apply_act(m, a.act));
  }
}

template <typename XT, int P, int Q, int S, int TPX, int TCO, int G, int CPG>
cudaError_t launch(const ConvArgs& a, int smem_bytes, cudaStream_t stream) {
  constexpr int BCO = TCO * G;
  constexpr int CAP = THREADS / G * TPX;
  const int need = dynamic_smem(a.rin, a.wst, a.p * a.q, CPG, BCO, CAP, a.chunks, a.ng);
  if (need != smem_bytes) return cudaErrorInvalidValue;   // the host's geometry disagrees
  auto* kern = sa_conv_kernel<XT, P, Q, S, TPX, TCO, G, CPG>;
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
template <typename XT, int TPX, int TCO, int G>
cudaError_t dispatch(const ConvArgs& a, int smem_bytes, cudaStream_t st) {
  if (a.p == 11 && a.q == 11 && a.stride == 4) {
    if constexpr (TPX * TCO > 64) {
      return cudaErrorInvalidValue;
    } else {
      return a.ci == 3 ? launch<XT, 11, 11, 4, TPX, TCO, G, 3>(a, smem_bytes, st)
                       : launch<XT, 11, 11, 4, TPX, TCO, G, 4>(a, smem_bytes, st);
    }
  }
  if (a.p == 5 && a.q == 5 && a.stride == 1)
    return launch<XT, 5, 5, 1, TPX, TCO, G, 4>(a, smem_bytes, st);
  if (a.p == 3 && a.q == 3 && a.stride == 1)
    return launch<XT, 3, 3, 1, TPX, TCO, G, 4>(a, smem_bytes, st);
  return launch<XT, 0, 0, 0, TPX, TCO, G, 4>(a, smem_bytes, st);
}

// bf16 x has no 8 x 16 tile (kernels/sa_conv_implicit.py::BF16_TILES): its
// widened pixels push the unrolled 3x3 and 5x5 bodies past 255 registers.
template <typename XT>
cudaError_t by_tile(const ConvArgs& a, int tile, int smem_bytes, cudaStream_t st) {
  if (tile == 0) return dispatch<XT, 8, 8, 4>(a, smem_bytes, st);
  if constexpr (sizeof(XT) == 4)
    if (tile == 1) return dispatch<XT, 8, 16, 4>(a, smem_bytes, st);
  if (tile == 2) return dispatch<XT, 6, 16, 2>(a, smem_bytes, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x_kind and out_kind: 0 fp32, 2 bf16 (fp32 x writes fp32).  f_kind: 0
// fp32, 1 int8.  tile: 0 (8 pixels x 8 channels per thread, 512
// x 32 per CTA), 1 (8 x 16, 512 x 64) or 2 (6 x 16, 768 x 32).  pw = ps = 1 for no pool.  bands 0:
// flat pixel tiles of per_cta pixels; else bands per image, emitted rows
// per band (rows) and bands per CTA (per_cta).  rin: staged input rows of a
// stage; ng: groups of 4 channels per staged chunk.  The
// geometry comes from repro_torch/kernels/sa_conv_implicit.py::
// conv_geometry; smem_bytes must equal what it implies.  Returns the first
// CUDA error of the attribute call or the launch.
extern "C" int sa_conv_implicit_launch(const void* x, int x_kind, int out_kind, const void* f,
                                       int f_kind, const void* scale, const void* bias, void* out, int n,
                                       int h, int w, int ci, int p, int q, int co, int stride,
                                       int pw, int ps, int tile, int bands, int rows, int per_cta,
                                       int rin, int ng, int act, int smem_bytes, void* stream) {
  ConvArgs a;
  if (!(x_kind == KIND_F32 && out_kind == KIND_F32) &&
      !(x_kind == KIND_BF16 && (out_kind == KIND_F32 || out_kind == KIND_BF16)))
    return cudaErrorInvalidValue;
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
  const bool split = p == 11 && q == 11 && stride == 4;   // the specialised strided shape
  a.wst = split ? stride * ((w + stride - 1) / stride) : w;
  const bool cpg3 = split && ci == 3;
  a.ng = ng;
  a.chunks = (ci + GROUP * ng - 1) / (GROUP * ng);
  if (ng < 1 || cpg3 && ng != 1) return cudaErrorInvalidValue;
  a.f_int8 = f_kind == 1;
  const auto addr = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr); };
  if (x_kind == KIND_F32)
    a.xvec = ci % 4 == 0 && addr(x) % 16 == 0 ? 16 : 4;
  else
    a.xvec = ci % 4 == 0 && addr(x) % 8 == 0 ? 8 : 2;
  if (a.f_int8)
    a.fvec = co % 4 == 0 && addr(f) % 4 == 0 ? 4 : 0;
  else
    a.fvec = co % 4 == 0 && addr(f) % 16 == 0 ? 16 : 4;
  if (f_kind != 0 && f_kind != 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return x_kind == KIND_BF16 ? by_tile<__nv_bfloat16>(a, tile, smem_bytes, st)
                             : by_tile<float>(a, tile, smem_bytes, st);
}

// The dynamic shared memory sa_conv_implicit_launch passes for these
// arguments (tile, x_kind, ci, p, q, stride, rin and ng as it takes them; w
// the launch's padded input width), or -1 where it has no instantiation:
// what repro_torch/analysis/launch.py derives, asked of the built kernel.
extern "C" int sa_conv_implicit_smem(int tile, int x_kind, int w, int ci, int p, int q,
                                     int stride, int rin, int ng) {
  static const int kTile[3][3] = {{8, 8, 4}, {8, 16, 4}, {6, 16, 2}};   // TPX, TCO, G
  if (tile < 0 || tile > 2 || (x_kind != KIND_F32 && x_kind != KIND_BF16) || ng < 1 ||
      stride < 1 || (tile == 1 && x_kind == KIND_BF16))
    return -1;
  const int tpx = kTile[tile][0], tco = kTile[tile][1], g = kTile[tile][2];
  const bool split = p == 11 && q == 11 && stride == 4;
  if (split && tpx * tco > 64) return -1;
  const int wst = split ? stride * ((w + stride - 1) / stride) : w;
  const int cpg = split && ci == 3 ? 3 : GROUP;
  return dynamic_smem(rin, wst, p * q, cpg, tco * g, THREADS / g * tpx,
                      (ci + GROUP * ng - 1) / (GROUP * ng), ng);
}
