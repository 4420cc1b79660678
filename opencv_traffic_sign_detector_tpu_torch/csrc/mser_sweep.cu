// K3 and K7: the fused MSER level sweep in shared-memory tiles, one kernel
// with two outputs.
//
// Replaces opencv_traffic_sign_detector_tpu/ops/mser_pallas.py:
// fused_level_sweep (K3, _collapsed_kernel) and fused_level_sweep_full (K7,
// _full_kernel), both over _sweep_body: the bbox-area stability sweep over
// every level of a stack of windows.  They differ only in what the emit
// writes, so sweep_tile_kernel<kFull> runs both:
// * K3 (tsd_level_sweep, kFull = false): row-strip windows; per core pixel
//   the max over levels of (qv << lbits) | t, int32 [n, core, w];
// * K7 (tsd_level_sweep_full, kFull = true): each whole plane as one strip
//   (no halo, the plane's own width); every level's byte qv, cast through
//   int32 to u8 and 0 where there is no candidate, for every pixel into
//   [n, levels, r, w].  It is the reference's oracle between K3 and the XLA
//   sweep, so "K7 folded == K3" compares the two outputs of one kernel.
//
// _sweep_body has three forms, chosen by the config, and each has both
// outputs here: the default (below: Jacobi passes in tiles); extent-only
// (cfg.sweep_extent_only: the area is the squared height; a flag of the
// emit, Thresholds::extent_only); and scan-pass (cfg.scan_passes > 0: whole-
// run resolves along rows and columns; a second design, further below, that
// keeps a band of rows on chip for all levels).
//
// On the TPU the whole sweep state of one strip window stays in VMEM across
// all levels.  Here one window is ~0.28 M pixels with ~30 bytes of state per
// pixel (8 MB), far beyond one SM's 227 KB of shared memory, so the tiled
// design's state lives in device memory between launches.
//
// What bounds it: the sweep's real work is 181 operations a mask pixel a
// level (17 for the warm start, 27 a pass, 56 for the emit), 161 of them
// compares, min/max, selects and logic on the integer pipe, which runs at
// half the f32 rate (chip_smoke.py: SWEEP_OPS, _bound); pixels outside a
// level's mask need none.  Its compulsory traffic is the windows in and the
// output: one int32 a core pixel (K3), or a byte a pixel a level (K7: 544 MB
// at [64, 402, 682] x 31 levels, 0.16 ms at 3.35 TB/s).  A first form
// launched an init, 2*ccl_iters Jacobi passes and an emit per level, each a
// full read and write of five int32 planes, about 250 bytes a pixel a level:
// it ran at the memory's rate on its own state (PERF.md).
//
// This design moves far fewer state bytes and keeps the passes on chip:
// * One launch runs a span of `span` Jacobi passes (the wrapper's 6, 1.5
//   levels of the tuned config) with the warm starts and emits inside it.
//   Each block holds a region of at most 64 x 64 pixels: a tile plus a
//   halo of `span` pixels on every side.  After pass k only pixels at
//   least k from the region's edge are exact, so the core is exact at the
//   end of the span, and it is all the block writes back.
// * Thread (c, g) of the 1024 owns column c, rows [4g, 4g + 4) of the
//   region, in registers for the whole span.  Each pass publishes every
//   pixel to one of two shared-memory exchange buffers (used in turn: one
//   barrier a pass) and reads its left and right neighbours there; its
//   vertical neighbours come from its own registers but at the ends of its
//   run.  The block fills an SM with 32 warps at 64 registers a thread,
//   which hide more latency than 16 warps with runs of 8 rows (PERF.md).
// * The bbox planes are int16 pairs, (ymin, xmin) and (ymax, xmax), one
//   int32 each, merged with the packed min/max instructions (__vmins2,
//   __vmaxs2); the sentinels 1<<28 and -1 become INT16_MAX and -1, which
//   order the same against real rows and columns (< 32767).  An anchor's
//   bbox is always real, so the f32 area never sees a sentinel.  State is
//   12 bytes a pixel, double-buffered in device memory between launches.
// * The rings live in scratch laid out by the tile plan: per block, slot
//   and thread one 8-byte record of its 4 pixels.  The emit reads a
//   thread's five slots as five vector loads in flight together (the
//   first form waited on a round trip per pixel) and writes a record back
//   only where a value changed.
// * K3 reads and writes its output max only on a candidate and at the last
//   level.  K7 writes every emit's byte: the lanes of a warp hold
//   consecutive columns of one region row, so a store covers consecutive
//   bytes of one output row.
// It still runs at several times its operations bound (PERF.md): with one
// block an SM, nothing overlaps a block's barriers in the passes or its
// round trips to device memory at load, emit and write-back.
//
// Semantics carried over exactly from the reference:
// * Jacobi passes: every pass reads the previous pass's planes.  An
//   in-place update would propagate further and change the candidates; the
//   truncation at 2*ccl_iters passes is load-bearing.
// * The reference exits the pass loop early when a full pass changes
//   nothing.  That only fires at a fixed point, where further passes change
//   nothing either, so running all passes gives the identical state.
// * Within a pass, a pixel's bbox channels use live = mask & (new key >= 0).
// * Neighbour reads wrap modulo the window, as pltpu.roll does; the
//   window's first and last rows are masked off.  A tile loads its halo
//   through the same wraparound (a tile on the left edge loads columns from
//   the right edge; a window narrower than a tile appears in it more than
//   once), so the loaded region is an unrolled cover of the torus.
// * K3's windows are padded with 255 and the levels reach 270: padding
//   joins the mask at the top levels, like any pixel.
// * The emit's dead mark (keys = -1 on an anchor whose bbox area exceeds
//   max_area) is carried across levels in the state.
// * Rings are bf16, stored with round-to-nearest-even; the variation's
//   division is IEEE f32 (never build with --use_fast_math; -fmad=false).
// * K3's output comes only from the strip's core rows: max over levels of
//   (qv << lbits) | t.  K7's strip is the whole plane: every row emits,
//   rows 0 and r - 1 (off the mask) as 0.
#include <cuda_bf16.h>

#include <type_traits>

#include "tsd_common.cuh"

namespace {

constexpr int kRegion = 64;                              // region rows and columns
constexpr int kRows = 4;                                 // rows a thread owns
constexpr int kTileThreads = kRegion * kRegion / kRows;  // one column of kRows each
constexpr int kRegionPx = kRegion * kRegion;
constexpr int kTileSmem = 2 * 3 * kRegionPx * 4;         // two exchange buffers
constexpr int kLoInit = 0x7FFF7FFF;                      // (ymin, xmin) = INT16_MAX
constexpr int kHiInit = -1;                              // (ymax, xmax) = -1

struct Thresholds {
    float min_area, max_area, max_variation, min_diversity;
    bool extent_only;  // the area proxy is the squared height, not the bbox area
};

struct TileGeom {
    int n, r, w;           // windows, rows per window, columns
    int core, halo;        // the strip's emitted rows [halo, halo + core)
    int th, tw, h;         // tile core rows and columns, tile halo (= span)
    int tiles_x;           // tiles per window row
};

__device__ __forceinline__ int wrap(int x, int m) {
    x %= m;
    return x < 0 ? x + m : x;
}

__device__ __forceinline__ int min5(int a, int b, int c, int d, int e) {
    return min(min(a, b), min(min(c, d), e));
}

__device__ __forceinline__ int vmin5(int a, int b, int c, int d, int e) {
    const unsigned m = __vmins2(__vmins2((unsigned)a, (unsigned)b),
                                __vmins2((unsigned)c, (unsigned)d));
    return (int)__vmins2(m, (unsigned)e);
}

__device__ __forceinline__ int vmax5(int a, int b, int c, int d, int e) {
    const unsigned m = __vmaxs2(__vmaxs2((unsigned)a, (unsigned)b),
                                __vmaxs2((unsigned)c, (unsigned)d));
    return (int)__vmaxs2(m, (unsigned)e);
}

// A thread's value of one ring slot for its kRows pixels: one 8-byte
// record, read and written as a vector.
union RingRec {
    uint2 v;
    __nv_bfloat16 h[kRows];
};

__device__ __forceinline__ bool same_bits(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __bfloat16_as_ushort(a) == __bfloat16_as_ushort(b);
}

// The ring slots level t reads (slots 0..d the area ring, d + 1 and d + 2
// the variation ring, d + 3 the last emitted area): A[t-d-1] in `area`, which
// is also the slot the level writes, A[t-d] in `a_td`, V[t-d-1] in `v_c`, and
// V[t-d-2] in `v_prev`, the variation slot the level writes.
struct RingSlots {
    int area, a_td, v_c, v_prev, last;
};

__device__ __forceinline__ RingSlots ring_slots(int t, int d) {
    const int nring = d + 1;
    const int v_new_s = (t + 2 * nring - d) % 2;
    return {t % nring, (t + nring - d % nring) % nring, nring + 1 - v_new_s, nring + v_new_s,
            nring + 2};
}

// The emit of both designs, per pixel (mser_pallas.py: _sweep_body after the
// propagation).  anchor_area: a mask pixel whose key is its own is its
// component's anchor; its area is the bbox area of the packed pairs, or with
// extent_only the squared height, an f32 product capped at 65535, and past
// max_area the anchor takes key -1 (the dead mark).  0 off an anchor.
__device__ __forceinline__ float anchor_area(int& key, int lo, int hi, int key0, bool in_mask,
                                             const Thresholds& th) {
    if (!in_mask || key != key0) return 0.0f;
    const float h = (float)((hi >> 16) - (lo >> 16) + 1);
    const float a = fminf(
        __fmul_rn(h, th.extent_only ? h : (float)((int)(short)hi - (int)(short)lo + 1)),
        65535.0f);
    if (a > th.max_area) key = -1;  // after the area
    return a;
}

// stability: the candidate test of one emitting pixel from its area this
// level and its ring values (A[t-d-1], A[t-d], V[t-d-1], V[t-d-2], the last
// emitted area); -> whether it is a candidate, its byte, and the values its
// variation and last-emit rings take.
struct Stability {
    bool cand;
    float qv, v_new, last;
};

__device__ __forceinline__ Stability stability(float a_cur, float area_c, float atd, float vc,
                                               float v_prev, float lst, const Thresholds& th) {
    Stability s;
    s.v_new = (atd > 0.0f && a_cur > 0.0f) ? __fdiv_rn(__fsub_rn(a_cur, atd), fmaxf(atd, 1.0f))
                                           : __int_as_float(0x7f800000);
    const bool cand = area_c >= th.min_area && area_c <= th.max_area &&
                      vc < th.max_variation && vc <= v_prev && vc <= s.v_new;
    s.cand = cand && (lst <= 0.0f || __fsub_rn(area_c, lst) >=
                                         __fmul_rn(th.min_diversity, fmaxf(area_c, 1.0f)));
    const float qv = __fsub_rn(254.0f, floorf(__fmul_rn(vc, 253.0f)));
    s.qv = fminf(fmaxf(qv, 1.0f), 254.0f);
    s.last = s.cand ? area_c : lst;
    return s;
}

template <bool kFull>
using SweepOut = std::conditional_t<kFull, uint8_t, int32_t>;

// One pixel's output at level t: K7 its byte (0 without a candidate) at
// out[o]; K3 the running max of (qv << lbits) | t at out[o], read and
// written only on a candidate, at the first level and at the last (a level
// without a candidate adds t, which the last level's t bounds).
template <bool kFull>
__device__ __forceinline__ void emit_out(SweepOut<kFull>* out, long long o, const Stability& s,
                                         int t, int num_levels, int lbits) {
    if constexpr (kFull) {
        out[o] = (uint8_t)(int)(s.cand ? s.qv : 0.0f);
    } else {
        const int packed = (int)(s.cand ? s.qv : 0.0f) * (1 << lbits) + t;
        if (t == 0) {
            out[o] = packed;
        } else if (s.cand || t == num_levels - 1) {
            out[o] = max(out[o], packed);
        }
    }
}

// One span of the sweep: passes [t0 * num_passes + p0, ... + npass) of the
// level sequence, with the warm starts and emits that fall inside it.
// Grid: (tiles of one window, windows).  A block holds a region of
// (th + 2h) x (tw + 2h) <= 64 x 64 pixels; thread (c, g) owns column c,
// rows [4g, 4g + 4), in registers across the whole span.  Each pass
// publishes every pixel to a shared-memory exchange buffer (two, used in
// turn: one barrier a pass), then reads its left and right neighbours
// there; vertical neighbours come from its own registers but at the ends
// of its column run.
//
// s_in / s_out: int32 [3, n, r, w] (keys, (ymin, xmin), (ymax, xmax)).
// rings: the sweep's scratch in the tile plan's own layout, bf16
// [n * tiles, d + 4 slots, kTileThreads, kRows]: slots 0..d the area ring,
// d + 1 and d + 2 the variation ring, d + 3 the last emitted area.  A
// thread reads and writes its pixels' slot as one 8-byte record, so the
// emit's ring reads of all its pixels are in flight together.
//
// out: K3 (kFull false) int32 [n, core, w], the strip's core rows; K7
// (kFull true) u8 [n, num_levels, r, w], every level of the whole window.
template <bool kFull>
__global__ void __launch_bounds__(kTileThreads, 1)
sweep_tile_kernel(const uint8_t* __restrict__ win, const int32_t* __restrict__ s_in,
                  int32_t* __restrict__ s_out, uint2* __restrict__ rings,
                  SweepOut<kFull>* __restrict__ out, TileGeom g, int t0, int p0, int npass,
                  int num_levels, int step, int d, int num_passes, int lbits,
                  Thresholds th) {
    extern __shared__ int32_t smem[];  // [2 buffers][keys, lo, hi][64][64]

    const int rh = g.th + 2 * g.h, rw = g.tw + 2 * g.h;
    const int hw = g.r * g.w;
    const int big = 256 * hw;
    const long long total = (long long)g.n * hw;
    const long long base = (long long)blockIdx.y * hw;
    // the block's window in the output, less the strip halo's rows (K3)
    const long long obase = kFull ? base * num_levels
                                  : (long long)blockIdx.y * g.core * g.w - (long long)g.halo * g.w;
    const int tile_y = blockIdx.x / g.tiles_x, tile_x = blockIdx.x - tile_y * g.tiles_x;
    const int row0 = tile_y * g.th - g.h, col0 = tile_x * g.tw - g.h;
    const int c = threadIdx.x % kRegion, r0 = threadIdx.x / kRegion * kRows;
    const bool first = t0 == 0 && p0 == 0;
    const int nring = d + 1;
    // this thread's record of ring slot k: rec[k * kTileThreads]
    uint2* rec = rings + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * (nring + 3) *
                             kTileThreads + threadIdx.x;

    // The region is an unrolled cover of the window's torus: its pixel
    // (i, j) is window pixel (wrap(row0 + i), wrap(col0 + j)).
    const int gc = wrap(col0 + c, g.w);
    const int gr0 = wrap(row0 + r0, g.r);
    const bool col_core = c >= g.h && c < g.h + g.tw && col0 + c < g.w;
    const bool col_inner = c > 0 && c < rw - 1;
    int K[kRows], LO[kRows], HI[kRows];
    unsigned V[kRows / 4] = {};  // window bytes, four to a word
    unsigned used = 0, inner = 0, core = 0, emits = 0;
    {
        int gr = gr0;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            const int i = r0 + k;
            K[k] = big;
            LO[k] = kLoInit;
            HI[k] = kHiInit;
            if (i < rh && c < rw) {  // a thread past the region idles, but
                used |= 1u << k;     // reaches every barrier
                const long long p = base + gr * g.w + gc;
                V[k / 4] |= (unsigned)win[p] << (8 * (k % 4));
                if (!first) {
                    K[k] = s_in[p];
                    LO[k] = s_in[total + p];
                    HI[k] = s_in[2 * total + p];
                }
                if (col_inner && i > 0 && i < rh - 1) inner |= 1u << k;
                const int ur = row0 + i;  // unwrapped
                if (col_core && i >= g.h && i < g.h + g.th && ur < g.r) {
                    core |= 1u << k;
                    if (ur >= g.halo && ur < g.halo + g.core) emits |= 1u << k;
                }
            }
            gr = gr + 1 == g.r ? 0 : gr + 1;
        }
    }

    int t = t0, p = p0, left = npass, buf = 0;
    while (true) {
        const int level = t * step;
        unsigned mask = 0;
        {
            int gr = gr0;
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
                const int v = (V[k / 4] >> (8 * (k % 4))) & 0xff;
                const bool m = (used >> k & 1u) && v <= level && gr > 0 && gr < g.r - 1;
                mask |= (unsigned)m << k;
                if (p == 0) {  // warm start: fold the level's mask into the state
                    const int rc = (gr << 16) | gc;
                    K[k] = m ? min(K[k], v * hw + gr * g.w + gc) : big;
                    LO[k] = m ? (int)__vmins2((unsigned)LO[k], (unsigned)rc) : kLoInit;
                    HI[k] = m ? (int)__vmaxs2((unsigned)HI[k], (unsigned)rc) : kHiInit;
                }
                gr = gr + 1 == g.r ? 0 : gr + 1;
            }
        }
        // Jacobi passes.  A pixel outside the mask holds the sentinels from
        // its warm start and keeps them, so only mask pixels are computed.
        const unsigned active = inner & mask;
        for (; p < num_passes && left > 0; ++p, --left, buf ^= 1) {
            int32_t* xk = smem + buf * 3 * kRegionPx;
            int32_t* xlo = xk + kRegionPx;
            int32_t* xhi = xlo + kRegionPx;
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
                if (used >> k & 1u) {
                    const int q = (r0 + k) * kRegion + c;
                    xk[q] = K[k];
                    xlo[q] = LO[k];
                    xhi[q] = HI[k];
                }
            }
            __syncthreads();
            if (active) {
                const int q0 = r0 * kRegion + c;
                int pk = 0, plo = 0, phi = 0;  // the old values of the row above
                if (active & 1u) {
                    pk = xk[q0 - kRegion];
                    plo = xlo[q0 - kRegion];
                    phi = xhi[q0 - kRegion];
                }
#pragma unroll
                for (int k = 0; k < kRows; ++k) {
                    const int ck = K[k], clo = LO[k], chi = HI[k];
                    if (active >> k & 1u) {
                        const int q = q0 + k * kRegion;
                        const int dk = k + 1 < kRows ? K[(k + 1) % kRows] : xk[q + kRegion];
                        const int nk = min5(ck, pk, dk, xk[q - 1], xk[q + 1]);
                        K[k] = nk;
                        if (nk >= 0) {  // live
                            const int dlo = k + 1 < kRows ? LO[(k + 1) % kRows] : xlo[q + kRegion];
                            const int dhi = k + 1 < kRows ? HI[(k + 1) % kRows] : xhi[q + kRegion];
                            LO[k] = vmin5(clo, plo, dlo, xlo[q - 1], xlo[q + 1]);
                            HI[k] = vmax5(chi, phi, dhi, xhi[q - 1], xhi[q + 1]);
                        } else {
                            LO[k] = kLoInit;
                            HI[k] = kHiInit;
                        }
                    }
                    pk = ck;
                    plo = clo;
                    phi = chi;
                }
            }
        }
        if (p < num_passes) break;  // the span ends inside level t

        // emit: bbox-area stability, dead mark, candidate test, collapse
        const RingSlots sl = ring_slots(t, d);
        const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
        const __nv_bfloat16 inf = __float2bfloat16_rn(__int_as_float(0x7f800000));
        // level 0 reads the initial rings: areas and last-emit 0, variations inf
        RingRec area, a_td, v_c, v_prev, last;
        if (emits && t) {  // five vector loads, all in flight together
            area.v = rec[sl.area * kTileThreads];
            a_td.v = rec[sl.a_td * kTileThreads];
            v_c.v = rec[sl.v_c * kTileThreads];
            v_prev.v = rec[sl.v_prev * kTileThreads];
            last.v = rec[sl.last * kTileThreads];
        } else {
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
                area.h[k] = a_td.h[k] = last.h[k] = zero;
                v_c.h[k] = v_prev.h[k] = inf;
            }
        }
        bool a_changed = false, v_changed = false, l_changed = false;
        int gr = gr0;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            const int v = (V[k / 4] >> (8 * (k % 4))) & 0xff;
            const float a_cur = anchor_area(K[k], LO[k], HI[k], v * hw + gr * g.w + gc,
                                            mask >> k & 1u, th);
            if (emits >> k & 1u) {
                const Stability s = stability(
                    a_cur, __bfloat162float(area.h[k]), __bfloat162float(a_td.h[k]),
                    __bfloat162float(v_c.h[k]), __bfloat162float(v_prev.h[k]),
                    __bfloat162float(last.h[k]), th);
                const __nv_bfloat16 a_newb = __float2bfloat16_rn(a_cur);
                const __nv_bfloat16 v_newb = __float2bfloat16_rn(s.v_new);
                const __nv_bfloat16 l_newb = __float2bfloat16_rn(s.last);
                a_changed |= !same_bits(a_newb, area.h[k]);
                v_changed |= !same_bits(v_newb, v_prev.h[k]);
                l_changed |= !same_bits(l_newb, last.h[k]);
                area.h[k] = a_newb;    // slot sl.area is the slot written
                v_prev.h[k] = v_newb;  // and so is slot sl.v_prev
                last.h[k] = l_newb;
                emit_out<kFull>(out, kFull ? obase + (long long)t * hw + gr * g.w + gc
                                           : obase + gr * g.w + gc,
                                s, t, num_levels, lbits);
            }
            gr = gr + 1 == g.r ? 0 : gr + 1;
        }
        if (emits) {
            if (t == 0) {  // the first level writes every slot: no fill launch
                for (int k = 0; k < nring; ++k) {
                    rec[k * kTileThreads] = k == sl.area ? area.v : make_uint2(0, 0);
                }
                rec[sl.v_prev * kTileThreads] = v_prev.v;
                rec[sl.v_c * kTileThreads] = v_c.v;  // all inf
                rec[sl.last * kTileThreads] = last.v;
            } else {
                if (a_changed) rec[sl.area * kTileThreads] = area.v;
                if (v_changed) rec[sl.v_prev * kTileThreads] = v_prev.v;
                if (l_changed) rec[sl.last * kTileThreads] = last.v;
            }
        }
        ++t;
        p = 0;
        if (t == num_levels || left == 0) break;
    }

    // write back the core
    int gr = gr0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        if (core >> k & 1u) {
            const long long px = base + gr * g.w + gc;
            s_out[px] = K[k];
            s_out[total + px] = LO[k];
            s_out[2 * total + px] = HI[k];
        }
        gr = gr + 1 == g.r ? 0 : gr + 1;
    }
}

// The span loop of both outputs: ceil(levels * passes / span) launches, the
// state ping-ponging between the two buffers.
template <bool kFull>
int run_tiles(const void* win, void* out, void* state, void* rings, int n, int r, int w,
              int core, int halo, int th_rows, int tw, int span, int num_levels, int step,
              int d, int num_passes, int lbits, Thresholds th, void* stream) {
    if (span < 1 || num_passes < 1 || th_rows < 1 || tw < 1 ||
        th_rows + 2 * span > kRegion || tw + 2 * span > kRegion || r >= 32767 ||
        w >= 32767) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t e = cudaFuncSetAttribute(
        sweep_tile_kernel<kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t st = (cudaStream_t)stream;
    const TileGeom g{n, r, w, core, halo, th_rows, tw, span, (w + tw - 1) / tw};
    const dim3 grid(g.tiles_x * ((r + th_rows - 1) / th_rows), n);
    const long long total = (long long)n * r * w;
    int32_t* buf[2] = {(int32_t*)state, (int32_t*)state + 3 * total};
    const long long passes = (long long)num_levels * num_passes;
    int cur = 0;
    for (long long s0 = 0; s0 < passes; s0 += span, cur ^= 1) {
        const int npass = (int)(passes - s0 < span ? passes - s0 : span);
        sweep_tile_kernel<kFull><<<grid, kTileThreads, kTileSmem, st>>>(
            (const uint8_t*)win, buf[cur], buf[1 - cur], (uint2*)rings,
            (SweepOut<kFull>*)out, g, (int)(s0 / num_passes), (int)(s0 % num_passes), npass,
            num_levels, step, d, num_passes, lbits, th);
    }
    return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The scan-pass body (cfg.scan_passes > 0): per level a warm start, then
// scan_passes times a row resolve and a column resolve, then one more row
// resolve, then the emit.  A resolve reduces each run of mask pixels along
// its row (column) whole, so it cannot run in the tiles above: a run spans
// the window, and a row that is all mask (every row at the levels of 255
// and up, where the border and the padding join the mask) wraps round it.
//
// Bands (scan_band_kernel): a block owns a band of `rows` whole window rows
// and keeps their sweep state (keys, (ymin, xmin), (ymax, xmax): 12 bytes a
// pixel) and window bytes in shared memory for all levels of the call, so
// no resolve goes through device memory.  One cooperative launch runs the
// call: `slots` windows a wave, `bands` blocks a window, at most one block
// an SM, all co-resident; each block loops over the waves.  The host's plan
// (ops/mser_cuda.py: scan_plan) picks the band height from the SM count and
// the shared memory a block may take, for the fewest waves x band rows; the
// launch refuses a grid that cannot be co-resident, and the wrapper raises
// before it on windows no plan holds.
//
// Row resolve: local to the band, a warp a row.  The run reduce is a
// segmented scan whose element is (break, keys, lo, hi): a pixel off the
// mask is a break holding the identities.  Each lane folds a chunk of
// consecutive pixels; a shuffle scan over the lanes gives each chunk its
// carry.  The scan is cyclic as pltpu.roll is: the carry into the row's
// first pixel is the whole row's aggregate, which is the run that crosses
// column w - 1 into 0, or the whole row where no pixel breaks it.  A forward
// walk leaves at each pixel the reduce from its run's start; a backward walk
// over those values leaves at each pixel its whole run's reduce.  A row
// with no pixel in the level's mask holds the sentinels and is skipped.
// The warm start is fused into a level's first row resolve, the emit into
// its last.
//
// Column resolve, with band carries.  Column runs never wrap (rows 0 and
// r - 1 are off the mask), but they cross bands.  A thread a column walks
// its band once: it writes back each run that lies between two breaks
// inside the band, and leaves the band's summary in device memory (its
// first and last break, the aggregate of its top run, from the band's
// first row to the first break, and of its bottom run).  Then the block
// waits at a barrier of its window's blocks.  Then each column combines the
// bottom runs of the bands above it up to the first band with a break, and
// the top runs of the bands below, and writes its top and bottom runs'
// whole values.  The barrier is a
// counter per window slot in device memory that only grows (the target is
// bands x the barriers passed), legal because the cooperative launch makes
// every block co-resident; the summaries are double-buffered across
// column resolves, so no block overwrites a summary another still reads.
// cooperative_groups' grid sync is not used: a window's bands wait only
// for each other.
//
// Replaces the scan_passes > 0 branch of mser_pallas.py: _sweep_body
// (axis_resolve), in both fused_level_sweep and fused_level_sweep_full.
// What bounds it: the function's operations (chip_smoke.py: SWEEP_SCAN_OPS)
// against the windows in and the output once.  Its floors in this design:
// shared-memory walks, tens of bytes a pixel a resolve; the rings, which
// stay in device memory, read (5 bf16) and written where they change for
// each mask pixel of an emitting row from its first level in the mask (a
// pixel's rings hold their initial values until then, so they are neither
// read nor written before); the barriers, scan_passes a level and wave,
// each as long as the slowest band of the window.  chip_smoke.py times a
// call at 1, 2 and 3 passes: the steps are a pass's cost (PERF.md).
//
// The same semantics as the reference's axis_resolve: keys reduce by min
// over mask ? keys : big, the packed pairs by __vmins2 / __vmaxs2 over
// live ? pair : sentinel, live = mask & keys >= 0 taken before the resolve;
// after it the pairs keep their run's value only where the run's key is
// >= 0.  A dead mark (-1) spreads through its run within the resolve.  The
// shared state is kept in that form: off the mask the sentinels, and the
// pairs at their sentinels where the key is < 0 (the warm start folds the
// liveness in; the emit's dead mark is folded in at the next warm start).

constexpr int kBandThreads = 1024;
constexpr int kNotInterior = 1 << 30;  // a row's least byte off the mask's rows
constexpr int kSummaryFields = 8;      // first break + 1, top, bottom runs, last break
constexpr int kCounterStride = 32;     // ints between two slots' barrier counters

struct BandGeom {
    int n, r, w;      // windows, rows, columns
    int core, halo;   // K3: the strip's emitted rows [halo, halo + core)
    int rows, bands;  // rows a band, bands a window
    int slots, waves; // windows a wave, waves
};

// Shared memory of a band: keys, lo and hi, each row's least byte (int32),
// then the window bytes.  The host plans with the same cost a row
// (ops/mser_cuda.py: SCAN_ROW_BYTES, SCAN_ROW_EXTRA) and passes its bytes;
// a plan that gives a band fewer is refused, not launched.
__host__ __device__ __forceinline__ long long band_smem_bytes(int rows, int w) {
    return (long long)rows * (13LL * w + 4);
}

// A segmented-scan element or aggregate: f = a break lies in it
struct Run {
    int f, k, lo, hi;
};

// a, then b, in scan order
__device__ __forceinline__ Run seg(const Run& a, const Run& b) {
    if (b.f) return b;
    return {a.f, min(a.k, b.k), (int)__vmins2((unsigned)a.lo, (unsigned)b.lo),
            (int)__vmaxs2((unsigned)a.hi, (unsigned)b.hi)};
}

// the reduce of a and (k, lo, hi), keeping a's break flag
__device__ __forceinline__ Run merge(const Run& a, int k, int lo, int hi) {
    return {a.f, min(a.k, k), (int)__vmins2((unsigned)a.lo, (unsigned)lo),
            (int)__vmaxs2((unsigned)a.hi, (unsigned)hi)};
}

__device__ __forceinline__ Run shfl(const Run& x, int src, int mode) {
    // mode 0: from lane src; 1: from lane - src; 2: from lane + src
    const unsigned all = 0xffffffffu;
    if (mode == 1) {
        return {__shfl_up_sync(all, x.f, src), __shfl_up_sync(all, x.k, src),
                __shfl_up_sync(all, x.lo, src), __shfl_up_sync(all, x.hi, src)};
    }
    if (mode == 2) {
        return {__shfl_down_sync(all, x.f, src), __shfl_down_sync(all, x.k, src),
                __shfl_down_sync(all, x.lo, src), __shfl_down_sync(all, x.hi, src)};
    }
    return {__shfl_sync(all, x.f, src), __shfl_sync(all, x.k, src),
            __shfl_sync(all, x.lo, src), __shfl_sync(all, x.hi, src)};
}

// The carry into this lane's chunk, given each lane's chunk aggregate, for a
// cyclic scan over the lanes in ascending (fwd) or descending order: the
// whole row's aggregate, then the chunks before this one.
__device__ __forceinline__ Run warp_carry(Run x, bool fwd, int big) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {  // inclusive scan
        const Run o = shfl(x, d, fwd ? 1 : 2);
        if (fwd ? lane >= d : lane + d < 32) x = seg(o, x);
    }
    const Run total = shfl(x, fwd ? 31 : 0, 0);
    Run excl = shfl(x, 1, fwd ? 1 : 2);
    if (lane == (fwd ? 0 : 31)) excl = {0, big, kLoInit, kHiInit};
    return seg(total, excl);
}

// Pixels of a lane's chunk in a row resolve: odd, so that the lanes' first
// pixels fall in distinct shared-memory banks.
__device__ __forceinline__ int scan_chunk(int w) { return ((w + 31) / 32) | 1; }

// Wait until every block of this window slot has arrived here: `target` is
// the slot's bands times the barriers it has passed, this one included.  A
// wait of kBarrierTimeout cycles (seconds; a legitimate wait is a band's
// resolve, microseconds) can only be a block that is not resident: the
// kernel traps, and the launch reports an error, rather than hang the card.
constexpr long long kBarrierTimeout = 1LL << 34;

__device__ __forceinline__ void slot_barrier(int* ctr, int target) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(ctr, 1);
        const long long t0 = clock64();
        while (*(volatile int*)ctr < target) {
            if (clock64() - t0 > kBarrierTimeout) __trap();
        }
        __threadfence();
    }
    __syncthreads();
}

// The band's shared state and the level a block works on.
struct BandLevel {
    int32_t *sk, *slo, *shi;
    const int32_t* rowmin;
    const uint8_t* sv;
    int w, level;

    __device__ __forceinline__ bool mask(int i, int x) const {
        return rowmin[i] <= level && sv[i * w + x] <= level;
    }
};

// One row resolve of band row i (window row y) by one warp; with `warm`
// the level's warm start first.  The row holds a pixel of the level's mask.
// Three walks over each lane's chunk: a fold (the warm start and the
// chunk's aggregate), a forward walk (each pixel the reduce from its run's
// start), a backward walk over those values (each pixel its whole run's
// reduce).  The backward carry comes from the forward walk: the descending
// aggregate of a chunk's prefix values is its prefix before its first
// break (prefixes only grow along a run), or its last prefix.
__device__ __forceinline__ void band_row_resolve(const BandLevel& s, int i, int y, int hw,
                                                 int big, bool warm) {
    const int lane = threadIdx.x & 31, w = s.w, level = s.level;
    int32_t* rk = s.sk + i * w;
    int32_t* rlo = s.slo + i * w;
    int32_t* rhi = s.shi + i * w;
    const uint8_t* rv = s.sv + i * w;
    const int chunk = scan_chunk(w);
    const int a = min(lane * chunk, w), b = min(a + chunk, w);
    const Run id = {0, big, kLoInit, kHiInit};
    // fold of the chunk, with the warm start: fold the level's mask into
    // the state, liveness included
    Run acc = id;
    for (int x = a; x < b; ++x) {
        const int v = rv[x];
        const bool m = v <= level;
        int K = rk[x], LO = rlo[x], HI = rhi[x];
        if (warm && m) {
            const int rc = (y << 16) | x;
            K = min(K, v * hw + y * w + x);
            LO = K >= 0 ? (int)__vmins2((unsigned)LO, (unsigned)rc) : kLoInit;
            HI = K >= 0 ? (int)__vmaxs2((unsigned)HI, (unsigned)rc) : kHiInit;
            rk[x] = K;
            rlo[x] = LO;
            rhi[x] = HI;
        }
        acc = seg(acc, Run{!m, K, LO, HI});
    }
    // forward walk: each pixel the reduce from its run's start
    acc = warp_carry(acc, true, big);
    Run desc = id;  // the descending aggregate of the chunk's prefixes
    for (int x = a; x < b; ++x) {
        if (!(rv[x] <= level)) {
            acc = id;
            desc.f = 1;
            continue;
        }
        acc = merge(acc, rk[x], rlo[x], rhi[x]);
        rk[x] = acc.k;
        rlo[x] = acc.lo;
        rhi[x] = acc.hi;
        if (!desc.f) desc = {0, acc.k, acc.lo, acc.hi};
    }
    // backward over those: each pixel its whole run's reduce, the pairs
    // at their sentinels where the run's key is < 0
    acc = warp_carry(desc, false, big);
    for (int x = b - 1; x >= a; --x) {
        if (!(rv[x] <= level)) {
            acc = id;
            continue;
        }
        acc = merge(acc, rk[x], rlo[x], rhi[x]);
        const bool live = acc.k >= 0;
        rk[x] = acc.k;
        rlo[x] = live ? acc.lo : kLoInit;
        rhi[x] = live ? acc.hi : kHiInit;
    }
}

// The emit of band row i (window row y, `has`: it holds a mask pixel) by one
// warp, a lane a column: the tiled design's emit per pixel, over the rings
// in the plain layout bf16 [d + 4, n, r, w] (ring slot k of pixel px at
// rings[k * total + px]).  A pixel off the mask has no anchor and its rings
// hold their initial values, so it is a non-candidate and they are not
// touched; at a pixel's first level in the mask they are read as their
// initial values and every slot is written.
template <bool kFull>
__device__ __forceinline__ void band_row_emit(const BandLevel& s, int i, int y, bool has,
                                              long long px0, long long o0, long long total,
                                              __nv_bfloat16* __restrict__ rings,
                                              SweepOut<kFull>* __restrict__ out, int hw, int t,
                                              int step, int num_levels, int d, int lbits,
                                              const Thresholds& th) {
    const int lane = threadIdx.x & 31, w = s.w, level = s.level;
    int32_t* rk = s.sk + i * w;
    const uint8_t* rv = s.sv + i * w;
    const RingSlots sl = ring_slots(t, d);
    const float inf = __int_as_float(0x7f800000);
    const Stability off = {false, 1.0f, inf, 0.0f};
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    const __nv_bfloat16 binf = __float2bfloat16_rn(inf);
    for (int x = lane; x < w; x += 32) {
        const int v = rv[x];
        if (!(has && v <= level)) {
            emit_out<kFull>(out, o0 + x, off, t, num_levels, lbits);
            continue;
        }
        const int K0 = rk[x];
        int K = K0;
        const float a_cur = anchor_area(K, s.slo[i * w + x], s.shi[i * w + x],
                                        v * hw + y * w + x, true, th);
        if (K != K0) rk[x] = K;  // the dead mark
        __nv_bfloat16* ring = rings + px0 + x;
        const bool first = v > level - step;  // the pixel's first level in the mask
        // there the rings hold their initial values: areas and last-emit 0,
        // variations inf
        __nv_bfloat16 area = zero, a_td = zero, v_c = binf, v_prev = binf, last = zero;
        if (!first) {
            area = ring[sl.area * total];
            a_td = ring[sl.a_td * total];
            v_c = ring[sl.v_c * total];
            v_prev = ring[sl.v_prev * total];
            last = ring[sl.last * total];
        }
        const Stability st =
            stability(a_cur, __bfloat162float(area), __bfloat162float(a_td),
                      __bfloat162float(v_c), __bfloat162float(v_prev), __bfloat162float(last), th);
        const __nv_bfloat16 a_newb = __float2bfloat16_rn(a_cur);
        const __nv_bfloat16 v_newb = __float2bfloat16_rn(st.v_new);
        const __nv_bfloat16 l_newb = __float2bfloat16_rn(st.last);
        if (first) {  // every slot
            for (int k = 0; k <= d; ++k) ring[k * total] = k == sl.area ? a_newb : zero;
            ring[sl.v_c * total] = binf;
            ring[sl.v_prev * total] = v_newb;
            ring[sl.last * total] = l_newb;
        } else {  // the slots the level writes, where they change
            if (!same_bits(a_newb, area)) ring[sl.area * total] = a_newb;
            if (!same_bits(v_newb, v_prev)) ring[sl.v_prev * total] = v_newb;
            if (!same_bits(l_newb, last)) ring[sl.last * total] = l_newb;
        }
        emit_out<kFull>(out, o0 + x, st, t, num_levels, lbits);
    }
}

// Writes run value v over band rows [i0, i1) of column x, the pairs at
// their sentinels where its key is < 0.
__device__ __forceinline__ void put_run(const BandLevel& s, int x, int i0, int i1, const Run& v) {
    const bool live = v.k >= 0;
    const int lo = live ? v.lo : kLoInit, hi = live ? v.hi : kHiInit;
    for (int i = i0; i < i1; ++i) {
        s.sk[i * s.w + x] = v.k;
        s.slo[i * s.w + x] = lo;
        s.shi[i * s.w + x] = hi;
    }
}

// The carry into a band's column x from the bands that `step` (-1: above,
// +1: below) leads to, to the first band with a break: the reduce of their
// bottom (above) or top (below) runs.  Summaries are read kCarryBatch bands
// at a time, their loads in flight together.
constexpr int kCarryBatch = 8;

__device__ __forceinline__ Run band_carry(const int* summ, int band, int bands, int step,
                                          int x, int w, int big) {
    Run c = {0, big, kLoInit, kHiInit};
    const int field = step < 0 ? 4 : 1;  // bottom run, or top run
    for (int bb = band + step; bb >= 0 && bb < bands; bb += kCarryBatch * step) {
        int f[kCarryBatch], k[kCarryBatch], lo[kCarryBatch], hi[kCarryBatch];
#pragma unroll
        for (int j = 0; j < kCarryBatch; ++j) {
            const int b = bb + j * step;
            f[j] = 1;
            k[j] = big;
            lo[j] = kLoInit;
            hi[j] = kHiInit;
            if (b >= 0 && b < bands) {
                const int* o = summ + (long long)b * kSummaryFields * w + x;
                f[j] = __ldcg(o);
                k[j] = __ldcg(o + field * w);
                lo[j] = __ldcg(o + (field + 1) * w);
                hi[j] = __ldcg(o + (field + 2) * w);
            }
        }
#pragma unroll
        for (int j = 0; j < kCarryBatch; ++j) {
            c = merge(c, k[j], lo[j], hi[j]);
            if (f[j]) return c;
        }
    }
    return c;
}

// One column resolve of the band, a thread a column.  Before the slot's
// barrier one walk down the column writes each run that lies between two
// breaks inside the band (the band's alone) and leaves the band's summary:
// its first break + 1 (0: none), the reduce of its top run (rows above the
// first break), of its bottom run (rows below the last break), and its last
// break.  After it, the top and bottom runs take the carries from the bands
// above and below.  summ: this resolve's summary buffer of the slot, int32
// [bands, 8, w].
__device__ __forceinline__ void band_col_resolve(const BandLevel& s, int nrows, int band,
                                                 int bands, int* summ, int* ctr, int target,
                                                 int big) {
    const int w = s.w;
    const Run id = {0, big, kLoInit, kHiInit};
    for (int x = threadIdx.x; x < w; x += blockDim.x) {
        int first = -1, last = -1, start = -1;
        Run top = id, run = id;
        for (int i = 0; i < nrows; ++i) {
            if (!s.mask(i, x)) {
                if (first < 0) {
                    first = i;
                } else if (start >= 0) {
                    put_run(s, x, start, i, run);
                }
                last = i;
                run = id;
                start = -1;
                continue;
            }
            const int q = i * w + x;
            if (first < 0) {
                top = merge(top, s.sk[q], s.slo[q], s.shi[q]);
            } else {
                run = merge(run, s.sk[q], s.slo[q], s.shi[q]);
                if (start < 0) start = i;
            }
        }
        const Run bot = first < 0 ? top : run;
        const int vals[kSummaryFields] = {first + 1, top.k, top.lo, top.hi,
                                          bot.k,     bot.lo, bot.hi, last};
        int* mine = summ + (long long)band * kSummaryFields * w + x;
#pragma unroll
        for (int j = 0; j < kSummaryFields; ++j) __stcg(mine + j * w, vals[j]);
    }
    slot_barrier(ctr, target);
    for (int x = threadIdx.x; x < w; x += blockDim.x) {
        const int* mine = summ + (long long)band * kSummaryFields * w + x;
        const int first = __ldcg(mine) - 1, last = __ldcg(mine + 7 * w);
        const Run top = {0, __ldcg(mine + w), __ldcg(mine + 2 * w), __ldcg(mine + 3 * w)};
        const Run bot = {0, __ldcg(mine + 4 * w), __ldcg(mine + 5 * w), __ldcg(mine + 6 * w)};
        if (first < 0) {  // no break: the band is one run
            const Run up = band_carry(summ, band, bands, -1, x, w, big);
            const Run dn = band_carry(summ, band, bands, 1, x, w, big);
            put_run(s, x, 0, nrows, merge(merge(up, top.k, top.lo, top.hi), dn.k, dn.lo, dn.hi));
            continue;
        }
        if (first > 0) {
            const Run up = band_carry(summ, band, bands, -1, x, w, big);
            put_run(s, x, 0, first, merge(up, top.k, top.lo, top.hi));
        }
        if (last < nrows - 1) {
            const Run dn = band_carry(summ, band, bands, 1, x, w, big);
            put_run(s, x, last + 1, nrows, merge(dn, bot.k, bot.lo, bot.hi));
        }
    }
}

// The whole scan-pass call.  Block (slot, band) owns rows [band * rows,
// band * rows + rows) of window wave * slots + slot in each wave.
// sync: int32, the slots' barrier counters (kCounterStride apart, zero at
// the launch), then two summary buffers [2, slots, bands, 8, w].
// out: K3 (kFull false) int32 [n, core, w]; K7 (kFull true) u8 [n,
// num_levels, r, w].
template <bool kFull>
__global__ void __launch_bounds__(kBandThreads, 1)
scan_band_kernel(const uint8_t* __restrict__ win, __nv_bfloat16* __restrict__ rings,
                 SweepOut<kFull>* __restrict__ out, int* __restrict__ sync, BandGeom g,
                 int num_levels, int step, int d, int scan_passes, int lbits, Thresholds th) {
    extern __shared__ int32_t smem[];
    const int w = g.w, hw = g.r * w, big = 256 * hw;
    const long long total = (long long)g.n * hw;
    const int slot = blockIdx.x / g.bands, band = blockIdx.x - slot * g.bands;
    const int y0 = band * g.rows, nrows = min(g.rows, g.r - y0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int bw = g.rows * w;
    int32_t* rowmin = smem + 3 * bw;
    BandLevel s{smem, smem + bw, smem + 2 * bw, rowmin,
                reinterpret_cast<const uint8_t*>(rowmin + g.rows), w, 0};
    uint8_t* sv = reinterpret_cast<uint8_t*>(rowmin + g.rows);
    int* ctr = sync + slot * kCounterStride;
    int* summ = sync + g.slots * kCounterStride;
    const long long buf_ints = (long long)g.slots * g.bands * kSummaryFields * w;
    int barriers = 0;

    for (int wave = 0; wave < g.waves; ++wave) {
        const int wi = wave * g.slots + slot;
        if (wi >= g.n) break;  // every block of the slot stops here
        const long long wbase = (long long)wi * hw;
        // the band's window bytes, the sentinel state, each row's least byte
        for (int i = warp; i < nrows; i += nwarps) {
            const int y = y0 + i;
            int least = 255;
            for (int x = lane; x < w; x += 32) {
                const int v = win[wbase + (long long)y * w + x];
                sv[i * w + x] = (uint8_t)v;
                s.sk[i * w + x] = big;
                s.slo[i * w + x] = kLoInit;
                s.shi[i * w + x] = kHiInit;
                least = min(least, v);
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                least = min(least, __shfl_xor_sync(0xffffffffu, least, o));
            }
            if (lane == 0) rowmin[i] = y > 0 && y < g.r - 1 ? least : kNotInterior;
        }
        __syncthreads();
        for (int t = 0; t < num_levels; ++t) {
            s.level = t * step;
            for (int k = 0;; ++k) {
                const bool emit = k == scan_passes;
                for (int i = warp; i < nrows; i += nwarps) {
                    const int y = y0 + i;
                    const bool has = rowmin[i] <= s.level;
                    if (has) band_row_resolve(s, i, y, hw, big, k == 0);
                    if (emit && (kFull || (y >= g.halo && y < g.halo + g.core))) {
                        __syncwarp();
                        const long long o0 =
                            kFull ? ((long long)wi * num_levels + t) * hw + (long long)y * w
                                  : ((long long)wi * g.core + y - g.halo) * w;
                        band_row_emit<kFull>(s, i, y, has, wbase + (long long)y * w, o0, total,
                                             rings, out, hw, t, step, num_levels, d, lbits, th);
                    }
                }
                __syncthreads();
                if (emit) break;
                ++barriers;
                int* sb = summ + (barriers & 1) * buf_ints +
                          (long long)slot * g.bands * kSummaryFields * w;
                band_col_resolve(s, nrows, band, g.bands, sb, ctr, g.bands * barriers, big);
                __syncthreads();
            }
        }
    }
}

// The scan-pass call of both outputs: one cooperative launch of a plan's
// grid with `smem` bytes of shared memory a block, after the barrier
// counters are zeroed.  The device refuses what the plan got wrong: more
// shared memory than a block may opt in to (cudaFuncSetAttribute), or a
// grid that cannot be all resident, which a window's bands need since they
// wait for each other (cudaLaunchCooperativeKernel).
template <bool kFull>
int run_scan(const void* win, void* out, void* sync, void* rings, BandGeom g, int smem,
             int num_levels, int step, int d, int scan_passes, int lbits, Thresholds th,
             void* stream) {
    if (scan_passes < 1 || g.n < 1 || g.r < 1 || g.w < 1 || g.r >= 32767 || g.w >= 32767 ||
        g.rows < 1 || g.bands < 1 || g.slots < 1 || g.waves < 1 ||
        (long long)g.rows * g.bands < g.r || (long long)g.rows * (g.bands - 1) >= g.r ||
        (long long)g.slots * g.waves < g.n || smem < band_smem_bytes(g.rows, g.w)) {
        return (int)cudaErrorInvalidValue;
    }
    auto kernel = scan_band_kernel<kFull>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t st = (cudaStream_t)stream;
    e = cudaMemsetAsync(sync, 0, sizeof(int) * kCounterStride * g.slots, st);
    if (e != cudaSuccess) return (int)e;
    const uint8_t* win_p = (const uint8_t*)win;
    __nv_bfloat16* rings_p = (__nv_bfloat16*)rings;
    SweepOut<kFull>* out_p = (SweepOut<kFull>*)out;
    int* sync_p = (int*)sync;
    void* args[] = {&win_p, &rings_p, &out_p, &sync_p, &g, &num_levels, &step, &d,
                    &scan_passes, &lbits, &th};
    e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(g.slots * g.bands),
                                    dim3(kBandThreads), args, (size_t)smem, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
}  // namespace

// win: u8 [n, r, w]; state: i32 [2, 3, n, r, w] (two buffers of keys,
// (ymin, xmin), (ymax, xmax)); rings: bf16 [n * tiles, d + 4, 1024, 4] (see
// sweep_tile_kernel).  Tiles of th x tw core pixels, `span` passes per
// launch.

// K3: row-strip windows.  out: i32 [n, core, w].
TSD_API int tsd_level_sweep(const void* win, void* out, void* state, void* rings,
                            int n, int r, int w, int core, int halo, int th, int tw,
                            int span, int num_levels, int step, int d, int num_passes,
                            int lbits, int extent_only, float min_area, float max_area,
                            float max_variation, float min_diversity, void* stream) {
    return run_tiles<false>(win, out, state, rings, n, r, w, core, halo, th, tw, span,
                            num_levels, step, d, num_passes, lbits,
                            Thresholds{min_area, max_area, max_variation, min_diversity,
                                       extent_only != 0},
                            stream);
}

// K7: each plane one strip, no halo.  full: u8 [n, num_levels, r, w].
TSD_API int tsd_level_sweep_full(const void* win, void* full, void* state, void* rings,
                                 int n, int r, int w, int th, int tw, int span,
                                 int num_levels, int step, int d, int num_passes,
                                 int extent_only, float min_area, float max_area,
                                 float max_variation, float min_diversity, void* stream) {
    return run_tiles<true>(win, full, state, rings, n, r, w, r, 0, th, tw, span, num_levels,
                           step, d, num_passes, 0,
                           Thresholds{min_area, max_area, max_variation, min_diversity,
                                      extent_only != 0},
                           stream);
}

// The scan-pass body of K3 (full = 0: out i32 [n, core, w]) or K7 (full = 1,
// core = r, halo = 0: out u8 [n, num_levels, r, w]) as one cooperative
// launch of bands x slots blocks of `rows` window rows each, over `waves`
// waves, `smem` bytes of shared memory a block (ops/mser_cuda.py:
// scan_plan).  sync: i32, the barrier counters and summaries
// (scan_band_kernel); rings: bf16 [d + 4, n, r, w].  Refuses a plan whose
// band does not fit its bytes or a block's shared memory, or whose grid
// cannot be co-resident.
TSD_API int tsd_level_sweep_scan(const void* win, void* out, void* sync, void* rings,
                                 int full, int n, int r, int w, int core, int halo,
                                 int rows, int bands, int slots, int waves, int smem,
                                 int num_levels, int step, int d, int scan_passes, int lbits,
                                 int extent_only,
                                 float min_area, float max_area, float max_variation,
                                 float min_diversity, void* stream) {
    const Thresholds th{min_area, max_area, max_variation, min_diversity, extent_only != 0};
    if (full) {
        const BandGeom g{n, r, w, r, 0, rows, bands, slots, waves};
        return run_scan<true>(win, out, sync, rings, g, smem, num_levels, step, d, scan_passes, 0,
                              th, stream);
    }
    const BandGeom g{n, r, w, core, halo, rows, bands, slots, waves};
    return run_scan<false>(win, out, sync, rings, g, smem, num_levels, step, d, scan_passes,
                           lbits, th, stream);
}
