// K5: K synchronous masked 4-neighbour min passes with wraparound.
//
// Replaces opencv_traffic_sign_detector_tpu/ops/pallas_prop.py:
// propagate_rolls_pallas (_kernel).  Per plane of a [P, H, W] int32 key
// stack with a [P, H, W] mask: k = mask ? keys : big, then K times
// k = mask ? min(k, min of the 4 neighbours) : big, the neighbours read
// modulo the plane as pltpu.roll / jnp.roll do.  Every pass reads the
// previous pass's whole plane (Jacobi): an in-place pass would propagate
// further within a pass and change the keys whenever K is below
// convergence, which the MSER sweep relies on (config.py ccl_iters).
//
// Four forms, chosen by the planes' shape alone (rolls_form below;
// ops/prop_cuda.py: rolls_form mirrors it, checked at every call):
// * window and window64: a 128x128 plane (the refine's candidate windows)
//   or a 64x64 one (the low-res refine's) is one block's registers, one
//   kernel template for both (rolls_window_kernel<Window>, <Window64>): 8
//   rows a warp, a lane 4 columns wide at 128 px (the layout of
//   window_regs.cuh, 16 warps) and 2 at 64 px (8 warps).  No halo: the
//   plane's own wraparound closes the layout, lane 0's left neighbour being
//   lane 31's last column (a shuffle from (lane + 31) & 31) and warp 0's row
//   above the last warp's last row (the exchange row taken modulo the
//   warps).  Shared memory holds only the warps' first and last rows, two
//   pass parities of them, one barrier a pass.  That barrier also ORs
//   whether the pass before changed a pixel: a pass that changes none is a
//   fixed point, every later pass changes nothing, and the block leaves the
//   loop.  This is exact for any keys and mask; a seed flood whose
//   component is tens of pixels across is at rest long before the refine's
//   96 passes, one that fills its window is not.  Device memory is read
//   once and written once, 9 bytes a pixel; what is left is the integer
//   pipe: a pixel a pass, the function's two 3-input minima and the
//   maximum with the mask's floor, and the design's test for a change.
// * resident: any other plane whose two key buffers and mask fit one
//   block's shared memory (windows of frames smaller than 128 pixels, the
//   small planes of an XLA sweep) runs all passes there, one block a plane,
//   with the mask as the same floor and the same stop at a fixed point.  A
//   thread walks down a run of rows of a column carrying the rows above, at
//   and below in registers: 4 shared loads (the row below, left, right and
//   the mask byte) and a store a pixel a pass.
// * tiled: larger planes (the sweep's 402x682, 1.1 MB of keys) cannot stay
//   on chip.  A launch a pass through device memory moves ~9 bytes a pixel
//   a pass for a function whose inputs and output are 9 bytes a pixel in
//   all: bound by bytes it need not move.  So one launch runs a span of up
//   to S passes (ops/prop_cuda.py: ROLLS_SPAN).  A block loads a region of
//   (kRows x its warps) x kRegionW pixels, a core tile plus a halo of S
//   pixels on every side, read through the plane's wraparound on both axes
//   (a tile on the left edge reads the far right; a plane smaller than the
//   region repeats inside it), so the region is an unrolled cover of the
//   torus.  After pass k of the span only pixels at least k from the
//   region's border are exact; after the span the core is, and only the
//   core is written.  Keys cross device memory once a span; spans
//   ping-pong between `out` and `scratch` so that the last lands in `out`.
//   - Inside a block the keys never leave registers (window_regs.cuh): a
//     warp is as wide as the region, a lane takes its left and right
//     neighbours by warp shuffles and its vertical ones from its own
//     registers; only each warp's first and last rows cross shared memory
//     to the warps above and below, double-buffered, one barrier a pass.
//     What is left per pixel and pass is two 3-input minima and a select.
//   - The region's rows are loaded by the widest loads that every row's
//     alignment allows, all started before any is used: one round of load
//     latency a block, hidden behind the other blocks of the SM (three,
//     by the register cap).
//   - Early stop, exact: if the span's first pass changes no pixel off the
//     region's border, no core pixel can change in this span (a change
//     creeps in one pixel a pass from the border and reaches only the
//     halo), so the block writes its core as loaded.  The sweep warm
//     starts each level from the last one's keys, so many blocks are at
//     rest.
//   What bounds it now is the region's load and store, halo included: an
//   8-pass call spends most of its time there (PERF.md).
#include <climits>
#include "window_regs.cuh"

namespace {

constexpr int kThreads = 256;
// Shared memory one block may use on sm_90 (227 KB).
constexpr long long kResidentBytes = 232448;

__host__ __device__ inline long long resident_bytes(int h, int w) {
    return (long long)h * w * 9;  // two int32 key buffers + one mask byte
}

// mask ? src : big
__global__ void rolls_mask_kernel(const int32_t* __restrict__ src,
                                  const uint8_t* __restrict__ mask,
                                  int32_t* __restrict__ dst, long long total, int big) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p < total) dst[p] = mask[p] ? src[p] : big;
}

// The tiled form's geometry.  A warp spans the region's width; a block's
// kWarps warps stack kRows rows each.  ops/prop_cuda.py mirrors the region
// as ROLLS_REGION_H and ROLLS_REGION_W and computes the core from them
// (rolls_tiles).
constexpr int kRegionW = kStripW;
constexpr int kWarps = 8;
constexpr int kRegionH = kRows * kWarps;
// Blocks an SM must hold: the register cap (85 a thread).  Three measured
// fastest of 1, 2, 3, 4 and 6 (PERF.md): more blocks hide a block's loads
// behind another's passes; six spill.
constexpr int kTileBlocksPerSm = 3;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wrap(int x, int n) {
    x %= n;
    return x < 0 ? x + n : x;
}

__device__ __forceinline__ int min5(int a, int b, int c, int d, int e) {
    return __vimin3_s32(__vimin3_s32(a, b, c), d, e);
}

// A warp's first and last rows into `xch`, one pass's exchange buffer,
// [first, last][warp][lane] of a lane's row (int4 or int2).  The block's
// barrier comes between this and the pass that reads the buffer; passes
// alternate between two buffers, so that one barrier a pass is enough.
template <int kW, class V>
__device__ __forceinline__ void publish_rows(const V (&v)[kRows], V (*xch)[kW][32], int wp,
                                             int lane) {
    xch[0][wp][lane] = v[0];
    xch[1][wp][lane] = v[kRows - 1];
}

// One Jacobi pass over a lane's kRows x 4 pixels of a region of a larger
// plane, in a block of kW warps whose rows `xch` holds (publish_rows, then
// a barrier): the tiled form.  A pixel on the region's border reads a
// neighbour that is not its own (lane 0's left is its own last column, warp
// 0's row above is its own), so the border is never exact and never
// written; the mask bits `m` select which pixels move, and with kTrack the
// pass returns whether a pixel of `inner` changed.  The select stays a
// conditional around min5: the compiler then moves by predicate on the FMA
// pipe, where a select after the minimum takes the integer pipe, which the
// minima fill (5% slower at the sweeps' calls, PERF.md).
template <int kW, bool kTrack>
__device__ __forceinline__ unsigned jacobi_pass(int4 (&v)[kRows], unsigned m, unsigned inner,
                                                int4 (*xch)[kW][32], int wp, int lane) {
    int4 prev = wp > 0 ? xch[1][wp - 1][lane] : v[0];
    const int4 below = wp < kW - 1 ? xch[0][wp + 1][lane] : v[kRows - 1];
    unsigned changed = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const int4 cur = v[k];
        const int4 dn = k + 1 < kRows ? v[(k + 1) % kRows] : below;  // not yet updated
        const int lf = __shfl_up_sync(kFull, cur.w, 1);
        const int rt = __shfl_down_sync(kFull, cur.x, 1);
        int4 n;
        const unsigned mk = m >> (4 * k);
        n.x = (mk & 1u) ? min5(cur.x, prev.x, dn.x, lf, cur.y) : cur.x;
        n.y = (mk & 2u) ? min5(cur.y, prev.y, dn.y, cur.x, cur.z) : cur.y;
        n.z = (mk & 4u) ? min5(cur.z, prev.z, dn.z, cur.y, cur.w) : cur.z;
        n.w = (mk & 8u) ? min5(cur.w, prev.w, dn.w, cur.z, rt) : cur.w;
        if (kTrack) {
            const unsigned ik = inner >> (4 * k);
            changed |= ((ik & 1u) && n.x != cur.x) | ((ik & 2u) && n.y != cur.y) |
                       ((ik & 4u) && n.z != cur.z) | ((ik & 8u) && n.w != cur.w);
        }
        v[k] = n;
        prev = cur;
    }
    return changed;
}

// A lane's row of a whole plane in registers (the window forms): 4 columns
// as an int4 at 128 px, 2 as an int2 at 64 px.  `wrap_row` moves one row a
// pass: each pixel the least of itself and its 4 neighbours (lf and rt: the
// columns left and right of the lane's, from the neighbouring lanes), then
// the greater of that and its floor, INT_MIN on the mask and `big` off it.
// max(min5, floor) holds a pixel off the mask at `big` with one instruction
// where a select needs the mask bit in a predicate first, 10 instructions a
// pixel against 6 (PERF.md).  `row_change` is nonzero where a pixel moved.
__device__ __forceinline__ int4 wrap_row(const int4& cur, const int4& up, const int4& dn, int lf,
                                         int rt, const int4& fl) {
    int4 n;
    n.x = max(min5(cur.x, up.x, dn.x, lf, cur.y), fl.x);
    n.y = max(min5(cur.y, up.y, dn.y, cur.x, cur.z), fl.y);
    n.z = max(min5(cur.z, up.z, dn.z, cur.y, cur.w), fl.z);
    n.w = max(min5(cur.w, up.w, dn.w, cur.z, rt), fl.w);
    return n;
}

__device__ __forceinline__ int2 wrap_row(const int2& cur, const int2& up, const int2& dn, int lf,
                                         int rt, const int2& fl) {
    return make_int2(max(min5(cur.x, up.x, dn.x, lf, cur.y), fl.x),
                     max(min5(cur.y, up.y, dn.y, cur.x, rt), fl.y));
}

__device__ __forceinline__ unsigned row_change(const int4& n, const int4& cur) {
    return (n.x ^ cur.x) | (n.y ^ cur.y) | (n.z ^ cur.z) | (n.w ^ cur.w);
}

__device__ __forceinline__ unsigned row_change(const int2& n, const int2& cur) {
    return (n.x ^ cur.x) | (n.y ^ cur.y);
}

__device__ __forceinline__ int first_col(const int4& v) { return v.x; }
__device__ __forceinline__ int first_col(const int2& v) { return v.x; }
__device__ __forceinline__ int last_col(const int4& v) { return v.w; }
__device__ __forceinline__ int last_col(const int2& v) { return v.y; }

// Keeps the floors in registers: the compiler would else derive them from
// the mask bits again in every pass.
__device__ __forceinline__ void pin(int4& f) {
    asm volatile("" : "+r"(f.x), "+r"(f.y), "+r"(f.z), "+r"(f.w));
}

__device__ __forceinline__ void pin(int2& f) { asm volatile("" : "+r"(f.x), "+r"(f.y)); }

// One Jacobi pass over a whole plane of kW warps x kRows rows and 32 lanes'
// rows, neighbours read modulo it: lane 0's left is lane 31's last column,
// warp 0's row above is the last warp's last row.  Returns whether a pixel
// changed (nonzero).
template <int kW, class V>
__device__ __forceinline__ unsigned wrap_pass(V (&v)[kRows], const V (&floor)[kRows],
                                              V (*xch)[kW][32], int wp, int lane) {
    V prev = xch[1][(wp + kW - 1) % kW][lane];
    const V below = xch[0][(wp + 1) % kW][lane];
    unsigned changed = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const V cur = v[k];
        const V dn = k + 1 < kRows ? v[(k + 1) % kRows] : below;  // not yet updated
        const int lf = __shfl_sync(kFull, last_col(cur), (lane + 31) & 31);
        const int rt = __shfl_sync(kFull, first_col(cur), (lane + 1) & 31);
        const V n = wrap_row(cur, prev, dn, lf, rt, floor[k]);
        changed |= row_change(n, cur);
        v[k] = n;
        prev = cur;
    }
    return changed;
}

// The window form's plane, 128x128 (the refine's windows): the layout of
// window_regs.cuh, 16 warps of 8 rows, a lane 4 columns, one block an SM
// (95 registers a thread): two, at 64 registers, spill and measured slower
// (PERF.md).
struct Window {
    using Vec = int4;
    static constexpr int kSide = kStripW, kWarps = kSide / kRows, kBlocksPerSm = 1;

    static __device__ __forceinline__ void load(const int32_t* __restrict__ keys,
                                                const uint8_t* __restrict__ mask, int wp,
                                                int lane, int big, int4 (&v)[kRows],
                                                int4 (&floor)[kRows]) {
        const long long base = (long long)blockIdx.x * kSide * kSide;
        const unsigned m = load_window(keys + base, mask + base, kSide, kSide, wp, lane, big, v);
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            floor[k].x = (m >> (4 * k) & 1u) ? INT_MIN : big;
            floor[k].y = (m >> (4 * k) & 2u) ? INT_MIN : big;
            floor[k].z = (m >> (4 * k) & 4u) ? INT_MIN : big;
            floor[k].w = (m >> (4 * k) & 8u) ? INT_MIN : big;
            pin(floor[k]);
        }
    }

    static __device__ __forceinline__ void store(int32_t* __restrict__ out, int wp, int lane,
                                                 const int4 (&v)[kRows]) {
        store_window(out + (long long)blockIdx.x * kSide * kSide, kSide, kSide, wp, lane, v);
    }
};

// The window64 form's plane, 64x64 (the low-res refine's windows): a lane
// 2 columns wide, 8 warps of 8 rows, 62 registers, four blocks an SM.  The
// window form's own layout, 4 columns a lane and so a plane a half-warp,
// measured 8% slower in blocks of two planes and 33% in blocks of four: a
// block runs its slowest plane's passes (PERF.md).  A row is one 8-byte
// load and store a lane if the stack's first pixel is aligned; every row's
// loads are started before any is used.
struct Window64 {
    using Vec = int2;
    static constexpr int kSide = 64, kWarps = kSide / kRows, kBlocksPerSm = 4;

    static __device__ __forceinline__ long long first(int wp, int lane) {
        return ((long long)blockIdx.x * kSide + wp * kRows) * kSide + 2 * lane;
    }

    static __device__ __forceinline__ void load(const int32_t* __restrict__ keys,
                                                const uint8_t* __restrict__ mask, int wp,
                                                int lane, int big, int2 (&v)[kRows],
                                                int2 (&floor)[kRows]) {
        const long long base = first(wp, lane);
        const bool vec = aligned(keys, 8) && aligned(mask, 2);
        unsigned mb[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            const long long e = base + k * kSide;
            if (vec) {
                v[k] = __ldg(reinterpret_cast<const int2*>(keys + e));
                mb[k] = *reinterpret_cast<const uint16_t*>(mask + e);
            } else {
                v[k] = make_int2(keys[e], keys[e + 1]);
                mb[k] = (unsigned)mask[e] | (unsigned)mask[e + 1] << 8;
            }
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            const bool on_x = (mb[k] & 0xffu) != 0, on_y = (mb[k] >> 8) != 0;
            v[k] = make_int2(on_x ? v[k].x : big, on_y ? v[k].y : big);
            floor[k] = make_int2(on_x ? INT_MIN : big, on_y ? INT_MIN : big);
            pin(floor[k]);
        }
    }

    static __device__ __forceinline__ void store(int32_t* __restrict__ out, int wp, int lane,
                                                 const int2 (&v)[kRows]) {
        const long long base = first(wp, lane);
        const bool vec = aligned(out, 8);
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            const long long e = base + k * kSide;
            if (vec) {
                *reinterpret_cast<int2*>(out + e) = v[k];
            } else {
                out[e] = v[k].x;
                out[e + 1] = v[k].y;
            }
        }
    }
};

// The window forms: one block a plane of F (Window, Window64), all passes
// in its registers, neighbours read modulo the plane.  The barrier of pass
// p also tells whether pass p - 1 changed a pixel of the plane; if none did
// the keys are at a fixed point and the block stores them.  Testing for a
// change only every 2nd, 4th or 8th pass measured slower (PERF.md).
template <class F>
__global__ void __launch_bounds__(32 * F::kWarps, F::kBlocksPerSm)
rolls_window_kernel(const int32_t* __restrict__ keys, const uint8_t* __restrict__ mask,
                    int32_t* __restrict__ out, int passes, int big) {
    using V = typename F::Vec;
    __shared__ V xch[2][2][F::kWarps][32];  // [pass parity][first, last row]
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    V v[kRows], floor[kRows];
    F::load(keys, mask, wp, lane, big, v, floor);
    unsigned changed = 1;
    for (int p = 0; p < passes; ++p) {
        publish_rows(v, xch[p & 1], wp, lane);
        if (!__syncthreads_or(changed)) break;
        changed = wrap_pass(v, floor, xch[p & 1], wp, lane);
    }
    F::store(out, wp, lane, v);
}

// The resident form: one block of 32 x ny threads a plane, thread (tx, ty)
// taking columns tx, tx + 32, ... and in each the rows [ty * run, (ty + 1) *
// run), run = ceil(h / ny).  The mask is kept as a byte 0 or -1, so that a
// pixel's floor (INT_MIN on the mask, `big` off it) is one bitwise select.
// The barrier that starts a pass also ORs whether the pass before changed
// a pixel, and the block leaves the loop at the first fixed point.
// Launched with 1024 threads: at the LDA step's eight 98x98 planes (8
// blocks, 8 SMs) 512 and 256 measured slower (PERF.md).
__global__ void __launch_bounds__(1024)
rolls_resident_kernel(const int32_t* __restrict__ keys, const uint8_t* __restrict__ mask,
                      int32_t* __restrict__ out, int h, int w, int passes, int big) {
    extern __shared__ int32_t smem[];
    const int hw = h * w;
    int32_t* a = smem;
    int32_t* b = smem + hw;
    int8_t* m = reinterpret_cast<int8_t*>(smem + 2 * hw);
    const long long base = (long long)blockIdx.x * hw;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int i = tid; i < hw; i += nthreads) {
        const bool mk = mask[base + i] != 0;
        m[i] = mk ? -1 : 0;
        a[i] = mk ? keys[base + i] : big;
    }
    const int run = (h + blockDim.y - 1) / blockDim.y;
    const int r0 = threadIdx.y * run, r1 = min(h, r0 + run);
    unsigned changed = 1;
    for (int k = 0; k < passes; ++k) {
        // every write of the pass before is done, and every read of `b`
        if (!__syncthreads_or(changed)) break;
        changed = 0;
        for (int c = threadIdx.x; c < w && r0 < r1; c += blockDim.x) {
            const int lc = c == 0 ? w - 1 : c - 1, rc = c == w - 1 ? 0 : c + 1;
            int up = a[(r0 == 0 ? h - 1 : r0 - 1) * w + c], cur = a[r0 * w + c];
            for (int r = r0; r < r1; ++r) {
                const int rw = r * w;
                const int dn = a[(r == h - 1 ? 0 : r + 1) * w + c];
                const int on = m[rw + c];
                const int n = max(min5(cur, up, dn, a[rw + lc], a[rw + rc]),
                                  (on & INT_MIN) | (~on & big));
                changed |= (unsigned)(n ^ cur);
                b[rw + c] = n;
                up = cur;
                cur = dn;
            }
        }
        int32_t* t = a;
        a = b;
        b = t;
    }
    __syncthreads();
    for (int i = tid; i < hw; i += nthreads) out[base + i] = a[i];
}

// One span of `npass` passes: reads `src`, writes the cores into `dst`.
// Grid: tiles_x * tiles_y blocks a plane, planes flattened into blockIdx.x.
// The mask is applied on load (a no-op after the first span: a pixel off
// the mask already holds `big`).
__global__ void __launch_bounds__(32 * kWarps, kTileBlocksPerSm)
rolls_tile_kernel(const int32_t* __restrict__ src, const uint8_t* __restrict__ mask,
                  int32_t* __restrict__ dst, int h, int w, int tiles_x, int tiles_y,
                  int core_h, int core_w, int span, int npass, int big) {
    __shared__ int4 xch[2][2][kWarps][32];  // [pass parity][first, last row]
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    const int tiles = tiles_x * tiles_y;
    const int plane = blockIdx.x / tiles, tile = blockIdx.x - plane * tiles;
    const int tile_y = tile / tiles_x, tile_x = tile - tile_y * tiles_x;
    const int row0 = tile_y * core_h - span, col0 = tile_x * core_w - span;
    const int rh = core_h + 2 * span, rw = core_w + 2 * span;  // the region in use
    const long long base = (long long)plane * h * w;
    const int i0 = wp * kRows, j0 = lane * kLaneCols;

    // Region pixel (i, j) is plane pixel (wrap(row0 + i), wrap(col0 + j)).
    int gc[kLaneCols];
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) gc[q] = wrap(col0 + j0 + q, w);
    const bool contiguous = gc[0] + kLaneCols - 1 == gc[kLaneCols - 1];
    // Every row's first pixel shares the alignment (in pixels: 4, 2 or 1)
    // of the first row's with the row length, so one branch picks the
    // widest loads for all rows and each form starts its rows' loads back
    // to back, before any is used.
    const bool lane_used = j0 < rw;
    int cls = 1;
    if (contiguous) {
        const long long e = base + (long long)wrap(row0 + i0, h) * w + gc[0];
        const unsigned low = (unsigned)(reinterpret_cast<uintptr_t>(src + e) >> 2) |
                             (unsigned)reinterpret_cast<uintptr_t>(mask + e) | (unsigned)w;
        cls = (low & 1u) ? 1 : (low & 2u) ? 2 : 4;
    }
    int4 v[kRows];
    unsigned mb[kRows];  // a row's 4 mask bytes
    if (cls == 4) load_rows<4>(src + base, mask + base, h, w, wrap(row0 + i0, h), gc,
                               lane_used ? rh - i0 : 0, big, v, mb);
    else if (cls == 2) load_rows<2>(src + base, mask + base, h, w, wrap(row0 + i0, h), gc,
                                    lane_used ? rh - i0 : 0, big, v, mb);
    else load_rows<1>(src + base, mask + base, h, w, wrap(row0 + i0, h), gc,
                      lane_used ? rh - i0 : 0, big, v, mb);
    const unsigned m = mask_rows(v, mb, kFull, big);
    unsigned inner = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k;
        const bool row_inner = i > 0 && i < rh - 1;
#pragma unroll
        for (int q = 0; q < kLaneCols; ++q)
            inner |= (unsigned)(row_inner && j0 + q > 0 && j0 + q < rw - 1) << (4 * k + q);
    }

    if (npass > 0) {
        publish_rows(v, xch[0], wp, lane);
        __syncthreads();
        const unsigned changed =
            jacobi_pass<kWarps, true>(v, m, inner, xch[0], wp, lane);
        // at rest: no core pixel changes in this span
        const bool rest = __syncthreads_or(changed) == 0;
        if (!rest) {
            for (int p = 1; p < npass; ++p) {
                publish_rows(v, xch[p & 1], wp, lane);
                __syncthreads();
                jacobi_pass<kWarps, false>(v, m, inner, xch[p & 1], wp, lane);
            }
        }
    }

    // the core, where it lies in the plane
    const int uc0 = col0 + j0;
    const bool first_ok = j0 >= span && uc0 < w;
    const bool last_ok = j0 + kLaneCols - 1 < span + core_w && uc0 + kLaneCols - 1 < w;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k, ur = row0 + i;
        if (i < span || i >= span + core_h || ur >= h) continue;
        int32_t* o = dst + base + (long long)ur * w + uc0;
        if (first_ok && last_ok) {
            if (aligned(o, 16)) {
                *reinterpret_cast<int4*>(o) = v[k];
            } else if (aligned(o, 8)) {
                *reinterpret_cast<int2*>(o) = make_int2(v[k].x, v[k].y);
                *reinterpret_cast<int2*>(o + 2) = make_int2(v[k].z, v[k].w);
            } else {
                o[0] = v[k].x, o[1] = v[k].y, o[2] = v[k].z, o[3] = v[k].w;
            }
        } else {  // the core's or the plane's ragged edge
            const int vals[kLaneCols] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
            for (int q = 0; q < kLaneCols; ++q)
                if (j0 + q >= span && j0 + q < span + core_w && uc0 + q < w) o[q] = vals[q];
        }
    }
}

// The form a [*, h, w] stack takes, by its planes' shape alone: 0 window
// (128x128 in registers), 1 window64 (64x64 in registers), 2 resident (any
// other plane whose two key buffers and mask fit one block's shared
// memory), 3 tiled.  The first three run in one launch and need no scratch.
// ops/prop_cuda.py: ROLLS_FORMS names the codes and rolls_form mirrors the
// choice; the wrapper raises at any call where the two disagree.
inline int rolls_form(int h, int w) {
    if (h == Window::kSide && w == Window::kSide) return 0;
    if (h == Window64::kSide && w == Window64::kSide) return 1;
    return resident_bytes(h, w) <= kResidentBytes ? 2 : 3;
}

}  // namespace

TSD_API int tsd_propagate_rolls_form(int h, int w) { return rolls_form(h, w); }

// keys, out: i32 [p, h, w]; mask: u8 [p, h, w].  The form is rolls_form(h,
// w)'s.  The tiled form runs ceil(passes / span) launches of at most `span`
// passes over cores of core_h x core_w pixels (ops/prop_cuda.py:
// rolls_tiles); scratch: i32 [p, h, w], read only when it takes more than
// one launch.
TSD_API int tsd_propagate_rolls(const void* keys, const void* mask, void* out,
                                void* scratch, int p, int h, int w, int passes,
                                int big, int span, int core_h, int core_w, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t* k = (const int32_t*)keys;
    const uint8_t* m = (const uint8_t*)mask;
    int32_t* o = (int32_t*)out;
    if (p == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
    const int form = rolls_form(h, w);
    if (form == 0) {
        rolls_window_kernel<Window><<<p, 32 * Window::kWarps, 0, st>>>(k, m, o, passes, big);
        return (int)cudaGetLastError();
    }
    if (form == 1) {
        rolls_window_kernel<Window64><<<p, 32 * Window64::kWarps, 0, st>>>(k, m, o, passes, big);
        return (int)cudaGetLastError();
    }
    if (form == 2) {
        const int smem = (int)resident_bytes(h, w);
        cudaError_t e = cudaFuncSetAttribute(
            rolls_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        rolls_resident_kernel<<<p, dim3(32, 32), smem, st>>>(k, m, o, h, w, passes, big);
        return (int)cudaGetLastError();
    }
    if (passes == 0) {
        const long long total = (long long)p * h * w;
        rolls_mask_kernel<<<tsd_blocks(total, kThreads), kThreads, 0, st>>>(k, m, o, total, big);
        return (int)cudaGetLastError();
    }
    if (span < 1 || core_h < 1 || core_w < kLaneCols || core_w % kLaneCols ||
        core_h + 2 * span > kRegionH || core_w + 2 * span > kRegionW)
        return (int)cudaErrorInvalidValue;
    const int launches = (passes + span - 1) / span;
    if (launches > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int tiles_x = (w + core_w - 1) / core_w, tiles_y = (h + core_h - 1) / core_h;
    const long long blocks = (long long)tiles_x * tiles_y * p;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    // launch i writes `out` when launches-1-i is even, so the last lands there
    int32_t* bufs[2] = {o, (int32_t*)scratch};
    const int32_t* src = k;
    for (int i = 0; i < launches; ++i) {
        int32_t* dst = bufs[(launches - 1 - i) % 2];
        const int npass = passes - i * span < span ? passes - i * span : span;
        rolls_tile_kernel<<<(int)blocks, 32 * kWarps, 0, st>>>(
            src, m, dst, h, w, tiles_x, tiles_y, core_h, core_w, span, npass, big);
        src = dst;
    }
    return (int)cudaGetLastError();
}
