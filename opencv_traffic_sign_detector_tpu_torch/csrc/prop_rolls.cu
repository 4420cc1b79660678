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
// Three forms, chosen by the planes' shape alone:
// * window: a 128x128 plane (the refine's candidate windows) is one block's
//   registers in the layout of window_regs.cuh, 16 warps of 8 rows, with no
//   halo: the plane's own wraparound closes the layout, lane 0's left
//   neighbour being lane 31's last column (a shuffle from (lane + 31) & 31)
//   and warp 0's row above warp 15's last row (the exchange row taken modulo
//   the warps).  Shared memory holds only the warps' first and last rows,
//   two pass parities of them (32 KB), one barrier a pass.  That barrier
//   also ORs whether the pass before changed a pixel: a pass that changes
//   none is a fixed point, every later pass changes nothing, and the block
//   leaves the loop.  This is exact for any keys and mask; a seed flood
//   whose component is tens of pixels across is at rest long before the
//   refine's 96 passes, one that fills its window is not.  Device memory
//   is read once and written once, 9 bytes a pixel;
//   what bounds the form is the integer pipe (two 3-input minima, a
//   maximum with the mask's floor and the test for a change, a pixel a
//   pass).
// * resident: any other plane whose two key buffers and mask fit one
//   block's shared memory (windows of frames smaller than 128 pixels) runs
//   all passes there, one block a plane.  Bound: shared memory bandwidth (5
//   loads and 1 store per pixel per pass).
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

__global__ void rolls_resident_kernel(const int32_t* __restrict__ keys,
                                      const uint8_t* __restrict__ mask,
                                      int32_t* __restrict__ out, int h, int w,
                                      int passes, int big) {
    extern __shared__ int32_t smem[];
    const int hw = h * w;
    int32_t* a = smem;
    int32_t* b = smem + hw;
    uint8_t* m = reinterpret_cast<uint8_t*>(smem + 2 * hw);
    const long long base = (long long)blockIdx.x * hw;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    for (int i = tid; i < hw; i += nthreads) {
        const bool mk = mask[base + i] != 0;
        m[i] = mk;
        a[i] = mk ? keys[base + i] : big;
    }
    __syncthreads();
    for (int k = 0; k < passes; ++k) {
        for (int r = threadIdx.y; r < h; r += blockDim.y) {
            const int rw = r * w;
            const int up = (r == 0 ? h - 1 : r - 1) * w;
            const int dn = (r == h - 1 ? 0 : r + 1) * w;
            for (int c = threadIdx.x; c < w; c += blockDim.x) {
                const int i = rw + c;
                if (!m[i]) {
                    b[i] = big;
                    continue;
                }
                const int lf = rw + (c == 0 ? w - 1 : c - 1);
                const int rt = rw + (c == w - 1 ? 0 : c + 1);
                b[i] = min(a[i], min(min(a[up + c], a[dn + c]), min(a[lf], a[rt])));
            }
        }
        __syncthreads();  // every read of `a` is done before it is written
        int32_t* t = a;
        a = b;
        b = t;
    }
    for (int i = tid; i < hw; i += nthreads) out[base + i] = a[i];
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
// The window form: the warps that cover a 128x128 plane.
constexpr int kWindow = kStripW;
constexpr int kWindowWarps = kWindow / kRows;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wrap(int x, int n) {
    x %= n;
    return x < 0 ? x + n : x;
}

__device__ __forceinline__ int min5(int a, int b, int c, int d, int e) {
    return __vimin3_s32(__vimin3_s32(a, b, c), d, e);
}

// A warp's first and last rows into `xch`, one pass's exchange buffer,
// [first, last][warp][lane] int4.  The block's barrier comes between this
// and the pass that reads the buffer; passes alternate between two buffers,
// so that one barrier a pass is enough.
template <int kW>
__device__ __forceinline__ void publish_rows(const int4 (&v)[kRows], int4 (*xch)[kW][32], int wp,
                                             int lane) {
    xch[0][wp][lane] = v[0];
    xch[1][wp][lane] = v[kRows - 1];
}

// One Jacobi pass over a lane's kRows x 4 pixels, in a block of kW warps
// whose rows `xch` holds (publish_rows, then a barrier).
// Without kWrap the block is a region of a larger plane: a pixel on its
// border reads a neighbour that is not its own (lane 0's left is its own
// last column, warp 0's row above is its own), so the border is never exact
// and never written; the mask bits `m` select which pixels move, and with
// kTrack the pass returns whether a pixel of `inner` changed.  The select
// stays a conditional around min5: the compiler then moves by predicate on
// the FMA pipe, where a select after the minimum takes the integer pipe,
// which the minima fill (5% slower at the sweeps' calls, PERF.md).
// With kWrap the block is a whole plane 32 * 4 columns wide and kW * kRows
// rows high and neighbours are read modulo it: lane 0's left is lane 31's
// last column, warp 0's row above is the last warp's last row.  The mask
// then comes as `floor`, INT_MIN for a pixel on it and `big` off it:
// max(min5, floor) holds a pixel off the mask at `big` with one instruction
// where a select needs the mask bit in a predicate first, 10 instructions a
// pixel against 6 (PERF.md); it costs 32 registers, which a block that has
// the SM to itself can spare and the tiled form cannot.  kTrack returns
// whether any pixel changed (nonzero), as the OR of old ^ new.
template <int kW, bool kWrap, bool kTrack>
__device__ __forceinline__ unsigned jacobi_pass(int4 (&v)[kRows], unsigned m, unsigned inner,
                                                const int4* floor, int4 (*xch)[kW][32], int wp,
                                                int lane) {
    int4 prev, below;
    if (kWrap) {
        prev = xch[1][(wp + kW - 1) % kW][lane];
        below = xch[0][(wp + 1) % kW][lane];
    } else {
        prev = wp > 0 ? xch[1][wp - 1][lane] : v[0];
        below = wp < kW - 1 ? xch[0][wp + 1][lane] : v[kRows - 1];
    }
    unsigned changed = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const int4 cur = v[k];
        const int4 dn = k + 1 < kRows ? v[(k + 1) % kRows] : below;  // not yet updated
        const int lf = kWrap ? __shfl_sync(kFull, cur.w, (lane + 31) & 31)
                             : __shfl_up_sync(kFull, cur.w, 1);
        const int rt = kWrap ? __shfl_sync(kFull, cur.x, (lane + 1) & 31)
                             : __shfl_down_sync(kFull, cur.x, 1);
        int4 n;
        if (kWrap) {
            n.x = max(min5(cur.x, prev.x, dn.x, lf, cur.y), floor[k].x);
            n.y = max(min5(cur.y, prev.y, dn.y, cur.x, cur.z), floor[k].y);
            n.z = max(min5(cur.z, prev.z, dn.z, cur.y, cur.w), floor[k].z);
            n.w = max(min5(cur.w, prev.w, dn.w, cur.z, rt), floor[k].w);
            if (kTrack)
                changed |= (n.x ^ cur.x) | (n.y ^ cur.y) | (n.z ^ cur.z) | (n.w ^ cur.w);
        } else {
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
        }
        v[k] = n;
        prev = cur;
    }
    return changed;
}

// The window form: one block a 128x128 plane, all passes in registers,
// neighbours read modulo the plane.  The barrier of pass p also tells
// whether pass p - 1 changed a pixel of the plane; if none did the keys are
// at a fixed point and the block stores them.  One block an SM (95
// registers a thread): two, at 64 registers, spill and measured slower, as
// did testing for a change only every 2nd, 4th or 8th pass (PERF.md).
__global__ void __launch_bounds__(32 * kWindowWarps, 1)
rolls_window_kernel(const int32_t* __restrict__ keys, const uint8_t* __restrict__ mask,
                    int32_t* __restrict__ out, int passes, int big) {
    __shared__ int4 xch[2][2][kWindowWarps][32];  // [pass parity][first, last row]
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    const long long base = (long long)blockIdx.x * kWindow * kWindow;
    int4 v[kRows];
    const unsigned m = load_window(keys + base, mask + base, kWindow, kWindow, wp, lane, big, v);
    int4 floor[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        floor[k].x = (m >> (4 * k) & 1u) ? INT_MIN : big;
        floor[k].y = (m >> (4 * k) & 2u) ? INT_MIN : big;
        floor[k].z = (m >> (4 * k) & 4u) ? INT_MIN : big;
        floor[k].w = (m >> (4 * k) & 8u) ? INT_MIN : big;
        // keeps the floors in registers: the compiler would else derive
        // them from the mask bits again in every pass
        asm volatile("" : "+r"(floor[k].x), "+r"(floor[k].y), "+r"(floor[k].z), "+r"(floor[k].w));
    }
    unsigned changed = 1;
    for (int p = 0; p < passes; ++p) {
        publish_rows(v, xch[p & 1], wp, lane);
        if (!__syncthreads_or(changed)) break;
        changed = jacobi_pass<kWindowWarps, true, true>(v, m, kFull, floor, xch[p & 1], wp, lane);
    }
    store_window(out + base, kWindow, kWindow, wp, lane, v);
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
            jacobi_pass<kWarps, false, true>(v, m, inner, nullptr, xch[0], wp, lane);
        // at rest: no core pixel changes in this span
        const bool rest = __syncthreads_or(changed) == 0;
        if (!rest) {
            for (int p = 1; p < npass; ++p) {
                publish_rows(v, xch[p & 1], wp, lane);
                __syncthreads();
                jacobi_pass<kWarps, false, false>(v, m, inner, nullptr, xch[p & 1], wp, lane);
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

}  // namespace

// 1 when one block holds a whole plane, in registers (128x128) or in shared
// memory: the call then runs the window or the resident form in one launch
// and needs no scratch.
TSD_API int tsd_propagate_rolls_resident(int h, int w) {
    return resident_bytes(h, w) <= kResidentBytes;
}

// keys, out: i32 [p, h, w]; mask: u8 [p, h, w].  The form is chosen by h and
// w alone: window, resident, else tiled.  The tiled form runs
// ceil(passes / span) launches of at most `span` passes over cores of
// core_h x core_w pixels (ops/prop_cuda.py: rolls_tiles); scratch: i32
// [p, h, w], read only when it takes more than one launch.
TSD_API int tsd_propagate_rolls(const void* keys, const void* mask, void* out,
                                void* scratch, int p, int h, int w, int passes,
                                int big, int span, int core_h, int core_w, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t* k = (const int32_t*)keys;
    const uint8_t* m = (const uint8_t*)mask;
    int32_t* o = (int32_t*)out;
    if (p == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
    if (h == kWindow && w == kWindow) {
        rolls_window_kernel<<<p, 32 * kWindowWarps, 0, st>>>(k, m, o, passes, big);
        return (int)cudaGetLastError();
    }
    if (resident_bytes(h, w) <= kResidentBytes) {
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
