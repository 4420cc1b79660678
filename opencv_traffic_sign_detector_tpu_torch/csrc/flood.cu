// K4: per-candidate seed flood with bbox and pixel-area reduction.
//
// Replaces opencv_traffic_sign_detector_tpu/ops/pallas_prop.py:
// flood_bbox_pallas (_flood_bbox_kernel).  The TPU form takes materialised
// [N,128,128] seed maps and masks and resolves mask runs with Hillis-Steele
// doubling over rolled copies of int32 keys, because its vector unit cannot
// scan.  The work is a flood of one bit a pixel: a run of the mask (pixel <=
// level, inner ring only) is reached as a whole if any of its pixels is.
// Here one warp owns one candidate window and holds both planes as bits, a
// 128-pixel row in two 64-bit words, four consecutive rows a lane:
// - the mask is built from coalesced byte reads of the window, straight from
//   the padded native intensity planes, one __ballot_sync a 32-pixel word;
//   a lane loads its bytes of 8 rows before their ballots, so that 32 loads
//   are in flight (a ballot after each load left the warp waiting on every
//   load);
// - a row resolve is carry arithmetic: for seeds s inside mask m, m + s
//   carries from each seed to the end of its run, so s | ((m + s) ^ m ^ s) & m
//   fills every run upward from its lowest seed, and the same on the
//   bit-reversed row fills downward; their union is every run holding a seed;
// - a column resolve is a segmented OR scan down and up the rows: inside a
//   lane over its four rows, across lanes by five shuffle steps of (reach
//   leaving the bottom row, columns open through all four rows);
// - the reduction is popcounts, row tests and the OR of the rows, then one
//   warp reduction each.
// A window whose seed is not on a mask pixel reads one byte and writes the
// empty result.  Passes run H,V,...,H,V,H as in the reference, whose runs
// never wrap because the inner ring is masked.  Bound: the larger of the
// plane bytes under the windows, each once (neighbouring windows overlap),
// and the bit work (~50 integer operations a 32-pixel word); the kernel
// stays above both by the latency of its byte loads at 128 registers a
// thread (16 warps an SM).  Output is [N,5] int32 (ymin,
// ymax, xmin, xmax, area); an empty component gives (big, -1, big, -1, 0)
// like the reference.
//
// K6 below replaces pallas_prop.py: propagate_scan_pallas (_scan_kernel),
// the same flood on int32 keys without the reduction: every run takes the
// least key of its pixels.  A block holds one [<=128, <=128] plane in its
// registers in the layout of window_regs.cuh (16 warps of 8 rows, a lane 4
// columns wide; a smaller plane is padded with pixels off the mask, where
// runs end anyway).  A resolve is a segmented min scan forward and then
// backward over the forward result, three steps each: inside a lane, across
// lanes or warps from (least key leaving, open through), inside the lane
// again from the key entering.  Rows scan across the 32 lanes by five
// shuffle steps of 8 keys and one word of flags, with no barrier; columns
// across the 16 warps through shared memory, one barrier a resolve.  It
// shares no code with K4's bit flood: bbox(K6 == 0) == K4 is a check of
// both.  Bound by its bytes (9 a pixel, read and written once); what it
// pays above them is shuffles and the scans' selects.
#include "window_regs.cuh"

namespace {

constexpr int kWin = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFloodWarps = 4;  // windows a block, one a warp
constexpr int kStepRows = 8;    // window rows whose bytes a lane loads at once

using u64 = unsigned long long;

// One 128-pixel row: bit c of the pair is column c.
struct Row {
    u64 lo, hi;
};

__device__ __forceinline__ Row operator&(Row a, Row b) { return {a.lo & b.lo, a.hi & b.hi}; }
__device__ __forceinline__ Row operator|(Row a, Row b) { return {a.lo | b.lo, a.hi | b.hi}; }
__device__ __forceinline__ Row reversed(Row a) { return {__brevll(a.hi), __brevll(a.lo)}; }

// Every pixel of m from the lowest pixel of s in its run to the run's top
// end (s inside m): the carries of m + s, taken across the two words.
__device__ __forceinline__ Row fill_up(Row m, Row s) {
    const u64 lo = m.lo + s.lo;
    const u64 hi = m.hi + s.hi + (lo < m.lo ? 1ull : 0ull);
    return {s.lo | ((lo ^ m.lo ^ s.lo) & m.lo), s.hi | ((hi ^ m.hi ^ s.hi) & m.hi)};
}

// Row resolve: every run of m that holds a pixel of s.
__device__ __forceinline__ Row resolve_row(Row m, Row s) {
    return fill_up(m, s) | reversed(fill_up(reversed(m), reversed(s)));
}

__device__ __forceinline__ Row shfl_up(Row a, int d) {
    return {__shfl_up_sync(kFull, a.lo, d), __shfl_up_sync(kFull, a.hi, d)};
}
__device__ __forceinline__ Row shfl_down(Row a, int d) {
    return {__shfl_down_sync(kFull, a.lo, d), __shfl_down_sync(kFull, a.hi, d)};
}

// Column resolve of the warp's window: lane l holds rows 4l..4l+3.  Down,
// then up: each is a local pass over the lane's rows, an inclusive scan of
// (reach leaving the lane, columns open through the lane) across lanes, and
// a second local pass from the reach entering the lane.
__device__ __forceinline__ void resolve_cols(const Row (&m)[4], Row (&r)[4], int lane) {
    const Row open = m[0] & m[1] & m[2] & m[3];
#pragma unroll
    for (int s = 1; s < 4; ++s) r[s] = r[s] | (r[s - 1] & m[s]);
    Row out = r[3], t = open;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const Row po = shfl_up(out, d), pt = shfl_up(t, d);
        if (lane >= d) {
            out = out | (po & t);
            t = t & pt;
        }
    }
    Row in = shfl_up(out, 1);
    if (lane == 0) in = {0ull, 0ull};
    r[0] = r[0] | (in & m[0]);
#pragma unroll
    for (int s = 1; s < 4; ++s) r[s] = r[s] | (r[s - 1] & m[s]);

#pragma unroll
    for (int s = 2; s >= 0; --s) r[s] = r[s] | (r[s + 1] & m[s]);
    out = r[0];
    t = open;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const Row po = shfl_down(out, d), pt = shfl_down(t, d);
        if (lane + d < 32) {
            out = out | (po & t);
            t = t & pt;
        }
    }
    in = shfl_down(out, 1);
    if (lane == 31) in = {0ull, 0ull};
    r[3] = r[3] | (in & m[3]);
#pragma unroll
    for (int s = 2; s >= 0; --s) r[s] = r[s] | (r[s + 1] & m[s]);
}

// cand rows: (plane, y0, x0, seed_y, seed_x, level) int32.  Plane and origin
// are clamped so that the window lies inside the planes, as the reference's
// dynamic_slice clamps its start indices; the seed is in window coordinates.
__global__ void __launch_bounds__(kFloodWarps * 32)
flood_bbox_kernel(const uint8_t* __restrict__ planes, const int32_t* __restrict__ cand,
                  int32_t* __restrict__ out, int n, int np, int h, int w, int wh, int ww,
                  int passes, int big) {
    const int lane = threadIdx.x & 31;
    const int idx = blockIdx.x * kFloodWarps + (threadIdx.x >> 5);
    if (idx >= n) return;  // the whole warp
    const int32_t* cd = cand + (size_t)idx * 6;
    const int plane = min(max(cd[0], 0), np - 1);
    const int y0 = min(max(cd[1], 0), h - wh), x0 = min(max(cd[2], 0), w - ww);
    const int sy = cd[3], sx = cd[4], level = cd[5];
    const uint8_t* src = planes + ((size_t)plane * h + y0) * w + x0;
    int32_t* o = out + (size_t)idx * 5;

    const bool seeded = sy > 0 && sy < wh - 1 && sx > 0 && sx < ww - 1 &&
                        (int)__ldg(src + (size_t)sy * w + sx) <= level;
    if (!seeded) {  // the seed is off the mask: an empty component
        if (lane < 5) o[lane] = lane == 4 ? 0 : (lane & 1 ? -1 : big);
        return;
    }

    // mask rows 4*lane + s; the ballot of row y's k-th 32 columns is its
    // k-th word, kept by the lane that owns the row.  A lane loads its bytes
    // of kStepRows rows before their ballots, so that their loads are in
    // flight together (-1: off the inner ring).
    Row m[4], r[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) m[s] = r[s] = {0ull, 0ull};
    for (int y0r = 0; y0r < wh; y0r += kStepRows) {
        int v[kStepRows][4];
#pragma unroll
        for (int j = 0; j < kStepRows; ++j) {
            const int y = y0r + j;
            const uint8_t* row = src + (size_t)y * w;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int x = k * 32 + lane;
                v[j][k] = y > 0 && y < wh - 1 && x > 0 && x < ww - 1 ? (int)__ldg(row + x) : -1;
            }
        }
#pragma unroll
        for (int j = 0; j < kStepRows; ++j) {
            unsigned wd[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) wd[k] = __ballot_sync(kFull, v[j][k] >= 0 && v[j][k] <= level);
            if (lane == (y0r + j) >> 2)
                m[j & 3] = {wd[0] | (u64)wd[1] << 32, wd[2] | (u64)wd[3] << 32};
        }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        if (lane * 4 + s == sy) {
            const u64 bit = 1ull << (sx & 63);
            r[s] = sx < 64 ? Row{bit, 0ull} : Row{0ull, bit};
        }
    }

    for (int k = 0; k < passes; ++k) {
#pragma unroll
        for (int s = 0; s < 4; ++s) r[s] = resolve_row(m[s], r[s]);
        resolve_cols(m, r, lane);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) r[s] = resolve_row(m[s], r[s]);

    int area = 0, ymin = big, ymax = -1;
    Row cols = {0ull, 0ull};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        area += __popcll(r[s].lo) + __popcll(r[s].hi);
        if (r[s].lo | r[s].hi) {
            ymin = min(ymin, lane * 4 + s);
            ymax = lane * 4 + s;
        }
        cols = cols | r[s];
    }
    area = __reduce_add_sync(kFull, area);
    ymin = __reduce_min_sync(kFull, ymin);
    ymax = __reduce_max_sync(kFull, ymax);
    const unsigned c[4] = {__reduce_or_sync(kFull, (unsigned)cols.lo),
                           __reduce_or_sync(kFull, (unsigned)(cols.lo >> 32)),
                           __reduce_or_sync(kFull, (unsigned)cols.hi),
                           __reduce_or_sync(kFull, (unsigned)(cols.hi >> 32))};
    int xmin = big, xmax = -1;
#pragma unroll
    for (int k = 3; k >= 0; --k)
        if (c[k]) xmin = k * 32 + __ffs(c[k]) - 1;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (c[k]) xmax = k * 32 + 31 - __clz(c[k]);
    if (lane < 5) o[lane] = lane == 0 ? ymin : lane == 1 ? ymax : lane == 2 ? xmin
                                             : lane == 3 ? xmax : area;
}

// K6 (propagate_scan): the same H,V,...,H run resolves on int32 keys, each
// run taking the minimum key of its pixels, and the resolved keys written
// out instead of reduced.  Runs end at the plane's edges.  Equal to the
// reference's Hillis-Steele doubling when the plane's border rows and
// columns are masked off (its documented precondition): its runs then never
// wrap.
constexpr int kScanWarps = kWin / kRows;
constexpr int kNoKey = 0x7fffffff;  // off the mask, or nothing entering a run

// A scan step: `val` joined by the carry where bit `on` says they connect.
// `val` is kNoKey off the mask, so a pixel off the mask stays so.
__device__ __forceinline__ int carry_min(bool on, int val, int carry) {
    return min(val, on ? carry : kNoKey);
}
__device__ __forceinline__ int4 carry_min(unsigned on, int4 val, int4 carry) {
    return make_int4(carry_min((on & 1u) != 0, val.x, carry.x),
                     carry_min((on & 2u) != 0, val.y, carry.y),
                     carry_min((on & 4u) != 0, val.z, carry.z),
                     carry_min((on & 8u) != 0, val.w, carry.w));
}

// One direction of the row resolve over the lane's kRows rows: with kFwd
// every mask pixel takes the least key from its run's left end to itself,
// else from itself to the right end.  Bit 4k of `open` says that row k's 4
// pixels of this lane are all on the mask.
template <bool kFwd>
__device__ __forceinline__ void scan_rows(int4 (&v)[kRows], unsigned m, unsigned open, int lane) {
    int out[kRows];  // the key leaving the lane, nothing entering it
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const unsigned mk = m >> (4 * k);
        if (kFwd) {
            out[k] = carry_min((mk & 8u) != 0, v[k].w, carry_min((mk & 4u) != 0, v[k].z,
                     carry_min((mk & 2u) != 0, v[k].y, v[k].x)));
        } else {
            out[k] = carry_min((mk & 1u) != 0, v[k].x, carry_min((mk & 2u) != 0, v[k].y,
                     carry_min((mk & 4u) != 0, v[k].z, v[k].w)));
        }
    }
    // inclusive scan across lanes; a lane with no lane d away reads itself
    unsigned t = open;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const unsigned pt = kFwd ? __shfl_up_sync(kFull, t, d) : __shfl_down_sync(kFull, t, d);
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            const int po = kFwd ? __shfl_up_sync(kFull, out[k], d)
                                : __shfl_down_sync(kFull, out[k], d);
            out[k] = carry_min((t >> (4 * k) & 1u) != 0, out[k], po);
        }
        t &= pt;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        int in = kFwd ? __shfl_up_sync(kFull, out[k], 1) : __shfl_down_sync(kFull, out[k], 1);
        if (lane == (kFwd ? 0 : 31)) in = kNoKey;  // runs end at the plane's edge
        const unsigned mk = m >> (4 * k);
        if (kFwd) {
            v[k].x = carry_min((mk & 1u) != 0, v[k].x, in);
            v[k].y = carry_min((mk & 2u) != 0, v[k].y, v[k].x);
            v[k].z = carry_min((mk & 4u) != 0, v[k].z, v[k].y);
            v[k].w = carry_min((mk & 8u) != 0, v[k].w, v[k].z);
        } else {
            v[k].w = carry_min((mk & 8u) != 0, v[k].w, in);
            v[k].z = carry_min((mk & 4u) != 0, v[k].z, v[k].w);
            v[k].y = carry_min((mk & 2u) != 0, v[k].y, v[k].z);
            v[k].x = carry_min((mk & 1u) != 0, v[k].x, v[k].y);
        }
    }
}

// Row resolve: forward, then backward over the forward result, whose value
// at a run's right end is the run's least key.
__device__ __forceinline__ void resolve_key_rows(int4 (&v)[kRows], unsigned m, int lane) {
    unsigned open = m & (m >> 1);
    open &= open >> 2;
    open &= 0x11111111u;
    scan_rows<true>(v, m, open, lane);
    scan_rows<false>(v, m, open, lane);
}

// What a warp tells the others of its kRows rows in a column resolve, a
// column each: the key leaving its last row downward and its first row
// upward (nothing entering), and whether all its rows are on the mask.
struct ScanExchange {
    int4 down[kScanWarps][32];
    int4 up[kScanWarps][32];
    unsigned open[kScanWarps][32];
};

// Column resolve.  Every warp publishes its three entries, and after the
// barrier scans those of the warps above it for the key entering its first
// row and those below for the key entering its last.  Then down inside the
// lane from the first, and up over that result from the second: the key
// entering from below is the least of the run's pixels below the warp, and
// the downward result at the run's last row here the least of all above.
__device__ __forceinline__ void resolve_key_cols(int4 (&v)[kRows], unsigned m, ScanExchange& x,
                                                 int wp, int lane) {
    const int4 none = make_int4(kNoKey, kNoKey, kNoKey, kNoKey);
    int4 down = none, up = none;
#pragma unroll
    for (int k = 0; k < kRows; ++k) down = carry_min(m >> (4 * k), v[k], down);
#pragma unroll
    for (int k = kRows - 1; k >= 0; --k) up = carry_min(m >> (4 * k), v[k], up);
    unsigned open = m & (m >> 16);
    open &= open >> 8;
    open &= open >> 4;
    x.down[wp][lane] = down;
    x.up[wp][lane] = up;
    x.open[wp][lane] = open & 0xfu;
    __syncthreads();
    int4 in_down = none, in_up = none;  // runs end at the plane's edge
    for (int j = 0; j < wp; ++j) in_down = carry_min(x.open[j][lane], x.down[j][lane], in_down);
    for (int j = kScanWarps - 1; j > wp; --j)
        in_up = carry_min(x.open[j][lane], x.up[j][lane], in_up);
#pragma unroll
    for (int k = 0; k < kRows; ++k) v[k] = in_down = carry_min(m >> (4 * k), v[k], in_down);
#pragma unroll
    for (int k = kRows - 1; k >= 0; --k) v[k] = in_up = carry_min(m >> (4 * k), v[k], in_up);
}

// Two blocks an SM: one's load and store overlap the other's scans.  That
// caps a thread at 64 registers, some 20 short, and the few spilled words
// cost less than the overlap gains (PERF.md).
__global__ void __launch_bounds__(32 * kScanWarps, 2)
propagate_scan_kernel(const int32_t* __restrict__ keys, const uint8_t* __restrict__ mask,
                      int32_t* __restrict__ out, int h, int w, int passes, int big) {
    // column resolves alternate between two buffers: a warp may publish the
    // next one's entries while another still reads this one's
    __shared__ ScanExchange xch[2];
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    const long long base = (long long)blockIdx.x * h * w;
    int4 v[kRows];
    const unsigned m = load_window(keys + base, mask + base, h, w, wp, lane, kNoKey, v);
    for (int k = 0; k < passes; ++k) {
        resolve_key_rows(v, m, lane);
        resolve_key_cols(v, m, xch[k & 1], wp, lane);
    }
    resolve_key_rows(v, m, lane);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        v[k].x = (m >> (4 * k) & 1u) ? v[k].x : big;
        v[k].y = (m >> (4 * k) & 2u) ? v[k].y : big;
        v[k].z = (m >> (4 * k) & 4u) ? v[k].z : big;
        v[k].w = (m >> (4 * k) & 8u) ? v[k].w : big;
    }
    store_window(out + base, h, w, wp, lane, v);
}

}  // namespace

// keys, out: i32 [n, h, w]; mask: u8 [n, h, w]; h, w <= 128
TSD_API int tsd_propagate_scan(const void* keys, const void* mask, void* out, int n,
                               int h, int w, int passes, int big, void* stream) {
    if (h > kWin || w > kWin) return (int)cudaErrorInvalidValue;
    if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
    propagate_scan_kernel<<<n, 32 * kScanWarps, 0, (cudaStream_t)stream>>>(
        (const int32_t*)keys, (const uint8_t*)mask, (int32_t*)out, h, w, passes, big);
    return (int)cudaGetLastError();
}

// planes: u8 [np, h, w]; cand: i32 [n, 6]; out: i32 [n, 5]; wh, ww <= 128
TSD_API int tsd_flood_bbox(const void* planes, const void* cand, void* out, int n,
                           int np, int h, int w, int wh, int ww, int passes,
                           int big, void* stream) {
    if (wh > kWin || ww > kWin) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    flood_bbox_kernel<<<tsd_blocks(n, kFloodWarps), kFloodWarps * 32, 0,
                        (cudaStream_t)stream>>>(
        (const uint8_t*)planes, (const int32_t*)cand, (int32_t*)out, n, np, h, w, wh,
        ww, passes, big);
    return (int)cudaGetLastError();
}
