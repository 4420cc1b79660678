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
// the same flood on int32 keys without the reduction: one block per
// [<=128, <=128] plane resolves key runs in shared memory (66 KB of keys,
// dynamic), one thread walking each row or column run by run, and writes
// the keys back.  Bound by those sequential walks (128 dependent steps a
// thread, four warps a block), not by its 128 KB a plane of keys.
#include "tsd_common.cuh"

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
// out instead of reduced.  Equal to the reference's Hillis-Steele doubling
// when the plane's border rows and columns are masked off (its documented
// precondition): runs then never wrap.
constexpr int kStride = 132;     // mask row stride in bytes: 33 words, no bank conflicts
constexpr int kKeyStride = 129;  // words: odd, so row and column walks are conflict-free

__device__ void min_runs(const uint8_t* m, int32_t* k, int n_lines, int len,
                         int m_line, int m_step, int k_line, int k_step) {
    const int line = threadIdx.x;
    if (line >= n_lines) return;
    const uint8_t* ml = m + line * m_line;
    int32_t* kl = k + line * k_line;
    int i = 0;
    while (i < len) {
        if (!ml[i * m_step]) {
            ++i;
            continue;
        }
        const int start = i;
        int mn = kl[i * k_step];
        while (i < len && ml[i * m_step]) mn = min(mn, kl[(i++) * k_step]);
        for (int j = start; j < i; ++j) kl[j * k_step] = mn;
    }
}

__global__ void propagate_scan_kernel(const int32_t* __restrict__ keys,
                                      const uint8_t* __restrict__ mask,
                                      int32_t* __restrict__ out, int h, int w,
                                      int passes, int big) {
    extern __shared__ int32_t ks[];
    uint8_t* m = reinterpret_cast<uint8_t*>(ks + kWin * kKeyStride);
    const long long base = (long long)blockIdx.x * h * w;
    for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
        const int r = i / w, c = i - r * w;
        const bool mk = mask[base + i] != 0;
        m[r * kStride + c] = mk;
        ks[r * kKeyStride + c] = mk ? keys[base + i] : big;
    }
    __syncthreads();
    for (int k = 0; k <= passes; ++k) {
        min_runs(m, ks, h, w, kStride, 1, kKeyStride, 1);  // rows
        __syncthreads();
        if (k == passes) break;
        min_runs(m, ks, w, h, 1, kStride, 1, kKeyStride);  // columns
        __syncthreads();
    }
    for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
        const int r = i / w, c = i - r * w;
        out[base + i] = ks[r * kKeyStride + c];
    }
}

constexpr int kScanSmem = kWin * kKeyStride * 4 + kWin * kStride;

}  // namespace

// keys, out: i32 [n, h, w]; mask: u8 [n, h, w]; h, w <= 128
TSD_API int tsd_propagate_scan(const void* keys, const void* mask, void* out, int n,
                               int h, int w, int passes, int big, void* stream) {
    if (h > kWin || w > kWin) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    cudaError_t e = cudaFuncSetAttribute(
        propagate_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kScanSmem);
    if (e != cudaSuccess) return (int)e;
    propagate_scan_kernel<<<n, kWin, kScanSmem, (cudaStream_t)stream>>>(
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
