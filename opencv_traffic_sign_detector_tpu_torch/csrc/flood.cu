// K4: per-candidate seed flood with bbox and pixel-area reduction.
//
// Replaces opencv_traffic_sign_detector_tpu/ops/pallas_prop.py:
// flood_bbox_pallas (_flood_bbox_kernel).  The TPU form takes materialised
// [N,128,128] seed maps and masks and resolves mask runs with Hillis-Steele
// doubling over rolled copies, because its vector unit cannot scan.  Here one
// block owns one candidate window: it reads the 128x128 window straight from
// the padded native intensity planes at the candidate's origin, builds the
// mask (pixel <= level, inner ring only) and the one-byte reach map (the
// seed) in shared memory, and resolves runs with one thread per row (or per
// column) scanning each mask run: if any pixel of a run is reached, the
// whole run is.  Passes run in the order H,V,...,H,V,H as in the reference;
// the result equals the reference's segmented run-min of a {0 at seed, big
// elsewhere} map, whose runs never wrap because the inner ring is masked.
// Bound: the sequential row and column scans (128 steps per thread, four
// warps per block) and the 16 KB window read; 4096 windows fill the card
// about 30 blocks deep.  Output is [N,5] int32 (ymin, ymax, xmin, xmax,
// area); an empty component gives (big, -1, big, -1, 0) like the reference.
//
// K6 below replaces pallas_prop.py: propagate_scan_pallas (_scan_kernel),
// K4's flood without the reduction: one block per [<=128, <=128] plane
// resolves int32 key runs in shared memory (66 KB of keys, dynamic) and
// writes the keys back.  Bound like K4 by the sequential run walks.
#include "tsd_common.cuh"

namespace {

constexpr int kWin = 128;
constexpr int kStride = 132;  // row stride in bytes: 33 words, no bank conflicts

__device__ void resolve_rows(const uint8_t* m, uint8_t* reach, int wh, int ww) {
    const int r = threadIdx.x;
    if (r >= wh) return;
    const uint8_t* mr = m + r * kStride;
    uint8_t* rr = reach + r * kStride;
    int c = 0;
    while (c < ww) {
        if (!mr[c]) {
            ++c;
            continue;
        }
        const int start = c;
        int any = 0;
        while (c < ww && mr[c]) any |= rr[c++];
        if (any)
            for (int j = start; j < c; ++j) rr[j] = 1;
    }
}

__device__ void resolve_cols(const uint8_t* m, uint8_t* reach, int wh, int ww) {
    const int c = threadIdx.x;
    if (c >= ww) return;
    int r = 0;
    while (r < wh) {
        if (!m[r * kStride + c]) {
            ++r;
            continue;
        }
        const int start = r;
        int any = 0;
        while (r < wh && m[r * kStride + c]) any |= reach[(r++) * kStride + c];
        if (any)
            for (int j = start; j < r; ++j) reach[j * kStride + c] = 1;
    }
}

// cand rows: (plane, y0, x0, seed_y, seed_x, level) int32.  Plane and origin
// are clamped so that the window lies inside the planes, as the reference's
// dynamic_slice clamps its start indices.
__global__ void flood_bbox_kernel(const uint8_t* __restrict__ planes,
                                  const int32_t* __restrict__ cand,
                                  int32_t* __restrict__ out, int np, int h,
                                  int w, int wh, int ww, int passes, int big) {
    __shared__ uint8_t m[kWin * kStride];
    __shared__ uint8_t reach[kWin * kStride];
    __shared__ int red[5];
    const int n = blockIdx.x;
    const int32_t* cd = cand + n * 6;
    const int plane = min(max(cd[0], 0), np - 1);
    const int y0 = min(max(cd[1], 0), h - wh), x0 = min(max(cd[2], 0), w - ww);
    const int sy = cd[3], sx = cd[4], level = cd[5];
    const uint8_t* src = planes + (size_t)plane * h * w;
    for (int i = threadIdx.x; i < wh * ww; i += blockDim.x) {
        const int r = i / ww, c = i - r * ww;
        const bool inner = r > 0 && r < wh - 1 && c > 0 && c < ww - 1;
        const bool mk = inner && (int)src[(size_t)(y0 + r) * w + x0 + c] <= level;
        m[r * kStride + c] = mk;
        reach[r * kStride + c] = mk && r == sy && c == sx;
    }
    if (threadIdx.x == 0) {
        red[0] = big;  // ymin
        red[1] = -1;   // ymax
        red[2] = big;  // xmin
        red[3] = -1;   // xmax
        red[4] = 0;    // area
    }
    __syncthreads();
    for (int k = 0; k < passes; ++k) {
        resolve_rows(m, reach, wh, ww);
        __syncthreads();
        resolve_cols(m, reach, wh, ww);
        __syncthreads();
    }
    resolve_rows(m, reach, wh, ww);
    __syncthreads();

    const int r = threadIdx.x;
    if (r < wh) {
        int cnt = 0, cmin = big, cmax = -1;
        for (int c = 0; c < ww; ++c) {
            if (reach[r * kStride + c]) {
                ++cnt;
                cmin = min(cmin, c);
                cmax = c;
            }
        }
        if (cnt) {
            atomicMin(&red[0], r);
            atomicMax(&red[1], r);
            atomicMin(&red[2], cmin);
            atomicMax(&red[3], cmax);
            atomicAdd(&red[4], cnt);
        }
    }
    __syncthreads();
    if (threadIdx.x < 5) out[n * 5 + threadIdx.x] = red[threadIdx.x];
}

// K6 (propagate_scan): the same H,V,...,H run resolves on int32 keys, each
// run taking the minimum key of its pixels, and the resolved keys written
// out instead of reduced.  Equal to the reference's Hillis-Steele doubling
// when the plane's border rows and columns are masked off (its documented
// precondition): runs then never wrap.
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

// planes: u8 [np, h, w]; cand: i32 [n, 6]; out: i32 [n, 5]
TSD_API int tsd_flood_bbox(const void* planes, const void* cand, void* out, int n,
                           int np, int h, int w, int wh, int ww, int passes,
                           int big, void* stream) {
    if (wh > kWin || ww > kWin) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    flood_bbox_kernel<<<n, kWin, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)planes, (const int32_t*)cand, (int32_t*)out, np, h, w, wh,
        ww, passes, big);
    return (int)cudaGetLastError();
}
