// Crop and bilinear resize of boxes through their 192-px windows: the
// CUDA form of ops/resize.py: _crop_resize_window.
//
// It replaces no TPU kernel: the JAX package leaves its window path to XLA
// (opencv_traffic_sign_detector_tpu/ops/resize.py).  It was added because
// that path, run as PyTorch operators on the card, spends ~9 ms a batch of
// 32 x 128 boxes moving data for a 7.7 MB result: a 192x192xC uint8 window
// gathered for each box, widened to f32, and two hat-weight matrix
// products, [S, 192] x [192, 192 C] and [S, 192] x [192, C], in whose
// 192-term sums at most two terms are not zero.  Each output sample needs
// at most four input bytes a channel (two window rows by two columns), so
// the least the work takes is bytes and f32 operations about even: ~9.6 MB
// (the distinct taps, most of them hits in L2, the coordinates and the
// crops) and 14 operations an output byte, ~3 us a batch at 25x25x3
// (chip_smoke.py's bound).
//
// Design: a warp takes one output row of one box (the rows of consecutive
// boxes side by side in a block), a lane one output column (a second one
// for out_size over 32).  The warp shares the row's two window rows and
// weights; neighbouring lanes read neighbouring columns, so their taps
// share cache lines, through the read-only path.  Nothing is staged in
// shared memory: a sample is a few independent gathers, bound by their
// latency, and 4096 boxes x 25 rows give the SMs warps enough to hide it.
//
// Arithmetic, bit for bit the window path as the card computes it in f32
// with TF32 off: window row k (and column k) weighs max(1 - |rel - k|, 0),
// the plain version's own f32 expression, which is exactly 0 but at
// k = floor(rel) and floor(rel) + 1; that second tap exists only while it
// lies inside the window (k + 1 <= 191: boxes over 192 px are edge-clamped,
// rel at most 191).  The other 190 terms of each sum add exact zeros, so
// only the order of the two that are left counts, and cuBLAS's choice of
// kernel for each product sets it.  cuBLAS chooses by the whole shape and
// by its version; the order below was read on the card with torch
// 2.11.0+cu128, CUDA 12.8 and cuBLASLt 120902, and chip_smoke.py phase 4
// holds it at the detection path's call, the shapes of every other caller
// (recognition, both trainers, parallel/train.py) and 2**20 random boxes.
// Another cuBLAS may choose otherwise: run that phase again on it.
// - the row pass, and the column pass for C = 3, run as SIMT GEMMs, which
//   sum into one accumulator from 0, k ascending, by FFMA:
//   fma(w_hi, p_hi, w_lo * p_lo);
// - the column pass for C = 1 is a matrix-vector product (gemv2T), whose
//   threads take neighbouring k apart and add their rounded products after:
//   w_lo * t_lo + w_hi * t_hi, each rounded.
// Where out_size is a power of 2 every product and sum is exact and any
// order gives the same.  All are written with the _rn intrinsics, so that
// the compiler can neither contract nor split them; then rint (half to
// even, as torch.round), a clamp to 0..255 and uint8.
#include "tsd_common.cuh"

namespace {

constexpr int kWin = 192;    // ops/resize.py: _CROP_WIN
constexpr int kMaxOut = 64;  // the largest out_size (ops/resize.py: CROP_MAX_OUT)
constexpr int kWarps = 8;    // output rows a block

struct Taps {
    int k;         // the first tap, floor(rel)
    float lo, hi;  // the weights of taps k and k + 1
    bool has_hi;   // tap k + 1 lies inside the window
};

__device__ __forceinline__ float hat(float rel, int k) {
    return fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(rel, (float)k))), 0.0f);
}

__device__ __forceinline__ Taps taps(float rel) {
    Taps t;
    t.k = (int)floorf(rel);
    t.has_hi = t.k + 1 < kWin;
    t.lo = hat(rel, t.k);
    t.hi = t.has_hi ? hat(rel, t.k + 1) : 0.0f;
    return t;
}

// The two non-zero terms of one hat-weight sum, in the GEMM's order.
__device__ __forceinline__ float two_taps(const Taps& t, float lo, float hi) {
    const float first = __fmul_rn(t.lo, lo);
    return t.has_hi ? __fmaf_rn(t.hi, hi, first) : first;
}

// The column pass: the GEMM's order, or for one channel the matrix-vector
// product's sum of two rounded products.
template <int C>
__device__ __forceinline__ float column_pass(const Taps& t, float lo, float hi) {
    if (C != 1) return two_taps(t, lo, hi);
    const float first = __fmul_rn(t.lo, lo);
    return t.has_hi ? __fadd_rn(first, __fmul_rn(t.hi, hi)) : first;
}

// image [frames, h, w, C] u8; wy0, wx0 [boxes] i64 window origins;
// rel_y, rel_x [boxes, s] f32 sample coordinates in the window;
// out [boxes, s, s, C] u8; a box's frame is box / n.
template <int C>
__global__ void __launch_bounds__(kWarps * 32)
crop_resize_kernel(const uint8_t* __restrict__ image, const int64_t* __restrict__ wy0,
                   const int64_t* __restrict__ wx0, const float* __restrict__ rel_y,
                   const float* __restrict__ rel_x, uint8_t* __restrict__ out,
                   long long rows, int n, int h, int w, int s) {
    const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= rows) return;
    const int lane = threadIdx.x & 31;
    const long long box = row / s;
    const Taps ty = taps(__ldg(rel_y + row));
    const size_t pitch = (size_t)w * C;
    const uint8_t* r0 = image + ((size_t)(box / n) * h + __ldg(wy0 + box) + ty.k) * pitch
                        + (size_t)__ldg(wx0 + box) * C;
    const uint8_t* r1 = ty.has_hi ? r0 + pitch : r0;
    const float* rx = rel_x + box * s;
    uint8_t* o = out + row * s * C;
    for (int j = lane; j < s; j += 32) {
        const Taps tx = taps(__ldg(rx + j));
        const uint8_t* a = r0 + tx.k * C;
        const uint8_t* b = r1 + tx.k * C;
        const int next = tx.has_hi ? C : 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float t_lo = two_taps(ty, (float)__ldg(a + c), (float)__ldg(b + c));
            const float t_hi = two_taps(ty, (float)__ldg(a + next + c), (float)__ldg(b + next + c));
            const float v = rintf(column_pass<C>(tx, t_lo, t_hi));
            o[j * C + c] = (uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);
        }
    }
}

}  // namespace

// image [b, h, w, c] u8 (h, w >= 192), wy0 and wx0 [b, n] i64, rel_y and
// rel_x [b, n, s] f32 -> out [b, n, s, s, c] u8.  c is 1 or 3, s 1 to 64.
TSD_API int tsd_crop_resize(const void* image, const void* wy0, const void* wx0,
                            const void* rel_y, const void* rel_x, void* out, int b, int n,
                            int h, int w, int c, int s, void* stream) {
    if ((c != 1 && c != 3) || s < 1 || s > kMaxOut || h < kWin || w < kWin || b < 0 || n < 0)
        return (int)cudaErrorInvalidValue;
    const long long rows = (long long)b * n * s;
    if (rows == 0) return (int)cudaGetLastError();
    const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
    cudaStream_t st = (cudaStream_t)stream;
    const auto* img = (const uint8_t*)image;
    const auto *y0 = (const int64_t*)wy0, *x0 = (const int64_t*)wx0;
    const auto *ry = (const float*)rel_y, *rx = (const float*)rel_x;
    if (c == 1)
        crop_resize_kernel<1><<<blocks, kWarps * 32, 0, st>>>(img, y0, x0, ry, rx,
                                                               (uint8_t*)out, rows, n, h, w, s);
    else
        crop_resize_kernel<3><<<blocks, kWarps * 32, 0, st>>>(img, y0, x0, ry, rx,
                                                               (uint8_t*)out, rows, n, h, w, s);
    return (int)cudaGetLastError();
}
