// CLAHE kernels K1 (tile histograms) and K2 (interpolated LUT apply).
//
// K1 replaces opencv_traffic_sign_detector_tpu/ops/clahe_pallas.py:
// tile_histograms_pallas (_hist_kernel).  The TPU form looped over the 256
// bins with a compare and two 0/1 selector matmuls, because scatters are
// slow there.  On the H100 a shared-memory histogram with atomicAdd is the
// natural form: one block per (frame, tile) reads the tile's bytes once.
// Bound: device-memory reads of the frame (1 byte per pixel); shared-memory
// atomic contention on flat tiles is the second cost.  Exact: integer counts.
//
// K2 replaces clahe_pallas.py: clahe_apply_pallas (_apply_kernel).  The TPU
// form blended whole LUT columns with matmuls and a 256-step select loop to
// avoid gathers.  Here the frame's [T,T,256] u8 LUT set (16 KB at T=8) sits
// in shared memory and each thread reads its pixel's four LUT entries.
// Bound: device-memory traffic (1 byte in, 1 byte out per pixel); each block
// covers a band of rows so that the 16 KB LUT load is amortised.  The f32
// blend uses explicit round-to-nearest intrinsics in the order of
// opencv_traffic_sign_detector_tpu/ops/clahe.py:135-137, so rint ties fall
// exactly as in the plain version.
#include "tsd_common.cuh"

namespace {

constexpr int kMaxLutBytes = 8 * 8 * 256;
constexpr int kApplyRows = 8;

__global__ void tile_hist_kernel(const uint8_t* __restrict__ x,
                                 int32_t* __restrict__ out,
                                 int h, int w, int tiles) {
    __shared__ int hist[256];
    const int tile = blockIdx.x;
    const int b = blockIdx.y;
    const int ty = tile / tiles, tx = tile % tiles;
    const int th = h / tiles, tw = w / tiles;
    hist[threadIdx.x] = 0;
    __syncthreads();
    const uint8_t* base = x + (size_t)b * h * w + (size_t)ty * th * w + (size_t)tx * tw;
    const int n = th * tw;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / tw, c = i - r * tw;
        atomicAdd(&hist[base[(size_t)r * w + c]], 1);
    }
    __syncthreads();
    out[((size_t)b * tiles * tiles + tile) * 256 + threadIdx.x] = hist[threadIdx.x];
}

__global__ void clahe_apply_kernel(const uint8_t* __restrict__ x,
                                   const uint8_t* __restrict__ luts,
                                   const int32_t* __restrict__ ty1,
                                   const int32_t* __restrict__ ty2,
                                   const float* __restrict__ ya,
                                   const int32_t* __restrict__ tx1,
                                   const int32_t* __restrict__ tx2,
                                   const float* __restrict__ xa,
                                   uint8_t* __restrict__ out,
                                   int h, int w, int tiles) {
    __shared__ uint8_t lut[kMaxLutBytes];
    const int b = blockIdx.y;
    const int nlut = tiles * tiles * 256;
    const uint8_t* lb = luts + (size_t)b * nlut;
    for (int i = threadIdx.x; i < nlut; i += blockDim.x) lut[i] = lb[i];
    __syncthreads();

    const int r0 = blockIdx.x * kApplyRows;
    const int rows = min(kApplyRows, h - r0);
    const size_t fbase = (size_t)b * h * w;
    for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
        const int r = r0 + i / w, c = i % w;
        const size_t p = fbase + (size_t)r * w + c;
        const int v = x[p];
        const int row1 = ty1[r] * tiles, row2 = ty2[r] * tiles;
        const float p11 = (float)lut[(row1 + tx1[c]) * 256 + v];
        const float p12 = (float)lut[(row1 + tx2[c]) * 256 + v];
        const float p21 = (float)lut[(row2 + tx1[c]) * 256 + v];
        const float p22 = (float)lut[(row2 + tx2[c]) * 256 + v];
        const float fx = xa[c], fy = ya[r];
        const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
        const float top = __fadd_rn(__fmul_rn(p11, gx), __fmul_rn(p12, fx));
        const float bot = __fadd_rn(__fmul_rn(p21, gx), __fmul_rn(p22, fx));
        float o = rintf(__fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy)));
        o = fminf(fmaxf(o, 0.0f), 255.0f);
        out[p] = (uint8_t)o;
    }
}

}  // namespace

TSD_API int tsd_tile_histograms(const void* x, void* out, int b, int h, int w,
                                int tiles, void* stream) {
    dim3 grid(tiles * tiles, b);
    tile_hist_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, (int32_t*)out, h, w, tiles);
    return (int)cudaGetLastError();
}

TSD_API int tsd_clahe_apply(const void* x, const void* luts, const void* ty1,
                            const void* ty2, const void* ya, const void* tx1,
                            const void* tx2, const void* xa, void* out, int b,
                            int h, int w, int tiles, void* stream) {
    if (tiles * tiles * 256 > kMaxLutBytes) return (int)cudaErrorInvalidValue;
    dim3 grid((h + kApplyRows - 1) / kApplyRows, b);
    clahe_apply_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, (const uint8_t*)luts, (const int32_t*)ty1,
        (const int32_t*)ty2, (const float*)ya, (const int32_t*)tx1,
        (const int32_t*)tx2, (const float*)xa, (uint8_t*)out, h, w, tiles);
    return (int)cudaGetLastError();
}

TSD_API const char* tsd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
