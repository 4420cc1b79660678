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
// Two forms, both ping-pong:
// * resident: when a plane's two key buffers and its mask fit one block's
//   shared memory (the refine's 128x128 windows: 2 x 64 KB + 16 KB), one
//   block owns one plane and runs all K passes there, as the TPU keeps the
//   plane in VMEM; device memory is read and written once.  Bound: shared
//   memory bandwidth (5 loads and 1 store per pixel per pass), one block
//   per SM.
// * streaming: larger planes (the sweep's 402x682, 1.1 MB of keys) cannot
//   stay on chip, so each pass is one launch over all planes, reading the
//   last pass's keys from device memory (mostly L2) into a second buffer.
//   Bound: memory traffic, about 9 bytes per pixel per pass.  Fusing
//   passes in shared-memory tiles with halos is later work.
#include "tsd_common.cuh"

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

// One pass: reads `src`, writes `dst`.  With `premask` the source is the
// caller's unmasked keys and every read applies the mask first.
__global__ void rolls_pass_kernel(const int32_t* __restrict__ src,
                                  const uint8_t* __restrict__ mask,
                                  int32_t* __restrict__ dst, int h, int w,
                                  long long total, int big, int premask) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= total) return;
    if (!mask[p]) {
        dst[p] = big;
        return;
    }
    const int hw = h * w;
    const long long base = p - p % hw;
    const int local = (int)(p - base);
    const int row = local / w, col = local - row * w;
    const long long up = base + (row == 0 ? h - 1 : row - 1) * w + col;
    const long long dn = base + (row == h - 1 ? 0 : row + 1) * w + col;
    const long long lf = base + row * w + (col == 0 ? w - 1 : col - 1);
    const long long rt = base + row * w + (col == w - 1 ? 0 : col + 1);
    auto ld = [&](long long q) { return (premask && !mask[q]) ? big : src[q]; };
    dst[p] = min(src[p], min(min(ld(up), ld(dn)), min(ld(lf), ld(rt))));
}

}  // namespace

// keys, out: i32 [p, h, w]; mask: u8 [p, h, w]; scratch: i32 [p, h, w], or
// null when a plane fits shared memory (tsd_propagate_rolls_resident).
TSD_API int tsd_propagate_rolls_resident(int h, int w) {
    return resident_bytes(h, w) <= kResidentBytes;
}

TSD_API int tsd_propagate_rolls(const void* keys, const void* mask, void* out,
                                void* scratch, int p, int h, int w, int passes,
                                int big, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t* k = (const int32_t*)keys;
    const uint8_t* m = (const uint8_t*)mask;
    int32_t* o = (int32_t*)out;
    if (p == 0) return (int)cudaGetLastError();
    if (resident_bytes(h, w) <= kResidentBytes) {
        const int smem = (int)resident_bytes(h, w);
        cudaError_t e = cudaFuncSetAttribute(
            rolls_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        rolls_resident_kernel<<<p, dim3(32, 32), smem, st>>>(k, m, o, h, w, passes, big);
        return (int)cudaGetLastError();
    }
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const long long total = (long long)p * h * w;
    const int blocks = tsd_blocks(total, kThreads);
    if (passes == 0) {
        rolls_mask_kernel<<<blocks, kThreads, 0, st>>>(k, m, o, total, big);
        return (int)cudaGetLastError();
    }
    // pass i writes `out` when K-1-i is even, so the last pass lands there
    int32_t* bufs[2] = {o, (int32_t*)scratch};
    const int32_t* src = k;
    for (int i = 0; i < passes; ++i) {
        int32_t* dst = bufs[(passes - 1 - i) % 2];
        rolls_pass_kernel<<<blocks, kThreads, 0, st>>>(src, m, dst, h, w, total, big, i == 0);
        src = dst;
    }
    return (int)cudaGetLastError();
}
