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
// avoid gathers.  The work is 1 byte in and 1 byte out a pixel with ~20 f32
// operations between, so the bound is device-memory bytes; what the kernel
// must avoid is per-pixel overhead (LUT loads, index arithmetic, slow
// conversions) and exposed load latency.  Its design:
// - a block owns a piece of at most 32 rows of a strip in which the (top,
//   bottom) tile rows are constant (the launch plan, ops/clahe_cuda.py:
//   apply_plan, from the coordinate rule itself) and a 512-column segment.
//   It copies only those two LUT rows, and packs, for each column case of
//   its segment (which two tile columns it blends) and each value, the four
//   LUT bytes into one word: one shared-memory load a pixel;
// - the piece's pixels come in by asynchronous 16-byte copies into shared
//   memory, issued with the LUT rows' copies before anything waits: one
//   round of load latency a block (a second round, so that half the rows
//   arrive while the first half is blended, measured no gain);
// - a thread owns 16 contiguous columns, their weights and cases in
//   registers; its warp walks the piece's rows with one row weight each and
//   stores its 16 pixels as one uint4;
// - bytes become floats as 2^23 + b - 2^23 and the rounding is the add of
//   1.5 * 2^23, both exact, so no conversion-pipe instruction is left.
// Blocks of two warps keep more pieces in flight on an SM than larger ones
// (measured: 128 and 256 threads were slower).  The blend keeps
// opencv_traffic_sign_detector_tpu/ops/clahe.py:135-137's f32 operations in
// their order, each rounded on its own (no FMA): bit for bit the plain
// version.
#include "tsd_common.cuh"

#include <cuda_pipeline.h>

namespace {

constexpr int kMaxTiles = 8;
constexpr int kApplyThreads = 64;
constexpr int kVec = 16;                  // pixels a thread loads and stores at once
constexpr int kSegCols = 32 * kVec;       // columns a block covers (ops/clahe_cuda.py: SEG_COLS)
constexpr int kTileRows = 32;             // most rows of a piece (ops/clahe_cuda.py: PIECE_ROWS)

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

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

// Byte i of e as an exact float: the bytes (e_i, 0, 0, 0x4b) are the float
// 2^23 + e_i.
__device__ __forceinline__ float byte_float(uint32_t e, int i) {
    return __fsub_rn(__uint_as_float(__byte_perm(e, 0x4b000000u, 0x7540 | i)), 8388608.0f);
}

// One pixel: e packs LUT[top][tx1][v], LUT[top][tx2][v], LUT[bottom][tx1][v],
// LUT[bottom][tx2][v].  rint(o) of |o| < 2^22 is the float o + 1.5 * 2^23
// (spacing 1 there, ties to even on an even offset), read back from its bits.
__device__ __forceinline__ int blend(uint32_t e, float fx, float gy, float fy) {
    const float gx = __fsub_rn(1.0f, fx);
    const float top = __fadd_rn(__fmul_rn(byte_float(e, 0), gx), __fmul_rn(byte_float(e, 1), fx));
    const float bot = __fadd_rn(__fmul_rn(byte_float(e, 2), gx), __fmul_rn(byte_float(e, 3), fx));
    const float o = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
    const int q = __float_as_int(__fadd_rn(o, 12582912.0f)) - 0x4b400000;
    return __vimin_s32_relu(q, 255);  // max(min(q, 255), 0)
}

// plan: [pieces, 4] int32 (r0, r1, ty1, ty2), r1 - r0 <= kTileRows;
// ya: f32 [h]; col_case: i32 [w], the column's (tx1, tx2) as case k =
// (max(k-1, 0), min(k, tiles-1)), at most max_cases in a segment; xa: f32
// [w].  grid (pieces, segments, frames); dynamic shared memory
// apply_smem_bytes(tiles, max_cases).
__host__ __device__ constexpr int apply_smem_bytes(int tiles, int max_cases) {
    return kTileRows * kSegCols + 2 * tiles * 256 + max_cases * 256 * 4;
}

__global__ void __launch_bounds__(kApplyThreads)
clahe_apply_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ luts,
                   const int4* __restrict__ plan, const float* __restrict__ ya,
                   const int32_t* __restrict__ col_case, const float* __restrict__ xa,
                   uint8_t* __restrict__ out, int h, int w, int tiles, int max_cases) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* tile = smem;                                // [kTileRows][kSegCols]
    uint8_t* lut_rows = tile + kTileRows * kSegCols;     // [2][tiles * 256]
    uint32_t* tab = reinterpret_cast<uint32_t*>(lut_rows + 2 * tiles * 256);  // [cases][256]
    const int b = blockIdx.z;
    const int4 piece = plan[blockIdx.x];
    const int c0 = blockIdx.y * kSegCols, ncol = min(kSegCols, w - c0);
    const int rows = min(piece.y - piece.x, kTileRows);
    const int row_bytes = tiles * 256;
    const uint8_t* xb = x + ((size_t)b * h + piece.x) * w + c0;
    uint8_t* ob = out + ((size_t)b * h + piece.x) * w + c0;

    // 1. one round of asynchronous copies: the strip's two LUT rows and the
    // block's 16-byte-aligned pixel vectors; meanwhile each thread loads its
    // 16 columns' weights and cases
    for (int i = threadIdx.x; i < rows * 32; i += kApplyThreads) {
        const int rr = i >> 5, cv = (i & 31) * kVec;
        const uint8_t* g = xb + (size_t)rr * w + cv;
        if (cv + kVec <= ncol && aligned16(g)) __pipeline_memcpy_async(tile + rr * kSegCols + cv, g, 16);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const uint8_t* src = luts + ((size_t)b * tiles + (half ? piece.w : piece.z)) * row_bytes;
        uint8_t* dst = lut_rows + half * row_bytes;
        if (aligned16(src)) {
            for (int i = threadIdx.x; i < row_bytes / 16; i += kApplyThreads)
                __pipeline_memcpy_async(dst + 16 * i, src + 16 * i, 16);
        } else {
            for (int i = threadIdx.x; i < row_bytes; i += kApplyThreads) dst[i] = src[i];
        }
    }
    __pipeline_commit();

    const int cv = (threadIdx.x & 31) * kVec;
    const int nv = max(min(kVec, ncol - cv), 0);
    const int k0 = col_case[c0], k1 = col_case[c0 + ncol - 1];
    float fx[kVec];
    int base[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
        fx[i] = i < nv ? xa[c0 + cv + i] : 0.0f;
        base[i] = i < nv ? (col_case[c0 + cv + i] - k0) * 256 : 0;
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    // 2. the four LUT bytes of each column case and value, packed
    for (int i = threadIdx.x; i < min(k1 - k0 + 1, max_cases) * 256; i += kApplyThreads) {
        const int k = k0 + (i >> 8), v = i & 255;
        const int a = max(k - 1, 0) * 256 + v, c = min(k, tiles - 1) * 256 + v;
        const uint8_t* bot = lut_rows + row_bytes;
        tab[i] = (uint32_t)lut_rows[a] | (uint32_t)lut_rows[c] << 8 | (uint32_t)bot[a] << 16 |
                 (uint32_t)bot[c] << 24;
    }
    __syncthreads();

    // 3. a thread's 16 columns down the piece's rows, a warp a row
    for (int rr = threadIdx.x >> 5; rr < piece.y - piece.x && nv > 0; rr += kApplyThreads / 32) {
        const float fy = ya[piece.x + rr], gy = __fsub_rn(1.0f, fy);
        const uint8_t* g = xb + (size_t)rr * w + cv;
        uint8_t* o = ob + (size_t)rr * w + cv;
        const bool staged = rr < rows && nv == kVec && aligned16(g);  // as copied above
        if (staged && aligned16(o)) {
            const uint4 in = *reinterpret_cast<const uint4*>(tile + rr * kSegCols + cv);
            const uint32_t iw[4] = {in.x, in.y, in.z, in.w};
            uint32_t ow[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int q[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int i = 4 * j + k;
                    q[k] = blend(tab[base[i] + __byte_perm(iw[j], 0u, 0x4440 | k)], fx[i], gy, fy);
                }
                ow[j] = __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                                    __byte_perm(q[2], q[3], 0x0040), 0x5410);
            }
            *reinterpret_cast<uint4*>(o) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
        } else {  // a row not 16-byte aligned, or the segment's ragged end
#pragma unroll
            for (int i = 0; i < kVec; ++i) {
                if (i < nv) {
                    const int v = staged ? tile[rr * kSegCols + cv + i] : g[i];
                    o[i] = (uint8_t)blend(tab[base[i] + v], fx[i], gy, fy);
                }
            }
        }
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

TSD_API int tsd_clahe_apply(const void* x, const void* luts, const void* plan,
                            const void* ya, const void* col_case, const void* xa,
                            void* out, int pieces, int b, int h, int w, int tiles,
                            int max_cases, void* stream) {
    if (tiles < 1 || tiles > kMaxTiles || max_cases < 1 || max_cases > tiles + 1 || b > 65535)
        return (int)cudaErrorInvalidValue;
    if (pieces == 0 || b == 0 || w == 0) return (int)cudaGetLastError();
    dim3 grid(pieces, (w + kSegCols - 1) / kSegCols, b);
    clahe_apply_kernel<<<grid, kApplyThreads, apply_smem_bytes(tiles, max_cases),
                         (cudaStream_t)stream>>>(
        (const uint8_t*)x, (const uint8_t*)luts, (const int4*)plan, (const float*)ya,
        (const int32_t*)col_case, (const float*)xa, (uint8_t*)out, h, w, tiles, max_cases);
    return (int)cudaGetLastError();
}

TSD_API const char* tsd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
