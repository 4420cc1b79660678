// CLAHE kernels K1 (tile histograms, with the per-tile LUTs as a tail) and
// K2 (interpolated LUT apply).
//
// K1 replaces opencv_traffic_sign_detector_tpu/ops/clahe_pallas.py:
// tile_histograms_pallas (_hist_kernel).  The TPU form looped over the 256
// bins with a compare and two 0/1 selector matmuls, because scatters are
// slow there.  On the H100 a shared-memory histogram with atomicAdd is the
// natural form, and the work is one byte read a pixel: the bound is
// device-memory bytes.  What the kernel must avoid is per-pixel overhead
// (byte loads, a division a pixel) and atomics that serialise on one
// address (flat tiles: road, sky).  Its design:
// - a block takes a piece of the rows of one tile row across the frame's
//   full width (ops/clahe_cuda.py: hist_pieces): one contiguous run of
//   bytes, read as aligned 16-byte words whatever the width (the bytes
//   before the first and after the last aligned word go one a thread);
// - a word's tile column comes from one division a word; a word that
//   crosses a tile-column boundary, or the end of a row, steps its column
//   and tile pixel by pixel with compares only;
// - kHistCopies private sets of the tile row's histograms a block, two
//   warps a set, merged at the end; a 32-bit or 128-bit group of equal
//   bytes is counted with one add;
// - one piece a tile row: the merged counts are the histograms, stored or
//   (tile_luts) turned into LUTs in the same block; several pieces: integer
//   atomicAdd into an output zeroed on the same stream, exact in any order.
// The LUT tail replaces the reference's XLA steps between its two kernels
// (ops/clahe.py:42-73 there): OpenCV's clip rule, an inclusive integer
// cumsum over the 256 bins and rint(float(cdf) * f32(255 / area)), one warp
// a tile, 8 bins a lane, the sums by shuffles.  Exact: integers and one
// correctly rounded f32 product, ties to even.
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

// K1's block and its private histogram sets (ops/clahe_cuda.py:
// HIST_THREADS, HIST_COPIES).
constexpr int kHistThreads = 512;
constexpr int kHistCopies = 8;
constexpr int kLutThreads = 256;

// Four pixels of one tile column: one add where the bytes are equal.
__device__ __forceinline__ void count4(int* hp, uint32_t s) {
    if (s == __byte_perm(s, 0u, 0x0000)) {
        atomicAdd(hp + (s & 255u), 4);
        return;
    }
    atomicAdd(hp + (s & 255u), 1);
    atomicAdd(hp + (s >> 8 & 255u), 1);
    atomicAdd(hp + (s >> 16 & 255u), 1);
    atomicAdd(hp + (s >> 24), 1);
}

// Sixteen pixels from column c0 of a row of w = tiles * tw columns, the
// row's end wrapping to the next row's first column.  hist: [tiles][256].
__device__ __forceinline__ void count16(int* hist, uint4 q, int c0, int w, int tw) {
    int t = c0 / tw, nb = (t + 1) * tw;  // the tile column and its end
    if (c0 + kVec <= nb) {
        int* hp = hist + t * 256;
        if (q.x == q.y && q.y == q.z && q.z == q.w && q.x == __byte_perm(q.x, 0u, 0x0000)) {
            atomicAdd(hp + (q.x & 255u), kVec);
            return;
        }
        count4(hp, q.x);
        count4(hp, q.y);
        count4(hp, q.z);
        count4(hp, q.w);
        return;
    }
    const uint32_t ws[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
        int c = c0 + k;
        while (c >= nb) {
            if (nb >= w) {  // the row's end
                c0 -= w;
                c -= w;
                t = 0;
                nb = tw;
            } else {
                ++t;
                nb += tw;
            }
        }
        atomicAdd(hist + t * 256 + (ws[k >> 2] >> (8 * (k & 3)) & 255u), 1);
    }
}

__device__ __forceinline__ void load8(const int* p, int (&v)[8]) {
    if (aligned16(p)) {
        const int4 a = *reinterpret_cast<const int4*>(p), b = *reinterpret_cast<const int4*>(p + 4);
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
        v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = p[k];
    }
}

// One warp, one tile: the lane's bins 8 * lane .. + 7 of the histogram at
// `hist` -> the same entries of the LUT at `lut`.  OpenCV's clip rule (cap
// at clip, excess / 256 to every bin, the residual one a bin at stride
// max(256 / residual, 1)), inclusive cumsum, rint(float(cdf) * scale).
__device__ __forceinline__ void tile_lut(const int* hist, uint8_t* lut, int lane, int clip,
                                         float scale) {
    int hv[8];
    load8(hist + 8 * lane, hv);
    int excess = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) excess += max(hv[k] - clip, 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) excess += __shfl_xor_sync(0xffffffffu, excess, o);
    const int batch = excess >> 8, residual = excess & 255;
    const int step = max(256 / max(residual, 1), 1);
    int cdf[8], run = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int bin = 8 * lane + k;
        const int bonus = residual > 0 && bin % step == 0 && bin / step < residual;
        run += min(hv[k], clip) + batch + bonus;
        cdf[k] = run;
    }
    int upto = run;  // inclusive scan of the lanes' sums
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, upto, o);
        if (lane >= o) upto += t;
    }
    const int before = upto - run;
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int q = __float2int_rn(__fmul_rn(__int2float_rn(cdf[k] + before), scale));
        packed[k >> 2] |= (uint32_t)__vimin_s32_relu(q, 255) << (8 * (k & 3));
    }
    uint8_t* o = lut + 8 * lane;
    if ((reinterpret_cast<uintptr_t>(o) & 7) == 0) {
        *reinterpret_cast<uint2*>(o) = make_uint2(packed[0], packed[1]);
    } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = (uint8_t)(packed[k >> 2] >> (8 * (k & 3)));
    }
}

// grid (frames, tile rows, pieces); dynamic shared memory kHistCopies *
// tiles * 256 ints.  With kLuts (one piece a tile row only) the block turns
// its tile row's histograms into LUTs and writes those instead.
template <bool kLuts>
__global__ void __launch_bounds__(kHistThreads)
tile_hist_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ out,
                 uint8_t* __restrict__ luts, int h, int w, int tiles, int pieces, int clip,
                 float scale) {
    extern __shared__ __align__(16) int hist[];  // [kHistCopies][tiles][256]
    const int b = blockIdx.x, ty = blockIdx.y, piece = blockIdx.z;
    const int th = h / tiles, tw = w / tiles, bins = tiles * 256;
    const int r0 = ty * th + (int)((long long)piece * th / pieces);
    const int r1 = ty * th + (int)((long long)(piece + 1) * th / pieces);
    for (int i = threadIdx.x; i < kHistCopies * bins / 4; i += kHistThreads)
        reinterpret_cast<int4*>(hist)[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    int* mine = hist + (threadIdx.x >> 5) % kHistCopies * bins;

    // the piece is one run of bytes: head, aligned 16-byte words, tail
    const uint8_t* p = x + ((size_t)b * h + r0) * w;
    const unsigned n = (unsigned)(r1 - r0) * (unsigned)w;
    const unsigned head = min(n, (unsigned)(-reinterpret_cast<intptr_t>(p) & 15));
    const unsigned words = (n - head) / kVec, tail = head + kVec * words;
    for (unsigned i = threadIdx.x; i < head + (n - tail); i += kHistThreads) {
        const unsigned idx = i < head ? i : tail + (i - head);
        atomicAdd(mine + idx % w / tw * 256 + p[idx], 1);
    }
    const uint4* pw = reinterpret_cast<const uint4*>(p + head);
    for (unsigned i0 = threadIdx.x; i0 < words; i0 += 4 * kHistThreads) {
        uint4 q[4];  // four loads in flight
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (i0 + u * kHistThreads < words) q[u] = pw[i0 + u * kHistThreads];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const unsigned i = i0 + u * kHistThreads;
            if (i < words) count16(mine, q[u], (int)((head + kVec * i) % w), w, tw);
        }
    }
    __syncthreads();

    int32_t* o = out + ((size_t)b * tiles + ty) * bins;
    for (int i = threadIdx.x; i < bins; i += kHistThreads) {
        int s = 0;
#pragma unroll
        for (int c = 0; c < kHistCopies; ++c) s += hist[c * bins + i];
        if (kLuts) hist[i] = s;  // bin i of every set is this thread's alone
        else if (pieces == 1) o[i] = s;
        else if (s) atomicAdd(o + i, s);
    }
    if (kLuts) {
        __syncthreads();
        for (int tx = threadIdx.x >> 5; tx < tiles; tx += kHistThreads / 32)
            tile_lut(hist + tx * 256, luts + (((size_t)b * tiles + ty) * tiles + tx) * 256,
                     threadIdx.x & 31, clip, scale);
    }
}

// hist: i32 [n, 256] -> luts: u8 [n, 256], a warp a tile.
__global__ void __launch_bounds__(kLutThreads)
tile_lut_kernel(const int32_t* __restrict__ hist, uint8_t* __restrict__ luts, int n, int clip,
                float scale) {
    const int tile = blockIdx.x * (kLutThreads / 32) + (threadIdx.x >> 5);
    if (tile < n) tile_lut(hist + (size_t)tile * 256, luts + (size_t)tile * 256,
                           threadIdx.x & 31, clip, scale);
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

namespace {

// Launches K1 over pieces of tile rows; with luts, one piece and the tail.
int launch_hist(const void* x, void* out, void* luts, int b, int h, int w, int tiles,
                int pieces, int clip, float scale, cudaStream_t st) {
    if (tiles < 1 || tiles > kMaxTiles || h % tiles || w % tiles || pieces < 1 ||
        pieces > 65535 || (luts != nullptr && pieces != 1) ||
        (long long)(h / tiles) * w > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (b == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
    const int smem = kHistCopies * tiles * 256 * (int)sizeof(int);
    auto kernel = luts != nullptr ? tile_hist_kernel<true> : tile_hist_kernel<false>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (pieces > 1) {
        e = cudaMemsetAsync(out, 0, (size_t)b * tiles * tiles * 256 * sizeof(int32_t), st);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<dim3(b, tiles, pieces), kHistThreads, smem, st>>>(
        (const uint8_t*)x, (int32_t*)out, (uint8_t*)luts, h, w, tiles, pieces, clip, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// x: u8 [b, h, w]; out: i32 [b, tiles, tiles, 256].  pieces: blocks a tile
// row (ops/clahe_cuda.py: hist_pieces); above 1 the blocks add into `out`,
// zeroed here on the same stream.
TSD_API int tsd_tile_histograms(const void* x, void* out, int b, int h, int w,
                                int tiles, int pieces, void* stream) {
    return launch_hist(x, out, nullptr, b, h, w, tiles, pieces, 0, 0.0f, (cudaStream_t)stream);
}

// x -> luts: u8 [b, tiles, tiles, 256].  One piece a tile row: one launch,
// the LUTs from the block's own counts, `hist` unused.  Several: the
// histograms into hist (i32 [b, tiles, tiles, 256]), then a warp a tile.
TSD_API int tsd_tile_luts(const void* x, void* hist, void* luts, int b, int h, int w,
                          int tiles, int pieces, int clip, float scale, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (pieces == 1) return launch_hist(x, nullptr, luts, b, h, w, tiles, 1, clip, scale, st);
    if (hist == nullptr) return (int)cudaErrorInvalidValue;
    const int rc = launch_hist(x, hist, nullptr, b, h, w, tiles, pieces, 0, 0.0f, st);
    const long long n = (long long)b * tiles * tiles;
    if (rc != 0 || n == 0) return rc;
    const int per_block = kLutThreads / 32;
    tile_lut_kernel<<<(unsigned)((n + per_block - 1) / per_block), kLutThreads, 0, st>>>(
        (const int32_t*)hist, (uint8_t*)luts, (int)n, clip, scale);
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
