// K3: the fused MSER level sweep with in-kernel level collapse.
//
// Replaces opencv_traffic_sign_detector_tpu/ops/mser_pallas.py:
// fused_level_sweep (_collapsed_kernel + _sweep_body).  On the TPU the
// whole sweep state of one strip window stays in VMEM across all levels.
// One window here is ~0.28 M pixels with ~30 bytes of state per pixel
// (8 MB), far beyond one SM's 227 KB of shared memory, so this first form
// keeps the state planes in device memory and runs every window of the
// batch (frame x polarity x strip) in one grid per launch.  Per level it
// launches an init/warm-start step, 2*ccl_iters Jacobi passes, and one emit
// step.  Bound: device-memory bandwidth; each pass reads and writes the
// five int32 planes (about 40 bytes per pixel with the 4-neighbour reads
// mostly served by L1/L2).  Fusing passes into shared-memory tiles with
// halos is the work of a later change.
//
// Semantics carried over exactly from the reference:
// * Jacobi passes: every pass reads the previous pass's planes (ping-pong
//   buffers).  An in-place update would propagate further and change the
//   candidates; the truncation at 2*ccl_iters passes is load-bearing.
// * The reference exits the pass loop early when a full pass changes
//   nothing.  That only fires at a fixed point, where further passes change
//   nothing either, so running all passes gives the identical state.
// * Within a pass, a pixel's bbox channels use live = mask & (new key >= 0).
// * Neighbour reads wrap modulo the window, as pltpu.roll does; the
//   window's first and last rows are masked off.
// * Rings are bf16, stored with round-to-nearest-even; the variation's
//   division is IEEE f32 (never build with --use_fast_math).
// * Output comes only from the core rows: max over levels of
//   (qv << lbits) | t.
//
// K7 (tsd_level_sweep_full) replaces mser_pallas.py: fused_level_sweep_full
// (_full_kernel), the same body over one strip per plane (no halo, the
// plane's real width) writing each level's byte qv, cast through int32 to
// u8, for every row into [P, L, H, W] instead of folding the running max.
// It is the reference's oracle that pairs K3 with the XLA sweep; it adds
// one byte per pixel per level of writes to K3's traffic.
#include <cuda_bf16.h>

#include "tsd_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBigC = 1 << 28;

struct Planes {
    int32_t* keys;
    int32_t* ymin;
    int32_t* xmin;
    int32_t* ymax;
    int32_t* xmax;
};

struct Geometry {
    int n, r, w;      // windows, rows per window, columns
    int core, halo;   // emitted rows [halo, halo + core)
    long long total;  // n * r * w
};

__device__ __forceinline__ bool in_mask(const uint8_t* win, long long p, int row,
                                        int rows, int level) {
    return (int)win[p] <= level && row > 0 && row < rows - 1;
}

// Warm start of level t: fold the level's mask into the carried state.
__global__ void sweep_init_kernel(const uint8_t* __restrict__ win, Planes s,
                                  __nv_bfloat16* __restrict__ rings,
                                  int32_t* __restrict__ out, Geometry g,
                                  int level, int first, int n_ring_planes) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= g.total) return;
    const int hw = g.r * g.w;
    const int local = (int)(p % hw);
    const int row = local / g.w, col = local - row * g.w;
    const int big = 256 * hw;
    int keys, ymin, xmin, ymax, xmax;
    if (first) {
        keys = big;
        ymin = xmin = kBigC;
        ymax = xmax = -1;
        for (int k = 0; k < n_ring_planes; ++k) {
            // area ring and last-emit start at 0, the variation ring at inf
            rings[(long long)k * g.total + p] = __float2bfloat16_rn(0.0f);
        }
        if (out != nullptr && row >= g.halo && row < g.halo + g.core) {
            out[(p / hw) * (long long)g.core * g.w + (long long)(row - g.halo) * g.w + col] = 0;
        }
    } else {
        keys = s.keys[p];
        ymin = s.ymin[p];
        xmin = s.xmin[p];
        ymax = s.ymax[p];
        xmax = s.xmax[p];
    }
    const int v = win[p];
    const bool m = in_mask(win, p, row, g.r, level);
    const int keys0 = v * hw + local;
    s.keys[p] = m ? min(keys, keys0) : big;
    s.ymin[p] = m ? min(ymin, row) : kBigC;
    s.ymax[p] = m ? max(ymax, row) : -1;
    s.xmin[p] = m ? min(xmin, col) : kBigC;
    s.xmax[p] = m ? max(xmax, col) : -1;
}

// One synchronous propagation pass: reads `a`, writes `b`.
__global__ void sweep_pass_kernel(const uint8_t* __restrict__ win, Planes a,
                                  Planes b, Geometry g, int level) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= g.total) return;
    const int hw = g.r * g.w;
    const long long base = p - (p % hw);
    const int local = (int)(p - base);
    const int row = local / g.w, col = local - row * g.w;
    const int up = (row == 0 ? g.r - 1 : row - 1) * g.w + col;
    const int dn = (row == g.r - 1 ? 0 : row + 1) * g.w + col;
    const int lf = row * g.w + (col == 0 ? g.w - 1 : col - 1);
    const int rt = row * g.w + (col == g.w - 1 ? 0 : col + 1);
    const bool m = in_mask(win, p, row, g.r, level);
    const int big = 256 * hw;

#define NB_MIN(x) min(min(x[base + up], x[base + dn]), min(x[base + lf], x[base + rt]))
#define NB_MAX(x) max(max(x[base + up], x[base + dn]), max(x[base + lf], x[base + rt]))
    const int knew = m ? min(a.keys[p], NB_MIN(a.keys)) : big;
    b.keys[p] = knew;
    const bool live = m && knew >= 0;
    b.ymin[p] = live ? min(a.ymin[p], NB_MIN(a.ymin)) : kBigC;
    b.ymax[p] = live ? max(a.ymax[p], NB_MAX(a.ymax)) : -1;
    b.xmin[p] = live ? min(a.xmin[p], NB_MIN(a.xmin)) : kBigC;
    b.xmax[p] = live ? max(a.xmax[p], NB_MAX(a.xmax)) : -1;
#undef NB_MIN
#undef NB_MAX
}

struct Thresholds {
    float min_area, max_area, max_variation, min_diversity;
};

struct Slots {
    int old_a, td_a, write_a, v_new, v_c;
};

// Bbox-area stability, dead mark, candidate test and level collapse.
__global__ void sweep_emit_kernel(const uint8_t* __restrict__ win, Planes s,
                                  __nv_bfloat16* __restrict__ aring,
                                  __nv_bfloat16* __restrict__ vring,
                                  __nv_bfloat16* __restrict__ lastemit,
                                  int32_t* __restrict__ out,
                                  uint8_t* __restrict__ full, Geometry g,
                                  int level, int t, int num_levels, int lbits,
                                  Slots sl, Thresholds th) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= g.total) return;
    const int hw = g.r * g.w;
    const int local = (int)(p % hw);
    const int row = local / g.w, col = local - row * g.w;
    const bool m = in_mask(win, p, row, g.r, level);
    const int keys = s.keys[p];
    const int keys0 = (int)win[p] * hw + local;
    const bool anchor = m && keys == keys0;

    // f32 before the product: sentinel extents overflow int32
    float bb = __fmul_rn((float)(s.ymax[p] - s.ymin[p] + 1),
                         (float)(s.xmax[p] - s.xmin[p] + 1));
    bb = fminf(bb, 65535.0f);
    const float a_cur = anchor ? bb : 0.0f;
    if (anchor && bb > th.max_area) s.keys[p] = -1;  // dead mark, after the area

    const float area_c = __bfloat162float(aring[(long long)sl.old_a * g.total + p]);
    const float a_td = __bfloat162float(aring[(long long)sl.td_a * g.total + p]);
    const float v_c = __bfloat162float(vring[(long long)sl.v_c * g.total + p]);
    const float v_prev = __bfloat162float(vring[(long long)sl.v_new * g.total + p]);
    const float v_new = (a_td > 0.0f && a_cur > 0.0f)
                            ? __fdiv_rn(__fsub_rn(a_cur, a_td), fmaxf(a_td, 1.0f))
                            : __int_as_float(0x7f800000);
    bool cand = area_c >= th.min_area && area_c <= th.max_area &&
                v_c < th.max_variation && v_c <= v_prev && v_c <= v_new;
    const float last = __bfloat162float(lastemit[p]);
    const bool diverse =
        last <= 0.0f ||
        __fsub_rn(area_c, last) >= __fmul_rn(th.min_diversity, fmaxf(area_c, 1.0f));
    cand = cand && diverse;
    lastemit[p] = __float2bfloat16_rn(cand ? area_c : last);
    float qv = __fsub_rn(254.0f, floorf(__fmul_rn(v_c, 253.0f)));
    qv = fminf(fmaxf(qv, 1.0f), 254.0f);

    aring[(long long)sl.write_a * g.total + p] = __float2bfloat16_rn(a_cur);
    vring[(long long)sl.v_new * g.total + p] = __float2bfloat16_rn(v_new);

    if (full != nullptr) {
        // K7: every row's byte of this level, qv cast through int32
        full[((p / hw) * num_levels + t) * (long long)hw + local] =
            (uint8_t)(int)(cand ? qv : 0.0f);
    } else if (row >= g.halo && row < g.halo + g.core) {
        const int packed = (int)(cand ? qv : 0.0f) * (1 << lbits) + t;
        int32_t* o = out + (p / hw) * (long long)g.core * g.w +
                     (long long)(row - g.halo) * g.w + col;
        *o = max(*o, packed);
    }
}

__global__ void fill_inf_kernel(__nv_bfloat16* __restrict__ x, long long n) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p < n) x[p] = __float2bfloat16_rn(__int_as_float(0x7f800000));
}

// The host loop over levels.  Exactly one of `out` (K3: level-collapsed
// core rows) and `full` (K7: every level's byte map) is non-null.
int run_sweep(const void* win, int32_t* o, uint8_t* full, void* state, void* rings,
              int n, int r, int w, int core, int halo, int num_levels, int step,
              int d, int num_passes, int lbits, float min_area, float max_area,
              float max_variation, float min_diversity, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    Geometry g{n, r, w, core, halo, (long long)n * r * w};
    const long long total = g.total;
    int32_t* planes = (int32_t*)state;
    Planes cur{planes, planes + total, planes + 2 * total, planes + 3 * total,
               planes + 4 * total};
    Planes nxt{planes + 5 * total, planes + 6 * total, planes + 7 * total,
               planes + 8 * total, planes + 9 * total};
    const int nring = d + 1;
    __nv_bfloat16* aring = (__nv_bfloat16*)rings;
    __nv_bfloat16* vring = aring + (long long)nring * total;
    __nv_bfloat16* lastemit = vring + 2 * total;
    Thresholds th{min_area, max_area, max_variation, min_diversity};
    const int blocks = tsd_blocks(total, kThreads);
    const uint8_t* w8 = (const uint8_t*)win;

    for (int t = 0; t < num_levels; ++t) {
        const int level = t * step;
        // zero every ring plane, then set the variation ring to inf
        sweep_init_kernel<<<blocks, kThreads, 0, st>>>(w8, cur, aring, o, g, level,
                                                       t == 0, t == 0 ? nring + 3 : 0);
        if (t == 0) {
            fill_inf_kernel<<<tsd_blocks(2 * total, kThreads), kThreads, 0, st>>>(
                vring, 2 * total);
        }
        for (int k = 0; k < num_passes; ++k) {
            sweep_pass_kernel<<<blocks, kThreads, 0, st>>>(w8, cur, nxt, g, level);
            Planes tmp = cur;
            cur = nxt;
            nxt = tmp;
        }
        // ring slot arithmetic copied from mser_pallas.py:343-351,381-382
        Slots sl;
        sl.old_a = (t + nring - (d + 1) % nring) % nring;
        sl.td_a = (t + nring - d % nring) % nring;
        sl.v_new = (t + 2 * nring - d) % 2;
        sl.v_c = 1 - sl.v_new;
        sl.write_a = t % nring;
        sweep_emit_kernel<<<blocks, kThreads, 0, st>>>(w8, cur, aring, vring,
                                                       lastemit, o, full, g, level,
                                                       t, num_levels, lbits, sl, th);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// win: u8 [n, r, w]; out: i32 [n, core, w]; state: i32 [2, 5, n, r, w]
// (ping-pong planes keys, ymin, xmin, ymax, xmax); rings: bf16
// [d + 1 + 2 + 1, n, r, w] (area ring, variation ring, last-emit).
TSD_API int tsd_level_sweep(const void* win, void* out, void* state, void* rings,
                            int n, int r, int w, int core, int halo,
                            int num_levels, int step, int d, int num_passes,
                            int lbits, float min_area, float max_area,
                            float max_variation, float min_diversity,
                            void* stream) {
    return run_sweep(win, (int32_t*)out, nullptr, state, rings, n, r, w, core, halo,
                     num_levels, step, d, num_passes, lbits, min_area, max_area,
                     max_variation, min_diversity, stream);
}

// K7: one strip per plane, no halo.  win: u8 [n, r, w]; full: u8
// [n, num_levels, r, w]; state and rings as above.
TSD_API int tsd_level_sweep_full(const void* win, void* full, void* state, void* rings,
                                 int n, int r, int w, int num_levels, int step, int d,
                                 int num_passes, float min_area, float max_area,
                                 float max_variation, float min_diversity,
                                 void* stream) {
    return run_sweep(win, nullptr, (uint8_t*)full, state, rings, n, r, w, r, 0,
                     num_levels, step, d, num_passes, 0, min_area, max_area,
                     max_variation, min_diversity, stream);
}
