// int32 keys under a byte mask, held in a block's registers: the layout that
// K5 (prop_rolls.cu) and K6 (flood.cu) share, with its loads and stores.
//
// A warp spans kStripW = 128 neighbouring columns, a lane kLaneCols = 4 of
// them over kRows = 8 rows: 32 keys as one int4 a row, the mask as one bit a
// pixel (bit 4 * row + column of one word), a pixel off the mask holding
// `big`.  A block's warps stack their rows.  Left and right neighbours are
// then one warp shuffle away, upper and lower ones in the lane's own
// registers, and only what crosses a warp's first and last rows needs shared
// memory.  A row is loaded as one 16-byte word of keys and one 4-byte word
// of mask a lane where every row's alignment allows, all rows' loads started
// before any is used, so a block waits for device memory once.
#pragma once

#include "tsd_common.cuh"

constexpr int kLaneCols = 4;
constexpr int kRows = 8;
constexpr int kStripW = 32 * kLaneCols;
static_assert(kLaneCols * kRows <= 32, "a lane's mask bits fill one word");

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// A lane's kRows rows of 4 keys and 4 mask bytes from plane row gr on (rows
// wrap at h), the first `rows` of them; the others read as off the mask.
// kAlign: pixels to which every row's first address is aligned, 4 or 2 (the
// columns gc[0..3] are then neighbours), or 1: any columns, scalar loads.
template <int kAlign>
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ keys,
                                          const uint8_t* __restrict__ mask, int h, int w,
                                          int gr, const int (&gc)[kLaneCols], int rows, int big,
                                          int4 (&v)[kRows], unsigned (&mb)[kRows]) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        v[k] = make_int4(big, big, big, big);
        mb[k] = 0;
        if (k < rows) {
            const int32_t* kp = keys + (long long)gr * w;
            const uint8_t* mp = mask + (long long)gr * w;
            if (kAlign == 4) {
                v[k] = *reinterpret_cast<const int4*>(kp + gc[0]);
                mb[k] = *reinterpret_cast<const uint32_t*>(mp + gc[0]);
            } else if (kAlign == 2) {
                const int2 lo = *reinterpret_cast<const int2*>(kp + gc[0]);
                const int2 hi = *reinterpret_cast<const int2*>(kp + gc[0] + 2);
                v[k] = make_int4(lo.x, lo.y, hi.x, hi.y);
                mb[k] = (uint32_t)*reinterpret_cast<const uint16_t*>(mp + gc[0]) |
                        (uint32_t)*reinterpret_cast<const uint16_t*>(mp + gc[0] + 2) << 16;
            } else {
                v[k] = make_int4(kp[gc[0]], kp[gc[1]], kp[gc[2]], kp[gc[3]]);
                mb[k] = (uint32_t)mp[gc[0]] | (uint32_t)mp[gc[1]] << 8 |
                        (uint32_t)mp[gc[2]] << 16 | (uint32_t)mp[gc[3]] << 24;
            }
        }
        gr = gr + 1 == h ? 0 : gr + 1;
    }
}

// The mask bits of the loaded bytes `mb`, those outside `keep` dropped, and
// the mask applied: a key off the mask becomes `big`.
__device__ __forceinline__ unsigned mask_rows(int4 (&v)[kRows], const unsigned (&mb)[kRows],
                                              unsigned keep, int big) {
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
#pragma unroll
        for (int q = 0; q < kLaneCols; ++q)
            m |= (unsigned)((mb[k] >> (8 * q) & 0xffu) != 0) << (4 * k + q);
    }
    m &= keep;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        v[k].x = (m >> (4 * k) & 1u) ? v[k].x : big;
        v[k].y = (m >> (4 * k) & 2u) ? v[k].y : big;
        v[k].z = (m >> (4 * k) & 4u) ? v[k].z : big;
        v[k].w = (m >> (4 * k) & 8u) ? v[k].w : big;
    }
    return m;
}

// A whole [h, w] plane, h <= kRows * the block's warps and w <= kStripW, into
// the block's registers: warp wp's lane holds rows wp * kRows on and columns
// lane * kLaneCols on.  Pixels past the plane's last row or column read as
// off the mask.  Returns the lane's mask bits.
__device__ __forceinline__ unsigned load_window(const int32_t* __restrict__ keys,
                                                const uint8_t* __restrict__ mask, int h, int w,
                                                int wp, int lane, int big, int4 (&v)[kRows]) {
    const int i0 = wp * kRows, j0 = lane * kLaneCols;
    const int rows = j0 < w ? h - i0 : 0;
    int gc[kLaneCols];
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) gc[q] = min(j0 + q, w - 1);
    unsigned mb[kRows];
    // w a multiple of 4: a lane lies inside the plane or outside it, and
    // every row shares the plane's alignment
    if (w % kLaneCols == 0 && aligned(keys, 16) && aligned(mask, 4))
        load_rows<4>(keys, mask, h, w, i0, gc, rows, big, v, mb);
    else
        load_rows<1>(keys, mask, h, w, i0, gc, rows, big, v, mb);
    // a lane across the plane's last column read that column again
    const unsigned cols = j0 + kLaneCols <= w ? 0xfu : j0 < w ? (1u << (w - j0)) - 1u : 0u;
    return mask_rows(v, mb, cols * 0x11111111u, big);
}

// The block's registers back into the [h, w] plane, the pixels inside it.
__device__ __forceinline__ void store_window(int32_t* __restrict__ out, int h, int w, int wp,
                                             int lane, const int4 (&v)[kRows]) {
    const int i0 = wp * kRows, j0 = lane * kLaneCols;
    const bool wide = w % kLaneCols == 0 && aligned(out, 16);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        if (i0 + k >= h || j0 >= w) continue;
        int32_t* o = out + (long long)(i0 + k) * w + j0;
        if (wide) {
            *reinterpret_cast<int4*>(o) = v[k];
        } else {
            const int vals[kLaneCols] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
            for (int q = 0; q < kLaneCols; ++q)
                if (j0 + q < w) o[q] = vals[q];
        }
    }
}
