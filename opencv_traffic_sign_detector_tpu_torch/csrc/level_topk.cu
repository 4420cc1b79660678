// Candidate select of the level-by-level MSER sweep: the running top-n of
// each frame's packed keys, merged a level at a time, as two kernels a
// level (ops/level_topk.py: level_topk).
//
// It replaces no TPU kernel: the JAX package leaves its exact top-k to XLA
// (opencv_traffic_sign_detector_tpu/ops/mser.py: lax.top_k over the
// [L, 2, H*W] map).  The port took it level by level with torch.topk: each
// level's byte map sb [B, P] (P = 2 H W) widened to int64 keys
// (byte << 40 | 2^40 - 1 - t P - i, i the flat index in the level), a
// radix select of n over P keys a frame, and a second select merging the
// result into the running top-n.  At recognition's [8, 2, 802, 1362] that
// is 140 MB of keys written and read several times a level, ~1.15 ms, 39
// levels a batch.  Almost every byte is 0: a byte is set only at the
// anchor pixel of a stable, diverse component (tens a level).
//
// Bound: one read of the level's bytes, 17.5 MB at 3.35 TB/s, 5.2 us; the
// rest is a sort of the few keys kept.
//
// Design:
// - topk_compact_kernel reads sb once, 16 bytes a load, streaming (the
//   bytes are read once).  A word of zeros costs its load.  A nonzero byte
//   is kept where its packed key beats the frame's running n-th key (read
//   on the card), or at the first level, where the list is empty, always.
//   Only such a key can enter: every zero byte of a later level is below
//   every zero byte of the first.  A kept key is appended to its frame's
//   row of `keys` as byte << 24 | i through one atomic counter a frame, one
//   add a 16-byte word.  A row holds P keys, so it cannot overflow.
// - topk_merge_kernel, a block a frame, reads the kept count on the card
//   (the graph stays static, nothing syncs), takes the kept keys in chunks
//   of kChunk into shared memory beside the running list, drops those at
//   or below its n-th key, and ranks the rest and the list: a key's rank is
//   the number of keys above it, in the list (a binary search: it is
//   sorted) and in the chunk (a count).  Every key is unique (the index is
//   part of it), so the ranks are a permutation and each rank below n
//   writes one slot of the next list, in descending order.  Any count of
//   kept keys takes as many chunks as it needs: slower, and exact, up to a
//   map in which every byte is nonzero.
// - The first level's list is its fillers, the top of its zero bytes: the
//   keys (0, i) of the zero bytes among i < n, lowest first, which
//   torch.topk would take where fewer than n bytes are set.  With the
//   level's nonzero keys they number at least n.
// The merge zeroes the frame's counter for the next level's compaction and
// adds the kept count to an optional int64 counter (the tracer's
// topk_kept, runtime/trace.py).
#include <algorithm>

#include "tsd_common.cuh"

namespace {

constexpr int kIdxBits = 40;    // ops/level_topk.py: IDX_BITS
constexpr int kLevelBits = 24;  // a kept key: byte << 24 | i (ops/level_topk.py: LEVEL_BITS)
constexpr unsigned kIdxMask = (1u << kLevelBits) - 1;
constexpr int kCompactThreads = 256;
constexpr int kWords = 4;  // 16-byte words a thread loads at once
constexpr int kMergeThreads = 512;
constexpr int kChunk = 1024;  // kept keys a merge block ranks at once
constexpr int kMaxN = 4096;   // ops/level_topk.py: MAX_N

__device__ __forceinline__ long long packed_key(unsigned byte, long long low_t, long long i) {
    return ((long long)byte << kIdxBits) | (low_t - i);
}

// Byte j of a 16-byte word, by selects (no indexed array in local memory).
__device__ __forceinline__ unsigned byte_at(const uint4& v, int j) {
    const unsigned w = j < 8 ? (j < 4 ? v.x : v.y) : (j < 12 ? v.z : v.w);
    return (w >> (8 * (j & 3))) & 0xffu;
}

// Keep one byte at flat position g of [B, P], testing its frame's n-th key.
__device__ void keep_byte(unsigned byte, long long g, int per_level, int n, bool first,
                          long long low_t, const long long* __restrict__ best,
                          unsigned* __restrict__ keys, int* __restrict__ counts) {
    if (byte == 0) return;
    const int frame = (int)(g / per_level);
    const int i = (int)(g - (long long)frame * per_level);
    if (!first && packed_key(byte, low_t, i) <= best[(long long)frame * n + n - 1]) return;
    const int slot = atomicAdd(counts + frame, 1);
    keys[(long long)frame * per_level + slot] = (byte << kLevelBits) | (unsigned)i;
}

// One 16-byte word of nonzero content starting at flat position g0.
__device__ void keep_word(const uint4& v, long long g0, int per_level, int n, bool first,
                          long long low_t, const long long* __restrict__ best,
                          unsigned* __restrict__ keys, int* __restrict__ counts) {
    const int frame = (int)(g0 / per_level);
    if ((g0 + 15) / per_level != frame) {  // the word straddles two frames
        for (int j = 0; j < 16; ++j)
            keep_byte(byte_at(v, j), g0 + j, per_level, n, first, low_t,
                      best, keys, counts);
        return;
    }
    const int i0 = (int)(g0 - (long long)frame * per_level);
    const long long thr = first ? -1 : best[(long long)frame * n + n - 1];
    unsigned kept = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const unsigned byte = byte_at(v, j);
        if (byte != 0 && packed_key(byte, low_t, i0 + j) > thr) kept |= 1u << j;
    }
    if (kept == 0) return;
    int slot = atomicAdd(counts + frame, __popc(kept));
    unsigned* row = keys + (long long)frame * per_level;
    while (kept) {
        const int j = __ffs(kept) - 1;
        kept &= kept - 1;
        row[slot++] = (byte_at(v, j) << kLevelBits) | (unsigned)(i0 + j);
    }
}

// sb [total] u8 = [B, P]; `head` bytes before the first 16-byte aligned
// word, `words` aligned words, the rest a tail of under 16 bytes.
__global__ void __launch_bounds__(kCompactThreads)
topk_compact_kernel(const uint8_t* __restrict__ sb, const long long* __restrict__ best,
                    unsigned* __restrict__ keys, int* __restrict__ counts, long long total,
                    long long head, long long words, int per_level, int n, int first,
                    long long low_t) {
    if (blockIdx.x == 0 && threadIdx.x < 32) {  // the unaligned head and tail, a byte a thread
        const long long tail = head + 16 * words;
        const long long g = threadIdx.x < 16 ? threadIdx.x : tail + threadIdx.x - 16;
        if ((threadIdx.x < 16 && g < head) || (threadIdx.x >= 16 && g < total))
            keep_byte(sb[g], g, per_level, n, first, low_t, best, keys, counts);
    }
    const uint4* vec = reinterpret_cast<const uint4*>(sb + head);
    const long long base = (long long)blockIdx.x * kCompactThreads * kWords + threadIdx.x;
    uint4 v[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
        const long long w = base + (long long)k * kCompactThreads;
        v[k] = w < words ? __ldcs(vec + w) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k)
        if (v[k].x | v[k].y | v[k].z | v[k].w)
            keep_word(v[k], head + 16 * (base + (long long)k * kCompactThreads), per_level, n,
                      first != 0, low_t, best, keys, counts);
}

// The number of keys above x in list[0, m), sorted descending.
__device__ __forceinline__ int above(const long long* list, int m, long long x) {
    int lo = 0, hi = m;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (list[mid] > x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// A block a frame: best [B, n] i64, descending, updated in place (read
// whole before it is written); keys [B, P] the compacted keys, counts [B].
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const uint8_t* __restrict__ sb, long long* __restrict__ best,
                  const unsigned* __restrict__ keys, int* __restrict__ counts,
                  unsigned long long* __restrict__ kept_total, int per_level, int n, int first,
                  long long low_t) {
    extern __shared__ long long smem[];
    long long* list = smem;        // [n], the running list, descending
    long long* next = smem + n;    // [n], the list being ranked into
    long long* chunk = smem + 2 * n;  // [kChunk], kept keys above the list's n-th
    __shared__ int s_m, s_s;
    const int frame = blockIdx.x, tid = threadIdx.x;
    const int kept = counts[frame];
    long long* out = best + (long long)frame * n;
    if (first) {
        if (tid < 32) {  // the fillers: zero bytes among i < n, lowest first
            const uint8_t* row = sb + (long long)frame * per_level;
            int m = 0;
            for (int i0 = 0; i0 < n; i0 += 32) {
                const int i = i0 + tid;
                const bool zero = i < n && row[i] == 0;
                const unsigned ballot = __ballot_sync(0xffffffffu, zero);
                if (zero) list[m + __popc(ballot & ((1u << tid) - 1))] = low_t - i;
                m += __popc(ballot);
            }
            if (tid == 0) s_m = m;
        }
    } else {
        for (int j = tid; j < n; j += kMergeThreads) list[j] = out[j];
        if (tid == 0) s_m = n;
    }
    __syncthreads();
    int m = s_m;
    const unsigned* mine = keys + (long long)frame * per_level;
    for (int off = 0; off < kept; off += kChunk) {
        const long long thr = m == n ? list[n - 1] : -1;
        if (tid == 0) s_s = 0;
        __syncthreads();
        for (int q = tid; q < kChunk && off + q < kept; q += kMergeThreads) {
            const unsigned key = mine[off + q];
            const long long x = packed_key(key >> kLevelBits, low_t, key & kIdxMask);
            if (x > thr) chunk[atomicAdd(&s_s, 1)] = x;
        }
        __syncthreads();
        const int s = s_s;
        for (int e = tid; e < m + s; e += kMergeThreads) {
            const long long x = e < m ? list[e] : chunk[e - m];
            int r = e < m ? e : above(list, m, x);
            for (int c = 0; c < s; ++c) r += chunk[c] > x;
            if (r < n) next[r] = x;
        }
        __syncthreads();
        m = min(n, m + s);
        long long* done = next;
        next = list;
        list = done;
    }
    for (int j = tid; j < n; j += kMergeThreads) out[j] = list[j];
    if (tid == 0) {
        counts[frame] = 0;
        if (kept_total != nullptr) atomicAdd(kept_total, (unsigned long long)kept);
    }
}

}  // namespace

// sb [b, p] u8 (level t's byte map), best [b, n] i64 (the running list,
// descending; unread where first), keys [b, p] u32 and counts [b] i32
// (scratch, counts zero on entry and left zero), kept_total one i64 or
// null.  Writes the top n of the list and the level's keys into best.
TSD_API int tsd_level_topk(const void* sb, void* best, void* keys, void* counts,
                           void* kept_total, int b, int p, int n, int t, int first,
                           void* stream) {
    if (b < 1 || n < 1 || n > kMaxN || n > p || t < 0 || p > (int)kIdxMask + 1
        || (long long)(t + 1) * p > (1ll << kIdxBits))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const long long low_t = (1ll << kIdxBits) - 1 - (long long)t * p;
    const long long total = (long long)b * p;
    const auto addr = reinterpret_cast<uintptr_t>(sb);
    const long long head = std::min<long long>((16 - (long long)(addr & 15)) & 15, total);
    const long long words = (total - head) / 16;
    const long long per_block = (long long)kCompactThreads * kWords;
    const unsigned blocks = (unsigned)std::max<long long>(1, (words + per_block - 1) / per_block);
    topk_compact_kernel<<<blocks, kCompactThreads, 0, st>>>(
        (const uint8_t*)sb, (const long long*)best, (unsigned*)keys, (int*)counts, total, head,
        words, p, n, first, low_t);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int smem = (2 * n + kChunk) * (int)sizeof(long long);
    e = cudaFuncSetAttribute(topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    topk_merge_kernel<<<b, kMergeThreads, smem, st>>>(
        (const uint8_t*)sb, (long long*)best, (const unsigned*)keys, (int*)counts,
        (unsigned long long*)kept_total, p, n, first, low_t);
    return (int)cudaGetLastError();
}
