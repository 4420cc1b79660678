// Shared helpers for the port's CUDA kernels.
//
// Every C entry point takes raw device pointers and the caller's stream
// (PyTorch's current stream), launches asynchronously, allocates nothing,
// and returns cudaGetLastError() so that the Python wrapper can raise on a
// refused launch.  The library is built with -fmad=false: several kernels
// must reproduce the plain f32 operation order bit for bit, and a
// contracted multiply-add rounds once where the reference rounds twice.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define TSD_API extern "C" __attribute__((visibility("default")))

static inline int tsd_blocks(long long n, int threads) {
    return static_cast<int>((n + threads - 1) / threads);
}
