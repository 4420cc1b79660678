// The tracer's device stamp: one thread writes the card's %globaltimer.
//
// Replaces no TPU kernel: the reference reads its stage times from XLA's
// profiler, and the port's replayed graph has no host boundary between its
// stages (runtime/trace.py).  Enqueued at each stage boundary while a graph
// is captured, it becomes a node of the graph, so every replay writes the
// time at which the card reached that boundary into its slot of a small
// int64 buffer, which the host copies back beside the batch's records.
// Bound: one 8-byte store; what it costs is the launch of a graph node,
// about a microsecond of the card's time.
#include "tsd_common.cuh"

namespace {

__global__ void stamp_kernel(long long* slot) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    *slot = static_cast<long long>(t);
}

}  // namespace

// stamps: i64 [>= slot + 1]; writes the card's nanosecond clock at stamps[slot]
TSD_API int tsd_stamp(void* stamps, int slot, void* stream) {
    stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(static_cast<long long*>(stamps) + slot);
    return (int)cudaGetLastError();
}
