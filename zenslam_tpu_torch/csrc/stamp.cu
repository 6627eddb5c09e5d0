// A device time stamp: one thread reads %globaltimer (ns) and writes
// (stamp id, ns) into the next slot of a ring in device memory.
//
// Used by zenslam_tpu_torch/utils/tracing.py. The ring is one int64 buffer:
// element 0 is the count of stamps taken since the last reset, elements
// 2 + 2k and 3 + 2k hold slot k (capacity slots, a power of two). A slot is
// taken with atomicAdd on the count, so stamps on several streams never
// share one; a ring that wraps overwrites its oldest slots, and the count
// says how many were lost. Launched while a stream captures a CUDA graph,
// the stamp is one node of the graph, its id and ring pointer fixed at the
// capture: every replay stamps again with no host work.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void stamp_kernel(unsigned long long* ring, unsigned long long mask, long long id) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long slot = atomicAdd(ring, 1ULL) & mask;
  long long* row = reinterpret_cast<long long*>(ring) + 2 + 2 * slot;
  row[0] = id;
  row[1] = static_cast<long long>(now);
}

extern "C" int stamp_launch(void* ring, unsigned long long capacity, long long id,
                            void* stream) {
  if (capacity == 0 || (capacity & (capacity - 1)) != 0) return (int)cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(static_cast<unsigned long long*>(ring),
                                                   capacity - 1, id);
  return (int)cudaGetLastError();
}
