// The device phase clock behind svs_torch.utils.profiling.mark.
//
// Replaces no TPU kernel: svs_tpu reads its programs' phases from the XLA
// profiler, while here a captured CUDA graph replays with no host call that
// a host span could see.  So a program enqueues one of these one-thread
// kernels at each phase boundary; each reads the device's %globaltimer (ns)
// and adds the time since the previous mark on this device into the
// phase's slot, with a count.  A graph replay then sums its phases on the
// card with no host call and no synchronise; the host reads the buffer once
// (profiling.snapshot).
//
// Bound: one launch.  The kernel reads and writes three int64s; the cost is
// the launch itself (a node of the graph), a few microseconds at most, the
// least a kernel on the stream can take.  Kernels of one stream run in
// order, so one thread with plain loads and stores suffices: no atomics.
//
// Buffer layout (int64): [0] the previous mark's stamp, then a pair
// (sum of ns, count) for each slot.  ``slot`` < 0 (the ``begin`` mark)
// stamps and adds nothing, so the gap between two programs is never counted.

#include <cuda_runtime.h>

__global__ void svs_phase_clock(long long* buf, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (slot >= 0) {
    buf[1 + 2 * slot] += (long long)now - buf[0];
    buf[2 + 2 * slot] += 1;
  }
  buf[0] = (long long)now;
}

extern "C" int svs_phase_mark(void* buf, int slot, void* stream) {
  svs_phase_clock<<<1, 1, 0, (cudaStream_t)stream>>>(
      static_cast<long long*>(buf), slot);
  return (int)cudaGetLastError();
}
