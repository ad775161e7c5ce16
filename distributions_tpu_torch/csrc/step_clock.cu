// Timestamps on the card's global nanosecond timer (%globaltimer), for the
// phase marks of a fused sweep (ops/gibbs.py `_DeviceClock`): one thread
// writes the timer into a slot of a device buffer once the work before it
// on the stream is done.  Launched while the stream captures a CUDA graph,
// the mark becomes a kernel node, which `step_clock_set_enabled` switches
// on and off in the instantiated graph: a replay with the marks off runs
// none of them (a disabled node is an empty one), where event-record nodes
// would cost every replay a few microseconds each.

#include <cuda_runtime.h>

__global__ void step_clock_mark(unsigned long long* stamps, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  stamps[slot] = t;
}

// Launches the mark of `slot` on `stream`; *node is the kernel node it
// added while the stream captures, else NULL.
extern "C" int step_clock_mark_launch(void* stamps, int slot, void* stream,
                                      void** node) {
  if (slot < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  step_clock_mark<<<1, 1, 0, st>>>((unsigned long long*)stamps, slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *node = nullptr;
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  err = cudaStreamGetCaptureInfo(st, &status, nullptr, nullptr, &deps, &n);
  if (err != cudaSuccess) return (int)err;
  if (status == cudaStreamCaptureStatusActive) {
    // the launch is the capture's one frontier node
    if (n != 1) return (int)cudaErrorStreamCaptureUnmatched;
    *node = (void*)deps[0];
  }
  return 0;
}

// Switches a captured mark node on or off in the graph instantiated from
// the graph that holds it; later launches of `exec` follow.
extern "C" int step_clock_set_enabled(void* exec, void* node, int on) {
  return (int)cudaGraphNodeSetEnabled((cudaGraphExec_t)exec,
                                      (cudaGraphNode_t)node, on ? 1 : 0);
}

extern "C" const char* step_clock_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
