// A device timestamp: one thread writes the device's global timer into one
// 8-byte slot, in stream order.
//
// marlsnake_torch/utils/profiling.py's Tracer puts one of these between the
// phases of a loop (the DQN chunk's act, env step, TD gradient and optimizer;
// the PPO update's collect, gathers, forward-backward and Adam steps). A
// kernel on a stream starts once the kernels before it have finished, so the
// difference between two stamps is the device time of the work enqueued
// between them, idle time included. Nothing is read back: the slots stay on
// the device until the tracer reads its whole ring once.
//
// %globaltimer counts nanoseconds on a clock that every SM of the device
// shares. How finely it ticks is the driver's choice; the resolution on the
// H100 is measured and kept in PERF.md.

#include <cstdint>

#include <cuda_runtime.h>

__global__ void stamp_kernel(uint64_t* slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

extern "C" int marlsnake_stamp(void* slot, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(slot));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* marlsnake_stamp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
