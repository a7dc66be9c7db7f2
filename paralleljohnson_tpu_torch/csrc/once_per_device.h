// Shared by the kernel sources that set a function attribute before a
// launch (minplus.cu: the tiles' shared memory above 48 KB; fw_kleene.cu:
// the non-portable cluster size).
#pragma once

#include <cuda_runtime.h>

#include <mutex>

// A function attribute belongs to the current device's context, so a
// process that launches on several cards sets it once on each: ``set``
// runs once per device (at most kMaxDevices), its result kept. Each
// caller's lambda is a type of its own, so each attribute has its own
// flags.
template <typename F>
cudaError_t once_per_device(F set) {
  constexpr int kMaxDevices = 64;
  static std::once_flag once[kMaxDevices];
  static cudaError_t err[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [&] { err[dev] = set(); });
  return err[dev];
}
