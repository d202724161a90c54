// The blocks of a kernel that fill the device, queried once.
//
// A launch sized to the card (K1's one wave of resident blocks, K5's
// cooperative grid) needs the device's SM count and the blocks of its kernel
// one SM holds.  The runtime queries behind them cost more than the launch,
// so resident_blocks runs them once per device and slot and keeps the
// answers in static atomics.  Threads racing on a first call store the same
// values.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace repro_torch {

constexpr int kMaxDevices = 16;   // devices past this are queried every call

// The current device's SM count (*sms) and the blocks of `kernel` one SM
// holds at `threads` threads and `smem` bytes of dynamic shared memory
// (*per_sm, at least 1 on success).  `Cache` names the cache: one type per
// kernel instance, which keeps kSlots answers per device, one per launch
// shape the caller numbers by `slot` (0 <= slot < kSlots).  Where
// opt_in_smem > 0, the kernel's dynamic shared-memory limit is first raised
// to it, once, with the queries.
template <typename Cache, int kSlots = 1>
cudaError_t resident_blocks(const void* kernel, int threads, size_t smem,
                            int slot, size_t opt_in_smem, int* sms,
                            int* per_sm) {
  static std::atomic<int> sm_count[kMaxDevices];
  static std::atomic<int> resident[kMaxDevices][kSlots];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached) {
    *sms = sm_count[device].load();
    *per_sm = resident[device][slot].load();
    if (*sms > 0 && *per_sm > 0) return cudaSuccess;
  }
  if (opt_in_smem > 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(opt_in_smem));
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads, smem);
  }
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  if (cached) {
    sm_count[device].store(*sms);
    resident[device][slot].store(*per_sm);
  }
  return cudaSuccess;
}

}  // namespace repro_torch
