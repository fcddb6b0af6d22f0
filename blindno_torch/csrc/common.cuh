// Launch helpers shared by the port's kernel sources (header only; each source that
// includes it gets its own copies of these inline templates).
#pragma once

#include <cuda_runtime.h>

namespace blindno {

constexpr size_t kMaxSmem = 232448;      // what one H100 block may use
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared-memory limit to the most a block may use when `bytes`
// needs more than the default, once per device (the attribute is the device's, and
// setting it costs a host call). `raised` is the caller's static flags for this one
// kernel: kernels of one signature share a function type, so the flags cannot be keyed
// by the template argument here.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int device, bool* raised) {
  if (bytes <= kDefaultSmem || raised[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kMaxSmem));
  if (err == cudaSuccess) raised[device] = true;
  return err;
}

// Run `launch()` (which returns a cudaError_t) with `device` current, then make the
// calling thread's previous current device current again. Returns the CUDA error code.
template <typename Launch>
int on_device(int device, Launch launch) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = launch();
  if (previous != device) {
    const cudaError_t restored = cudaSetDevice(previous);
    if (err == cudaSuccess) err = restored;
  }
  return err;
}

}  // namespace blindno
