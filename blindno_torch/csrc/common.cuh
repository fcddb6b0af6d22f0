// Launch and copy helpers shared by the port's kernel sources (header only; each source
// that includes it gets its own copies of these inline functions and templates).
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

// ---- cp.async staging ------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes through L2 only (never the read-only or L1 path), zero-filled past src_bytes.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- programmatic dependent launch -----------------------------------------------------

// A kernel launched by launch_clusters may start while the kernel before it on the
// stream still runs. The kernel before lets it be scheduled from here on ...
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// ... and, until it has waited here for the kernel before to finish and its writes to be
// visible, it reads nothing that kernel may write and writes nothing to global memory.
// A kernel launched plainly waits for nothing here.
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Launch `kernel` as clusters of cluster_dims blocks; with `dependent`, they may start
// before the previous kernel on `stream` ends (see wait_prerequisites), else only after
// it. Returns the first error of the launch.
template <typename... Params, typename... Args>
cudaError_t launch_cluster_grid(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                                dim3 cluster_dims, bool dependent, cudaStream_t stream,
                                Args... args) {
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster_dims.x;
  attrs[0].val.clusterDim.y = cluster_dims.y;
  attrs[0].val.clusterDim.z = cluster_dims.z;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = dependent ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// launch_cluster_grid as a programmatic dependent of the kernel before it on `stream`.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                            dim3 cluster_dims, cudaStream_t stream, Args... args) {
  return launch_cluster_grid(kernel, grid, threads, smem, cluster_dims, true, stream, args...);
}

}  // namespace blindno
