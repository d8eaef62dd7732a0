// Launch helpers shared by the kernel sources: one thread per lane, the
// ragged last block masked by `lane < L`, the launch's error code returned
// to the Python wrapper (which raises on anything but 0).
#pragma once
#include <cuda_runtime.h>

#define LANE_INDEX(tpb) ((long)blockIdx.x * (tpb) + threadIdx.x)
#define GRID_FOR(L, tpb) ((unsigned)(((L) + (tpb)-1) / (tpb)))
#define LAUNCH_STATUS() ((int)cudaGetLastError())

// Ask for `bytes` of dynamic shared memory for `kernel`: above the default
// 48 KB a kernel must opt in.  The CUDA error code, 0 on success.
template <class K>
static inline int smem_opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The most dynamic shared memory a block of the current device may opt in
// to, in bytes; 0 if the query fails.
static inline size_t smem_block_max() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return (size_t)v;
}
