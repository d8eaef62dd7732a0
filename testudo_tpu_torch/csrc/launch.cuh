// Launch helpers shared by the kernel sources: one thread per lane, the
// ragged last block masked by `lane < L`, the launch's error code returned
// to the Python wrapper (which raises on anything but 0).
#pragma once
#include <cuda_runtime.h>

#define LANE_INDEX(tpb) ((long)blockIdx.x * (tpb) + threadIdx.x)
#define GRID_FOR(L, tpb) ((unsigned)(((L) + (tpb)-1) / (tpb)))
#define LAUNCH_STATUS() ((int)cudaGetLastError())
