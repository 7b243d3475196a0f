// Shared declarations of the hand-written Hopper kernels.
//
// Every entry point has a plain C interface so that the library builds with
// nvcc alone (no PyTorch headers) and loads with ctypes.  Each launches on
// the caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() right after the launch: 0 means the launch was taken.
#pragma once

#include <cuda_runtime.h>

#define SPK_EXPORT extern "C" __attribute__((visibility("default")))
