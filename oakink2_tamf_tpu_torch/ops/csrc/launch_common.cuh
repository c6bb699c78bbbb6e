// The one symbol every kernel library exports besides its launch function:
// the text of a CUDA error code, which ops/_build.Kernel.launch reads when a
// launch function returns a code other than 0 (cudaSuccess).
#pragma once

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int e) {
    return cudaGetErrorString(static_cast<cudaError_t>(e));
}
