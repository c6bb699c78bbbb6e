// The h2o backward with the argmin held constant, shared by h2o_nn_bwd.cu
// (kernel #5, the all-pairs route) and h2o_topk_bwd.cu (kernel #11, the
// cluster route). Each file exports its own launch symbol, so each keeps
// its own library and launch count.
//
// With j* = idx_i the forward's first-min index and xr_i the cotangent of
// dist_i already divided by max(dist_i, 1e-12), for frame f with cloud
// y = y[f / y_group]:
//   gx_i = xr_i (x_i - y_{j*})
// and, with GRAD_Y (y_group == 1 only),
//   gy_j = - sum_{i : idx_i = j} xr_i (x_i - y_j).
//
// Bound: bytes. Each input is read once (x, idx, xr, the gathered y rows)
// and gx (gy) written once; the arithmetic is a few flops per element. The
// TPU selects y_{j*} and scatters into gy with one-hot matrices on its
// matrix unit, tile by tile (the cluster route over the forward's candidate
// cells); here an index is a load and the scatter an atomic add, so the
// candidate lists are not needed once the index is known. Design
// (nn_signed_bwd.cu's): one block of 256 threads per frame; the threads
// stride over the rows (coalesced index and cotangent loads), write gx
// once, and with GRAD_Y add -xr_i (x_i - y_{j*}) into the frame's gy
// accumulator [P2, 3] in shared memory (96 KB at 8192 points, past the
// 48 KB default: the launch opts in to the larger carve-out), which is
// written to device memory once at the end. Rows with a zero cotangent
// issue no atomic. Without GRAD_Y the scatter and the shared memory are
// compiled out (the TPU's `_nogy` variants).
//
// The atomic additions land in an order that changes from run to run, so
// gy is not bitwise reproducible: compare it at rtol.
#pragma once

#include "launch_common.cuh"

#define H2O_BWD_THREADS 256

template <bool GRAD_Y>
__global__ void __launch_bounds__(H2O_BWD_THREADS)
h2o_bwd_kernel(const float* __restrict__ x,      // [F, P1, 3]
               const float* __restrict__ y,      // [G, P2, 3]
               const int* __restrict__ idx,      // [F, P1] first argmin
               const float* __restrict__ xr,     // [F, P1]
               float* __restrict__ gx,           // [F, P1, 3]
               float* __restrict__ gy,           // [F, P2, 3] (GRAD_Y)
               int P1, int P2, int y_group) {
    extern __shared__ float acc[];  // [P2 * 3] (GRAD_Y)
    const int f = blockIdx.x;
    const int g = f / y_group;
    const float* xf = x + (size_t)f * P1 * 3;
    const float* yg = y + (size_t)g * P2 * 3;
    if (GRAD_Y) {
        for (int k = threadIdx.x; k < P2 * 3; k += blockDim.x) acc[k] = 0.f;
        __syncthreads();
    }
    for (int i = threadIdx.x; i < P1; i += blockDim.x) {
        const size_t o = (size_t)f * P1 + i;
        const float r = xr[o];
        const int j = idx[o];
        float v0 = 0.f, v1 = 0.f, v2 = 0.f;
        if (r != 0.f && (unsigned)j < (unsigned)P2) {
            v0 = r * (xf[3 * i + 0] - yg[3 * j + 0]);
            v1 = r * (xf[3 * i + 1] - yg[3 * j + 1]);
            v2 = r * (xf[3 * i + 2] - yg[3 * j + 2]);
            if (GRAD_Y) {
                atomicAdd(&acc[3 * j + 0], -v0);
                atomicAdd(&acc[3 * j + 1], -v1);
                atomicAdd(&acc[3 * j + 2], -v2);
            }
        }
        gx[3 * o + 0] = v0;
        gx[3 * o + 1] = v1;
        gx[3 * o + 2] = v2;
    }
    if (GRAD_Y) {
        __syncthreads();
        float* gyf = gy + (size_t)f * P2 * 3;
        for (int k = threadIdx.x; k < P2 * 3; k += blockDim.x) gyf[k] = acc[k];
    }
}

// The body of both launch symbols; returns cudaGetLastError().
static inline int h2o_bwd_launch(const float* x, const float* y, const int* idx,
                                 const float* xr, float* gx, float* gy,
                                 int F, int P1, int P2, int y_group, int grad_y,
                                 cudaStream_t stream) {
    if (F <= 0 || P1 <= 0) return 0;
    if (grad_y) {
        const size_t smem = (size_t)P2 * 3 * sizeof(float);
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                h2o_bwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        h2o_bwd_kernel<true><<<F, H2O_BWD_THREADS, smem, stream>>>(
            x, y, idx, xr, gx, gy, P1, P2, y_group);
    } else {
        h2o_bwd_kernel<false><<<F, H2O_BWD_THREADS, 0, stream>>>(
            x, y, idx, xr, gx, gy, P1, P2, y_group);
    }
    return (int)cudaGetLastError();
}
