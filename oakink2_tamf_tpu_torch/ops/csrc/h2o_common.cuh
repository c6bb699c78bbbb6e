// Shared pieces of the two hand->object nearest-neighbour kernels
// (h2o_nn.cu, h2o_cull.cu).
//
// Both kernels compute each (x, y) pair's squared distance with the one
// function below, so their minima are bit-identical: the culled kernel only
// skips pairs that provably cannot hold the minimum.
#pragma once

#include <cuda_runtime.h>

// x rows per block: one 128-row region of the (template-permuted) hand, the
// region size of the cull mask (ops/chamfer_cull.REGION_ROWS).
#define H2O_REGION_ROWS 128
// y points staged in shared memory per pass (8 KB of float4).
#define H2O_Y_STAGE 512
// Running-min start value; an invalid y sits at 1e15 per coordinate
// (d2 ~ 3e30), so it never beats it and an all-invalid cloud gives BIG.
#define H2O_BIG 1e30f

// Squared distance of one pair: 3 sub, 1 mul, 2 fma (8 flops). The explicit
// _rn intrinsics pin the rounding, so nvcc cannot contract differently in
// the two kernels; ops/chamfer_nn.pair_d2 repeats it in PyTorch.
__device__ __forceinline__ float h2o_pair_d2(float x0, float x1, float x2, float4 y) {
    const float d0 = __fsub_rn(x0, y.x);
    const float d1 = __fsub_rn(x1, y.y);
    const float d2 = __fsub_rn(x2, y.z);
    return __fmaf_rn(d2, d2, __fmaf_rn(d1, d1, __fmul_rn(d0, d0)));
}

// Loads this thread's x row, centred on its group's y-mean (the wrapper
// centres y the same way). Rows past P1 are dead and load nothing.
__device__ __forceinline__ bool h2o_load_row(
    const float* __restrict__ x, const float* __restrict__ ctr,
    int f, int g, int row, int P1, float& x0, float& x1, float& x2) {
    x0 = x1 = x2 = 0.f;
    if (row >= P1) return false;
    const float* xp = x + ((size_t)f * P1 + row) * 3;
    x0 = __fsub_rn(xp[0], ctr[3 * g + 0]);
    x1 = __fsub_rn(xp[1], ctr[3 * g + 1]);
    x2 = __fsub_rn(xp[2], ctr[3 * g + 2]);
    return true;
}

// Copies y[j0, j0 + n) of the group's cloud into shared memory.
__device__ __forceinline__ void h2o_stage_y(
    float4* ys, const float4* __restrict__ yg, int j0, int n) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) ys[k] = yg[j0 + k];
}

extern "C" const char* h2o_error_string(int e) {
    return cudaGetErrorString(static_cast<cudaError_t>(e));
}
