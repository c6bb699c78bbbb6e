// Shared pieces of the kernels that compute hand-object pair distances:
// through h2o_cells_common.cuh the h2o searches h2o_nn.cu, h2o_nn_dvec.cu,
// h2o_cull.cu, h2o_cull_dvec.cu and h2o_topk.cu; through o2h_common.cuh
// and bidir_common.cuh nn_signed.cu, dist_loss.cu, dist_loss_cull.cu and
// o2h_topk.cu.
//
// Every kernel computes each (x, y) pair's squared distance with the one
// function below, so their minima are bit-identical: the cell searches only
// skip pairs that provably cannot hold the minimum, and the signed kernels'
// object->hand direction sees the same value for a pair as the h2o one.
#pragma once

#include "launch_common.cuh"

// One 128-row region of the (template-permuted) hand, the region size of
// the cull mask (ops/chamfer_cull.REGION_ROWS).
#define H2O_REGION_ROWS 128
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

// Writes a live row's min and dvec = x - y[best_j] (centred). A row whose
// min is still BIG took no point (all cells culled, or an all-invalid
// cloud): its dvec is 0, never the offset to a FAR point.
__device__ __forceinline__ void h2o_write_dvec(
    float* __restrict__ d_out, float* __restrict__ dvec, size_t o,
    const float4* __restrict__ yg, float best, int best_j,
    float x0, float x1, float x2) {
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    if (best < H2O_BIG) {
        const float4 yj = yg[best_j];
        v0 = __fsub_rn(x0, yj.x);
        v1 = __fsub_rn(x1, yj.y);
        v2 = __fsub_rn(x2, yj.z);
    }
    d_out[o] = best;
    dvec[3 * o + 0] = v0;
    dvec[3 * o + 1] = v1;
    dvec[3 * o + 2] = v2;
}
