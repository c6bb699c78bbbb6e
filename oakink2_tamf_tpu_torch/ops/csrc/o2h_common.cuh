// Shared pieces of the object->hand (o2h) direction of the signed kernels
// (nn_signed.cu, dist_loss.cu, dist_loss_cull.cu, o2h_topk.cu): per object
// point y_j, the first hand row i that minimises ||x_i - y_j||^2, and the
// sign numerator n_i . (y_j - x_i) read from that row.
//
// Layout: a block of nn_signed.cu or dist_loss*.cu stages its frame's hand
// rows, centred on the group's y-mean like the h2o kernels centre them, and
// their normals in shared memory as float4 (P1 x 32 bytes, 24.9 KB for the
// 778 MANO rows); o2h_topk.cu stages the rows alone, centred the same way,
// and reads the winner's normal from global memory. The searches
// themselves are the kernels' own (bidir_common.cuh, o2h_topk.cu).
#pragma once

#include "h2o_common.cuh"

// An invalid y sits at 1e15 per coordinate after centring (ops/chamfer_nn.FAR).
#define O2H_INVALID_Y 5e14f

// Stages frame f's rows (centred) and normals: xs[i] = (x - ctr, 0),
// ns[i] = (n, 0). Ends with a barrier.
__device__ __forceinline__ void o2h_stage_rows(
    float4* xs, float4* ns, const float* __restrict__ x, const float* __restrict__ n,
    const float* __restrict__ ctr, int f, int g, int P1) {
    const float c0 = ctr[3 * g + 0], c1 = ctr[3 * g + 1], c2 = ctr[3 * g + 2];
    for (int i = threadIdx.x; i < P1; i += blockDim.x) {
        const float* xp = x + ((size_t)f * P1 + i) * 3;
        const float* np_ = n + ((size_t)f * P1 + i) * 3;
        xs[i] = make_float4(__fsub_rn(xp[0], c0), __fsub_rn(xp[1], c1), __fsub_rn(xp[2], c2), 0.f);
        ns[i] = make_float4(np_[0], np_[1], np_[2], 0.f);
    }
    __syncthreads();
}

// n . (y - x) with pinned rounding: three f32 differences, then
// fl(n0 d0), fma(n1, d1, .), fma(n2, d2, .) (ops/chamfer_signed repeats it).
__device__ __forceinline__ float o2h_sign_numer(float4 xr, float4 nr, float4 y) {
    const float d0 = __fsub_rn(y.x, xr.x);
    const float d1 = __fsub_rn(y.y, xr.y);
    const float d2 = __fsub_rn(y.z, xr.z);
    return __fmaf_rn(nr.z, d2, __fmaf_rn(nr.y, d1, __fmul_rn(nr.x, d0)));
}

__device__ __forceinline__ float o2h_signf(float v) {
    return (float)((v > 0.f) - (v < 0.f));
}
