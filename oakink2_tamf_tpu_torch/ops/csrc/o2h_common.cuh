// Shared pieces of the object->hand (o2h) direction of the signed kernels
// (nn_signed.cu, dist_loss.cu): per object point y_j, the first hand row i
// that minimises ||x_i - y_j||^2, and the sign numerator n_i . (y_j - x_i)
// read from that row.
//
// Layout: a block stages its frame's hand rows, centred on the group's
// y-mean like the h2o kernels centre them, and their normals in shared
// memory as float4 (P1 x 32 bytes, 24.9 KB for the 778 MANO rows). Each
// thread owns O2H_COLS columns, strided by the block width so that loads
// and stores of neighbouring threads are neighbouring addresses, and keeps
// their points and running minima in registers: one broadcast shared load
// of a row serves O2H_COLS pairs.
#pragma once

#include "h2o_common.cuh"

#define O2H_THREADS 256
#define O2H_COLS 4
#define O2H_TILE (O2H_THREADS * O2H_COLS)  // columns per pass of a block
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

// Loads this thread's columns of the pass starting at j0 (dead columns past
// P2 get an invalid point and are never written).
__device__ __forceinline__ void o2h_load_cols(
    const float4* __restrict__ yg, int j0, int P2, float4 (&yv)[O2H_COLS]) {
#pragma unroll
    for (int c = 0; c < O2H_COLS; ++c) {
        const int j = j0 + c * O2H_THREADS + threadIdx.x;
        yv[c] = j < P2 ? yg[j] : make_float4(1e15f, 1e15f, 1e15f, 0.f);
    }
}

// First minimum over the rows for each of the thread's columns: a strict <
// over ascending i, starting at BIG, so an invalid column keeps (BIG, 0).
// The pair value is h2o_pair_d2 of (row, point), the h2o kernels' value.
__device__ __forceinline__ void o2h_scan(
    const float4* xs, int P1, const float4 (&yv)[O2H_COLS],
    float (&best)[O2H_COLS], int (&best_i)[O2H_COLS]) {
#pragma unroll
    for (int c = 0; c < O2H_COLS; ++c) {
        best[c] = H2O_BIG;
        best_i[c] = 0;
    }
#pragma unroll 2
    for (int i = 0; i < P1; ++i) {
        const float4 xr = xs[i];
#pragma unroll
        for (int c = 0; c < O2H_COLS; ++c) {
            const float d = h2o_pair_d2(xr.x, xr.y, xr.z, yv[c]);
            if (d < best[c]) {
                best[c] = d;
                best_i[c] = i;
            }
        }
    }
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
