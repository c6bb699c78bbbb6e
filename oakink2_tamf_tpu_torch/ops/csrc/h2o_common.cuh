// Shared pieces of the kernels that search a hand row's nearest object
// point (h2o_nn.cu, h2o_cull.cu, h2o_nn_dvec.cu, h2o_cull_dvec.cu,
// nn_signed.cu, dist_loss.cu).
//
// Every kernel computes each (x, y) pair's squared distance with the one
// function below, so their minima are bit-identical: the culled kernel only
// skips pairs that provably cannot hold the minimum, and the signed kernels'
// object->hand direction sees the same value for a pair as the h2o one.
#pragma once

#include "launch_common.cuh"

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

// The all-pairs row search of one (frame, 128-row region) block: the first
// minimum over the frame's whole cloud y[f / y_group] of this thread's row.
// The cloud streams through shared memory in 512-point stages; every
// thread reads each staged point as a broadcast. Dead rows (live == false)
// take part in the barriers and compute nothing; they return BIG, 0.
__device__ __forceinline__ void h2o_row_scan(
    float4* ys, const float4* __restrict__ yg, int P2, bool live,
    float x0, float x1, float x2, float& best, int& best_j) {
    best = H2O_BIG;
    best_j = 0;
    for (int j0 = 0; j0 < P2; j0 += H2O_Y_STAGE) {
        const int n = min(H2O_Y_STAGE, P2 - j0);
        h2o_stage_y(ys, yg, j0, n);
        __syncthreads();
        if (live) {
#pragma unroll 8
            for (int k = 0; k < n; ++k) {
                const float d = h2o_pair_d2(x0, x1, x2, ys[k]);
                if (d < best) {  // strict: ascending j, the first minimum wins
                    best = d;
                    best_j = j0 + k;
                }
            }
        }
        __syncthreads();
    }
}

// The culled row search with the first-min index (h2o_cull_dvec.cu): like
// h2o_row_scan over the tiles whose mask entry m[t] is set, in ascending
// tile order with a strict <, so the index is the first minimum among the
// pairs searched. The mask entry is block-uniform: a skipped tile costs no
// divergence and the barriers stay balanced. best stays BIG when every
// tile was culled.
__device__ __forceinline__ void h2o_cull_row_scan(
    float4* ys, const float4* __restrict__ yg, const int* __restrict__ m,
    int T, int tile, int P2, bool live,
    float x0, float x1, float x2, float& best, int& best_j) {
    best = H2O_BIG;
    best_j = 0;
    for (int t = 0; t < T; ++t) {
        if (m[t] == 0) continue;
        const int c1 = min((t + 1) * tile, P2);
        for (int j0 = t * tile; j0 < c1; j0 += H2O_Y_STAGE) {
            const int n = min(H2O_Y_STAGE, c1 - j0);
            h2o_stage_y(ys, yg, j0, n);
            __syncthreads();
            if (live) {
#pragma unroll 8
                for (int k = 0; k < n; ++k) {
                    const float d = h2o_pair_d2(x0, x1, x2, ys[k]);
                    if (d < best) {
                        best = d;
                        best_j = j0 + k;
                    }
                }
            }
            __syncthreads();
        }
    }
}

// Writes a live row's min and dvec = x - y[best_j] (centred). A row whose
// min is still BIG took no point (all tiles culled, or an all-invalid
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

// The body of the all-pairs h2o kernel (h2o_nn.cu; the h2o half of
// nn_signed.cu): block = (frame, 128-row region), one row per thread.
__device__ __forceinline__ void h2o_nn_block(
    const float* __restrict__ x, const float4* __restrict__ y,
    const float* __restrict__ ctr, float* __restrict__ d_out, int* __restrict__ i_out,
    int P1, int P2, int y_group, int R) {
    __shared__ float4 ys[H2O_Y_STAGE];
    const long long blk = blockIdx.x;
    const int f = (int)(blk / R);
    const int r = (int)(blk - (long long)f * R);
    const int g = f / y_group;
    const int row = r * H2O_REGION_ROWS + threadIdx.x;
    float x0, x1, x2;
    const bool live = h2o_load_row(x, ctr, f, g, row, P1, x0, x1, x2);
    float best;
    int best_j;
    h2o_row_scan(ys, y + (size_t)g * P2, P2, live, x0, x1, x2, best, best_j);
    if (live) {
        d_out[(size_t)f * P1 + row] = best;
        i_out[(size_t)f * P1 + row] = best_j;
    }
}
