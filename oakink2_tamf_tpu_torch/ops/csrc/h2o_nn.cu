// All-pairs hand->object nearest neighbour (h2o), forward only.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_pallas.py
// `_nn_h2o_kernel` (:354, pallas_call in `_nn_h2o_forward` at :389): per
// frame f and hand row i, the min over the frame's object cloud
// y[f / y_group] of ||x_i - y_j||^2 and its first-min index j.
//
// Bound: floating-point work, 8 flops per (x, y) pair on the non-tensor
// FP32 pipes; the bytes moved (x once, y once per group, d and idx out) are
// tiny beside it. Design for that bound: one block of 128 threads per
// (frame, 128-row region), one x row per thread held in registers; the
// frame's cloud streams through shared memory in 512-point stages and every
// thread reads each staged point as a broadcast, so the inner loop is one
// shared load and the pair arithmetic per pair. Dead rows past P1 (778 ->
// 7 regions of 128) idle in the last region.

#include "h2o_common.cuh"

__global__ void __launch_bounds__(H2O_REGION_ROWS)
h2o_nn_kernel(const float* __restrict__ x,     // [F, P1, 3]
              const float4* __restrict__ y,    // [G, P2] centred, invalid at 1e15
              const float* __restrict__ ctr,   // [G, 3] y-mean per group
              float* __restrict__ d_out,       // [F, P1] min squared distance
              int* __restrict__ i_out,         // [F, P1] first argmin
              int P1, int P2, int y_group, int R) {
    __shared__ float4 ys[H2O_Y_STAGE];
    const long long blk = blockIdx.x;
    const int f = (int)(blk / R);
    const int r = (int)(blk - (long long)f * R);
    const int g = f / y_group;
    const int row = r * H2O_REGION_ROWS + threadIdx.x;
    float x0, x1, x2;
    const bool live = h2o_load_row(x, ctr, f, g, row, P1, x0, x1, x2);
    const float4* yg = y + (size_t)g * P2;

    float best = H2O_BIG;
    int best_j = 0;
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
    if (live) {
        d_out[(size_t)f * P1 + row] = best;
        i_out[(size_t)f * P1 + row] = best_j;
    }
}

extern "C" int h2o_nn_launch(const float* x, const float4* y, const float* ctr,
                             float* d_out, int* i_out,
                             int F, int P1, int P2, int y_group, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0) return 0;
    const int R = (P1 + H2O_REGION_ROWS - 1) / H2O_REGION_ROWS;
    const unsigned blocks = (unsigned)((long long)F * R);
    h2o_nn_kernel<<<blocks, H2O_REGION_ROWS, 0, stream>>>(
        x, y, ctr, d_out, i_out, P1, P2, y_group, R);
    return (int)cudaGetLastError();
}
