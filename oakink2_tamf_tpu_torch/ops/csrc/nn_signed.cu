// Signed bidirectional hand/object nearest neighbour, forward.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_pallas.py `_nn_kernel`
// (:97, pallas_call in `_nn_forward` at :306). For frame f, its hand rows
// x_i with normals n_i and its object cloud y_j = y[f / y_group]:
//   h2o: min_j ||x_i - y_j||^2 and the first j reaching it      [F, P1] x 2
//   o2h: min_i ||x_i - y_j||^2, the first i* reaching it, and
//        the sign numerator n_{i*} . (y_j - x_{i*})                [F, P2] x 3
// Operands as ops/chamfer_nn.prepare makes them: y centred on its group's
// y-mean with invalid points at 1e15 (they never win a row; their own o2h
// outputs are (BIG, 0, .) and callers mask them), x centred as it loads.
//
// Bound: floating-point work, 8 flops per (x, y) pair; the bytes (x, n and
// y once, five [F, P] outputs) are far below it. The TPU gets both
// directions from one [P1, tile] distance block; on this card two simple
// passes are used, each reusing a proven layout, so every pair is computed
// twice (2x the bound's work):
//   h2o: h2o_common.cuh's row search, the exact loop of h2o_nn.cu, so its
//        values are bit-identical to kernels h2o_nn and h2o_cull;
//   o2h: one block of 256 threads per (frame, 1024-column tile); the
//        frame's 778 centred rows and normals sit in shared memory (24.9
//        KB); each thread keeps 4 columns in registers, so one broadcast
//        shared load serves 4 pairs; the winning row's normal and
//        coordinates are a shared-memory load, no gather through device
//        memory and no one-hot product.

#include "o2h_common.cuh"

__global__ void __launch_bounds__(H2O_REGION_ROWS)
nn_signed_h2o_kernel(const float* __restrict__ x, const float4* __restrict__ y,
                     const float* __restrict__ ctr, float* __restrict__ d_out,
                     int* __restrict__ i_out, int P1, int P2, int y_group, int R) {
    h2o_nn_block(x, y, ctr, d_out, i_out, P1, P2, y_group, R);
}

__global__ void __launch_bounds__(O2H_THREADS)
nn_signed_o2h_kernel(const float* __restrict__ x,     // [F, P1, 3]
                     const float* __restrict__ n,     // [F, P1, 3] normals
                     const float4* __restrict__ y,    // [G, P2] centred
                     const float* __restrict__ ctr,   // [G, 3]
                     float* __restrict__ o2h_d,       // [F, P2]
                     int* __restrict__ o2h_i,         // [F, P2]
                     float* __restrict__ o2h_dot,     // [F, P2]
                     int P1, int P2, int y_group, int T) {
    extern __shared__ float4 smem[];
    float4* xs = smem;
    float4* ns = smem + P1;
    const long long blk = blockIdx.x;
    const int f = (int)(blk / T);
    const int t = (int)(blk - (long long)f * T);
    const int g = f / y_group;
    o2h_stage_rows(xs, ns, x, n, ctr, f, g, P1);

    const int j0 = t * O2H_TILE;
    float4 yv[O2H_COLS];
    o2h_load_cols(y + (size_t)g * P2, j0, P2, yv);
    float best[O2H_COLS];
    int best_i[O2H_COLS];
    o2h_scan(xs, P1, yv, best, best_i);
#pragma unroll
    for (int c = 0; c < O2H_COLS; ++c) {
        const int j = j0 + c * O2H_THREADS + threadIdx.x;
        if (j < P2) {
            const size_t o = (size_t)f * P2 + j;
            o2h_d[o] = best[c];
            o2h_i[o] = best_i[c];
            o2h_dot[o] = o2h_sign_numer(xs[best_i[c]], ns[best_i[c]], yv[c]);
        }
    }
}

extern "C" int nn_signed_launch(const float* x, const float* n, const float4* y,
                                const float* ctr, float* h2o_d, int* h2o_i,
                                float* o2h_d, int* o2h_i, float* o2h_dot,
                                int F, int P1, int P2, int y_group, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0 || P2 <= 0) return 0;
    const int R = (P1 + H2O_REGION_ROWS - 1) / H2O_REGION_ROWS;
    nn_signed_h2o_kernel<<<(unsigned)((long long)F * R), H2O_REGION_ROWS, 0, stream>>>(
        x, y, ctr, h2o_d, h2o_i, P1, P2, y_group, R);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int T = (P2 + O2H_TILE - 1) / O2H_TILE;
    const size_t smem = (size_t)P1 * 2 * sizeof(float4);
    nn_signed_o2h_kernel<<<(unsigned)((long long)F * T), O2H_THREADS, smem, stream>>>(
        x, n, y, ctr, o2h_d, o2h_i, o2h_dot, P1, P2, y_group, T);
    return (int)cudaGetLastError();
}
