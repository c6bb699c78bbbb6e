// Cluster-pruned hand->object nearest neighbour (h2o), forward: kernel #10.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_cluster.py
// `_h2o_topk_kernel` (:474; pallas_calls in `_h2o_cluster_forward` at :539
// and, as the h2o half of the signed route, in `_signed_cluster_forward` at
// :892). The object cloud of frame f, y[f / y_group], is cut into cells of
// 128 consecutive points (the collate step sorts clouds spatially, so cells
// are compact). The selection stage (ops/chamfer_cluster.h2o_select, plain
// PyTorch as XLA runs it on the TPU) gives every 128-row tile t of the
// template-permuted hand the K cells cidx[f, t, :] with the smallest
// conservative margin. For each row x_i of the tile this kernel returns
//   min over the K cells c and their points s of ||x_i - y_{128 c + s}||^2
// and the global index 128 c + s of the first point reaching it, visiting
// the cells in candidate order with a strict < and each cell's points in
// ascending order: the TPU's per-cell argmin followed by `m < best_d`. The
// result equals the all-pairs kernel (h2o_nn.cu) whenever no tile of the
// frame overflows its budget (the certificate, ops/chamfer_cluster
// .h2o_cluster_overflow), and is never below it: a subset search.
//
// Operands as ops/chamfer_nn.prepare makes them: y centred on its group's
// y-mean with invalid points at 1e15 per coordinate (they never win: an
// all-invalid cloud gives BIG, never inf), x centred as it loads. Each pair
// goes through h2o_common.cuh's h2o_pair_d2, so values are bit-identical to
// the other h2o kernels' on the pairs they share.
//
// Bound: floating-point work, 8 flops per pair searched, F x P1 x K x 128
// pairs (~11.7 ms at the R training shape, 40960 frames x 778 rows x 24
// cells, at 67 TFLOP/s FP32). The TPU runs each [128, 128] candidate block
// on its matrix unit by expansion; this card has no such use for a 3-deep
// contraction, so, as in h2o_nn.cu: one block of 128 threads per (frame,
// 128-row tile), one row per thread; the tile's candidate cells are staged
// in shared memory four at a time (512 points, 8 KB of float4) between two
// barriers, and every thread reads each staged point as a broadcast. Rows
// past P1 (the pad of the last tile) take part in the barriers and compute
// nothing; points past P2 in the last cell are never staged or read.

#include "h2o_common.cuh"

#define TOPK_CELL 128        // points per cell (ops/chamfer_cluster.S_CELL) == block size
#define TOPK_STAGE_CELLS 4   // candidate cells staged per pass

__global__ void __launch_bounds__(TOPK_CELL)
h2o_topk_kernel(const float* __restrict__ x,      // [F, P1, 3] permuted rows
                const float4* __restrict__ y,     // [G, P2] centred, invalid at FAR
                const float* __restrict__ ctr,    // [G, 3]
                const int* __restrict__ cidx,     // [F, T, K] candidate cells
                float* __restrict__ d_out,        // [F, P1]
                int* __restrict__ i_out,          // [F, P1]
                int P1, int P2, int y_group, int T, int K) {
    __shared__ float4 ys[TOPK_STAGE_CELLS * TOPK_CELL];
    const long long blk = blockIdx.x;
    const int f = (int)(blk / T);
    const int t = (int)(blk - (long long)f * T);
    const int g = f / y_group;
    const int C = (P2 + TOPK_CELL - 1) / TOPK_CELL;
    const int row = t * TOPK_CELL + threadIdx.x;
    float x0, x1, x2;
    const bool live = h2o_load_row(x, ctr, f, g, row, P1, x0, x1, x2);
    const int* cl = cidx + ((size_t)f * T + t) * K;
    const float4* yg = y + (size_t)g * P2;
    float best = H2O_BIG;
    int best_j = 0;
    for (int k0 = 0; k0 < K; k0 += TOPK_STAGE_CELLS) {
        const int nc = min(TOPK_STAGE_CELLS, K - k0);
        int cell[TOPK_STAGE_CELLS];
#pragma unroll
        for (int q = 0; q < TOPK_STAGE_CELLS; ++q) {
            // block-uniform: an id out of range (never written by the
            // selection) is skipped, never read
            const int c = q < nc ? cl[k0 + q] : -1;
            cell[q] = (unsigned)c < (unsigned)C ? c : -1;
            const int j = cell[q] * TOPK_CELL + threadIdx.x;
            if (cell[q] >= 0 && j < P2) ys[q * TOPK_CELL + threadIdx.x] = yg[j];
        }
        __syncthreads();
        if (live) {
#pragma unroll
            for (int q = 0; q < TOPK_STAGE_CELLS; ++q) {
                if (cell[q] < 0) continue;
                const int j0 = cell[q] * TOPK_CELL;
                const int n = min(TOPK_CELL, P2 - j0);
                const float4* yc = ys + q * TOPK_CELL;
#pragma unroll 8
                for (int s = 0; s < n; ++s) {
                    const float d = h2o_pair_d2(x0, x1, x2, yc[s]);
                    if (d < best) {  // strict: candidate order, then ascending s
                        best = d;
                        best_j = j0 + s;
                    }
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

extern "C" int h2o_topk_launch(const float* x, const float4* y, const float* ctr,
                               const int* cidx, float* d_out, int* i_out,
                               int F, int P1, int P2, int y_group, int T, int K,
                               cudaStream_t stream) {
    if (F <= 0 || P1 <= 0 || P2 <= 0) return 0;
    h2o_topk_kernel<<<(unsigned)((long long)F * T), TOPK_CELL, 0, stream>>>(
        x, y, ctr, cidx, d_out, i_out, P1, P2, y_group, T, K);
    return (int)cudaGetLastError();
}
