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
// ascending order: the TPU's per-cell argmin followed by `m < best_d`. A
// candidate id outside [0, C) is skipped; a row that finds nothing keeps
// (BIG, 0). The result equals the all-pairs kernel (h2o_nn.cu) whenever no
// tile of the frame overflows its budget (the certificate,
// ops/chamfer_cluster.h2o_cluster_overflow), and is never below it: a
// subset search.
//
// Operands as ops/chamfer_nn.prepare makes them: y centred on its group's
// y-mean with invalid points at 1e15 per coordinate (they never win: an
// all-invalid cloud gives BIG, never inf), x centred as it loads; and
// `live` [G, C], one byte per cell that holds a valid point, which the
// wrapper derives from y itself. Each pair goes through h2o_common.cuh's
// h2o_pair_d2, so values are bit-identical to the other h2o kernels' on the
// pairs they share.
//
// Bound: floating-point work, 8 flops per pair that can count: each tile's
// real rows against the valid points of its candidate cells. At the R
// training shape (40960 frames x 778 rows x 8192 points, K = 24, y_group
// 160; 26880 of the frames hold a real object) that is 6.42e10 pairs, 7.7
// ms at the H100 SXM's 67 TFLOP/s FP32; it issues at least 7 instructions
// per pair (the pinned distance's 6 and a minimum), a floor of 13.4 ms at
// 33.45e12 lane-instructions/s.
//
// Design: one block of CELLS_THREADS (128) threads per (frame, tile) running
// h2o_cells_common.cuh's search over the tile's candidate list. A cell
// without a valid point is skipped, warp-uniformly, on its `live` byte: the
// padded object slots' frames (all cells empty, yet each tile handed 24 by
// the selection) then search nothing: at that shape 7.40e10 pairs of
// 128-row tiles are searched, not 1.13e11 (the bound's 6.42e10 on real
// rows, not 9.79e10). Each thread holds 4 rows, so one broadcast shared load
// feeds 4 pairs; the 4 warps split the K cells and merge per row in shared
// memory; the fast path is a per-segment fminf (7.375 SASS instructions per
// pair, the shared load included), and the first point is found again in
// the winning 32-point segment. The last tile (10 real rows) walks its
// cells with one row per lane, 32 rows, not 128 (6.60e10 pairs searched).
//
// Measured with topk_variants.py on an NVIDIA H100 80GB HBM3 (power limit
// 700.00 W) at that shape: 20.312 ms (the previous design, one row per
// thread with a compare and two selects per pair, 39.285-39.301 ms in the
// same run; this one without the skip 29.250-29.255 ms), 37.8% of
// the flop bound and 66.2% of the 7-instruction issue floor. ptxas: 61
// registers, no spills, 11264 bytes of shared memory. Of the layouts tried
// (1-4 rows per thread, 2-8 warp sets, 32-128-point segments, 2-12 blocks
// per SM), the shipped one is the fastest; segments of 128 points (the
// re-scan over a whole cell) cost 2%.

#include "h2o_cells_common.cuh"

__global__ void __launch_bounds__(CELLS_THREADS, CELLS_MIN_BLOCKS)
h2o_topk_kernel(const float* __restrict__ x,      // [F, P1, 3] permuted rows
                const float4* __restrict__ y,     // [G, P2] centred, invalid at FAR
                const float* __restrict__ ctr,    // [G, 3]
                const int* __restrict__ cidx,     // [F, T, K] candidate cells
                const unsigned char* __restrict__ live,  // [G, C] the cell holds a valid point
                float* __restrict__ d_out,        // [F, P1]
                int* __restrict__ i_out,          // [F, P1]
                int P1, int P2, int y_group, int T, int K) {
    __shared__ CellsShared sh;
    const long long blk = blockIdx.x;
    const int f = (int)(blk / T);
    const int t = (int)(blk - (long long)f * T);
    const int g = f / y_group;
    const int C = (P2 + CELL_PTS - 1) / CELL_PTS;
    const int* cl = cidx + ((size_t)f * T + t) * K;
    const unsigned char* lv = live + (size_t)g * C;
    h2o_cells_search(
        sh, x, ctr, f, g, t * CELL_PTS, P1, y + (size_t)g * P2, P2, K,
        [&](int k) {  // an id out of range (never written by the selection) or an empty cell: skip
            const int c = cl[k];
            return (unsigned)c < (unsigned)C && lv[c] ? c * CELL_PTS : -1;
        },
        [&](int row, float d, int j) {
            d_out[(size_t)f * P1 + row] = d;
            i_out[(size_t)f * P1 + row] = j;
        });
}

extern "C" int h2o_topk_launch(const float* x, const float4* y, const float* ctr,
                               const int* cidx, const unsigned char* live, float* d_out, int* i_out,
                               int F, int P1, int P2, int y_group, int T, int K,
                               cudaStream_t stream) {
    if (F <= 0 || P1 <= 0 || P2 <= 0) return 0;
    h2o_topk_kernel<<<(unsigned)((long long)F * T), CELLS_THREADS, 0, stream>>>(
        x, y, ctr, cidx, live, d_out, i_out, P1, P2, y_group, T, K);
    return (int)cudaGetLastError();
}
