// All-pairs hand->object nearest neighbour (h2o), forward only: kernel #1.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_pallas.py
// `_nn_h2o_kernel` (:354, pallas_call in `_nn_h2o_forward` at :389): per
// frame f and hand row i, the min over the frame's object cloud
// y[f / y_group] of ||x_i - y_j||^2 and its first-min index j.
//
// Bound: floating-point work, 8 flops per (real row, valid point) pair on
// the non-tensor FP32 pipes; the bytes moved (x once, y once per group, the
// cell flags, d and idx out) are tiny beside it. The search issues at least
// 7 instructions per pair (the pinned distance's 6 and a minimum).
//
// Design: h2o_cells_common.cuh's cell search (h2o_cells_block), shared with
// #2, #3, #4 and #10: one block of CELLS_THREADS per (frame, 128-row
// region); warp 0 lists the 128-point cells of the cloud that hold a valid
// point (`live`, one byte per cell, which the wrapper derives from the
// prepared cloud), ascending, and the warp sets split them. A cell of
// invalid points only can never lower a row (d ~ 3e30 > BIG), so the skip
// is exact: a padded object slot's all-invalid cloud lists no cell and its
// rows come out (BIG, 0) at once. Each thread holds 4 rows, so one broadcast
// shared load feeds 4 pairs; the fast path keeps a per-segment fminf, and
// the first point is found again in the winning 32-point segment. Rows of
// x_valid=False frames are searched like any other (the TPU kernel takes no
// x mask).
//
// Measured with topk_variants.py --all-pairs on an NVIDIA H100 80GB HBM3
// (power limit 700.00 W) at 10240 frames x 778 rows x 2048 points: 4.960-
// 4.964 ms (the previous design 6.274-6.275 ms in the same run). ptxas: 60
// registers, no spills; the layout is #4's (one warp set costs 2.2% here).

#include "h2o_cells_common.cuh"

__global__ void __launch_bounds__(CELLS_THREADS, CELLS_MIN_BLOCKS)
h2o_nn_kernel(const float* __restrict__ x,     // [F, P1, 3]
              const float4* __restrict__ y,    // [G, P2] centred, invalid at 1e15
              const float* __restrict__ ctr,   // [G, 3] y-mean per group
              const unsigned char* __restrict__ live,  // [G, C] the cell holds a valid point
              float* __restrict__ d_out,       // [F, P1] min squared distance
              int* __restrict__ i_out,         // [F, P1] first argmin
              int P1, int P2, int y_group, int R) {
    const int C = (P2 + CELL_PTS - 1) / CELL_PTS;
    h2o_cells_block<CELLS_INDEX>(
        x, y, ctr, d_out, i_out, nullptr, P1, P2, y_group, R,
        [&](int, int, int g, int c) { return live[(size_t)g * C + c] != 0; });
}

extern "C" int h2o_nn_launch(const float* x, const float4* y, const float* ctr,
                             const unsigned char* live, float* d_out, int* i_out,
                             int F, int P1, int P2, int y_group, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0) return 0;
    const int R = (P1 + CELL_PTS - 1) / CELL_PTS;
    const size_t smem = h2o_cells_smem(h2o_nn_kernel, P2);
    h2o_nn_kernel<<<(unsigned)((long long)F * R), CELLS_THREADS, smem, stream>>>(
        x, y, ctr, live, d_out, i_out, P1, P2, y_group, R);
    return (int)cudaGetLastError();
}
