// All-pairs hand->object nearest neighbour (h2o) with the offset to the
// nearest point, the forward of the differentiated h2o route: kernel #4.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_pallas.py
// `_nn_h2o_dvec_kernel` (:408, pallas_call in `_nn_h2o_dvec_forward` at
// :476): per frame f and hand row i, the min over the frame's object cloud
// y[f / y_group] of ||x_i - y_j||^2, and dvec_i = x_i - y_{j*} (both
// centred on the group's y-mean) at the first minimum j*. With dvec the
// backward is elementwise: d dist_i / d x_i = dvec_i / dist_i.
//
// Bound: floating-point work, 8 flops per (real row, valid point) pair on
// the non-tensor FP32 pipes, as h2o_nn.cu; dvec adds a 12-byte store per
// row. At least 7 instructions issued per pair.
//
// Design: #1's block (h2o_cells_block in h2o_cells_common.cuh over the
// cells of the cloud that hold a valid point, ascending, split among the
// warp sets; 4 rows per thread, per-segment minima merged per row on
// (value, rank)), with the first point found again in the winning 32-point
// segment; dvec costs one load of y4[g, j*] per row at the end, in place of
// the TPU's one-hot lane sums per tile. A row that took no point (an
// all-invalid cloud: no cell listed) writes BIG and dvec = 0, so the FAR
// coordinate never reaches a gradient.
//
// Measured with topk_variants.py --all-pairs on an NVIDIA H100 80GB HBM3
// (power limit 700.00 W) at 40960 frames x 778 rows x 2048 points (y_group
// 160, 4078 of 4096 cells live): 20.641-20.653 ms (the previous design, one
// row per thread with a compare and two selects per pair, 25.081-25.091 ms
// in the same run), 65.8% of the 7-instruction issue floor. ptxas: 60
// registers, no spills. Of the layouts tried (1 to 4 warp sets, 2 or 4
// rows per thread, 32- or 64-point segments, 8-32 blocks per SM) the
// shipped one is the fastest; one warp set per 128 rows costs 1.1%.

#include "h2o_cells_common.cuh"

__global__ void __launch_bounds__(CELLS_THREADS, CELLS_MIN_BLOCKS)
h2o_nn_dvec_kernel(const float* __restrict__ x,     // [F, P1, 3]
                   const float4* __restrict__ y,    // [G, P2] centred, invalid at 1e15
                   const float* __restrict__ ctr,   // [G, 3] y-mean per group
                   const unsigned char* __restrict__ live,  // [G, C] the cell holds a valid point
                   float* __restrict__ d_out,       // [F, P1] min squared distance
                   float* __restrict__ dvec,        // [F, P1, 3] x - y* (centred)
                   int P1, int P2, int y_group, int R) {
    const int C = (P2 + CELL_PTS - 1) / CELL_PTS;
    h2o_cells_block<CELLS_DVEC>(
        x, y, ctr, d_out, nullptr, dvec, P1, P2, y_group, R,
        [&](int, int, int g, int c) { return live[(size_t)g * C + c] != 0; });
}

extern "C" int h2o_nn_dvec_launch(const float* x, const float4* y, const float* ctr,
                                  const unsigned char* live, float* d_out, float* dvec,
                                  int F, int P1, int P2, int y_group, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0) return 0;
    const int R = (P1 + CELL_PTS - 1) / CELL_PTS;
    const size_t smem = h2o_cells_smem(h2o_nn_dvec_kernel, P2);
    h2o_nn_dvec_kernel<<<(unsigned)((long long)F * R), CELLS_THREADS, smem, stream>>>(
        x, y, ctr, live, d_out, dvec, P1, P2, y_group, R);
    return (int)cudaGetLastError();
}
