// Bounds-culled exact hand->object nearest neighbour (h2o) with the offset
// to the nearest point, the forward of the differentiated culled route:
// kernel #3.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_cull.py
// `_cull_dvec_kernel` (:204, pallas_call in `_cull_forward(with_dvec=True)`
// at :284): h2o_cull.cu's culled minimum of ||x_i - y_j||^2, plus
// dvec_i = x_i - y_{j*} (centred) at the first minimum j* among the pairs
// the mask keeps, in ascending point order. The backward is then
// elementwise (core/geometry.py). Rows that never took a point
// (x_valid=False frames, every tile culled, all-invalid clouds) come out at
// BIG with dvec = 0.
//
// Bound: floating-point work, 8 flops per (real row, point) pair of the
// blocks the mask keeps; at least 7 instructions per pair issued.
//
// Design: #2's block (h2o_cells_block in h2o_cells_common.cuh: one
// block per frame x 128-row region, the kept 128-point cells listed
// ascending and split among 4 warp sets, 4 rows per thread, per-segment
// minima merged per row on (value, rank)), with the first point found
// again in the winning 32-point segment; dvec costs one load of y4[g, j*]
// per row at the end, in place of the TPU's one-hot lane sums per tile.

#include "h2o_cells_common.cuh"

__global__ void __launch_bounds__(CELLS_THREADS, CELLS_MIN_BLOCKS)
h2o_cull_dvec_kernel(const float* __restrict__ x,     // [F, P1, 3]
                     const float4* __restrict__ y,    // [G, P2] centred, invalid at 1e15
                     const float* __restrict__ ctr,   // [G, 3]
                     const int* __restrict__ mask,    // [F, R, T] 1 = run the block
                     float* __restrict__ d_out,       // [F, P1]
                     float* __restrict__ dvec,        // [F, P1, 3]
                     int P1, int P2, int y_group, int R, int T, int tile) {
    const int cells_per_tile = tile / CELL_PTS;
    h2o_cells_block<CELLS_DVEC>(
        x, y, ctr, d_out, nullptr, dvec, P1, P2, y_group, R,
        [&](int f, int r, int, int c) { return mask[((size_t)f * R + r) * T + c / cells_per_tile] != 0; });
}

extern "C" int h2o_cull_dvec_launch(const float* x, const float4* y, const float* ctr,
                                    const int* mask, float* d_out, float* dvec,
                                    int F, int P1, int P2, int y_group, int T, int tile,
                                    cudaStream_t stream) {
    if (F <= 0 || P1 <= 0) return 0;
    if (tile <= 0 || tile % CELL_PTS != 0) return (int)cudaErrorInvalidValue;
    const int R = (P1 + CELL_PTS - 1) / CELL_PTS;
    const size_t smem = h2o_cells_smem(h2o_cull_dvec_kernel, P2);
    h2o_cull_dvec_kernel<<<(unsigned)((long long)F * R), CELLS_THREADS, smem, stream>>>(
        x, y, ctr, mask, d_out, dvec, P1, P2, y_group, R, T, tile);
    return (int)cudaGetLastError();
}
