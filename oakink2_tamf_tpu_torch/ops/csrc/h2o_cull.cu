// Bounds-culled exact hand->object nearest distance (h2o), forward only:
// kernel #2.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_cull.py
// `_cull_fwd_kernel` (:179, pallas_call in `_cull_forward(with_dvec=False)`
// at :307): the min over y of ||x_i - y_j||^2 like h2o_nn.cu, skipping every
// (frame, 128-row region, y-tile) block whose triangle-inequality bound says
// it cannot hold a row's minimum. The skip mask [F, R, T] comes from
// ops/chamfer_cull.cull_mask (plain PyTorch, as the TPU path's is XLA); its
// tile is a multiple of 128 points. A row whose every tile is culled
// (x_valid=False frames, all-invalid clouds) comes out BIG.
//
// Bound: floating-point work, 8 flops per (real row, point) pair of the
// blocks the mask keeps; the search issues at least 7 instructions per pair
// (the pinned distance's 6 and a minimum).
//
// Design: h2o_cells_common.cuh's cell search, shared with #3 and #10
// (h2o_cells_block): one block of CELLS_THREADS per (frame, region);
// the region's kept tiles, listed as the 128-point cells they hold, are
// split among 4 warp sets, each thread holding 4 rows (one broadcast
// shared load feeds 4 pairs) and keeping a per-segment fminf. With the mask
// at the port's tile of 128 points (ops/chamfer_cull.h2o_cull) a cell is
// searched only if its own bound can hold a row's minimum. No index is
// kept, so the winning segment is not re-scanned.

#include "h2o_cells_common.cuh"

__global__ void __launch_bounds__(CELLS_THREADS, CELLS_MIN_BLOCKS)
h2o_cull_kernel(const float* __restrict__ x,     // [F, P1, 3]
                const float4* __restrict__ y,    // [G, P2] centred, invalid at 1e15
                const float* __restrict__ ctr,   // [G, 3]
                const int* __restrict__ mask,    // [F, R, T] 1 = run the block
                float* __restrict__ d_out,       // [F, P1]
                int P1, int P2, int y_group, int R, int T, int tile) {
    const int cells_per_tile = tile / CELL_PTS;
    h2o_cells_block<CELLS_MIN>(
        x, y, ctr, d_out, nullptr, nullptr, P1, P2, y_group, R,
        [&](int f, int r, int, int c) { return mask[((size_t)f * R + r) * T + c / cells_per_tile] != 0; });
}

extern "C" int h2o_cull_launch(const float* x, const float4* y, const float* ctr,
                               const int* mask, float* d_out,
                               int F, int P1, int P2, int y_group, int T, int tile,
                               cudaStream_t stream) {
    if (F <= 0 || P1 <= 0) return 0;
    if (tile <= 0 || tile % CELL_PTS != 0) return (int)cudaErrorInvalidValue;
    const int R = (P1 + CELL_PTS - 1) / CELL_PTS;
    const size_t smem = h2o_cells_smem(h2o_cull_kernel, P2);
    h2o_cull_kernel<<<(unsigned)((long long)F * R), CELLS_THREADS, smem, stream>>>(
        x, y, ctr, mask, d_out, P1, P2, y_group, R, T, tile);
    return (int)cudaGetLastError();
}
