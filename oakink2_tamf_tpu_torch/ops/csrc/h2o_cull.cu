// Bounds-culled exact hand->object nearest distance (h2o), forward only.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_cull.py
// `_cull_fwd_kernel` (:179, pallas_call in `_cull_forward(with_dvec=False)`
// at :307): the min over y of ||x_i - y_j||^2 like h2o_nn.cu, skipping every
// (frame, 128-row region, y-tile) block whose triangle-inequality bound says
// it cannot hold a row's minimum. The skip mask [F, R, T] comes from
// ops/chamfer_cull.cull_mask (plain PyTorch, as the TPU path's is XLA).
//
// Bound: floating-point work, 8 flops per pair the mask keeps. Design for
// that bound: the h2o_nn.cu block shape (one block per frame x region, one
// row per thread, y staged through shared memory); the block reads its mask
// row and jumps over culled tiles (h2o_cull_row_scan, shared with
// h2o_cull_dvec.cu; the index it keeps is dead code here). A row whose every
// tile is culled (x_valid=False frames, all-invalid clouds) comes out BIG.

#include "h2o_common.cuh"

__global__ void __launch_bounds__(H2O_REGION_ROWS)
h2o_cull_kernel(const float* __restrict__ x,     // [F, P1, 3]
                const float4* __restrict__ y,    // [G, P2] centred, invalid at 1e15
                const float* __restrict__ ctr,   // [G, 3]
                const int* __restrict__ mask,    // [F, R, T] 1 = run the block
                float* __restrict__ d_out,       // [F, P1]
                int P1, int P2, int y_group, int R, int T, int tile) {
    __shared__ float4 ys[H2O_Y_STAGE];
    const long long blk = blockIdx.x;
    const int f = (int)(blk / R);
    const int r = (int)(blk - (long long)f * R);
    const int g = f / y_group;
    const int row = r * H2O_REGION_ROWS + threadIdx.x;
    float x0, x1, x2;
    const bool live = h2o_load_row(x, ctr, f, g, row, P1, x0, x1, x2);
    float best;
    int best_j;  // unused here: h2o_cull_dvec.cu reads it
    h2o_cull_row_scan(ys, y + (size_t)g * P2, mask + ((size_t)f * R + r) * T, T, tile, P2, live,
                      x0, x1, x2, best, best_j);
    if (live) d_out[(size_t)f * P1 + row] = best;
}

extern "C" int h2o_cull_launch(const float* x, const float4* y, const float* ctr,
                               const int* mask, float* d_out,
                               int F, int P1, int P2, int y_group, int T, int tile,
                               cudaStream_t stream) {
    if (F <= 0 || P1 <= 0) return 0;
    const int R = (P1 + H2O_REGION_ROWS - 1) / H2O_REGION_ROWS;
    const unsigned blocks = (unsigned)((long long)F * R);
    h2o_cull_kernel<<<blocks, H2O_REGION_ROWS, 0, stream>>>(
        x, y, ctr, mask, d_out, P1, P2, y_group, R, T, tile);
    return (int)cudaGetLastError();
}
