// Bounds-culled exact hand->object nearest neighbour (h2o) with the offset
// to the nearest point, the forward of the differentiated culled route.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_cull.py
// `_cull_dvec_kernel` (:204, pallas_call in `_cull_forward(with_dvec=True)`
// at :284): h2o_cull.cu's culled minimum of ||x_i - y_j||^2, plus
// dvec_i = x_i - y_{j*} (centred) at the first minimum j* among the pairs
// the mask keeps. The backward is then elementwise (ops/chamfer_cull.py).
//
// Bound: floating-point work, 8 flops per pair the mask keeps. Design: the
// h2o_cull.cu block shape (one block per frame x 128-row region, one row
// per thread, y staged through shared memory, block-uniform mask skip);
// the minimum is kept with its index by a strict < over ascending tiles
// (h2o_cull_row_scan, shared with h2o_cull.cu), and dvec costs one load of
// y4[g, j*] per row at the end, in place of the TPU's one-hot lane sums
// per tile. Rows that never took a point (x_valid=False frames, every tile
// culled, all-invalid clouds) come out at BIG with dvec = 0.

#include "h2o_common.cuh"

__global__ void __launch_bounds__(H2O_REGION_ROWS)
h2o_cull_dvec_kernel(const float* __restrict__ x,     // [F, P1, 3]
                     const float4* __restrict__ y,    // [G, P2] centred, invalid at 1e15
                     const float* __restrict__ ctr,   // [G, 3]
                     const int* __restrict__ mask,    // [F, R, T] 1 = run the block
                     float* __restrict__ d_out,       // [F, P1]
                     float* __restrict__ dvec,        // [F, P1, 3]
                     int P1, int P2, int y_group, int R, int T, int tile) {
    __shared__ float4 ys[H2O_Y_STAGE];
    const long long blk = blockIdx.x;
    const int f = (int)(blk / R);
    const int r = (int)(blk - (long long)f * R);
    const int g = f / y_group;
    const int row = r * H2O_REGION_ROWS + threadIdx.x;
    float x0, x1, x2;
    const bool live = h2o_load_row(x, ctr, f, g, row, P1, x0, x1, x2);
    const float4* yg = y + (size_t)g * P2;
    float best;
    int best_j;
    h2o_cull_row_scan(ys, yg, mask + ((size_t)f * R + r) * T, T, tile, P2, live,
                      x0, x1, x2, best, best_j);
    if (live) h2o_write_dvec(d_out, dvec, (size_t)f * P1 + row, yg, best, best_j, x0, x1, x2);
}

extern "C" int h2o_cull_dvec_launch(const float* x, const float4* y, const float* ctr,
                                    const int* mask, float* d_out, float* dvec,
                                    int F, int P1, int P2, int y_group, int T, int tile,
                                    cudaStream_t stream) {
    if (F <= 0 || P1 <= 0) return 0;
    const int R = (P1 + H2O_REGION_ROWS - 1) / H2O_REGION_ROWS;
    const unsigned blocks = (unsigned)((long long)F * R);
    h2o_cull_dvec_kernel<<<blocks, H2O_REGION_ROWS, 0, stream>>>(
        x, y, ctr, mask, d_out, dvec, P1, P2, y_group, R, T, tile);
    return (int)cudaGetLastError();
}
