// All-pairs hand->object nearest neighbour (h2o) with the offset to the
// nearest point, the forward of the differentiated h2o route.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_pallas.py
// `_nn_h2o_dvec_kernel` (:408, pallas_call in `_nn_h2o_dvec_forward` at
// :476): per frame f and hand row i, the min over the frame's object cloud
// y[f / y_group] of ||x_i - y_j||^2, and dvec_i = x_i - y_{j*} (both
// centred on the group's y-mean) at the first minimum j*. With dvec the
// backward is elementwise: d dist_i / d x_i = dvec_i / dist_i.
//
// Bound: floating-point work, 8 flops per (x, y) pair on the non-tensor
// FP32 pipes, as h2o_nn.cu; dvec adds one 16-byte load and a 12-byte store
// per row. Design: the h2o_nn.cu row search unchanged (h2o_row_scan keeps
// the first-min index in a register), then one read of y4[g, j*] from
// device memory. The TPU selects y* with one-hot lane sums over each tile;
// an index in a register makes that a single load here. A row that never
// took a point (an all-invalid cloud: every y at 1e15 loses to BIG) writes
// dvec = 0, so the FAR coordinate never reaches a gradient.

#include "h2o_common.cuh"

__global__ void __launch_bounds__(H2O_REGION_ROWS)
h2o_nn_dvec_kernel(const float* __restrict__ x,     // [F, P1, 3]
                   const float4* __restrict__ y,    // [G, P2] centred, invalid at 1e15
                   const float* __restrict__ ctr,   // [G, 3] y-mean per group
                   float* __restrict__ d_out,       // [F, P1] min squared distance
                   float* __restrict__ dvec,        // [F, P1, 3] x - y* (centred)
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
    float best;
    int best_j;
    h2o_row_scan(ys, yg, P2, live, x0, x1, x2, best, best_j);
    if (live) h2o_write_dvec(d_out, dvec, (size_t)f * P1 + row, yg, best, best_j, x0, x1, x2);
}

extern "C" int h2o_nn_dvec_launch(const float* x, const float4* y, const float* ctr,
                                  float* d_out, float* dvec,
                                  int F, int P1, int P2, int y_group, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0) return 0;
    const int R = (P1 + H2O_REGION_ROWS - 1) / H2O_REGION_ROWS;
    const unsigned blocks = (unsigned)((long long)F * R);
    h2o_nn_dvec_kernel<<<blocks, H2O_REGION_ROWS, 0, stream>>>(
        x, y, ctr, d_out, dvec, P1, P2, y_group, R);
    return (int)cudaGetLastError();
}
