// Cluster-pruned object->hand nearest neighbour (o2h) with the sign
// numerator: kernel #12 (the o2h half of the cluster route's signed pair;
// its h2o half is h2o_topk.cu).
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_cluster.py
// `_o2h_topk_kernel` (:801, pallas_call in `_signed_cluster_forward` at
// :920). For frame f, each object point y_j of 128-point cell c searches
// the hand tiles cidx_y[f, c, :] (128 rows each of the template-permuted
// hand, chosen by ops/chamfer_cluster.o2h_select; 0..T-1 in order when
// k_tiles is 0, the default) and returns
//   o2h_d: min over the candidate rows i of ||x_i - y_j||^2,
//   o2h_i: the first row i* reaching it (permuted row index; the wrapper
//          maps it back to the caller's order),
//   o2h_dot: the sign numerator n_{i*} . (y_j - x_{i*}),
// visiting tiles in candidate order with a strict < and each tile's rows in
// ascending order, as the TPU's per-tile argmin and `m < best_d` do. With
// k_tiles = 0 that is the first minimum over all rows in ascending order:
// the o2h half of nn_signed.cu, bit for bit. Rows past P1 (the last tile's
// pad) are never read; an invalid point (at 1e15) keeps (BIG, 0, .) and is
// masked by every caller.
//
// Bound: floating-point work, 8 flops per pair searched, F x P2 x Kx x 128
// pairs at most (the last tile holds P1 - 128 (T-1) rows). Design: one
// block of 128 threads per (frame, cell), one point per thread. The block
// stages its frame's rows, centred on the frame's y-mean, and normals in
// shared memory as float4 (o2h_common.cuh's o2h_stage_rows, 24.9 KB for
// the 778 MANO rows), then scans only the candidate tiles: each staged row
// is a broadcast read shared by the 128 points; the winner's row and
// normal for the sign are a shared-memory load, as in nn_signed.cu.

#include "o2h_common.cuh"

#define O2H_TOPK_CELL 128  // points per cell (ops/chamfer_cluster.S_CELL) == block size

__global__ void __launch_bounds__(O2H_TOPK_CELL)
o2h_topk_kernel(const float* __restrict__ x,      // [F, P1, 3] permuted rows
                const float* __restrict__ n,      // [F, P1, 3] permuted normals
                const float4* __restrict__ y,     // [F, P2] centred, invalid at FAR
                const float* __restrict__ ctr,    // [F, 3]
                const int* __restrict__ cidx_y,   // [F, C, Kx] candidate tiles
                float* __restrict__ o2h_d,        // [F, P2]
                int* __restrict__ o2h_i,          // [F, P2]
                float* __restrict__ o2h_dot,      // [F, P2]
                int P1, int P2, int C, int Kx) {
    extern __shared__ float4 smem[];
    float4* xs = smem;
    float4* ns = smem + P1;
    const long long blk = blockIdx.x;
    const int f = (int)(blk / C);
    const int c = (int)(blk - (long long)f * C);
    o2h_stage_rows(xs, ns, x, n, ctr, f, f, P1);  // ends with a barrier

    const int j = c * O2H_TOPK_CELL + threadIdx.x;
    if (j >= P2) return;  // the last cell's pad: no barrier follows
    const size_t o = (size_t)f * P2 + j;
    const float4 yv = y[o];
    const int T = (P1 + O2H_TOPK_CELL - 1) / O2H_TOPK_CELL;
    const int* cl = cidx_y + ((size_t)f * C + c) * Kx;
    float best = H2O_BIG;
    int best_i = 0;
    for (int k = 0; k < Kx; ++k) {
        const int t = cl[k];
        if ((unsigned)t >= (unsigned)T) continue;  // never written by the selection
        const int i1 = min(P1, (t + 1) * O2H_TOPK_CELL);
#pragma unroll 4
        for (int i = t * O2H_TOPK_CELL; i < i1; ++i) {
            const float4 xr = xs[i];
            const float d = h2o_pair_d2(xr.x, xr.y, xr.z, yv);
            if (d < best) {
                best = d;
                best_i = i;
            }
        }
    }
    o2h_d[o] = best;
    o2h_i[o] = best_i;
    o2h_dot[o] = o2h_sign_numer(xs[best_i], ns[best_i], yv);
}

extern "C" int o2h_topk_launch(const float* x, const float* n, const float4* y,
                               const float* ctr, const int* cidx_y, float* o2h_d,
                               int* o2h_i, float* o2h_dot, int F, int P1, int P2,
                               int C, int Kx, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0 || P2 <= 0) return 0;
    const size_t smem = (size_t)P1 * 2 * sizeof(float4);
    o2h_topk_kernel<<<(unsigned)((long long)F * C), O2H_TOPK_CELL, smem, stream>>>(
        x, n, y, ctr, cidx_y, o2h_d, o2h_i, o2h_dot, P1, P2, C, Kx);
    return (int)cudaGetLastError();
}
