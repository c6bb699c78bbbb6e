// Region-culled fused distance loss of G's extra loss (dist_impl
// "fused_cull"): dist_loss.cu's per-point integrands and gradient rows,
// with only the [128-row region, tile] blocks that the region-cull mask
// keeps searched.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_loss.py
// `_dist_loss_cull_kernel` (:505; `_dist_loss_forward_cull` :656,
// pallas_call at :673). Operands are dist_loss.cu's (rows x and normals n
// of the template-permuted hand, the group's centred cloud, GT fields,
// contact weights, x_valid) plus the mask m [F, R, T] int32 of
// ops/chamfer_loss.region_cull_mask: 0 = skip the block, 1 = it may hold a
// row's minimum, 3 = it may also hold a column's first-min row. The
// per-point formulas are dist_loss_common.cuh's. What the cull changes:
//   o2h, per column j in tile t: the first minimum over the rows of the
//     regions r with m[r][t] != 0, in ascending row order with a strict <
//     (the TPU's strict < across regions, chamfer_loss.py:576-585). A
//     column that searched no pair gives v = 0 and no gradient.
//   h2o, per row in region r: the first minimum over the tiles t with
//     m[r][t] != 0. A row that searched no pair (every block skipped: an
//     x_valid == 0 frame, an all-invalid cloud) gives dh = 0 and a zero
//     gradient row (the TPU's `hdone`, :644-653).
// The mask only drops blocks that provably hold no minimum, so on live
// frames whose cloud has a valid point the outputs equal dist_loss.cu's on
// the same operands bit for bit (gx_do up to the order of its atomics).
//
// Bound: floating-point work, 8 flops per (row, point) pair of the blocks
// the mask keeps on live frames; bytes are far below.
// Design: dist_loss.cu's two kernels, each computing the kept pairs once:
//   o2h: one block of 256 threads per frame; rows, normals and the gx_do
//        accumulator in shared memory. For each pass of 1024 columns a
//        region is scanned only if its flag is set for a tile the pass
//        touches; the test reads the mask alone, so it is uniform over the
//        block and a skipped region costs no divergence. Where a pass
//        straddles two tiles (a tile that is not a multiple of 1024), each
//        column also keeps the region's pairs only if its own tile's flag
//        is set.
//   h2o: one block of 128 rows per (frame, region), over the tiles whose
//        flag is set (h2o_common.cuh's h2o_cull_row_scan, first-min index
//        kept); the nearest point is one load after the search.

#include "dist_loss_common.cuh"

__global__ void __launch_bounds__(O2H_THREADS)
dist_loss_cull_o2h_kernel(const float* __restrict__ x,      // [F, P1, 3]
                          const float* __restrict__ n,      // [F, P1, 3]
                          const float4* __restrict__ y,     // [G, P2] centred
                          const float* __restrict__ ctr,    // [G, 3]
                          const float* __restrict__ og,     // [F, P2] GT signed o2h
                          const int* __restrict__ mask,     // [F, R, T]
                          const unsigned char* __restrict__ x_valid,  // [F]
                          float* __restrict__ v_out,        // [F, P2]
                          float* __restrict__ gx_do,        // [F, P1, 3]
                          int P1, int P2, int y_group, int R, int T, int tile) {
    extern __shared__ float4 smem[];
    float4* xs = smem;
    float4* ns = smem + P1;
    float* acc = reinterpret_cast<float*>(smem + 2 * P1);  // [P1 * 3]
    const int f = blockIdx.x;
    const int g = f / y_group;
    float* vf = v_out + (size_t)f * P2;
    float* gf = gx_do + (size_t)f * P1 * 3;
    if (!x_valid[f]) {  // uniform over the block, before any barrier
        for (int j = threadIdx.x; j < P2; j += blockDim.x) vf[j] = 0.f;
        for (int k = threadIdx.x; k < P1 * 3; k += blockDim.x) gf[k] = 0.f;
        return;
    }
    for (int k = threadIdx.x; k < P1 * 3; k += blockDim.x) acc[k] = 0.f;
    o2h_stage_rows(xs, ns, x, n, ctr, f, g, P1);  // ends with a barrier

    const float4* yg = y + (size_t)g * P2;
    const float* ogf = og + (size_t)f * P2;
    const int* mf = mask + (size_t)f * R * T;
    for (int j0 = 0; j0 < P2; j0 += O2H_TILE) {
        float4 yv[O2H_COLS];
        o2h_load_cols(yg, j0, P2, yv);
        int tc[O2H_COLS];  // each column's tile (a dead column takes the last)
#pragma unroll
        for (int c = 0; c < O2H_COLS; ++c) tc[c] = min(j0 + c * O2H_THREADS + (int)threadIdx.x, P2 - 1) / tile;
        const int t0 = j0 / tile;
        const int t1 = (min(j0 + O2H_TILE, P2) - 1) / tile;
        float best[O2H_COLS];
        int best_i[O2H_COLS];
#pragma unroll
        for (int c = 0; c < O2H_COLS; ++c) {
            best[c] = H2O_BIG;
            best_i[c] = -1;
        }
        for (int r = 0; r < R; ++r) {
            const int* mr = mf + r * T;
            bool any = false;
            for (int t = t0; t <= t1; ++t) any |= mr[t] != 0;
            if (!any) continue;  // block-uniform: the mask alone decides
            bool use[O2H_COLS];
#pragma unroll
            for (int c = 0; c < O2H_COLS; ++c) use[c] = mr[tc[c]] != 0;
            const int i1 = min(P1, (r + 1) * H2O_REGION_ROWS);
#pragma unroll 2
            for (int i = r * H2O_REGION_ROWS; i < i1; ++i) {
                const float4 xr = xs[i];
#pragma unroll
                for (int c = 0; c < O2H_COLS; ++c) {
                    const float d = h2o_pair_d2(xr.x, xr.y, xr.z, yv[c]);
                    if (use[c] && d < best[c]) {  // strict: the first minimum wins
                        best[c] = d;
                        best_i[c] = i;
                    }
                }
            }
        }
#pragma unroll
        for (int c = 0; c < O2H_COLS; ++c) {
            const int j = j0 + c * O2H_THREADS + threadIdx.x;
            if (j >= P2) continue;
            vf[j] = dist_loss_o2h_column(xs, ns, acc, yv[c], best[c], best_i[c],
                                         yv[c].x < O2H_INVALID_Y && best_i[c] >= 0, ogf[j]);
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < P1 * 3; k += blockDim.x) gf[k] = acc[k];
}

__global__ void __launch_bounds__(H2O_REGION_ROWS)
dist_loss_cull_h2o_kernel(const float* __restrict__ x,      // [F, P1, 3]
                          const float4* __restrict__ y,     // [G, P2] centred
                          const float* __restrict__ ctr,    // [G, 3]
                          const float* __restrict__ hg,     // [F, P1] GT h2o
                          const float* __restrict__ vw,     // [P1] contact weights
                          const int* __restrict__ mask,     // [F, R, T]
                          const unsigned char* __restrict__ x_valid,  // [F]
                          float* __restrict__ dh_out,       // [F, P1]
                          float* __restrict__ gx_dh,        // [F, P1, 3]
                          int P1, int P2, int y_group, int R, int T, int tile) {
    __shared__ float4 ys[H2O_Y_STAGE];
    const long long blk = blockIdx.x;
    const int f = (int)(blk / R);
    const int r = (int)(blk - (long long)f * R);
    const int g = f / y_group;
    const int row = r * H2O_REGION_ROWS + threadIdx.x;
    const size_t o = (size_t)f * P1 + row;
    if (!x_valid[f]) {  // uniform over the block, before any barrier
        if (row < P1) {
            dh_out[o] = 0.f;
            gx_dh[3 * o + 0] = gx_dh[3 * o + 1] = gx_dh[3 * o + 2] = 0.f;
        }
        return;
    }
    float x0, x1, x2;
    const bool live = h2o_load_row(x, ctr, f, g, row, P1, x0, x1, x2);
    float best;
    int best_j;
    const float4* yg = y + (size_t)g * P2;
    h2o_cull_row_scan(ys, yg, mask + ((size_t)f * R + r) * T, T, tile, P2, live,
                      x0, x1, x2, best, best_j);
    if (!live) return;
    dist_loss_h2o_row(dh_out, gx_dh, o, yg, best, best_j, best < H2O_BIG,
                      x0, x1, x2, hg[o], vw[row]);
}

extern "C" int dist_loss_cull_launch(const float* x, const float* n, const float4* y,
                                     const float* ctr, const float* og, const float* hg,
                                     const float* vw, const unsigned char* x_valid,
                                     const int* mask, float* v_out, float* dh_out,
                                     float* gx_do, float* gx_dh, int F, int P1, int P2,
                                     int y_group, int R, int T, int tile, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0 || P2 <= 0) return 0;
    const size_t smem = (size_t)P1 * (2 * sizeof(float4) + 3 * sizeof(float));
    dist_loss_cull_o2h_kernel<<<F, O2H_THREADS, smem, stream>>>(
        x, n, y, ctr, og, mask, x_valid, v_out, gx_do, P1, P2, y_group, R, T, tile);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dist_loss_cull_h2o_kernel<<<(unsigned)((long long)F * R), H2O_REGION_ROWS, 0, stream>>>(
        x, y, ctr, hg, vw, mask, x_valid, dh_out, gx_dh, P1, P2, y_group, R, T, tile);
    return (int)cudaGetLastError();
}
