// Fused distance loss of G's extra loss: per-point integrands of dist_o and
// dist_h and their gradients with respect to the hand rows, in one pass.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_loss.py
// `_dist_loss_kernel` (:129, body `_dist_loss_step` :185, pallas_call in
// `_dist_loss_forward` at :391). For frame f with rows x_i, normals n_i,
// cloud y_j = y[f / y_group] (centred, invalid points at 1e15), GT fields
// og_j (signed o2h) and hg_i (h2o), and contact weights vw_i:
//   o2h phase, per column j with first-min row i*:
//     dist = sqrt(d), sign = sign(n_{i*} . (y_j - x_{i*})), o = dist * sign
//     w = 1.5 if o < 0 else (1.0 if -0.005 < og_j < 0.01 else 0.1)
//     v_j = |o - og_j| w;  gx_do[i*] += w sgn(o - og_j) sign / max(dist, 1e-12) (x_{i*} - y_j)
//   h2o phase, per row i with first-min point j*:
//     hd = sqrt(d), dh_i = |hd - |hg_i|| vw_i
//     gx_dh[i] = vw_i sgn(hd - |hg_i|) / max(hd, 1e-12) (x_i - y_{j*})
// Invalid columns give v = 0 and no gradient. x_valid[f] == 0 frames
// (mask-padded frames, padded object slots) cost nothing and emit zeros.
//
// Bound: floating-point work, 8 flops per (x, y) pair; bytes are far below.
// Design: the two phases are two kernels launched back to back, each
// computing its pairs once (2x the bound's pair work, like nn_signed.cu):
//   o2h: one block of 256 threads per FRAME (not per tile), so the frame's
//        gx_do accumulator [P1, 3] lives in shared memory beside the staged
//        rows and normals (34 KB at 778 rows) and is written once: the
//        scatter is a shared atomic add, never a device-memory one. Each
//        thread keeps 4 columns per pass in registers (o2h_common.cuh).
//   h2o: h2o_common.cuh's row search with the first-min index kept; the
//        nearest point's coordinates are one load after the search.
// The per-point arithmetic of both phases is dist_loss_common.cuh's, which
// the region-culled twin (dist_loss_cull.cu) shares.
// The shared atomic adds land in a run-dependent order: gx_do is not
// bitwise reproducible, compare at rtol.

#include "dist_loss_common.cuh"

__global__ void __launch_bounds__(O2H_THREADS)
dist_loss_o2h_kernel(const float* __restrict__ x,      // [F, P1, 3]
                     const float* __restrict__ n,      // [F, P1, 3]
                     const float4* __restrict__ y,     // [G, P2] centred
                     const float* __restrict__ ctr,    // [G, 3]
                     const float* __restrict__ og,     // [F, P2] GT signed o2h
                     const unsigned char* __restrict__ x_valid,  // [F]
                     float* __restrict__ v_out,        // [F, P2]
                     float* __restrict__ gx_do,        // [F, P1, 3]
                     int P1, int P2, int y_group) {
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
    for (int j0 = 0; j0 < P2; j0 += O2H_TILE) {
        float4 yv[O2H_COLS];
        o2h_load_cols(yg, j0, P2, yv);
        float best[O2H_COLS];
        int best_i[O2H_COLS];
        o2h_scan(xs, P1, yv, best, best_i);
#pragma unroll
        for (int c = 0; c < O2H_COLS; ++c) {
            const int j = j0 + c * O2H_THREADS + threadIdx.x;
            if (j >= P2) continue;
            vf[j] = dist_loss_o2h_column(xs, ns, acc, yv[c], best[c], best_i[c],
                                         yv[c].x < O2H_INVALID_Y, ogf[j]);
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < P1 * 3; k += blockDim.x) gf[k] = acc[k];
}

__global__ void __launch_bounds__(H2O_REGION_ROWS)
dist_loss_h2o_kernel(const float* __restrict__ x,      // [F, P1, 3]
                     const float4* __restrict__ y,     // [G, P2] centred
                     const float* __restrict__ ctr,    // [G, 3]
                     const float* __restrict__ hg,     // [F, P1] GT h2o
                     const float* __restrict__ vw,     // [P1] contact weights
                     const unsigned char* __restrict__ x_valid,  // [F]
                     float* __restrict__ dh_out,       // [F, P1]
                     float* __restrict__ gx_dh,        // [F, P1, 3]
                     int P1, int P2, int y_group, int R) {
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
    h2o_row_scan(ys, yg, P2, live, x0, x1, x2, best, best_j);
    if (!live) return;
    dist_loss_h2o_row(dh_out, gx_dh, o, yg, best, best_j, true, x0, x1, x2, hg[o], vw[row]);
}

extern "C" int dist_loss_launch(const float* x, const float* n, const float4* y,
                                const float* ctr, const float* og, const float* hg,
                                const float* vw, const unsigned char* x_valid,
                                float* v_out, float* dh_out, float* gx_do, float* gx_dh,
                                int F, int P1, int P2, int y_group, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0 || P2 <= 0) return 0;
    const size_t smem = (size_t)P1 * (2 * sizeof(float4) + 3 * sizeof(float));
    dist_loss_o2h_kernel<<<F, O2H_THREADS, smem, stream>>>(
        x, n, y, ctr, og, x_valid, v_out, gx_do, P1, P2, y_group);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int R = (P1 + H2O_REGION_ROWS - 1) / H2O_REGION_ROWS;
    dist_loss_h2o_kernel<<<(unsigned)((long long)F * R), H2O_REGION_ROWS, 0, stream>>>(
        x, y, ctr, hg, vw, x_valid, dh_out, gx_dh, P1, P2, y_group, R);
    return (int)cudaGetLastError();
}
